// pad_rows: bucket padding of one [N, C] column block to [target, C] by
// repeating the last row — out[r, c] = a[min(r, N - 1), c].
//
// Replaces the Pallas kernel `_pad_kernel` behind `pad_rows_pallas`
// (sntc_tpu/kernels/assemble.py), which expressed the row gather as a
// one-hot matmul on the MXU.  Here one thread copies one output element;
// the copy is exact, so the result is bitwise the plain version's.
//
// Bound on an H100: bytes, (N + target) * C * itemsize (one read of the
// block, one write of the padded block).  Consecutive threads touch
// consecutive elements of a row-major block, so loads and stores coalesce.
//
// Plain C interface, bound with ctypes: each entry point launches on the
// given stream and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename scalar_t>
__global__ void pad_rows_kernel(const scalar_t* __restrict__ a,
                                scalar_t* __restrict__ out, int64_t n,
                                int64_t c, int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t r = i / c;
  const int64_t col = i - r * c;
  const int64_t src = r < n ? r : n - 1;
  out[i] = a[src * c + col];
}

template <typename scalar_t>
int launch(const void* a, void* out, int64_t n, int64_t c, int64_t target,
           void* stream) {
  const int64_t total = target * c;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  pad_rows_kernel<scalar_t><<<(unsigned)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const scalar_t*)a, (scalar_t*)out, n, c, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sntc_pad_rows_f32(const void* a, void* out, int64_t n,
                                 int64_t c, int64_t target, void* stream) {
  return launch<float>(a, out, n, c, target, stream);
}

extern "C" int sntc_pad_rows_f64(const void* a, void* out, int64_t n,
                                 int64_t c, int64_t target, void* stream) {
  return launch<double>(a, out, n, c, target, stream);
}
