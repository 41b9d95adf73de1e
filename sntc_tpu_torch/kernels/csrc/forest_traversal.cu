// forest_traversal: leaf statistics of every (tree, row) of a dense-heap
// forest — the serving walk of the random-forest / GBT / decision-tree heads.
//
// Replaces the Pallas kernel `_forest_kernel` behind
// `forest_leaf_stats_pallas` (sntc_tpu/kernels/forest.py).  That kernel
// kept one (tree, 128-row) tile in VMEM and turned every gather into an
// iota-mask select plus a one-hot MXU matmul, because the TPU has no fast
// gather.  A GPU gathers natively, so here one thread walks one (tree, row):
//
//     node = 0
//     repeat max_depth:
//         f = feature[t, node];  if f < 0: stop     (-1 leaf, -2 absent)
//         node = 2*node + 1 + (X[row, f] >= threshold[t, node])
//     out[t, row, :] = leaf_stats[t, node, :]
//
// The comparison is the same `>=` in the same type as the plain version,
// so a NaN feature value goes left and the result is bitwise equal to it.
//
// Bound on an H100: bytes.  The output T*N*S values are the bulk of the
// traffic (79 MB at T=20, N=65536, S=15 in f32, ~24 us at 3.35 TB/s);
// the walk itself is max_depth dependent loads per thread, which hit L2
// (one tree's feature/threshold arrays are 16 KB).  Consecutive threads
// are consecutive rows of one tree, so a warp's output is one contiguous
// 32*S-value run.  Staging a tree in shared memory and vectorized stores
// are later work.
//
// Plain C interface, bound with ctypes: each entry point launches on the
// given stream and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename scalar_t>
__global__ void forest_leaf_stats_kernel(
    const scalar_t* __restrict__ X,          // [N, F]
    const int32_t* __restrict__ feature,     // [T, M]
    const scalar_t* __restrict__ threshold,  // [T, M]
    const scalar_t* __restrict__ leaf,       // [T, M, S]
    scalar_t* __restrict__ out,              // [T, N, S]
    int64_t n, int64_t f, int64_t m, int64_t s, int max_depth) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int64_t t = blockIdx.y;
  const int32_t* feat_t = feature + t * m;
  const scalar_t* thr_t = threshold + t * m;
  const scalar_t* x_row = X + row * f;
  int64_t node = 0;
  for (int d = 0; d < max_depth; ++d) {
    const int32_t fi = __ldg(feat_t + node);
    if (fi < 0) break;
    const scalar_t xv = __ldg(x_row + fi);
    const scalar_t tv = __ldg(thr_t + node);
    node = 2 * node + 1 + (xv >= tv ? 1 : 0);
  }
  const scalar_t* src = leaf + (t * m + node) * s;
  scalar_t* dst = out + (t * n + row) * s;
  for (int64_t k = 0; k < s; ++k) dst[k] = __ldg(src + k);
}

template <typename scalar_t>
int launch(const void* X, const void* feature, const void* threshold,
           const void* leaf, void* out, int64_t n, int64_t f, int64_t t,
           int64_t m, int64_t s, int max_depth, void* stream) {
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)t);
  forest_leaf_stats_kernel<scalar_t>
      <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          (const scalar_t*)X, (const int32_t*)feature,
          (const scalar_t*)threshold, (const scalar_t*)leaf, (scalar_t*)out,
          n, f, m, s, max_depth);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sntc_forest_leaf_stats_f32(
    const void* X, const void* feature, const void* threshold,
    const void* leaf, void* out, int64_t n, int64_t f, int64_t t, int64_t m,
    int64_t s, int max_depth, void* stream) {
  return launch<float>(X, feature, threshold, leaf, out, n, f, t, m, s,
                       max_depth, stream);
}

extern "C" int sntc_forest_leaf_stats_f64(
    const void* X, const void* feature, const void* threshold,
    const void* leaf, void* out, int64_t n, int64_t f, int64_t t, int64_t m,
    int64_t s, int max_depth, void* stream) {
  return launch<double>(X, feature, threshold, leaf, out, n, f, t, m, s,
                        max_depth, stream);
}
