// pad_rows: bucket padding of one [N, C] block to a row-major [target, C]
// block by repeating the last row — out[r, c] = a[min(r, N - 1), c].
//
// Replaces the Pallas kernel `_pad_kernel` (sntc_tpu/kernels/assemble.py:57)
// behind `pad_rows_pallas` (:69), which expressed the row gather as a
// one-hot matmul on the MXU.  Here the kernel only copies, so the result is
// bitwise the plain version's.
//
// Bound on an H100: bytes, (N + target) * C * itemsize (one read of the
// block, one write of the padded block).
//
// The block arrives row-major, or column-major (strides (1, N)): the serve
// path packs each column of a batch contiguously on the host and uploads
// the [C, N] block as it is, so the transposition happens here, where it
// costs no more than the copy.  A thread block owns a tile of R output rows
// (R a power of two and a multiple of the V elements of a 16-byte vector,
// so that the tile's output starts 16-byte aligned; R * C * itemsize within
// kTileBytes, which keeps 8 blocks of 256 threads on an SM; smaller where
// the grid would otherwise have fewer than two blocks an SM) and builds the
// tile in shared memory in the output's own row-major order:
//   1. load the tile's real rows.  Column-major: a column's R elements are
//      contiguous in the input; eight lanes read 8 x 16 bytes of one column
//      (a whole 128-byte line), a warp four columns, and each lane scatters
//      its V elements into the tile's rows (the transposition).  Row-major:
//      the tile's R * C elements are contiguous: a flat 16-byte copy.
//   2. fill the tile's pad rows (rows >= N) with the last row, read once by
//      each thread that writes it (from the tile when the tile holds row
//      N - 1, else from the input) and kept in a register.
//   3. store the tile: R * C contiguous output elements, 16 bytes a lane.
// Offsets come from blockIdx, shifts and loop counters: the only division
// is one 32-bit division and remainder per thread, in the fill.  A
// column-major block whose columns do not start 16-byte aligned (N *
// itemsize not a multiple of 16) or an input pointer off 16 bytes loads
// element by element; the ragged last tile's tail stores element by
// element.
//
// Plain C interface, bound with ctypes: each entry point launches on the
// given stream and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileBytes = 24 * 1024;
constexpr int kMaxTileRows = 2048;
constexpr int kMaxSmemBytes = 227 * 1024;
constexpr int kLanesPerColumn = 8;  // 8 x 16 bytes: one 128-byte line
constexpr int kMinBlocks = 264;     // two blocks for each of the H100's 132 SMs

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
};

// The tile of one block: R rows starting at output row r0, of which
// `real` are rows of the input and `rows` are written.
struct Tile {
  int64_t r0;
  int real;
  int rows;
};

template <typename T, bool kColMajor, bool kVecIn>
__device__ __forceinline__ void load_tile(const T* __restrict__ a, T* tile,
                                          int64_t n, int c, const Tile& t,
                                          int rv_shift, int lane_shift) {
  using V = Vec16<T>;
  const int tid = threadIdx.x;
  if (kColMajor) {
    // work item -> (column, vector of the column): the low `lane_shift`
    // bits walk down a column, the next bits across columns, so a warp
    // reads whole 128-byte lines of (32 >> lane_shift) columns
    const int cols_per_group = 32 >> lane_shift;
    const int chunks = (1 << rv_shift) >> lane_shift;  // groups down a column
    const int c_groups = (c + cols_per_group - 1) / cols_per_group;
    const int items = c_groups * chunks * 32;
    for (int idx = tid; idx < items; idx += kThreads) {
      const int lane_r = idx & ((1 << lane_shift) - 1);
      const int lane_c = (idx >> lane_shift) & (cols_per_group - 1);
      const int hi = idx >> 5;
      const int rv = ((hi & (chunks - 1)) << lane_shift) | lane_r;
      const int col = ((hi >> (rv_shift - lane_shift)) << (5 - lane_shift)) |
                      lane_c;
      const int row = rv * V::n;
      if (col >= c || row >= t.real) continue;
      const T* src = a + (int64_t)col * n + t.r0 + row;
      if (kVecIn) {
        // n and r0 are multiples of V::n, so the vector lies in real rows
        const typename V::type v =
            __ldg(reinterpret_cast<const typename V::type*>(src));
        const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
        for (int k = 0; k < V::n; ++k) tile[(row + k) * c + col] = e[k];
      } else {
#pragma unroll
        for (int k = 0; k < V::n; ++k) {
          if (row + k < t.real) tile[(row + k) * c + col] = __ldg(src + k);
        }
      }
    }
  } else {
    const T* src = a + t.r0 * c;
    const int m = t.real * c;
    int done = 0;
    if (kVecIn) {
      // r0 * c is a multiple of V::n: the tile starts 16-byte aligned
      const int vecs = m / V::n;
      const typename V::type* s =
          reinterpret_cast<const typename V::type*>(src);
      typename V::type* d = reinterpret_cast<typename V::type*>(tile);
      for (int i = tid; i < vecs; i += kThreads) d[i] = __ldg(s + i);
      done = vecs * V::n;
    }
    for (int i = done + tid; i < m; i += kThreads) tile[i] = __ldg(src + i);
  }
}

template <typename T, bool kColMajor, bool kVecIn>
__global__ void __launch_bounds__(kThreads)
    pad_rows_kernel(const T* __restrict__ a, T* __restrict__ out, int64_t n,
                    int c, int64_t target, int tile_rows, int rv_shift,
                    int lane_shift) {
  using V = Vec16<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  const int tid = threadIdx.x;
  Tile t;
  t.r0 = (int64_t)blockIdx.x * tile_rows;
  t.real = (int)(n - t.r0 < tile_rows ? (n - t.r0 > 0 ? n - t.r0 : 0)
                                      : tile_rows);
  t.rows = (int)(target - t.r0 < tile_rows ? target - t.r0 : tile_rows);

  if (t.real > 0) {
    load_tile<T, kColMajor, kVecIn>(a, tile, n, c, t, rv_shift, lane_shift);
  }
  if (t.rows > t.real) {
    __syncthreads();  // the tile's last real row is read below
    // thread -> (column, first row): one 32-bit division per thread
    const int per_row = c < kThreads ? c : kThreads;
    const int rstep = kThreads / per_row;
    if (tid < rstep * per_row) {
      for (int col = tid % per_row; col < c; col += per_row) {
        T v;
        if (t.real > 0) {
          v = tile[(t.real - 1) * c + col];
        } else {
          v = kColMajor ? __ldg(a + (int64_t)col * n + (n - 1))
                        : __ldg(a + (n - 1) * c + col);
        }
        for (int r = t.real + tid / per_row; r < t.rows; r += rstep) {
          tile[r * c + col] = v;
        }
      }
    }
  }
  __syncthreads();

  // the tile's rows are contiguous in the output: a flat 16-byte copy
  T* dst = out + t.r0 * c;
  const int m = t.rows * c;
  const int vecs = m / V::n;
  const typename V::type* s = reinterpret_cast<const typename V::type*>(tile);
  typename V::type* d = reinterpret_cast<typename V::type*>(dst);
  for (int i = tid; i < vecs; i += kThreads) d[i] = s[i];
  for (int i = vecs * V::n + tid; i < m; i += kThreads) dst[i] = tile[i];
}

int log2_of(int x) {
  int s = 0;
  while ((1 << s) < x) ++s;
  return s;
}

template <typename T, bool kColMajor, bool kVecIn>
int launch_variant(const T* a, T* out, int64_t n, int c, int64_t target,
                   int tile_rows, cudaStream_t stream) {
  const int v = Vec16<T>::n;
  const int rv = tile_rows / v;
  const int rv_shift = log2_of(rv);
  const int lane_shift = log2_of(rv < kLanesPerColumn ? rv : kLanesPerColumn);
  const size_t smem = (size_t)tile_rows * c * sizeof(T);
  auto kernel = pad_rows_kernel<T, kColMajor, kVecIn>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = (target + tile_rows - 1) / tile_rows;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      a, out, n, c, target, tile_rows, rv_shift, lane_shift);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* a_, void* out_, int64_t n, int64_t c64, int64_t target,
           int col_major, void* stream_) {
  const T* a = (const T*)a_;
  T* out = (T*)out_;
  cudaStream_t stream = (cudaStream_t)stream_;
  const int v = Vec16<T>::n;
  if (c64 <= 0 || n <= 0 || target < n) return (int)cudaErrorInvalidValue;
  if ((int64_t)v * c64 * (int64_t)sizeof(T) > kMaxSmemBytes) {
    return (int)cudaErrorInvalidValue;  // the wrapper refuses such a block
  }
  if ((uintptr_t)out % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const int c = (int)c64;
  // the largest power-of-two tile within kTileBytes (at least one vector
  // of rows: a wide block takes more shared memory and fewer blocks an
  // SM), halved while the grid would leave SMs idle (a small bucket)
  int tile_rows = v;
  while (tile_rows < kMaxTileRows &&
         (int64_t)tile_rows * 2 * c * (int64_t)sizeof(T) <= kTileBytes) {
    tile_rows *= 2;
  }
  while (tile_rows > v && (target + tile_rows - 1) / tile_rows < kMinBlocks) {
    tile_rows /= 2;
  }
  const bool aligned = (uintptr_t)a % 16 == 0;
  if (col_major) {
    if (aligned && n % v == 0) {
      return launch_variant<T, true, true>(a, out, n, c, target, tile_rows,
                                           stream);
    }
    return launch_variant<T, true, false>(a, out, n, c, target, tile_rows,
                                          stream);
  }
  if (aligned) {
    return launch_variant<T, false, true>(a, out, n, c, target, tile_rows,
                                          stream);
  }
  return launch_variant<T, false, false>(a, out, n, c, target, tile_rows,
                                         stream);
}

}  // namespace

extern "C" int sntc_pad_rows_f32(const void* a, void* out, int64_t n,
                                 int64_t c, int64_t target, int col_major,
                                 void* stream) {
  return launch<float>(a, out, n, c, target, col_major, stream);
}

extern "C" int sntc_pad_rows_f64(const void* a, void* out, int64_t n,
                                 int64_t c, int64_t target, int col_major,
                                 void* stream) {
  return launch<double>(a, out, n, c, target, col_major, stream);
}
