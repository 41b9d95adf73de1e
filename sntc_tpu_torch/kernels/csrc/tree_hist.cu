// tree_hist: one tree level's weighted sufficient statistics, for every
// tree of a forest in one launch — the histogram of the level-wise tree
// grower and of the chi-square contingency.
//
//     out[t, f, node[t, n] * B + bin[f, n], :] += stats[n, :] * w[t, n]
//
// over rows n with 0 <= node[t, n] < n_nodes, w[t, n] != 0 and
// 0 <= bin[f, n] < B (w = 1 when no weights are given).
//
// Replaces the Pallas kernel `_hist_kernel` behind `level_histogram_pallas`
// (sntc_tpu/ops/pallas_histogram.py).  The TPU serialises scatter-adds, so
// that kernel recast the scatter as one-hot MXU matmuls over (8-feature,
// row-tile) blocks, one tree per call.  A GPU scatters into shared memory
// natively, so here each block privatises a histogram there:
//
//   * a block owns (tree t, a run of features, a slice of the node·bin
//     cell axis, a chunk of rows).  It zeroes its shared histogram, walks
//     its rows, adds each row's stats into the cells of its features with
//     shared-memory atomics, then adds its non-zero partial sums to device
//     memory with global atomics;
//   * where a feature's n_nodes·B·S cells fit the block's shared memory,
//     one block covers as many features as fit (the chi-square contingency:
//     1 node × 32 bins × 15 classes, 39 features a block), and the row axis
//     is cut into chunks so that enough blocks fill the card;
//   * where they do not (a deep level: 128 nodes × 32 bins × 15 stats is
//     245 KB a feature), the cell axis is cut into slices of whole cells and
//     each block keeps only the rows whose cell falls in its slice; rows
//     whose node lies outside the slice are dropped after one 4-byte read;
//   * rows with node -1 or weight 0 (~37 % under Poisson(1) bagging) are
//     skipped, and so are adds of exact zeros (14 of 15 one-hot class
//     stats): neither changes the sum.
//
// Sums are taken in a run-to-run varying order.  With integer-valued
// weights and stats (bagging counts, one-hot classes) every cell is a
// small-integer f32 sum and exact in any order, so the result is bitwise
// that of the plain version; with fractional weights it agrees to f32
// rounding (<= 1e-5 relative), and the last bits may differ between runs.
//
// Bound on an H100: bytes — the node ids, weights, bins and stats read and
// the [T, F, n_nodes·B, S] output written (196 MB at T=20, F=40, 128
// nodes, B=32, S=15: ~0.06 ms at 3.35 TB/s).  What this simple design
// pays beyond that: every cell slice re-reads the node ids of all rows,
// the output is zeroed and then written with atomics, and the stats row
// is read per feature from L1.  Row partitioning by node, vectorised
// loads and a deterministic reduction order are later work.
//
// Offsets into the output are 64-bit: T·F·n_nodes·B·S reaches 98 M
// elements at config 3's level 9 and more with GBT's 128 bins.
//
// Plain C interface, bound with ctypes: the entry point launches on the
// given stream and returns the first CUDA error of the launch (0 if none).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSmemBytes = 96 * 1024;  // two blocks fit an SM's 227 KB
constexpr int64_t kSmemFloats = kSmemBytes / 4;
constexpr int64_t kMinRowsPerBlock = 2048;
constexpr int kBlocksPerSm = 4;  // row chunks aim at this many blocks/SM

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__global__ void __launch_bounds__(kThreads) tree_hist_kernel(
    const int32_t* __restrict__ bins,    // [F, N]
    const int32_t* __restrict__ node,    // [T, N], -1 = inactive
    const float* __restrict__ weight,    // [T, N] or nullptr (all 1)
    const float* __restrict__ stats,     // [N, S]
    float* __restrict__ out,             // [T, F, n_nodes * B, S], zeroed
    int64_t n, int64_t n_feat, int64_t n_nodes, int64_t n_bins, int64_t s,
    int64_t feats_per_block, int64_t cells_per_slice, int64_t n_slices,
    int64_t rows_per_block) {
  extern __shared__ float hist[];  // [feats_per_block, slice cells, S]
  const int64_t cells = n_nodes * n_bins;  // node·bin cells per feature
  const int64_t slice = blockIdx.y % n_slices;
  const int64_t f0 = (blockIdx.y / n_slices) * feats_per_block;
  const int64_t nf = min64(feats_per_block, n_feat - f0);
  const int64_t t = blockIdx.z;
  const int64_t cell_lo = slice * cells_per_slice;
  const int64_t cell_hi = min64(cells, cell_lo + cells_per_slice);
  // nodes whose cells meet the slice; -1 and ids >= n_nodes fall outside
  const int64_t node_lo = cell_lo / n_bins;
  const int64_t node_hi = (cell_hi - 1) / n_bins;  // inclusive
  const int64_t width = (cell_hi - cell_lo) * s;   // floats per feature

  for (int64_t i = threadIdx.x; i < nf * width; i += blockDim.x) hist[i] = 0.f;
  __syncthreads();

  const int64_t row0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t row1 = min64(n, row0 + rows_per_block);
  const int32_t* node_t = node + t * n;
  const float* w_t = weight == nullptr ? nullptr : weight + t * n;
  for (int64_t r = row0 + threadIdx.x; r < row1; r += blockDim.x) {
    const int64_t nd = node_t[r];
    if (nd < node_lo || nd > node_hi) continue;
    const float w = w_t == nullptr ? 1.f : w_t[r];
    if (w == 0.f) continue;
    const float* st = stats + r * s;
    for (int64_t j = 0; j < nf; ++j) {
      const int64_t b = bins[(f0 + j) * n + r];
      if (b < 0 || b >= n_bins) continue;
      const int64_t cell = nd * n_bins + b;
      if (cell < cell_lo || cell >= cell_hi) continue;
      float* h = hist + j * width + (cell - cell_lo) * s;
      for (int64_t k = 0; k < s; ++k) {
        const float v = st[k];
        if (v != 0.f) atomicAdd(h + k, v * w);
      }
    }
  }
  __syncthreads();

  for (int64_t i = threadIdx.x; i < nf * width; i += blockDim.x) {
    const float v = hist[i];
    if (v == 0.f) continue;
    const int64_t j = i / width;
    const int64_t within = i - j * width;
    atomicAdd(out + ((t * n_feat + f0 + j) * cells + cell_lo) * s + within, v);
  }
}

}  // namespace

extern "C" int sntc_tree_hist_f32(
    const void* bins, const void* node, const void* weight, const void* stats,
    void* out, int64_t n, int64_t n_feat, int64_t n_trees, int64_t n_nodes,
    int64_t n_bins, int64_t s, void* stream) {
  const int64_t cells = n_nodes * n_bins;
  const int64_t feat_floats = cells * s;
  int64_t feats_per_block, cells_per_slice, n_slices, n_fblocks;
  if (feat_floats <= kSmemFloats) {
    // whole features per block, as many as fit, spread evenly
    cells_per_slice = cells;
    n_slices = 1;
    const int64_t fit = kSmemFloats / feat_floats;
    n_fblocks = (n_feat + fit - 1) / fit;
    feats_per_block = (n_feat + n_fblocks - 1) / n_fblocks;
  } else {
    // one feature per block, its cell axis cut into even slices
    if (s > kSmemFloats) return (int)cudaErrorInvalidValue;
    const int64_t fit = kSmemFloats / s;
    n_slices = (cells + fit - 1) / fit;
    cells_per_slice = (cells + n_slices - 1) / n_slices;
    feats_per_block = 1;
    n_fblocks = n_feat;
  }
  const int64_t grid_y = n_fblocks * n_slices;
  if (grid_y > 65535 || n_trees > 65535) return (int)cudaErrorInvalidConfiguration;

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(tree_hist_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  if (err != cudaSuccess) return (int)err;

  // cut the rows into chunks until the grid has ~kBlocksPerSm blocks per
  // SM, but no chunk below kMinRowsPerBlock rows
  const int64_t combos = n_trees * grid_y;
  const int64_t want = ((int64_t)kBlocksPerSm * sms + combos - 1) / combos;
  const int64_t most = (n + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  int64_t row_blocks = want < most ? want : most;
  if (row_blocks < 1) row_blocks = 1;
  const int64_t rows_per_block = (n + row_blocks - 1) / row_blocks;
  row_blocks = (n + rows_per_block - 1) / rows_per_block;

  const size_t smem = (size_t)(feats_per_block * cells_per_slice * s) * 4;
  const dim3 grid((unsigned)row_blocks, (unsigned)grid_y, (unsigned)n_trees);
  tree_hist_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)bins, (const int32_t*)node, (const float*)weight,
      (const float*)stats, (float*)out, n, n_feat, n_nodes, n_bins, s,
      feats_per_block, cells_per_slice, n_slices, rows_per_block);
  return (int)cudaGetLastError();
}
