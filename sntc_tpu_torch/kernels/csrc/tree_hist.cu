// tree_hist: one tree level's weighted sufficient statistics, for every
// tree of a forest in one launch — the histogram of the level-wise tree
// grower and of the chi-square contingency.
//
//     out[t, f, node[t, n] * B + bin[f, n], :] += stats[t, n, :] * w[t, n]
//
// over rows n with 0 <= node[t, n] < n_nodes, w[t, n] != 0 and
// 0 <= bin[f, n] < B (w = 1 when no weights are given).  The output is
// zeroed by the caller.  The stats are shared by every tree ([N, S], a
// tree stride of 0: the random forest's one-hot classes) or one row of
// stats per tree ([T, N, S], a tree stride of N * S: the one-vs-rest
// boosting fit, whose K class trees of a round each carry their class's
// signed residual stats [w, wr, wr^2]).
//
// Replaces the Pallas kernel `_hist_kernel` behind `level_histogram_pallas`
// (sntc_tpu/ops/pallas_histogram.py).  The TPU serialises scatter-adds, so
// that kernel recast the scatter as one-hot MXU matmuls over (8-feature,
// row-tile) blocks, one tree per call.  A GPU scatters natively, with
// atomics in shared memory or in L2.  One entry point, two regimes, chosen
// by shape (make_plan):
//
//   * shared (tree_hist_smem_kernel): a block owns (tree t, a run of whole
//     features, a chunk of rows).  It zeroes its features' histograms in
//     shared memory, walks its rows, adds each row's non-zero stats into
//     its features' cells with shared-memory atomics, then adds its
//     non-zero partial sums to device memory.  Row chunks fill the card.
//     What bounds it: every (tree, run of features) scans every row again
//     (node id, weight, stats), and skewed labels (80 % of CICIDS2017
//     flows are benign) pile its shared atomics onto few cells.  It wins
//     where it scans the rows few times: the chi-square contingency (1
//     tree, 78 features in 2 runs), a forest's first two levels (1 node:
//     all 40 features in one run, 20 scans) and GBT's one-tree levels.
//
//   * rows (tree_hist_rows_kernel): one thread per row.  It reads the
//     row's node ids and weights for up to kTreeChunk trees into
//     registers (coalesced across the warp) and, with shared stats, a
//     mask of its non-zero stats, then walks the features, kFeatBatch
//     bins loads in flight, and makes, for every tree whose node is in
//     range and whose weight is non-zero, one atomicAdd with its result
//     unused (red.global.add, resolved in L2) per non-zero stat.  With
//     per-tree stats the values and their zeros differ from tree to
//     tree, so each tree's stats row is read (through L1) and tested
//     for zeros per tree, not masked once per row.  Each warp starts at its own
//     feature, so the reductions in flight spread over every feature's
//     histograms instead of piling onto the hot node's cells of one.
//     Each input is read once per pass of kTreeChunk trees (T=20 takes
//     two passes of 10).  What bounds it: L2's reduction rate on the hot
//     nodes' lines (~61 M reductions at config 3's level 8) and, where
//     nodes are uniform, the output's sectors moving between L2 and
//     device memory (196 MB at the widest group: more than L2 holds).
//     It takes the deep levels, whose cells do not fit (128 nodes × 32
//     bins × 15 stats is 245 KB a feature), and every launch that would
//     scan the rows more than kMaxSmemScans times.
//
// Where the switch sits, and the times that set it: kMaxSmemScans.
//
// Rows with node -1 or weight 0 (~37 % under Poisson(1) bagging) are
// skipped, and so are adds of exact zeros (14 of 15 one-hot class stats;
// boosting's dense signed stats have almost none): neither changes the
// sum.  The regime switch was timed on shared stats; per-tree stats take
// the same plan (sntc_tree_hist_plan reports it).  Sums are taken in a run-to-run varying order.
// With integer-valued weights and stats (bagging counts, one-hot classes)
// every cell is a small-integer f32 sum below 2^24, exact in any order, so
// both regimes are bitwise equal to the plain version and to themselves
// run twice; with fractional weights they agree to f32 rounding (each
// cell within 1e-5 of its sum of absolute contributions), and the last
// bits may differ between runs.
//
// Offsets into the output are 64-bit: T·F·n_nodes·B·S reaches 98 M
// elements at config 3's level 9 and more with GBT's 128 bins.
//
// Plain C interface, bound with ctypes: the entry point launches on the
// given stream and returns the first CUDA error of the launch (0 if none);
// sntc_tree_hist_plan reports the plan the entry point takes for a shape.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// shared regime
constexpr int kThreads = 512;
constexpr int kSmemBytes = 96 * 1024;  // two blocks fit an SM's 227 KB
constexpr int64_t kSmemFloats = kSmemBytes / 4;
constexpr int64_t kMinRowsPerBlock = 2048;
constexpr int kBlocksPerSm = 4;  // row chunks aim at this many blocks/SM
// The regime switch.  The shared regime scans every row (node id, weight,
// stats) once per (tree, run of whole features a block holds); it is
// taken where those scans number at most kMaxSmemScans, the rows regime
// elsewhere.  Shared vs rows, ms, by scans, timed by
// scripts/tree_hist_crossover.py on an NVIDIA H100 80GB HBM3 at 700 W on
// config 3's fit (T=20, 40 features, B=32, S=15; the contingency: T=1,
// 78 features) and GBT's one-tree shape (78 features, B=128, S=3):
//    2 contingency 0.152 / 0.287     2 GBT, 1 node    0.293 / 1.026
//   20 level 0     0.884 / 1.282    20 GBT, 16 nodes  0.374 / 0.596
//   20 level 1     0.665 / 0.679    39 GBT, 32 nodes  0.439 / 0.599
//   40 level 2     0.537 / 0.394    78 GBT, 64 nodes  0.561 / 0.566
//   80 level 3     0.734 / 0.554   800 level 6        3.106 / 0.748
// Up to 39 scans the shared regime measured faster (by 0.014 ms or more);
// from 40 on it measured slower, or level within 1 % (GBT at 64 nodes).
constexpr int64_t kMaxSmemScans = 39;

// rows regime
constexpr int kRowThreads = 256;
constexpr int kTreeChunk = 16;  // trees a thread holds in registers
// both regimes
constexpr int kFeatBatch = 8;  // bins loads a thread keeps in flight

constexpr int kShared = 0, kRows = 1;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// bit k set where st[k0 + k] != 0, over k0 <= k0 + k < min(s, k0 + 32)
__device__ __forceinline__ uint32_t nonzero_stats(const float* st, int64_t k0,
                                                  int64_t s) {
  const int kn = (int)min64(32, s - k0);
  uint32_t nz = 0;
  for (int k = 0; k < kn; ++k)
    if (st[k0 + k] != 0.f) nz |= 1u << k;
  return nz;
}

__global__ void __launch_bounds__(kThreads) tree_hist_smem_kernel(
    const int32_t* __restrict__ bins,    // [F, N]
    const int32_t* __restrict__ node,    // [T, N], -1 = inactive
    const float* __restrict__ weight,    // [T, N] or nullptr (all 1)
    const float* __restrict__ stats,     // [N, S] or [T, N, S]
    float* __restrict__ out,             // [T, F, n_nodes * B, S], zeroed
    int64_t n, int64_t n_feat, int64_t n_nodes, int64_t n_bins, int64_t s,
    int64_t stats_tree_stride, int64_t feats_per_block,
    int64_t rows_per_block) {
  extern __shared__ float hist[];  // [feats_per_block, n_nodes * B, S]
  const int64_t width = n_nodes * n_bins * s;  // floats per feature
  const int64_t f0 = (int64_t)blockIdx.y * feats_per_block;
  const int64_t nf = min64(feats_per_block, n_feat - f0);
  const int64_t t = blockIdx.z;

  for (int64_t i = threadIdx.x; i < nf * width; i += blockDim.x) hist[i] = 0.f;
  __syncthreads();

  const int64_t row0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t row1 = min64(n, row0 + rows_per_block);
  const int32_t* node_t = node + t * n;
  const float* w_t = weight == nullptr ? nullptr : weight + t * n;
  const float* stats_t = stats + t * stats_tree_stride;  // the block's tree
  for (int64_t r = row0 + threadIdx.x; r < row1; r += blockDim.x) {
    const int64_t nd = node_t[r];
    if (nd < 0 || nd >= n_nodes) continue;
    const float w = w_t == nullptr ? 1.f : w_t[r];
    if (w == 0.f) continue;
    const float* st = stats_t + r * s;
    for (int64_t k0 = 0; k0 < s; k0 += 32) {
      const uint32_t nz = nonzero_stats(st, k0, s);
      if (nz == 0) continue;
      for (int64_t j0 = 0; j0 < nf; j0 += kFeatBatch) {
        // the bins of kFeatBatch features in flight at once
        int32_t bb[kFeatBatch];
#pragma unroll
        for (int i = 0; i < kFeatBatch; ++i)
          bb[i] = j0 + i < nf ? bins[(f0 + j0 + i) * n + r] : -1;
#pragma unroll
        for (int i = 0; i < kFeatBatch; ++i) {
          const int64_t b = bb[i];
          if (b < 0 || b >= n_bins) continue;
          float* h = hist + (j0 + i) * width + (nd * n_bins + b) * s + k0;
          for (uint32_t m = nz; m != 0; m &= m - 1) {
            const int k = __ffs(m) - 1;
            atomicAdd(h + k, st[k0 + k] * w);
          }
        }
      }
    }
  }
  __syncthreads();

  float* out_t = out + (t * n_feat + f0) * width;
  for (int64_t i = threadIdx.x; i < nf * width; i += blockDim.x) {
    const float v = hist[i];
    if (v != 0.f) atomicAdd(out_t + i, v);
  }
}

// kPerTree: stats [T, N, S] at stats_tree_stride = N * S per tree;
// otherwise stats [N, S] shared by every tree (stride 0)
template <bool kPerTree>
__global__ void __launch_bounds__(kRowThreads) tree_hist_rows_kernel(
    const int32_t* __restrict__ bins,    // [F, N]
    const int32_t* __restrict__ node,    // [T, N], -1 = inactive
    const float* __restrict__ weight,    // [T, N] or nullptr (all 1)
    const float* __restrict__ stats,     // [N, S] or [T, N, S]
    float* __restrict__ out,             // [T, F, n_nodes * B, S], zeroed
    int64_t n, int64_t n_feat, int64_t n_trees, int64_t n_nodes,
    int64_t n_bins, int64_t s, int64_t stats_tree_stride,
    int64_t trees_per_pass) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int64_t t0 = (int64_t)blockIdx.y * trees_per_pass;
  const int64_t t1 = min64(n_trees, t0 + trees_per_pass);
  const int64_t feat_floats = n_nodes * n_bins * s;
  const int64_t tree_floats = n_feat * feat_floats;

  // per tree of the chunk: the offset of the row's node in the chunk's
  // histograms of feature 0 (-1: the row does not count for the tree)
  // and the row's weight
  int64_t off[kTreeChunk];
  float w[kTreeChunk];
  bool any = false;
#pragma unroll
  for (int j = 0; j < kTreeChunk; ++j) {
    off[j] = -1;
    w[j] = 0.f;
    if (t0 + j < t1) {
      const int64_t nd = node[(t0 + j) * n + r];
      if (nd >= 0 && nd < n_nodes) {
        const float wj = weight == nullptr ? 1.f : weight[(t0 + j) * n + r];
        if (wj != 0.f) {
          off[j] = j * tree_floats + nd * n_bins * s;
          w[j] = wj;
          any = true;
        }
      }
    }
  }
  if (!any) return;

  float* out_c = out + t0 * tree_floats;
  // each warp walks the features from its own start, so that the warps
  // in flight spread their reductions over every feature's histograms
  const int64_t rot = (r >> 5) % n_feat;
  if (kPerTree) {
    // the row's stats of tree t0 + j: stats[t0 + j, r, :]
    const float* st0 = stats + t0 * stats_tree_stride + r * s;
    for (int64_t i0 = 0; i0 < n_feat; i0 += kFeatBatch) {
      int32_t bb[kFeatBatch];
#pragma unroll
      for (int i = 0; i < kFeatBatch; ++i) {
        int64_t f = rot + i0 + i;
        if (f >= n_feat) f -= n_feat;
        bb[i] = i0 + i < n_feat ? bins[f * n + r] : -1;
      }
#pragma unroll
      for (int i = 0; i < kFeatBatch; ++i) {
        const int64_t b = bb[i];
        if (b < 0 || b >= n_bins) continue;
        int64_t f = rot + i0 + i;
        if (f >= n_feat) f -= n_feat;
        float* of = out_c + f * feat_floats + b * s;
#pragma unroll
        for (int j = 0; j < kTreeChunk; ++j) {
          if (off[j] < 0) continue;
          const float* st = st0 + j * stats_tree_stride;
          for (int64_t k = 0; k < s; ++k) {
            const float v = st[k];
            if (v != 0.f) atomicAdd(of + off[j] + k, v * w[j]);
          }
        }
      }
    }
    return;
  }
  const float* st = stats + r * s;
  for (int64_t k0 = 0; k0 < s; k0 += 32) {
    const uint32_t nz = nonzero_stats(st, k0, s);
    if (nz == 0) continue;
    for (int64_t i0 = 0; i0 < n_feat; i0 += kFeatBatch) {
      // the bins of kFeatBatch features in flight at once
      int32_t bb[kFeatBatch];
#pragma unroll
      for (int i = 0; i < kFeatBatch; ++i) {
        int64_t f = rot + i0 + i;
        if (f >= n_feat) f -= n_feat;
        bb[i] = i0 + i < n_feat ? bins[f * n + r] : -1;
      }
#pragma unroll
      for (int i = 0; i < kFeatBatch; ++i) {
        const int64_t b = bb[i];
        if (b < 0 || b >= n_bins) continue;
        int64_t f = rot + i0 + i;
        if (f >= n_feat) f -= n_feat;
        float* of = out_c + f * feat_floats + b * s + k0;
        for (uint32_t m = nz; m != 0; m &= m - 1) {
          const int k = __ffs(m) - 1;
          const float v = st[k0 + k];
#pragma unroll
          for (int j = 0; j < kTreeChunk; ++j)
            if (off[j] >= 0) atomicAdd(of + off[j] + k, v * w[j]);
        }
      }
    }
  }
}

// How a launch covers its work, computed by one function for the launch
// and for sntc_tree_hist_plan, which reports it.
struct Plan {
  int64_t regime;           // kShared or kRows
  int64_t feats_per_block;  // shared: whole features a block holds
  int64_t trees_per_pass;   // rows: trees a thread covers (one grid row)
  int64_t row_blocks;       // shared: row chunks; rows: blocks of rows
  int64_t grid_blocks;      // blocks launched
  int64_t rows_per_block, grid_y, smem_bytes;
};

int make_plan(int64_t n, int64_t n_feat, int64_t n_trees, int64_t n_nodes,
              int64_t n_bins, int64_t s, Plan* p) {
  const int64_t feat_floats = n_nodes * n_bins * s;
  const int64_t fit = kSmemFloats / feat_floats;  // whole features a block holds
  const int64_t n_fblocks = fit < 1 ? 0 : (n_feat + fit - 1) / fit;
  if (fit < 1 || n_trees * n_fblocks > kMaxSmemScans) {
    // passes of at most kTreeChunk trees, as even as they come
    const int64_t passes = (n_trees + kTreeChunk - 1) / kTreeChunk;
    p->regime = kRows;
    p->feats_per_block = 0;
    p->trees_per_pass = (n_trees + passes - 1) / passes;
    p->rows_per_block = kRowThreads;
    p->row_blocks = (n + kRowThreads - 1) / kRowThreads;
    p->grid_y = (n_trees + p->trees_per_pass - 1) / p->trees_per_pass;
    p->smem_bytes = 0;
    if (p->grid_y > 65535 || p->row_blocks > INT32_MAX)
      return (int)cudaErrorInvalidConfiguration;
    p->grid_blocks = p->row_blocks * p->grid_y;
    return 0;
  }
  // whole features per block, as many as fit, spread evenly
  p->regime = kShared;
  p->trees_per_pass = 1;
  p->feats_per_block = (n_feat + n_fblocks - 1) / n_fblocks;
  p->grid_y = n_fblocks;
  p->smem_bytes = p->feats_per_block * feat_floats * 4;
  if (p->grid_y > 65535 || n_trees > 65535)
    return (int)cudaErrorInvalidConfiguration;

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;

  // cut the rows into chunks until the grid has ~kBlocksPerSm blocks per
  // SM, but no chunk below kMinRowsPerBlock rows
  const int64_t combos = n_trees * p->grid_y;
  const int64_t want = ((int64_t)kBlocksPerSm * sms + combos - 1) / combos;
  const int64_t most = (n + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  int64_t row_blocks = want < most ? want : most;
  if (row_blocks < 1) row_blocks = 1;
  p->rows_per_block = (n + row_blocks - 1) / row_blocks;
  p->row_blocks = (n + p->rows_per_block - 1) / p->rows_per_block;
  p->grid_blocks = p->row_blocks * combos;
  return 0;
}

}  // namespace

extern "C" int sntc_tree_hist_plan(int64_t n, int64_t n_feat, int64_t n_trees,
                                   int64_t n_nodes, int64_t n_bins, int64_t s,
                                   int64_t* out) {
  Plan p;
  const int err = make_plan(n, n_feat, n_trees, n_nodes, n_bins, s, &p);
  if (err != 0) return err;
  out[0] = p.regime;
  out[1] = p.feats_per_block;
  out[2] = p.trees_per_pass;
  out[3] = p.row_blocks;
  out[4] = p.grid_blocks;
  return 0;
}

// stats_tree_stride: 0 for stats [N, S] shared by every tree, N * S for
// stats [T, N, S], one row of stats per tree
extern "C" int sntc_tree_hist_f32(
    const void* bins, const void* node, const void* weight, const void* stats,
    void* out, int64_t n, int64_t n_feat, int64_t n_trees, int64_t n_nodes,
    int64_t n_bins, int64_t s, int64_t stats_tree_stride, void* stream) {
  if (stats_tree_stride != 0 && stats_tree_stride != n * s)
    return (int)cudaErrorInvalidValue;
  Plan p;
  const int perr = make_plan(n, n_feat, n_trees, n_nodes, n_bins, s, &p);
  if (perr != 0) return perr;
  const cudaStream_t st = (cudaStream_t)stream;
  if (p.regime == kRows) {
    const dim3 grid((unsigned)p.row_blocks, (unsigned)p.grid_y);
    if (stats_tree_stride != 0)
      tree_hist_rows_kernel<true><<<grid, kRowThreads, 0, st>>>(
          (const int32_t*)bins, (const int32_t*)node, (const float*)weight,
          (const float*)stats, (float*)out, n, n_feat, n_trees, n_nodes,
          n_bins, s, stats_tree_stride, p.trees_per_pass);
    else
      tree_hist_rows_kernel<false><<<grid, kRowThreads, 0, st>>>(
          (const int32_t*)bins, (const int32_t*)node, (const float*)weight,
          (const float*)stats, (float*)out, n, n_feat, n_trees, n_nodes,
          n_bins, s, 0, p.trees_per_pass);
    return (int)cudaGetLastError();
  }
  const cudaError_t err = cudaFuncSetAttribute(
      tree_hist_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)p.row_blocks, (unsigned)p.grid_y,
                  (unsigned)n_trees);
  tree_hist_smem_kernel<<<grid, kThreads, (size_t)p.smem_bytes, st>>>(
      (const int32_t*)bins, (const int32_t*)node, (const float*)weight,
      (const float*)stats, (float*)out, n, n_feat, n_nodes, n_bins, s,
      stats_tree_stride, p.feats_per_block, p.rows_per_block);
  return (int)cudaGetLastError();
}
