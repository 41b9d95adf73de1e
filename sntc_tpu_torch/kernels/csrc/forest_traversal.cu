// forest_traversal: leaf statistics of every (tree, row) of a dense-heap
// forest — the serving walk of the random-forest / GBT / decision-tree heads.
//
// Replaces the Pallas kernel `_forest_kernel` behind
// `forest_leaf_stats_pallas` (sntc_tpu/kernels/forest.py).  That kernel
// kept one (tree, 128-row) tile in VMEM and turned every gather into an
// iota-mask select plus a one-hot MXU matmul, because the TPU has no fast
// gather.  A GPU gathers natively; per (tree, row) the function is
//
//     node = 0
//     repeat max_depth:
//         f = feature[t, node];  if f < 0: stop     (-1 leaf, -2 absent)
//         node = 2*node + 1 + (X[row, f] >= threshold[t, node])
//     out[t, row, :] = leaf_stats[t, node, :]
//
// The comparison is the same `>=` in the same type as the plain version,
// so a NaN feature value goes left, and the kernel only copies leaf
// values: the result is bitwise equal to the plain version.
//
// Bound on an H100: bytes.  The [T, N, S] output is nearly all of them
// (78.6 MB at T=20, N=65536, S=15 in f32: 23.5 us of the 26.8 us bound
// at 3.35 TB/s).  The first version of this kernel (one thread per
// (tree, row), grid (row blocks, T)) took 0.285 ms there, 10.6x its
// bound, because of how it touched memory, not how much: each thread
// stored its S stats with S scalar stores 4*S bytes apart across the
// warp (32 sectors per store instruction, 8x the sectors of the data),
// gathered its leaf the same way, read X one value per level from rows
// 4*F bytes apart (32 lines per warp load, again for each of the T tree
// blocks), and issued two dependent loads (feature, then X) per level.
// Here a block takes a tile of kThreads rows and a group of trees, and
// per tree stages the tree's top levels, walks each row (one a thread)
// and writes the run.
//
//  * Coalesced output: each thread leaves its row's leaf slot in shared
//    memory; the block then writes its tree's contiguous run of rows*S
//    values in order, 16 bytes a thread from the run's first 16-byte
//    boundary on (the run's start, (t*N + row0)*S values, is often not
//    on one), each value read from its row's leaf in the same order, so
//    the leaf reads come in runs of S consecutive values.
//  * X tile: where a block walks several trees, it copies its rows' X,
//    coalesced, once into shared memory with an odd row stride (f | 1
//    values), so the walks' gathers of one feature at different rows
//    fall in different banks; the tile serves every tree of the group.
//    With one tree a block (small batches), or a tile larger than
//    kXTileBytes (F above ~95 features in f32), the walk reads X through
//    the read-only path instead: a shape rule, decided at launch.
//  * Staged nodes: per tree, the block copies (feature, threshold) of
//    the top min(max_depth, kStageLevels) levels into shared memory as
//    one 8-byte pair (16 in f64): one shared load a level, then the X
//    load.  Deeper levels (the estimators' maxDepth goes to 15, and a
//    depth-15 tree's 32767 internal slots take 256 KB in pairs, more
//    than a block has) read feature and threshold through __ldg, both
//    issued before the X load.
//  * Trees per block: the grid is (row tiles, tree groups), with as few
//    groups as keep at least kMinBlocks blocks: at N=65536, 256 tiles x
//    2 groups of 10 trees (512 blocks, just under one wave of four ~51 KB
//    blocks on each of 132 SMs), so X leaves L2 twice, not 20 times; at
//    N=2048 or 512 one tree a block, as before, since fewer blocks than
//    SMs would leave the card idle.
//
// Measured (scripts/forest_traversal_variants.py, builds in turns on
// one NVIDIA H100 80GB HBM3, 700 W; f32, T=20, depth 10, S=15).  Device
// time a launch by CUDA events around 100 queued launches, the first
// version -> this one: 65536 rows 0.2853 -> 0.0620 ms (2.3x the bound),
// 49950 rows 0.2247 -> 0.0527, 2048 rows 0.0154 -> 0.0073, 512 rows
// 0.0090 -> 0.0065; a depth-15 forest 0.2615 -> 0.0881; f64 0.5785 ->
// 0.1255.  The design's steps at 65536 rows, by profiler windows:
// coalesced scalar stores alone 0.085, plus the X tile and tree groups
// 0.080, plus staged nodes 0.062, plus 16-byte stores 0.059.  The X
// tile alone, against X through __ldg with the groups kept (profiler
// windows): 0.0602-
// 0.0607 vs 0.0752-0.0794 at 65536 rows, 0.0511-0.0516 vs 0.0667-0.0679
// at 49950; but 0.0061 vs 0.0055 at 512 and 0.0070 vs 0.0063 at 2048
// rows, where one tree reads 10 of a row's 40 values and the tile loads
// all 40: hence no tile for one tree a block (0.0071 -> 0.0065 at 512
// rows, 0.0079 -> 0.0073 at 2048, by events).  kMinBlocks 132 (one
// group of 20 trees) took 0.093 and 528 took 0.074; 128 or 512 threads
// a block 0.094 or 0.076; staging 8 levels matched 10, 6 was slower
// (0.065).  Tried and dropped: 8 loads in flight per thread in the copy
// loops (0.077: registers at the cap), per-warp output runs with the
// next tree staged into a second buffer, one barrier a tree
// (0.071-0.097: occupancy).  What holds the rest is not measured; the
// suspects are the two barriers a tree, which stall a block's warps
// together, and L2 traffic beside the output (leaf reads as many bytes
// as the output, 42 MB of node staging).
//
// Offsets into the output and the leaves are 64-bit (T*N*S grows with
// the batch); node indices are 32-bit (the entry points refuse M above
// INT32_MAX).
//
// Plain C interface, bound with ctypes: each entry point launches on the
// given stream and returns cudaGetLastError() of the launch (or
// cudaErrorInvalidValue for a shape it cannot index).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // rows a block walks: one a thread
constexpr int64_t kXTileBytes = 96 * 1024;  // two such blocks fit an SM
constexpr int kStageLevels = 10;  // all of config 3's depth-10 walk
constexpr int64_t kMinBlocks = 2 * 132;  // two for each of 132 SMs

__host__ __device__ inline int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// One heap slot of a tree: 8 bytes in f32, 16 in f64, one shared load.
template <typename scalar_t>
struct __align__(2 * sizeof(scalar_t)) Node {
  int32_t feature;
  scalar_t threshold;
};

// Element e of a row-major [rows, width] run as (r, k), advanced by a
// fixed step without a division per element.
struct Flat {
  int r, k, dr, dk, width;
  __device__ Flat(int e, int step, int w)
      : r(e / w), k(e - (e / w) * w), dr(step / w), dk(step - (step / w) * w),
        width(w) {}
  __device__ void advance() {
    r += dr;
    k += dk;
    if (k >= width) {
      k -= width;
      ++r;
    }
  }
};

template <typename scalar_t>
struct Vec;  // one 16-byte store
template <>
struct Vec<float> {
  using type = float4;
};
template <>
struct Vec<double> {
  using type = double2;
};

template <typename scalar_t, bool kStagedX>
__global__ void __launch_bounds__(kThreads) forest_leaf_stats_kernel(
    const scalar_t* __restrict__ X,          // [N, F]
    const int32_t* __restrict__ feature,     // [T, M]
    const scalar_t* __restrict__ threshold,  // [T, M]
    const scalar_t* __restrict__ leaf,       // [T, M, S]
    scalar_t* __restrict__ out,              // [T, N, S]
    int64_t n, int64_t f, int64_t n_trees, int64_t m, int s, int max_depth,
    int64_t trees_per_block, int stage_levels, int ldx) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stage_nodes = (1 << stage_levels) - 1;
  Node<scalar_t>* nodes = reinterpret_cast<Node<scalar_t>*>(smem);
  int32_t* slot = reinterpret_cast<int32_t*>(nodes + stage_nodes);
  scalar_t* xtile = reinterpret_cast<scalar_t*>(slot + kThreads);

  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * kThreads;
  const int rows = (int)min64(kThreads, n - row0);
  const int64_t t_end = min64(n_trees, (blockIdx.y + 1) * trees_per_block);

  if (kStagedX && f > 0) {
    const scalar_t* src = X + row0 * f;
    Flat e(tid, kThreads, (int)f);
    for (int i = tid; i < rows * (int)f; i += kThreads, e.advance())
      xtile[e.r * ldx + e.k] = __ldg(src + i);
  }

  for (int64_t t = blockIdx.y * trees_per_block; t < t_end; ++t) {
    const int32_t* feat_t = feature + t * m;
    const scalar_t* thr_t = threshold + t * m;
    // the previous tree's walks and writes are done with nodes and slot
    __syncthreads();
    for (int i = tid; i < stage_nodes; i += kThreads)
      nodes[i] = Node<scalar_t>{__ldg(feat_t + i), __ldg(thr_t + i)};
    __syncthreads();

    if (tid < rows) {
      const scalar_t* x_row =
          kStagedX ? xtile + tid * ldx : X + (row0 + tid) * f;
      int node = 0;
      for (int d = 0; d < max_depth; ++d) {
        int32_t fi;
        scalar_t tv;
        if (d < stage_levels) {
          const Node<scalar_t> nd = nodes[node];
          fi = nd.feature;
          tv = nd.threshold;
        } else {
          fi = __ldg(feat_t + node);
          tv = __ldg(thr_t + node);
        }
        if (fi < 0) break;
        const scalar_t xv = kStagedX ? x_row[fi] : __ldg(x_row + fi);
        node = 2 * node + 1 + (xv >= tv ? 1 : 0);
      }
      slot[tid] = node;
    }
    __syncthreads();

    // out[t, row0 : row0 + rows, :], one contiguous run, in order
    scalar_t* dst = out + (t * n + row0) * s;
    const scalar_t* leaf_t = leaf + t * m * s;
    const int count = rows * s, width = s > 0 ? s : 1;
    auto value = [&](int r, int k) {
      return __ldg(leaf_t + (int64_t)slot[r] * s + k);
    };
    // 16-byte stores from the first 16-byte boundary on; scalars before
    // it and after the last whole vector
    constexpr int kVec = 16 / sizeof(scalar_t);
    int head = (int)((uintptr_t)dst / sizeof(scalar_t) % kVec);
    head = head ? kVec - head : 0;
    head = head < count ? head : count;
    const int vecs = (count - head) / kVec;
    using V = typename Vec<scalar_t>::type;
    V* vdst = reinterpret_cast<V*>(dst + head);
    Flat e(head + tid * kVec, kThreads * kVec, width);
    for (int v = tid; v < vecs; v += kThreads, e.advance()) {
      V val;
      scalar_t* lanes = reinterpret_cast<scalar_t*>(&val);
      int r = e.r, k = e.k;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        lanes[j] = value(r, k);
        if (++k == width) {
          k = 0;
          ++r;
        }
      }
      vdst[v] = val;
    }
    if (tid < head) dst[tid] = value(tid / width, tid % width);
    const int tail = head + vecs * kVec + tid;
    if (tid < kVec && tail < count)
      dst[tail] = value(tail / width, tail % width);
  }
}

template <typename scalar_t>
int launch(const void* X, const void* feature, const void* threshold,
           const void* leaf, void* out, int64_t n, int64_t f, int64_t t,
           int64_t m, int64_t s, int max_depth, void* stream) {
  if (m > INT32_MAX || s > INT32_MAX / kThreads || f > INT32_MAX / kThreads)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = (n + kThreads - 1) / kThreads;
  int64_t groups = min64(t, (kMinBlocks + tiles - 1) / tiles);
  const int64_t trees_per_block = (t + groups - 1) / groups;
  groups = (t + trees_per_block - 1) / trees_per_block;
  const int ldx = (int)(f | 1);
  // a tile pays off only when several trees read it
  const bool staged_x =
      trees_per_block > 1 &&
      (int64_t)kThreads * ldx * (int64_t)sizeof(scalar_t) <= kXTileBytes;
  // a negative max_depth walks no level, as in the plain version
  const int stage_levels =
      max_depth < 0 ? 0 : (max_depth < kStageLevels ? max_depth : kStageLevels);
  const size_t smem =
      (((size_t)1 << stage_levels) - 1) * sizeof(Node<scalar_t>) +
      kThreads * sizeof(int32_t) +
      (staged_x ? (size_t)kThreads * ldx * sizeof(scalar_t) : 0);
  auto kernel = staged_x ? forest_leaf_stats_kernel<scalar_t, true>
                         : forest_leaf_stats_kernel<scalar_t, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)tiles, (unsigned)groups);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const scalar_t*)X, (const int32_t*)feature, (const scalar_t*)threshold,
      (const scalar_t*)leaf, (scalar_t*)out, n, f, t, m, (int)s, max_depth,
      trees_per_block, stage_levels, ldx);
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
