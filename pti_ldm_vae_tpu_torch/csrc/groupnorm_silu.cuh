// Pieces shared by the GroupNorm+SiLU forward (groupnorm_silu_fwd.cu) and
// backward (groupnorm_silu_bwd.cu) thread-block-cluster kernels for Hopper
// (sm_90a).
//
// Work split (both kernels; the host's pure function gn_plan in
// ops/kernels/groupnorm_silu.py chooses every number and passes it in):
//
//   An NHWC tensor is [B, HW, C]. A *slice* is SC contiguous channels made of
//   whole groups (SC = k * C/G), so its statistics need nothing from other
//   slices. Each (image, slice) is one cluster of CS blocks; the cluster's
//   blocks split the image's HW rows, block rank r taking rows
//   [r * rows_per_block, (r + 1) * rows_per_block). A block's threads form
//   NV = SC / V columns (V channels each, one 16-byte vector: 8 bf16 or 4 f32,
//   or V = 1 for tensors not aligned to 16 bytes) and RIT = threads / NV rows
//   of threads; thread (tr, j) owns column j of local rows tr, tr + RIT, ...
//
//   The first `staged` local rows of a block are copied into shared memory
//   with cp.async (8 commit groups, so the sums start while later rows are
//   still in flight); every thread copies, waits for and reads back only its
//   own rows, so staging needs no block barrier. Rows past them are read from
//   global memory, and read again in the second pass (from L2, which the same
//   cluster has just filled). A thread loads a few rows (kUnrollFwd,
//   kUnrollBwd) before it uses the first, so that many loads are in flight at
//   once; rows are still used in order.
//
//   Per-channel f32 sums are folded in a fixed order: across the lanes of a
//   warp that share a column (butterfly shuffles), across the warps (rows of
//   a shared-memory table, summed in row order), across the cluster's blocks
//   through distributed shared memory (every block reads every rank's
//   partials, rank 0 first), then channels into groups. Every block of a
//   cluster therefore holds the same statistics bit for bit, and two runs give
//   the same bits: no float atomics anywhere.
//
// Shared memory per block (layout(); the host computes the same sum):
//   [staged rows of x][staged rows of g][pub 2*SC f32][gather CS*2*SC f32]
//   [red 2*P*SC f32][coef 2*SC f32], each region rounded up to 16 bytes,
//   with P = threads / 32 when NV divides 32 (one row per warp after the
//   shuffles), else RIT.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_mma.cuh"

namespace gn {

namespace cg = cooperative_groups;

// threads per block at most, and registers capped so that this many blocks
// fit on an SM: 64 a thread in the forward, 128 in the bf16 backward, which
// holds more per-channel constants, 85 in the f32 one (gn_plan's
// _blocks_per_sm repeats these numbers)
constexpr int kMaxThreads = 256;
constexpr int kMinBlocksFwd = 4;
template <int V>
constexpr int kMinBlocksBwd = V >= 8 ? 2 : 3;
constexpr int kChunks = 8;  // cp.async commit groups of the staged rows
// rows a thread loads before it uses the first (the backward loads two tensors)
constexpr int kUnrollFwd = 4;
constexpr int kUnrollBwd = 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// silu(n) and sigmoid(n) with the fast exponential and division (a few ulp
// of f32; inf from the exponential gives 0, as it should).
__device__ __forceinline__ float sigmoid(float n) { return __fdividef(1.f, 1.f + __expf(-n)); }
__device__ __forceinline__ float silu(float n) { return __fdividef(n, 1.f + __expf(-n)); }

// V elements of T: one 16-byte vector (V * sizeof(T) == 16) or one element
// (V == 1), loaded raw (Raw) and unpacked to f32 registers when used.
template <typename T, int V>
struct Vec {
  static_assert(V == 1 || V * sizeof(T) == 16, "a column is one element or one 16-byte vector");
  using Raw = typename std::conditional<V == 1, T, uint4>::type;
  __device__ __forceinline__ static Raw raw_global(const T* p) {
    if constexpr (V == 1) {
      return p[0];
    } else {
      return __ldg(reinterpret_cast<const uint4*>(p));
    }
  }
  __device__ __forceinline__ static Raw raw_shared(const T* p) {
    return *reinterpret_cast<const Raw*>(p);
  }
  __device__ __forceinline__ static void unpack(float (&out)[V], const Raw& raw) {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = to_f32(e[v]);
  }
  __device__ __forceinline__ static void store_global(T* p, const float (&in)[V]) {
    if constexpr (V == 1) {
      p[0] = from_f32<T>(in[0]);
    } else {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int v = 0; v < V; ++v) e[v] = from_f32<T>(in[v]);
      *reinterpret_cast<uint4*>(p) = raw;
    }
  }
};

// Byte offsets of the shared-memory regions (see the header comment).
struct Layout {
  size_t stage_x, stage_g, pub, gather, red, coef, total;
};

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

__host__ __device__ inline int partial_rows(int threads, int nv) {
  return (32 % nv == 0) ? threads / 32 : threads / nv;
}

__host__ __device__ inline Layout layout(int sc, int cs, int threads, int nv, int staged_x,
                                         int staged_g, int esize) {
  Layout l;
  size_t off = 0;
  l.stage_x = off;
  off += round16(static_cast<size_t>(staged_x) * sc * esize);
  l.stage_g = off;
  off += round16(static_cast<size_t>(staged_g) * sc * esize);
  l.pub = off;
  off += round16(2 * static_cast<size_t>(sc) * 4);
  l.gather = off;
  off += round16(static_cast<size_t>(cs) * 2 * sc * 4);
  l.red = off;
  off += round16(2 * static_cast<size_t>(partial_rows(threads, nv)) * sc * 4);
  l.coef = off;
  off += round16(2 * static_cast<size_t>(sc) * 4);
  l.total = off;
  return l;
}

// Where this block sits: image, slice, rank in its cluster, its rows.
struct Place {
  int b, slice, rank, row0, nrows;
};

__device__ __forceinline__ Place place(int hw, int c, int sc, int cs, int rows_per_block) {
  Place p;
  const int cluster_id = blockIdx.x / cs;
  const int ns = c / sc;
  p.b = cluster_id / ns;
  p.slice = cluster_id % ns;
  p.rank = static_cast<int>(cg::this_cluster().block_rank());
  p.row0 = p.rank * rows_per_block;
  p.nrows = max(0, min(rows_per_block, hw - p.row0));
  return p;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Calls use(k, load(k)) for k = k0 .. k1-1 in order, each group of U rows
// loaded before the first of them is used.
template <int U, typename Load, typename Use>
__device__ __forceinline__ void rows_in_groups(int k0, int k1, Load load, Use use) {
  int k = k0;
  for (; k + U <= k1; k += U) {
    decltype(load(k)) raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) raw[u] = load(k + u);
#pragma unroll
    for (int u = 0; u < U; ++u) use(k + u, raw[u]);
  }
  for (; k < k1; ++k) use(k, load(k));
}

// cp.async.wait_group takes an immediate: chunk q of kChunks waits until at
// most kChunks - 1 - q groups are pending.
__device__ __forceinline__ void wait_chunk(int q) {
  switch (q) {
    case 0: hopper::cp_async_wait<7>(); break;
    case 1: hopper::cp_async_wait<6>(); break;
    case 2: hopper::cp_async_wait<5>(); break;
    case 3: hopper::cp_async_wait<4>(); break;
    case 4: hopper::cp_async_wait<3>(); break;
    case 5: hopper::cp_async_wait<2>(); break;
    case 6: hopper::cp_async_wait<1>(); break;
    default: hopper::cp_async_wait<0>(); break;
  }
}
static_assert(kChunks == 8, "wait_chunk counts eight commit groups");

// Folds two per-channel quantities (a, b: this thread's partials of its V
// channels) over the whole cluster. On return tot[0 .. SC) holds the a-sums
// and tot[SC .. 2 SC) the b-sums of the cluster's slice, identical in every
// block. The caller must call cluster_wait() before the block exits: other
// blocks may still be reading this block's pub until then.
template <int V>
__device__ __forceinline__ float* cluster_fold(float (&a)[V], float (&b)[V], unsigned char* smem,
                                               const Layout& l, int sc, int cs, int nv) {
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int p_rows = partial_rows(threads, nv);
  float* red = reinterpret_cast<float*>(smem + l.red);
  float* pub = reinterpret_cast<float*>(smem + l.pub);
  float* gather = reinterpret_cast<float*>(smem + l.gather);
  const int j = tid % nv;

  int row = tid / nv;
  bool writer = true;
  if (32 % nv == 0) {  // the lanes of a warp that share column j: lane ^ (nv << k)
    for (int off = nv; off < 32; off <<= 1) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        a[v] += __shfl_xor_sync(0xffffffffu, a[v], off);
        b[v] += __shfl_xor_sync(0xffffffffu, b[v], off);
      }
    }
    row = tid / 32;
    writer = (tid % 32) < nv;
  }
  if (writer) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      red[row * sc + j * V + v] = a[v];
      red[(p_rows + row) * sc + j * V + v] = b[v];
    }
  }
  __syncthreads();
  for (int e = tid; e < 2 * sc; e += threads) {  // e < SC: a, else b
    const float* col = red + (e < sc ? e : p_rows * sc + (e - sc));
    float s = 0.f;
    for (int r = 0; r < p_rows; ++r) s += col[r * sc];
    pub[e] = s;
  }
  cluster_arrive();  // this block's partials are published ...
  cluster_wait();    // ... and so are everyone else's
  cg::cluster_group cluster = cg::this_cluster();
  for (int e = tid; e < cs * 2 * sc; e += threads) {
    const int r = e / (2 * sc);
    const float* remote = cluster.map_shared_rank(pub, r);
    gather[e] = remote[e - r * 2 * sc];
  }
  cluster_arrive();  // done reading other blocks' shared memory (waited for at exit)
  __syncthreads();
  for (int e = tid; e < 2 * sc; e += threads) {  // rank order, into gather's first row
    float s = 0.f;
    for (int r = 0; r < cs; ++r) s += gather[r * 2 * sc + e];
    gather[e] = s;
  }
  __syncthreads();
  return gather;
}


// ---- the split form (spatial sharding: statistics summed across shards) -----
//
// An image's rows may lie on several ranks (its height cut into tiles), so
// its group statistics are the sum of every rank's partial sums. The split
// form computes them in four launches around the caller's all-reduce: per
// (image, group) the local f32 sums of x and x^2 (forward, stats), then y
// from the given mean / inverse std (forward, apply); per (image, channel)
// the local sums of dn and dn * xhat (backward, reduce), then dx from the
// given all-reduced sums (backward, dx). Work split of all four: block
// (t, b) owns rows [t * rows_per_tile, (t + 1) * rows_per_tile) of image b
// and every channel; its threads form NV = C / V columns of V channels (one
// 16-byte vector, or V = 1 for tensors not aligned to 16 bytes) and RIT =
// threads / NV rows, thread (tr, j) taking column j of rows tr, tr + RIT, ...
// A thread's channels are fixed, so per-channel coefficients sit in its
// registers. The two reductions are two-stage and atomic-free: a block folds
// its threads' per-channel sums through shared memory in thread-row order
// into [B, T, 2, C] f32 partials; a second kernel sums those over the tiles
// in tile order (and, for the statistics, over the channels of a group).
namespace split {

struct Args {
  const void* x;
  const void* g;       // backward: the upstream gradient
  void* out;           // y or dx
  const float* scale;  // [C]
  const float* bias;
  const float* mean;   // [B, G]
  const float* inv;
  const float* r;      // dx: the all-reduced [B, 2, C] sums
  float* partial;      // reductions: [B, T, 2, C]
  int hw, c, cpg, tiles, rows_per_tile, nv;
  float count;         // dx: elements of a group over the whole image
};

// Per-channel constants of this thread's V channels of image b.
template <int V>
struct Coef {
  float mean[V], inv[V], gam[V], bet[V];
  __device__ __forceinline__ void load(const Args& a, int b, int ch0) {
    const int groups = a.c / a.cpg;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int grp = b * groups + (ch0 + v) / a.cpg;
      mean[v] = a.mean[grp];
      inv[v] = a.inv[grp];
      gam[v] = a.scale[ch0 + v];
      bet[v] = a.bias[ch0 + v];
    }
  }
};

// Block (blockIdx.x, blockIdx.y): its image, first row, row count and this
// thread's column / first row.
struct Tile {
  int b, row0, nrows, tr, j, rit;
};

__device__ __forceinline__ Tile tile(const Args& a) {
  Tile t;
  t.b = blockIdx.y;
  t.row0 = blockIdx.x * a.rows_per_tile;
  t.nrows = max(0, min(a.rows_per_tile, a.hw - t.row0));
  t.rit = blockDim.x / a.nv;
  t.tr = threadIdx.x / a.nv;
  t.j = threadIdx.x % a.nv;
  return t;
}

// Stage 1 of a reduction: Op::add(s1, s2, x, g, coef) per element of the
// block's rows; the block's per-channel sums to partial[b][t][0 / 1][c].
// Dynamic shared memory: 2 * threads * V floats.
template <typename T, int V, typename Op>
__global__ void __launch_bounds__(kMaxThreads) reduce_kernel(Args a) {
  using VT = Vec<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);  // [2][RIT][C]
  const Tile t = tile(a);
  const int ch0 = t.j * V;
  Coef<V> cf;
  if constexpr (Op::kNeedsCoef) cf.load(a, t.b, ch0);
  const int64_t base = (static_cast<int64_t>(t.b) * a.hw + t.row0) * a.c + ch0;
  const T* x = static_cast<const T*>(a.x) + base;
  const T* g = Op::kNeedsCoef ? static_cast<const T*>(a.g) + base : nullptr;
  float s1[V], s2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s1[v] = s2[v] = 0.f;
  if (t.tr < t.nrows) {
    for (int row = t.tr; row < t.nrows; row += t.rit) {
      const int64_t off = static_cast<int64_t>(row) * a.c;
      float xv[V], gv[V];
      VT::unpack(xv, VT::raw_global(x + off));
      if constexpr (Op::kNeedsCoef) VT::unpack(gv, VT::raw_global(g + off));
      Op::add(s1, s2, xv, gv, cf);
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    red[t.tr * a.c + ch0 + v] = s1[v];
    red[(t.rit + t.tr) * a.c + ch0 + v] = s2[v];
  }
  __syncthreads();
  float* out = a.partial + (static_cast<int64_t>(t.b) * a.tiles + blockIdx.x) * 2 * a.c;
  for (int e = threadIdx.x; e < 2 * a.c; e += blockDim.x) {  // e < C: s1, else s2
    const int which = e / a.c, ch = e - which * a.c;
    const float* col = red + which * t.rit * a.c + ch;
    float s = 0.f;
    for (int r = 0; r < t.rit; ++r) s += col[r * a.c];
    out[e] = s;
  }
}

// Stage 2: partial [B, T, 2, C] summed over the tiles in order; with
// fold_groups, also over each group's channels in order (channel outer, tile
// inner), out [B, G, 2]; else out [B, 2, C]. One thread per output.
static __global__ void fold_kernel(const float* partial, float* out, int b, int tiles, int c, int cpg,
                            int fold_groups) {
  const int n = fold_groups ? b * (c / cpg) * 2 : b * 2 * c;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  if (fold_groups) {
    const int which = e % 2, grp = (e / 2) % (c / cpg), img = e / (2 * (c / cpg));
    float s = 0.f;
    for (int k = 0; k < cpg; ++k) {
      const int ch = grp * cpg + k;
      for (int tt = 0; tt < tiles; ++tt)
        s += partial[((static_cast<int64_t>(img) * tiles + tt) * 2 + which) * c + ch];
    }
    out[e] = s;
  } else {
    const int ch = e % c, which = (e / c) % 2, img = e / (2 * c);
    float s = 0.f;
    for (int tt = 0; tt < tiles; ++tt)
      s += partial[((static_cast<int64_t>(img) * tiles + tt) * 2 + which) * c + ch];
    out[e] = s;
  }
}

// Launches stage 1 then stage 2 on one stream; cudaGetLastError() after each.
template <typename T, int V, typename Op>
cudaError_t reduce(const Args& a, int b, int threads, float* out, int fold_groups,
                   cudaStream_t stream) {
  const int smem = 2 * threads * V * static_cast<int>(sizeof(float));
  reduce_kernel<T, V, Op><<<dim3(a.tiles, b), threads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = fold_groups ? b * (a.c / a.cpg) * 2 : b * 2 * a.c;
  fold_kernel<<<(n + 255) / 256, 256, 0, stream>>>(a.partial, out, b, a.tiles, a.c, a.cpg,
                                                   fold_groups);
  return cudaGetLastError();
}

// Whether the host's cut agrees with the kernels' assumptions.
inline bool args_ok(int c, int cpg, int vec, int threads, int tiles, int rows_per_tile, int hw) {
  if (vec < 1 || c % vec || c % cpg || threads > kMaxThreads) return false;
  const int nv = c / vec;
  return nv <= threads && threads % nv == 0 && tiles >= 1 &&
         static_cast<int64_t>(tiles) * rows_per_tile >= hw;
}

}  // namespace split

}  // namespace gn
