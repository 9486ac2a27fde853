// Flash-attention backward for Hopper (sm_90a), bf16, head dims above 128 (any
// multiple of 64), every product on the tensor cores (wgmma).
//
// Replaces the TPU kernel pti_ldm_vae_tpu/ops/pallas/flash_attention.py
// (_bwd_pallas, body _bwd_kernel) for bf16 inputs of a wide head: with s = q
// k^T * d^-0.5 and p = softmax(s),
//   dv = p^T g,  dp = g v^T,  ds = p * (dp - rowsum(dp * p)),
//   dq = ds k * d^-0.5,  dk = ds^T q * d^-0.5
// over [B, H, S, D] tensors. p is recomputed from the f32 row logsumexp the
// forward wrote; rowsum(dp * p) is delta = rowsum(dO * O), from a pre-pass.
// Like the TPU kernel and flash_attention_bwd_wgmma.cu (D <= 128), p and ds
// are rounded to bf16 before the products they feed; p, ds, delta and every
// sum are f32 until then. f32 inputs stay on the f32-FMA kernels of
// flash_attention_bwd.cu; the wrapper copies an unaligned bf16 view first.
//
// Bound on an H100: five [S, S] x [S, D] products of 2*S^2*D operations per
// (b, h): 343.6 GFLOP at config/ar_vae_dente_kl1e3.json's [8, 1, 4096, 256],
// the tensor cores' 989 TFLOP/s, 0.347 ms. What kept wide heads off the
// tensor cores: flash_attention_bwd_wgmma.cu holds dK and dV of a 64-row kv
// tile, 2 x D/2 f32 registers a thread (256 at D = 256), and stages whole-D
// tiles (over a block's 232,448 bytes of shared memory from D = 256 on).
//
// Design. One launch of flash_bwd_delta_kernel (one warp per row), then one
// launch of flash_bwd_wide_kernel, whose grid holds two roles, each cut into
// slices of 256 output columns (four units of 64; fewer in the last slice of
// a head dim that is not a multiple of 256):
// - dk/dv blocks own 64 kv rows and a slice of dK and dV and walk the q
//   tiles. Warpgroup 0 computes S^T = K Q^T, turns it into P^T = exp(S^T *
//   scale - lse) and accumulates dV += P^T dO (its 128-register slice
//   accumulator); warpgroup 1 computes dP^T = V dO^T, takes P^T from
//   warpgroup 0 through shared memory (f32, 16 KB, after a named barrier:
//   bar.sync 1, 256), forms dS^T = P^T o (dP^T - delta) and accumulates dK +=
//   dS^T Q. The fragment of a 64 x 64 accumulator is, thread by thread, the A
//   operand of the next product (hopper_mma.cuh), so neither P^T nor dS^T is
//   transposed.
// - dq blocks own 64 q rows and a slice of dQ and walk the kv tiles.
//   Warpgroup 0 computes S = Q K^T and P, warpgroup 1 dP = dO V^T and, with P
//   from warpgroup 0 (barrier 1), dS, which it hands back as bf16 A fragments
//   (8 KB, barrier 2); then each warpgroup accumulates half of the slice, dQ
//   += dS K (64 registers).
//   Per (kv tile, q tile) pair that is 4 * D/256 + 3 [64 x 64 x 256]
//   products (7 at D = 256, 11 at D = 512) against the 5 * D/256 the bound
//   counts: S and dP are computed in both roles and, past D = 256, once per
//   slice.
// - Depth chunks: the first products sum over chunks of 64 columns. Every
//   streamed item is one chunk of the tile's two B operands (q and dO, or k
//   and v: 64 rows x 64 columns of bf16 each, 8,320 bytes as [8 planes][64
//   rows][16 bytes], planes padded by 16 bytes) and, past D = 256, of the
//   block's own two A operands; up to D = 256 those (k and v, or q and dO)
//   stay in shared memory whole. The slice's own chunks come last in a tile,
//   and their ring slots are kept until the tile's second products, which
//   read them as MN-major B operands (dO and q for dV and dK, k for dQ): the
//   ring has 8 (6 past D = 256) stages, staged 4 (2) items ahead. A dk/dv
//   item that ends a tile also carries the tile's lse and delta (512 bytes).
// Each sum runs inside one warpgroup in tile order: no float atomics, and two
// runs give the same bits. The dK and dV sums run over all S q rows (4096 at
// kl1e3's shape) inside wgmma's f32 accumulators.
//
// Shared memory: 228,352 bytes at D = 256 (the whole k, v or q, dO tiles,
// the 24 KB exchange, 8 slots of 17,152 bytes), 227,328 bytes past it (the
// exchange and 6 slots of 33,792 bytes) at any head dim.
//
// C interface (loaded with ctypes): flash_attention_bwd_wide_wgmma returns the
// first error of its two launches (cudaGetLastError() after each); any other
// value than 0 is a failure. flash_attention_bwd_wide_wgmma_occupancy reports
// the shared memory per block and resident blocks per SM at a head dim
// (ops/kernels/flash_attention.py: wide_bwd_smem_bytes is the same formula).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int kRows = 64;                        // rows of every tile and of a block's role
constexpr int kThreads = 256;                    // two warpgroups
constexpr int kUnit = 64;                        // columns of a depth chunk and of an output unit
constexpr int kUnits = 4;                        // output units of a slice
constexpr int kSlice = kUnit * kUnits;
constexpr int kPlane = 64 * 16 + 16;             // bytes of one 8-column plane of a 64-row tile, padded
constexpr int kChunkBytes = kUnit / 8 * kPlane;  // one 64 x 64 bf16 tile: 8,320 bytes
constexpr int kStatBytes = 2 * kRows * 4;        // lse and delta of 64 rows
constexpr int kKeep = kUnits;                    // ring slots kept for a tile's second products
constexpr int kResidentMaxD = 256;               // the A operands stay whole up to this head dim
constexpr int kExchangeP = 128 * 32 * 4;         // P or P^T, f32, 32 a thread of a warpgroup
constexpr int kExchangeBytes = kExchangeP + 128 * 16 * 4;  // and dS as 16 bf16 pairs a thread
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int stages(bool resident) { return resident ? 8 : 6; }
__host__ __device__ constexpr int slot_bytes(bool resident) {
  return (resident ? 2 : 4) * kChunkBytes + kStatBytes;  // B1, B2 chunks (+ A1, A2 chunks), stats
}
__host__ __device__ inline int resident_bytes(int d) {
  return d <= kResidentMaxD ? 2 * (d / 8) * kPlane : 0;
}
__host__ __device__ inline int smem_bytes(int d) {
  const bool resident = d <= kResidentMaxD;
  return resident_bytes(d) + kExchangeBytes + stages(resident) * slot_bytes(resident);
}

// Rows row0 .. row0+63, columns col0 .. col0+8*planes-1 of a [s, d] row-major matrix into a
// plane-major tile; rows past s are zero-filled.
__device__ __forceinline__ void stage_tile(uint32_t dst, const __nv_bfloat16* __restrict__ src,
                                           int row0, int col0, int planes, int s, int d, int tid) {
  for (int i = tid; i < kRows * planes; i += kThreads) {
    const int piece = i % planes, r = i / planes;
    const bool live = row0 + r < s;
    const __nv_bfloat16* from =
        live ? src + static_cast<size_t>(row0 + r) * d + col0 + 8 * piece : src;
    cp_async_16(dst + piece * kPlane + r * 16, from, live);
  }
}

// lse and delta of rows row0 .. row0+63 (zero past s): [64 lse][64 delta] f32.
__device__ __forceinline__ void stage_stats(uint32_t dst, const float* __restrict__ lse,
                                            const float* __restrict__ delta, int row0, int s,
                                            int tid) {
  if (tid >= 2 * kRows) return;
  const int r = tid % kRows;
  const float* src = tid < kRows ? lse : delta;
  const bool live = row0 + r < s;
  cp_async_4(dst + tid * 4, live ? src + row0 + r : src, live);
}

__device__ __forceinline__ void named_barrier(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}

__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ dout,
                       float* __restrict__ delta, int rows, int d) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32;  // one warp per row
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * d;
  float acc = 0.f;
  for (int c = 2 * lane; c < d; c += 64) {
    const float2 o = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(out + base + c));
    const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + base + c));
    acc = fmaf(o.x, g.x, fmaf(o.y, g.y, acc));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// A fragment (k16 step ks, register r) of a 64 x 64 accumulator, rounded to bf16.
__device__ __forceinline__ void to_fragments(const float (&c)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[ks][r] = pack_bf16(c[8 * ks + 2 * r], c[8 * ks + 2 * r + 1]);
}

// acc += a (64 x 64, A fragments) * the 64-row x 64-column tile at b, read MN-major
// (depth = the tile's rows, columns = its 64 columns).
__device__ __forceinline__ void product_into(float (&acc)[32], const uint32_t (&a)[4][4], uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) WgmmaRS<64>::run(acc, a[ks], make_desc(b + ks * 256, 128, kPlane), 1);
}

// Stores one 64 x 64 unit of an accumulator (times mul) as bf16 rows row0 + 16w + l/4 (+ 8)
// below s, columns col .. col+63.
__device__ __forceinline__ void store_unit(__nv_bfloat16* __restrict__ dst, const float (&acc)[32],
                                           int row0, int col, int s, int d, float mul, int lane,
                                           int warp) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + 16 * warp + 8 * hf + lane / 4;
    if (row >= s) continue;
    __nv_bfloat16* at = dst + static_cast<size_t>(row) * d + col + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(at + 8 * j) =
          pack_bf16(acc[4 * j + 2 * hf] * mul, acc[4 * j + 2 * hf + 1] * mul);
  }
}

template <bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_wide_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int s, int d, int n_slices, float scale,
                      float scale_log2e) {
  constexpr int kStages = stages(kResident);
  constexpr int kSlot = slot_bytes(kResident);
  constexpr int kAhead = kStages - kKeep;  // items staged ahead of the one computed
  constexpr int kStatAt = (kResident ? 2 : 4) * kChunkBytes;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = (tid / 32) % 4, wg = tid / 128, wt = tid % 128;
  const int n_tiles = (s + kRows - 1) / kRows;
  const int role_blocks = n_tiles * n_slices;
  const bool dkdv = static_cast<int>(blockIdx.x) < role_blocks;
  const int x = dkdv ? static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x) - role_blocks;
  const int r0 = x / n_slices * kRows;  // the block's own rows: kv rows (dk/dv) or q rows (dq)
  const int slice = x % n_slices;
  const int col0 = slice * kSlice;
  const int units = min(kUnits, (d - col0) / kUnit);
  const int chunks = d / kUnit;
  const int rest = chunks - units;  // chunks outside the slice, streamed first in a tile
  const int n_items = n_tiles * chunks;
  const size_t head = static_cast<size_t>(blockIdx.y) * s * d;
  const float* lse_b = lse + static_cast<size_t>(blockIdx.y) * s;
  const float* delta_b = delta + static_cast<size_t>(blockIdx.y) * s;
  // A1, A2: the block's own rows (the A operands of S / S^T and dP / dP^T); B1, B2: the tile's
  const __nv_bfloat16* a1 = (dkdv ? k : q) + head;
  const __nv_bfloat16* a2 = (dkdv ? v : dout) + head;
  const __nv_bfloat16* b1 = (dkdv ? q : k) + head;
  const __nv_bfloat16* b2 = (dkdv ? dout : v) + head;

  const uint32_t base = smem_addr(smem);
  const int res_bytes = resident_bytes(d);
  float* const x_p = reinterpret_cast<float*>(smem + res_bytes);  // [32][128]: P (dq) or P^T
  uint32_t* const x_ds = reinterpret_cast<uint32_t*>(smem + res_bytes + kExchangeP);  // [16][128]
  const uint32_t ring = base + res_bytes + kExchangeBytes;

  // the depth chunk of a tile's j-th item: the chunks outside the slice, then its units in order
  auto chunk_of = [&](int j) {
    return j < rest ? (j < col0 / kUnit ? j : j + units) : col0 / kUnit + (j - rest);
  };
  auto slot_of = [&](int i) { return ring + (i % kStages) * kSlot; };
  // item i into its ring slot; one commit group per call, empty past the last item
  auto stage = [&](int i) {
    if (i < n_items) {
      const int t = i / chunks, j = i % chunks, c = chunk_of(j) * kUnit;
      const uint32_t slot = slot_of(i);
      stage_tile(slot, b1, t * kRows, c, kUnit / 8, s, d, tid);
      stage_tile(slot + kChunkBytes, b2, t * kRows, c, kUnit / 8, s, d, tid);
      if (!kResident) {
        stage_tile(slot + 2 * kChunkBytes, a1, r0, c, kUnit / 8, s, d, tid);
        stage_tile(slot + 3 * kChunkBytes, a2, r0, c, kUnit / 8, s, d, tid);
      }
      if (dkdv && j == chunks - 1) stage_stats(slot + kStatAt, lse_b, delta_b, t * kRows, s, tid);
    }
    cp_async_commit();
  };
  if (kResident) {  // the block's A1 and A2 tiles, whole, in the first group
    stage_tile(base, a1, r0, 0, d / 8, s, d, tid);
    stage_tile(base + d / 8 * kPlane, a2, r0, 0, d / 8, s, d, tid);
  }
  for (int i = 0; i < kAhead; ++i) stage(i);

  // dq role: lse (log2 units) and delta of this thread's two rows r0 + 16w + l/4 (+ 8)
  float row_lse[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};
  if (!dkdv) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + 16 * warp + 8 * hf + lane / 4;
      if (row < s) {
        row_lse[hf] = lse_b[row] * kLog2e;
        row_delta[hf] = delta_b[row];
      }
    }
  }

  // dk/dv: warpgroup 0 the dV slice, 1 the dK slice (4 units); dq: units 2*wg, 2*wg + 1
  float acc[kUnits][32];
#pragma unroll
  for (int u = 0; u < kUnits; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[u][i] = 0.f;
  float c_acc[32];  // warpgroup 0: S^T (dk/dv) or S (dq); warpgroup 1: dP^T or dP
  uint32_t frag[4][4];
  const uint32_t a_res = base + wg * (d / 8) * kPlane;

  int t = 0, j = 0;
  for (int i = 0; i < n_items; ++i) {
    cp_async_wait<kAhead - 1>();  // all groups but the newest kAhead-1: item i has landed
    fence_proxy_async();
    __syncthreads();  // item i is in for every thread; item i-1's computation is done
    stage(i + kAhead);  // into the slot of item i - kKeep, whose last reader was item i-1
    const uint32_t slot = slot_of(i);
    const int c = chunk_of(j);

    // first products over this depth chunk: warpgroup w multiplies its A (the block's rows)
    // by its B (the tile's rows), both K-major
    const uint32_t a_s = kResident ? a_res + c * kChunkBytes : slot + (2 + wg) * kChunkBytes;
    const uint32_t b_s = slot + wg * kChunkBytes;
    fence_registers(c_acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kUnit / 16; ++ks)
      WgmmaSS<64, 0, 0>::run(c_acc, make_desc(a_s + 2 * ks * kPlane, kPlane, 128),
                             make_desc(b_s + 2 * ks * kPlane, kPlane, 128), (j > 0 || ks > 0) ? 1 : 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(c_acc);

    if (j == chunks - 1) {
      // the tile's first products are whole; the slice's units sit in the last `units` items
      const int first_unit_item = i - units + 1;
      const int t0 = t * kRows;
      const bool ragged = t0 + kRows > s;
      if (dkdv) {
        const float* stats = reinterpret_cast<const float*>(smem + (slot - base) + kStatAt);
        if (wg == 0) {
          // P^T = exp(S^T * scale - lse): lse belongs to the columns (the tile's q rows)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int col = 8 * jj + 2 * (lane % 4);
            const float2 l2 = *reinterpret_cast<const float2*>(stats + col);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool odd = e & 1;
              float p = exp2f(fmaf(c_acc[4 * jj + e], scale_log2e, -(odd ? l2.y : l2.x) * kLog2e));
              if (ragged && t0 + col + odd >= s) p = 0.f;
              c_acc[4 * jj + e] = p;
              x_p[(4 * jj + e) * 128 + wt] = p;
            }
          }
          named_barrier(1);
          to_fragments(c_acc, frag);
          // dV += P^T dO: B = the dO unit (B2), depth = the tile's q rows
#pragma unroll
          for (int u = 0; u < kUnits; ++u) fence_registers(acc[u]);
          wgmma_fence();
#pragma unroll
          for (int u = 0; u < kUnits; ++u)
            if (u < units) product_into(acc[u], frag, slot_of(first_unit_item + u) + kChunkBytes);
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int u = 0; u < kUnits; ++u) fence_registers(acc[u]);
        } else {
          named_barrier(1);
          // dS^T = P^T o (dP^T - delta): delta belongs to the columns
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int col = 8 * jj + 2 * (lane % 4);
            const float2 d2 = *reinterpret_cast<const float2*>(stats + kRows + col);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              c_acc[4 * jj + e] = x_p[(4 * jj + e) * 128 + wt] * (c_acc[4 * jj + e] - ((e & 1) ? d2.y : d2.x));
          }
          to_fragments(c_acc, frag);
          // dK += dS^T Q: B = the q unit (B1)
#pragma unroll
          for (int u = 0; u < kUnits; ++u) fence_registers(acc[u]);
          wgmma_fence();
#pragma unroll
          for (int u = 0; u < kUnits; ++u)
            if (u < units) product_into(acc[u], frag, slot_of(first_unit_item + u));
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int u = 0; u < kUnits; ++u) fence_registers(acc[u]);
        }
      } else {
        if (wg == 0) {
          // P = exp(S * scale - lse): lse belongs to the rows
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float p = exp2f(fmaf(c_acc[4 * jj + e], scale_log2e, -row_lse[e >> 1]));
              if (ragged && t0 + 8 * jj + 2 * (lane % 4) + (e & 1) >= s) p = 0.f;
              x_p[(4 * jj + e) * 128 + wt] = p;
            }
          named_barrier(1);
          named_barrier(2);  // dS is in
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
#pragma unroll
            for (int r = 0; r < 4; ++r) frag[ks][r] = x_ds[(4 * ks + r) * 128 + wt];
        } else {
          named_barrier(1);
          // dS = P o (dP - delta): delta belongs to the rows
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              c_acc[4 * jj + e] = x_p[(4 * jj + e) * 128 + wt] * (c_acc[4 * jj + e] - row_delta[e >> 1]);
          to_fragments(c_acc, frag);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
#pragma unroll
            for (int r = 0; r < 4; ++r) x_ds[(4 * ks + r) * 128 + wt] = frag[ks][r];
          named_barrier(2);
        }
        // dQ += dS K on this warpgroup's two units: B = the k unit (B1), depth = the kv rows
#pragma unroll
        for (int uu = 0; uu < 2; ++uu) fence_registers(acc[uu]);
        wgmma_fence();
#pragma unroll
        for (int uu = 0; uu < 2; ++uu)
          if (2 * wg + uu < units) product_into(acc[uu], frag, slot_of(first_unit_item + 2 * wg + uu));
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int uu = 0; uu < 2; ++uu) fence_registers(acc[uu]);
      }
    }
    if (++j == chunks) {
      j = 0;
      ++t;
    }
  }

  if (dkdv) {
    __nv_bfloat16* dst = (wg == 0 ? dv : dk) + head;
    const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
    for (int u = 0; u < kUnits; ++u)
      if (u < units) store_unit(dst, acc[u], r0, col0 + kUnit * u, s, d, mul, lane, warp);
  } else {
#pragma unroll
    for (int uu = 0; uu < 2; ++uu)
      if (2 * wg + uu < units)
        store_unit(dq + head, acc[uu], r0, col0 + kUnit * (2 * wg + uu), s, d, scale, lane, warp);
  }
}

using KernelFn = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                          const __nv_bfloat16*, const float*, const float*, __nv_bfloat16*,
                          __nv_bfloat16*, __nv_bfloat16*, int, int, int, float, float);

KernelFn kernel_for(int d) {
  return d <= kResidentMaxD ? flash_bwd_wide_kernel<true> : flash_bwd_wide_kernel<false>;
}

bool takes(int d) { return d > 128 && d % kUnit == 0; }

}  // namespace

// Shared memory per block (bytes) and resident blocks per SM at head dim d.
extern "C" int flash_attention_bwd_wide_wgmma_occupancy(int d, int* smem, int* blocks_per_sm) {
  if (!takes(d)) return static_cast<int>(cudaErrorInvalidValue);
  *smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(kernel_for(d), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         *smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel_for(d), kThreads, *smem));
}

// q, k, v, out, dout, dq, dk, dv: contiguous bf16 [bh, s, d], 16-byte aligned, d a multiple
// of 64 above 128; lse (from a forward kernel): contiguous f32 [bh, s]; delta (scratch):
// contiguous f32 [bh, s]. bh <= 65535.
extern "C" int flash_attention_bwd_wide_wgmma(const void* q, const void* k, const void* v,
                                              const void* out, const void* dout, const void* lse,
                                              void* delta, void* dq, void* dk, void* dv, int bh,
                                              int s, int d, float scale, void* stream) {
  if (bh < 1 || s < 1 || bh > 65535 || !takes(d)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = bh * s;
  flash_bwd_delta_kernel<<<(rows + 7) / 8, 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout),
      static_cast<float*>(delta), rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = smem_bytes(d);
  const KernelFn kernel = kernel_for(d);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_slices = (d + kSlice - 1) / kSlice;
  const int n_tiles = (s + kRows - 1) / kRows;
  const dim3 grid(2 * n_tiles * n_slices, bh);  // dk/dv blocks, then dq blocks
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), s, d, n_slices, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
