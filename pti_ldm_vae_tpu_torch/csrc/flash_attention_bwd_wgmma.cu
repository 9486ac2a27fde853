// Flash-attention backward for Hopper (sm_90a), bf16, every product on the
// tensor cores (wgmma) with asynchronously staged tiles.
//
// Replaces the TPU kernel pti_ldm_vae_tpu/ops/pallas/flash_attention.py
// (_bwd_pallas, body _bwd_kernel) for bf16 inputs: with s = q k^T * d^-0.5
// and p = softmax(s),
//   dv = p^T g,  dp = g v^T,  ds = p * (dp - rowsum(dp * p)),
//   dq = ds k * d^-0.5,  dk = ds^T q * d^-0.5
// over [B, H, S, D] tensors, self-attention only. p is recomputed from the
// f32 row logsumexp either forward kernel writes; rowsum(dp * p) is delta =
// rowsum(dO * O), from a pre-pass. Like the TPU kernel, p and ds are rounded
// to bf16 before the products they feed (wgmma takes bf16 operands); sums,
// p, ds and delta are f32 until then. f32 inputs stay on the f32-FMA kernel
// of flash_attention_bwd.cu.
//
// Bound on an H100: five [S, S] x [S, D] products of 2*S^2*D operations per
// (b, h), 10.7 GFLOP at [8, 1, 1024, 128] on 14 MB of bf16 traffic: the
// tensor cores' 989 TFLOP/s, 0.0109 ms; this split design does seven
// products (p and ds are recomputed for dq), 0.0152 ms.
//
// Design. One launch of flash_bwd_delta_kernel (one warp per row), then one
// launch of flash_bwd_wgmma_kernel whose grid holds two roles: blocks x <
// n_pairs own 128 kv rows and walk the q sequence (dk, dv), blocks x >=
// n_pairs own 128 q rows and walk the kv sequence (dq). Both roles read the
// same inputs and write different outputs, so they run side by side: at [8,
// 1, 1024, 128] 128 blocks, one per SM. A block is two consumer warpgroups
// (256 threads), each owning 64 of the block's rows; both multiply every
// streamed tile, so each byte copied into shared memory feeds twice the
// products it would with one warpgroup per block: the copies, not the
// tensor cores, are what holds this kernel back (tools/ablate_wgmma_bwd.py).
// Each sum runs inside one warpgroup in tile order: no float atomics,
// bit-identical results from run to run.
// - Tiles are bf16 in shared memory as [D/8][row][8 bf16] planes, padded by
//   16 bytes (flash_attention_wgmma.cu): a K-major operand when the depth is
//   D, an MN-major B operand (transpose bit) when the depth is the tile's 64
//   rows. So every tile is staged once, in one layout, for both uses.
// - dk/dv role, orientation. It computes S^T = K Q^T and dP^T = V dO^T (M =
//   kv rows, N = q rows, depth D; A = the resident k / v tile, B = the
//   streamed q / dO tile, both K-major), not S and dP. Then the accumulator
//   fragment of P^T = exp(S^T * scale - lse) and of dS^T = P^T o (dP^T -
//   delta) is, thread by thread, the register A operand of dV += P^T dO and
//   dK += dS^T Q (B = the dO / q tile read MN-major, N = D): the hand-over of
//   the forward (hopper_mma.cuh). Computing S = Q K^T here would put q rows
//   on M and need P transposed, a round trip through shared memory per tile.
//   lse and delta belong to the q rows, the columns of S^T: each thread reads
//   those of its columns 8j + 2(l%4) + {0,1} from a 512-byte row of
//   statistics staged beside the q tile (4-byte cp.async: a row of [B*H, S]
//   f32 starts 16-byte aligned only when S is a multiple of 4).
// - dq role. S = Q K^T and dP = dO V^T (A = the resident q / dO tile), then
//   dQ += dS K with dS from registers and B = the streamed k tile read
//   MN-major; lse and delta of its two rows per thread sit in registers.
// - Copies: the streamed tiles go through a ring of three stages of cp.async
//   16-byte copies (zero-filled past S), loaded two tiles ahead of the
//   products and started right after the barrier that frees their slot.
// - Each tile does its two first products in one commit group (2*D/16
//   wgmma m64n64k16), then the softmax-side arithmetic on the fragments,
//   then its last products (4 wgmma m64nDk16 each). Ragged tiles: rows past
//   S are zero-filled on load and their p is forced to 0; their outputs are
//   never stored.
// - Registers: at D = 128 the dk/dv role holds dK and dV (64 + 64 f32 a
//   thread) and S^T, dP^T (32 + 32) at once; ptxas' report in chip_smoke.py
//   says whether that fits in 255 without spills (256 threads x 255
//   registers is what an SM holds).
//
// Shared memory: 4 resident tiles of (D/8) * 1040 bytes and two rows of
// statistics of 512 bytes, and three ring slots of two tiles and one row of
// statistics: 168,960 bytes at D = 128.
//
// C interface (loaded with ctypes): flash_attention_bwd_wgmma returns the
// first error of its two launches (cudaGetLastError() after each); any other
// value than 0 is a failure.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int kRows = 64;             // rows of a q tile and of a kv tile, and of a warpgroup
constexpr int kWarpgroups = 2;        // consumer warpgroups per block, each owning 64 rows
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kStages = 3;            // ring of streamed (tile, tile, statistics)
constexpr int kPlane = 64 * 16 + 16;  // bytes of one 8-column plane of a 64-row tile, padded
constexpr int kStatBytes = 2 * kRows * 4;  // lse and delta of 64 rows
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int tile_bytes() { return (D / 8) * kPlane; }
template <int D>
__host__ __device__ constexpr int slot_bytes() { return 2 * tile_bytes<D>() + kStatBytes; }
template <int D>
__host__ __device__ constexpr int resident_bytes() {  // two tiles and a row of statistics per warpgroup
  return kWarpgroups * slot_bytes<D>();
}
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return resident_bytes<D>() + kStages * slot_bytes<D>();
}

// Rows row0 .. row0+63 of a [s, D] matrix into a plane-major tile; rows past s are zero-filled.
template <int D>
__device__ __forceinline__ void stage_tile(uint32_t dst, const __nv_bfloat16* __restrict__ src,
                                           int row0, int s, int tid) {
  constexpr int kPieces = D / 8;  // 16-byte pieces per row
  for (int i = tid; i < kRows * kPieces; i += kThreads) {
    const int piece = i % kPieces, r = i / kPieces;
    const bool live = row0 + r < s;
    const __nv_bfloat16* from = live ? src + static_cast<size_t>(row0 + r) * D + 8 * piece : src;
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

// Stores a 64 x D accumulator (times mul) as bf16 rows row0 + 16w + l/4 (+ 8) below s.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst, const float (&acc)[D / 2],
                                           int row0, int s, float mul, int tid) {
  const int lane = tid % 32, warp = (tid / 32) % 4;  // warp within the warpgroup
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + 16 * warp + 8 * hf + lane / 4;
    if (row >= s) continue;
    __nv_bfloat16* at = dst + static_cast<size_t>(row) * D + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(at + 8 * j) =
          pack_bf16(acc[4 * j + 2 * hf] * mul, acc[4 * j + 2 * hf + 1] * mul);
  }
}

// The two first products of a tile pair: a1 b1^T and a2 b2^T, 64 x 64 each, depth D; all
// four tiles K-major.
template <int D>
__device__ __forceinline__ void two_products(float (&c1)[32], float (&c2)[32], uint32_t a1,
                                             uint32_t b1, uint32_t a2, uint32_t b2) {
  fence_registers(c1);
  fence_registers(c2);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    WgmmaSS<64, 0, 0>::run(c1, make_desc(a1 + 2 * ks * kPlane, kPlane, 128),
                           make_desc(b1 + 2 * ks * kPlane, kPlane, 128), ks > 0 ? 1 : 0);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    WgmmaSS<64, 0, 0>::run(c2, make_desc(a2 + 2 * ks * kPlane, kPlane, 128),
                           make_desc(b2 + 2 * ks * kPlane, kPlane, 128), ks > 0 ? 1 : 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_registers(c1);
  fence_registers(c2);
}

// A fragment (k16 step ks, register r) of a 64 x 64 accumulator, rounded to bf16.
__device__ __forceinline__ void to_fragments(const float (&c)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[ks][r] = pack_bf16(c[8 * ks + 2 * r], c[8 * ks + 2 * r + 1]);
}

// dk, dv of the kv rows k0 .. k0+127 (warpgroup wg: k0 + 64 wg ..), walking the q tiles.
template <int D>
__device__ __forceinline__ void dkdv_role(
    unsigned char* smem, const __nv_bfloat16* __restrict__ qb, const __nv_bfloat16* __restrict__ kb,
    const __nv_bfloat16* __restrict__ vb, const __nv_bfloat16* __restrict__ gb,
    const float* __restrict__ lse_b, const float* __restrict__ delta_b, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int k0, int s, float scale, float scale_log2e) {
  constexpr int kTile = tile_bytes<D>();
  const int tid = threadIdx.x, lane = tid % 32, wg = tid / 128;
  const uint32_t base = smem_addr(smem);
  const uint32_t ring = base + resident_bytes<D>();
  const int n_tiles = (s + kRows - 1) / kRows;

  // q tile t, its dO tile and its rows' statistics into ring slot t % kStages; one group per call
  auto stage_q = [&](int t) {
    if (t < n_tiles) {
      const uint32_t slot = ring + (t % kStages) * slot_bytes<D>();
      stage_tile<D>(slot, qb, t * kRows, s, tid);
      stage_tile<D>(slot + kTile, gb, t * kRows, s, tid);
      stage_stats(slot + 2 * kTile, lse_b, delta_b, t * kRows, s, tid);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int g = 0; g < kWarpgroups; ++g) {
    stage_tile<D>(base + g * slot_bytes<D>(), kb, k0 + g * kRows, s, tid);
    stage_tile<D>(base + g * slot_bytes<D>() + kTile, vb, k0 + g * kRows, s, tid);
  }
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) stage_q(t);
  const uint32_t k_smem = base + wg * slot_bytes<D>();  // this warpgroup's k and v tiles
  const uint32_t v_smem = k_smem + kTile;

  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    acc_dk[i] = 0.f;
    acc_dv[i] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // all groups but the newest kStages - 2: tile t has landed
    fence_proxy_async();
    __syncthreads();  // every thread's pieces of tile t are in; tile t-1's slot is consumed
    stage_q(t + kStages - 1);  // into the slot tile t-1 left

    const uint32_t q_smem = ring + (t % kStages) * slot_bytes<D>();
    const uint32_t g_smem = q_smem + kTile;
    const float* stats = reinterpret_cast<const float*>(smem + (q_smem - base) + 2 * kTile);

    // S^T = K Q^T, dP^T = V dO^T: rows = kv rows, columns = q rows of tile t
    float st[32], dpt[32];
    two_products<D>(st, dpt, k_smem, q_smem, v_smem, g_smem);

    // P^T and dS^T on the fragments; the statistics belong to the columns
    const int q0 = t * kRows;
    const bool ragged = q0 + kRows > s;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      const float2 l2 = *reinterpret_cast<const float2*>(stats + c);
      const float2 d2 = *reinterpret_cast<const float2*>(stats + kRows + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        float p = exp2f(fmaf(st[4 * j + e], scale_log2e, -(odd ? l2.y : l2.x) * kLog2e));
        if (ragged && q0 + c + odd >= s) p = 0.f;
        st[4 * j + e] = p;
        dpt[4 * j + e] = p * (dpt[4 * j + e] - (odd ? d2.y : d2.x));
      }
    }
    uint32_t pa[4][4], dsa[4][4];
    to_fragments(st, pa);
    to_fragments(dpt, dsa);

    // dV += P^T dO, dK += dS^T Q: depth = the 64 q rows, columns = D
    fence_registers(acc_dv);
    fence_registers(acc_dk);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      WgmmaRS<D>::run(acc_dv, pa[ks], make_desc(g_smem + ks * 256, 128, kPlane), 1);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      WgmmaRS<D>::run(acc_dk, dsa[ks], make_desc(q_smem + ks * 256, 128, kPlane), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(acc_dv);
    fence_registers(acc_dk);
  }
  store_rows<D>(dk, acc_dk, k0 + wg * kRows, s, scale, tid);
  store_rows<D>(dv, acc_dv, k0 + wg * kRows, s, 1.f, tid);
}

// dq of the q rows q0 .. q0+127 (warpgroup wg: q0 + 64 wg ..), walking the kv tiles.
template <int D>
__device__ __forceinline__ void dq_role(
    unsigned char* smem, const __nv_bfloat16* __restrict__ qb, const __nv_bfloat16* __restrict__ kb,
    const __nv_bfloat16* __restrict__ vb, const __nv_bfloat16* __restrict__ gb,
    const float* __restrict__ lse_b, const float* __restrict__ delta_b, __nv_bfloat16* __restrict__ dq,
    int q0, int s, float scale, float scale_log2e) {
  constexpr int kTile = tile_bytes<D>();
  const int tid = threadIdx.x, lane = tid % 32, wg = tid / 128, warp = (tid / 32) % 4;
  const uint32_t base = smem_addr(smem);
  const uint32_t q_smem = base + wg * slot_bytes<D>();  // this warpgroup's q and dO tiles
  const uint32_t g_smem = q_smem + kTile;
  const uint32_t ring = base + resident_bytes<D>();
  const float* stats = reinterpret_cast<const float*>(smem + wg * slot_bytes<D>() + 2 * kTile);
  const int n_tiles = (s + kRows - 1) / kRows;

  // k and v tile t into ring slot t % kStages; one group per call
  auto stage_kv = [&](int t) {
    if (t < n_tiles) {
      const uint32_t slot = ring + (t % kStages) * slot_bytes<D>();
      stage_tile<D>(slot, kb, t * kRows, s, tid);
      stage_tile<D>(slot + kTile, vb, t * kRows, s, tid);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int g = 0; g < kWarpgroups; ++g) {
    const uint32_t slot = base + g * slot_bytes<D>();
    stage_tile<D>(slot, qb, q0 + g * kRows, s, tid);
    stage_tile<D>(slot + kTile, gb, q0 + g * kRows, s, tid);
    stage_stats(slot + 2 * kTile, lse_b, delta_b, q0 + g * kRows, s, tid);
  }
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) stage_kv(t);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float row_lse[2], row_delta[2];  // rows 16w + l/4 and the one 8 further (log2 units for lse)

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    stage_kv(t + kStages - 1);
    if (t == 0) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * warp + 8 * hf + lane / 4;
        row_lse[hf] = stats[r] * kLog2e;
        row_delta[hf] = stats[kRows + r];
      }
    }

    const uint32_t k_smem = ring + (t % kStages) * slot_bytes<D>();
    const uint32_t v_smem = k_smem + kTile;

    // S = Q K^T, dP = dO V^T: rows = q rows, columns = kv rows of tile t
    float sc[32], dp[32];
    two_products<D>(sc, dp, q_smem, k_smem, g_smem, v_smem);

    const int k0 = t * kRows;
    const bool ragged = k0 + kRows > s;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        float p = exp2f(fmaf(sc[4 * j + e], scale_log2e, -row_lse[hf]));
        if (ragged && k0 + 8 * j + 2 * (lane % 4) + (e & 1) >= s) p = 0.f;
        dp[4 * j + e] = p * (dp[4 * j + e] - row_delta[hf]);
      }
    uint32_t dsa[4][4];
    to_fragments(dp, dsa);

    // dQ += dS K: depth = the 64 kv rows, columns = D
    fence_registers(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      WgmmaRS<D>::run(acc, dsa[ks], make_desc(k_smem + ks * 256, 128, kPlane), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(acc);
  }
  store_rows<D>(dq, acc, q0 + wg * kRows, s, scale, tid);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int s, float scale, float scale_log2e) {
  static_assert(D % 16 == 0 && D <= 128, "head dim must be a multiple of 16 up to 128");
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kBlockRows = kWarpgroups * kRows;
  const int n_pairs = (s + kBlockRows - 1) / kBlockRows;
  const size_t base = static_cast<size_t>(blockIdx.y) * s * D;
  const size_t stat_base = static_cast<size_t>(blockIdx.y) * s;
  const int pair = static_cast<int>(blockIdx.x);
  if (pair < n_pairs) {
    dkdv_role<D>(smem, q + base, k + base, v + base, dout + base, lse + stat_base,
                 delta + stat_base, dk + base, dv + base, pair * kBlockRows, s, scale, scale_log2e);
  } else {
    dq_role<D>(smem, q + base, k + base, v + base, dout + base, lse + stat_base, delta + stat_base,
               dq + base, (pair - n_pairs) * kBlockRows, s, scale, scale_log2e);
  }
}

template <int D>
cudaError_t occupancy(int* smem, int* blocks_per_sm) {
  *smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, flash_bwd_wgmma_kernel<D>,
                                                       kThreads, *smem);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int bh, int s,
                   float scale, cudaStream_t stream) {
  const int rows = bh * s;
  flash_bwd_delta_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout), delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int smem = smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int n_pairs = (s + kWarpgroups * kRows - 1) / (kWarpgroups * kRows);
  const dim3 grid(2 * n_pairs, bh);  // dk/dv blocks, then dq blocks
  flash_bwd_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta,
      static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), s, scale, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// Shared memory per block (bytes) and resident blocks per SM of the head-dim-d instantiation.
extern "C" int flash_attention_bwd_wgmma_occupancy(int d, int* smem, int* blocks_per_sm) {
  switch (d) {
    case 16: return static_cast<int>(occupancy<16>(smem, blocks_per_sm));
    case 32: return static_cast<int>(occupancy<32>(smem, blocks_per_sm));
    case 64: return static_cast<int>(occupancy<64>(smem, blocks_per_sm));
    case 128: return static_cast<int>(occupancy<128>(smem, blocks_per_sm));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, k, v, out, dout, dq, dk, dv: contiguous bf16 [bh, s, d], 16-byte aligned, d in {16, 32,
// 64, 128}; lse (from either forward kernel): contiguous f32 [bh, s]; delta (scratch):
// contiguous f32 [bh, s]. bh <= 65535.
extern "C" int flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                         const void* out, const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk, void* dv, int bh, int s,
                                         int d, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* const lse_f = static_cast<const float*>(lse);
  float* const delta_f = static_cast<float*>(delta);
  if (bh < 1 || s < 1 || bh > 65535) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 16: return static_cast<int>(launch<16>(q, k, v, out, dout, lse_f, delta_f, dq, dk, dv, bh, s, scale, st));
    case 32: return static_cast<int>(launch<32>(q, k, v, out, dout, lse_f, delta_f, dq, dk, dv, bh, s, scale, st));
    case 64: return static_cast<int>(launch<64>(q, k, v, out, dout, lse_f, delta_f, dq, dk, dv, bh, s, scale, st));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, out, dout, lse_f, delta_f, dq, dk, dv, bh, s, scale, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
