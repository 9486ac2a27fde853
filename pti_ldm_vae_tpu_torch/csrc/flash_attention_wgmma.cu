// Flash-attention forward for Hopper (sm_90a), bf16, both products on the
// tensor cores (wgmma) with asynchronously staged tiles.
//
// Replaces the TPU kernel pti_ldm_vae_tpu/ops/pallas/flash_attention.py
// (_forward, body _kernel) for bf16 inputs: softmax(q k^T * d^-0.5) v over
// [B, H, S, D] tensors, self-attention only, online softmax with the running
// max and sum in f32. When the caller passes a buffer it also writes each
// row's logsumexp of the scaled scores, lse = m + log(l), [B*H, S] f32, which
// the backward (flash_attention_bwd.cu) reads to recompute p. f32 inputs stay
// on the f32-FMA kernel of flash_attention.cu.
//
// Bound on an H100: at the VAE bottleneck ([8, 1, 1024, 128]) one call does
// 4*B*H*S^2*D = 4.3 GFLOP on 8 MB of bf16 inputs and outputs, ~540 FLOP per
// byte: the bound is the tensor cores' 989 TFLOP/s, 0.0043 ms. The FMA kernel
// is held by the CUDA cores' 67 TFLOP/s, f32 copies of q, k, v in shared
// memory and a round trip of p through shared memory.
//
// Design. A block is one warpgroup (128 threads) and owns 64 q rows of one
// (batch, head): at [8, 1, 1024, 128] 128 blocks, one wave on 132 SMs.
// - Tiles are bf16 in shared memory as [D/8][row][8 bf16] planes (a row is 16
//   bytes of a plane, 8 rows one core matrix of wgmma, hopper_mma.cuh): q
//   (64 rows, staged once) is a K-major A operand; a k tile (64 kv rows) is
//   a K-major B operand of S = q k^T; the v tile in the very same layout is
//   an MN-major B operand (transpose bit) of O += P v. Planes are padded by
//   16 bytes so that a warp's copies of one row spread over the banks.
// - k and v tiles go through a three-stage ring of cp.async 16-byte copies
//   (zero-filled past S), loaded two tiles ahead: with 64 q rows per block
//   every block pulls all of k and v from L2 (32 KB per tile at D = 128
//   against about 24 bytes per clock per SM), which takes longer than the
//   tile's two products, so the copies must never wait for the math.
// - S = q k^T: D/16 wgmma m64n64k16 into 32 f32 registers per thread. The
//   softmax scale is folded into the exponent, p = exp2(s * scale*log2(e) -
//   m), so q is not rescaled and rounded again. Columns past S score -inf.
// - Online softmax in registers: a row of the accumulator lies in the four
//   threads of a quad, so the row max takes two shuffles; the row sum stays
//   a per-thread partial (the correction factor is shared by the quad) and is
//   folded once at the end. No shared-memory round trip for p.
// - O += P v: p is rounded to bf16 and fed as the register A operand (the
//   accumulator fragment of the first product is the A fragment of the
//   second, thread-locally), 4 wgmma m64nDk16 per kv tile. Rounding p to bf16
//   is the one place where this kernel's arithmetic departs from the FMA
//   kernel's; the sums l and the logsumexp use the unrounded f32 p.
// - Output rows leave as packed bf16 pairs, 16 contiguous bytes per quad.
//
// Shared memory: (64 + 6*64) rows * (D/8 planes of 16 bytes) + padding, 114 KB
// at D = 128.
//
// C interface (loaded with ctypes): flash_attention_wgmma_fwd returns
// cudaGetLastError() after the launch; any other value than 0 is a failure.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr int kStages = 3;            // ring of (k, v) tiles
constexpr int kPlane = 64 * 16 + 16;  // bytes of one 8-column plane of a 64-row tile, padded

template <int D>
__host__ __device__ constexpr int tile_bytes() { return (D / 8) * kPlane; }
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return (1 + 2 * kStages) * tile_bytes<D>();  // q and the ring of (k, v)
}

// Copies rows row0 .. row0+63 of a [s, D] matrix into a plane-major tile;
// rows past s are zero-filled.
template <int D>
__device__ __forceinline__ void stage_tile(uint32_t dst, const __nv_bfloat16* __restrict__ src,
                                           int row0, int s, int tid) {
  constexpr int kPieces = D / 8;  // 16-byte pieces per row
  for (int i = tid; i < 64 * kPieces; i += kThreads) {
    const int piece = i % kPieces, r = i / kPieces;
    const bool live = row0 + r < s;
    const __nv_bfloat16* from = live ? src + static_cast<size_t>(row0 + r) * D + 8 * piece : src;
    cp_async_16(dst + piece * kPlane + r * 16, from, live);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int s, float scale_log2e) {
  static_assert(D % 16 == 0 && D <= 128, "head dim must be a multiple of 16 up to 128");
  constexpr int kTile = tile_bytes<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_smem = smem_addr(smem);
  const uint32_t kv_smem = q_smem + kTile;  // ring slot i: k at 2*i*kTile, v one tile further

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * kBlockQ;
  const size_t base = static_cast<size_t>(blockIdx.y) * s * D;
  const __nv_bfloat16* qb = q + base;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;

  const int n_tiles = (s + kBlockK - 1) / kBlockK;
  // kv tile t into its ring slot; one group per call, empty past the last tile
  auto stage_kv = [&](int t) {
    if (t < n_tiles) {
      const uint32_t slot = kv_smem + 2 * (t % kStages) * kTile;
      stage_tile<D>(slot, kb, t * kBlockK, s, tid);
      stage_tile<D>(slot + kTile, vb, t * kBlockK, s, tid);
    }
    cp_async_commit();
  };
  stage_tile<D>(q_smem, qb, q0, s, tid);
  stage_kv(0);
  stage_kv(1);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // per row half (rows lane/4 and lane/4 + 8 of the warp's 16): running max of the
  // scores in units of log2, and this thread's partial of the running sum
  float row_m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float row_l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<1>();  // all groups but the newest (tile t+1) are complete
    fence_proxy_async();
    __syncthreads();  // every thread's pieces of this tile (and of q) have landed; tile t-1 is consumed
    stage_kv(t + 2);  // into the slot tile t-1 left

    const uint32_t k_smem = kv_smem + 2 * (t % kStages) * kTile;
    const uint32_t v_smem = k_smem + kTile;

    // S = q k^T: rows = q rows, columns = kv rows of the tile, depth = D
    float sc[kBlockK / 2];
    fence_registers(sc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint64_t desc_q = make_desc(q_smem + 2 * ks * kPlane, kPlane, 128);
      const uint64_t desc_k = make_desc(k_smem + 2 * ks * kPlane, kPlane, 128);
      WgmmaSS<kBlockK, 0>::run(sc, desc_q, desc_k, ks > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(sc);

    // online softmax on the accumulator fragment
    const int k0 = t * kBlockK;
    const bool ragged = k0 + kBlockK > s;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
        float x = sc[4 * j + e] * scale_log2e;
        if (ragged && col >= s) x = -CUDART_INF_F;
        sc[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(row_m[hf], mx[hf]);  // finite: every tile has a live column
      corr[hf] = exp2f(row_m[hf] - m_new);
      row_m[hf] = m_new;
      row_l[hf] *= corr[hf];
    }
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[4 * j + e] - row_m[e >> 1]);
        sc[4 * j + e] = p;
        row_l[e >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];

    // O += P v: rows = q rows, depth = kv rows of the tile, columns = D
    uint32_t pa[kBlockK / 16][4];
#pragma unroll
    for (int ks = 0; ks < kBlockK / 16; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[ks][r] = pack_bf16(sc[8 * ks + 2 * r], sc[8 * ks + 2 * r + 1]);
    fence_registers(o);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBlockK / 16; ++ks) {
      // 16 kv rows from row 16*ks (two groups of 8 rows, 128 bytes apart); N-groups are planes
      const uint64_t desc_v = make_desc(v_smem + ks * 256, 128, kPlane);
      WgmmaRS<D>::run(o, pa[ks], desc_v, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(o);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    row_l[hf] += __shfl_xor_sync(0xffffffffu, row_l[hf], 1);
    row_l[hf] += __shfl_xor_sync(0xffffffffu, row_l[hf], 2);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + 16 * warp + 8 * hf + lane / 4;
    if (row >= s) continue;
    const float inv = 1.f / row_l[hf];
    __nv_bfloat16* dst = out + base + static_cast<size_t>(row) * D + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(o[4 * j + 2 * hf] * inv, o[4 * j + 2 * hf + 1] * inv);
    if (lse != nullptr && lane % 4 == 0)
      lse[static_cast<size_t>(blockIdx.y) * s + row] =
          row_m[hf] * 0.6931471805599453f + logf(row_l[hf]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                   int s, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, s,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int D>
cudaError_t occupancy(int* smem, int* blocks_per_sm) {
  *smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, flash_fwd_wgmma_kernel<D>,
                                                       kThreads, *smem);
}

}  // namespace

// Shared memory per block (bytes) and resident blocks per SM of the head-dim-d instantiation.
extern "C" int flash_attention_wgmma_occupancy(int d, int* smem, int* blocks_per_sm) {
  switch (d) {
    case 16: return static_cast<int>(occupancy<16>(smem, blocks_per_sm));
    case 32: return static_cast<int>(occupancy<32>(smem, blocks_per_sm));
    case 64: return static_cast<int>(occupancy<64>(smem, blocks_per_sm));
    case 128: return static_cast<int>(occupancy<128>(smem, blocks_per_sm));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, k, v, out: contiguous bf16 [bh, s, d], 16-byte aligned, d in {16, 32, 64, 128};
// lse: null or contiguous f32 [bh, s]. bh <= 65535.
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v, void* out,
                                         void* lse, int bh, int s, int d, float scale,
                                         void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* const lse_f = static_cast<float*>(lse);
  if (bh < 1 || s < 1 || bh > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (d) {
    case 16: err = launch<16>(q, k, v, out, lse_f, bh, s, scale, st); break;
    case 32: err = launch<32>(q, k, v, out, lse_f, bh, s, scale, st); break;
    case 64: err = launch<64>(q, k, v, out, lse_f, bh, s, scale, st); break;
    case 128: err = launch<128>(q, k, v, out, lse_f, bh, s, scale, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
