// Flash-attention forward for Hopper (sm_90a), bf16, head dims above 128 (any
// multiple of 64), both products on the tensor cores (wgmma).
//
// Replaces the TPU kernel pti_ldm_vae_tpu/ops/pallas/flash_attention.py
// (_forward, body _kernel) for bf16 inputs of a wide head:
// softmax(q k^T * d^-0.5) v over [B, H, S, D] tensors, self-attention only,
// online softmax with the running max and sum in f32, p rounded to bf16
// before the second product (as flash_attention_wgmma.cu does at D <= 128).
// When the caller passes a buffer it also writes each row's logsumexp, lse =
// m + log(l), [B*H, S] f32, for the backward. f32 inputs stay on the f32-FMA
// kernel of flash_attention.cu; the wrapper copies an unaligned bf16 view first.
//
// Bound on an H100: at config/ar_vae_dente_kl1e3.json's mid blocks ([8, 1,
// 4096, 256]) one call does 4*B*H*S^2*D = 137.4 GFLOP on 67 MB of bf16 inputs
// and outputs: the tensor cores' 989 TFLOP/s, 0.139 ms. What kept wide heads
// off the tensor cores: flash_attention_wgmma.cu holds the whole 64 x D f32
// output of its warpgroup in registers (D/2 a thread: 256 at D = 512, over
// the 255 a thread may have) and stages whole-D k and v tiles in a ring
// (232,960 bytes at D = 256, over the 232,448 a block may have).
//
// Design. The head dim is cut two ways.
// - Output slices: a block owns 128 q rows (two consumer warpgroups of 64)
//   and one slice of 256 output columns (four units of 64; the last slice of
//   a head dim that is not a multiple of 256 has fewer units). A warpgroup's
//   slice accumulator is 4 x 32 = 128 f32 registers a thread at any D. The
//   grid walks the slices, so at D = 512 the scores are computed twice: 1.5x
//   the minimum products, against exactly the minimum at D <= 256.
// - Depth chunks: S = q k^T is summed over chunks of 64 columns, so no tile
//   of k is ever whole-D. Every streamed item is one 64-row x 64-column bf16
//   tile (8,320 bytes as [8 planes][64 rows][16 bytes], planes padded by 16
//   bytes, hopper_mma.cuh's core-matrix layout): for each kv tile, first its
//   D/64 k chunks (a K-major B operand of S; 4 wgmma m64n64k16 a warpgroup),
//   then the slice's v units (an MN-major B operand of O += P v; 4 wgmma
//   m64n64k16 with P from registers). Items go through a ring of 8 cp.async
//   stages, staged 7 items ahead (zero-filled past S), one block-wide barrier
//   an item.
// - q: up to D = 512 each warpgroup's 64 x D q tile stays in shared memory
//   (133,120 bytes for both at D = 512); above that its chunk rides in the
//   item beside the k chunk (re-read from L2 for every kv tile), so the block
//   fits its 232,448 bytes at any head dim: 199,680 bytes in both modes.
// - Online softmax on the accumulator fragment of S after its last chunk, as
//   in flash_attention_wgmma.cu: scale folded into exp2, row max by two
//   shuffles in a quad, per-thread partial row sums folded at the end; P is
//   rounded to bf16 into the A fragments of the v items.
// - Output rows leave as packed bf16 pairs; the blocks of slice 0 write lse.
// No float atomics: every sum runs inside one warpgroup in a fixed order, so
// two runs give the same bits.
//
// C interface (loaded with ctypes): flash_attention_wide_wgmma_fwd returns
// cudaGetLastError() after the launch; any other value than 0 is a failure.
// flash_attention_wide_wgmma_occupancy reports the shared memory per block and
// resident blocks per SM at a head dim (ops/kernels/flash_attention.py:
// wide_fwd_smem_bytes is the same formula).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int kRows = 64;                     // q rows of a warpgroup, kv rows of a tile
constexpr int kWarpgroups = 2;                // consumer warpgroups a block
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kUnit = 64;                     // columns of a depth chunk and of an output unit
constexpr int kUnits = 4;                     // output units of a slice
constexpr int kSlice = kUnit * kUnits;        // output columns of a block
constexpr int kStages = 8;                    // ring of streamed items
constexpr int kPlane = 64 * 16 + 16;          // bytes of one 8-column plane of a 64-row tile, padded
constexpr int kChunkBytes = kUnit / 8 * kPlane;  // one 64 x 64 bf16 tile: 8,320 bytes
constexpr int kResidentMaxD = 512;            // q stays in shared memory up to this head dim

__host__ __device__ constexpr int slot_bytes(bool resident) {
  return resident ? kChunkBytes : (1 + kWarpgroups) * kChunkBytes;  // k chunk (+ both q chunks)
}
__host__ __device__ inline int q_tile_bytes(int d) { return d / 8 * kPlane; }
__host__ __device__ inline int smem_bytes(int d) {
  const bool resident = d <= kResidentMaxD;
  return (resident ? kWarpgroups * q_tile_bytes(d) : 0) + kStages * slot_bytes(resident);
}

// Rows row0 .. row0+63, columns col0 .. col0+8*planes-1 of a [s, d] row-major matrix
// into a plane-major tile; rows past s are zero-filled.
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

template <bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wide_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int s, int d, int n_slices, float scale_log2e) {
  constexpr int kSlot = slot_bytes(kResident);
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  const uint32_t ring = base + (kResident ? kWarpgroups * q_tile_bytes(d) : 0);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = (tid / 32) % 4, wg = tid / 128;
  const int slice = static_cast<int>(blockIdx.x) % n_slices;
  const int q0 = static_cast<int>(blockIdx.x) / n_slices * (kWarpgroups * kRows);
  const int col0 = slice * kSlice;
  const int units = min(kUnits, (d - col0) / kUnit);
  const int chunks = d / kUnit;
  const int per_tile = chunks + units;  // items of one kv tile: k chunks, then v units
  const int n_tiles = (s + kRows - 1) / kRows;
  const int n_items = n_tiles * per_tile;
  const size_t head = static_cast<size_t>(blockIdx.y) * s * d;
  const __nv_bfloat16* qb = q + head;
  const __nv_bfloat16* kb = k + head;
  const __nv_bfloat16* vb = v + head;

  // item i into ring slot i % kStages; one commit group per call, empty past the last item
  auto stage = [&](int i) {
    if (i < n_items) {
      const int t = i / per_tile, ph = i % per_tile;
      const uint32_t slot = ring + (i % kStages) * kSlot;
      if (ph < chunks) {
        stage_tile(slot, kb, t * kRows, ph * kUnit, kUnit / 8, s, d, tid);
        if (!kResident)
          for (int g = 0; g < kWarpgroups; ++g)
            stage_tile(slot + (1 + g) * kChunkBytes, qb, q0 + g * kRows, ph * kUnit, kUnit / 8, s, d,
                       tid);
      } else {
        stage_tile(slot, vb, t * kRows, col0 + (ph - chunks) * kUnit, kUnit / 8, s, d, tid);
      }
    }
    cp_async_commit();
  };
  if (kResident)  // both warpgroups' q tiles, in the first group
    for (int g = 0; g < kWarpgroups; ++g)
      stage_tile(base + g * q_tile_bytes(d), qb, q0 + g * kRows, 0, d / 8, s, d, tid);
  for (int i = 0; i < kStages - 1; ++i) stage(i);

  float o[kUnits][32];
#pragma unroll
  for (int u = 0; u < kUnits; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[u][i] = 0.f;
  float sc[32];
  uint32_t pa[4][4];
  // per row half (rows lane/4 and lane/4 + 8 of the warp's 16): running max of the
  // scores in units of log2, and this thread's partial of the running sum
  float row_m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float row_l[2] = {0.f, 0.f};
  const uint32_t q_res = base + wg * (kResident ? q_tile_bytes(d) : 0);

  int t = 0, ph = 0;
  for (int i = 0; i < n_items; ++i) {
    cp_async_wait<kStages - 2>();  // all groups but the newest kStages-2: item i has landed
    fence_proxy_async();
    __syncthreads();  // every thread's pieces of item i are in; item i-1's slot is consumed
    stage(i + kStages - 1);  // into the slot item i-1 left
    const uint32_t slot = ring + (i % kStages) * kSlot;

    if (ph < chunks) {
      // S += q[:, chunk] k[tile, chunk]^T: rows = q rows, columns = kv rows, depth = 64
      const uint32_t q_s = kResident ? q_res + ph * kChunkBytes : slot + (1 + wg) * kChunkBytes;
      fence_registers(sc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kUnit / 16; ++ks)
        WgmmaSS<64, 0, 0>::run(sc, make_desc(q_s + 2 * ks * kPlane, kPlane, 128),
                               make_desc(slot + 2 * ks * kPlane, kPlane, 128),
                               (ph > 0 || ks > 0) ? 1 : 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_registers(sc);

      if (ph == chunks - 1) {  // the tile's scores are whole: online softmax on the fragment
        const int k0 = t * kRows;
        const bool ragged = k0 + kRows > s;
        float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int j = 0; j < 8; ++j)
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
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(sc[4 * j + e] - row_m[e >> 1]);
            sc[4 * j + e] = p;
            row_l[e >> 1] += p;
          }
#pragma unroll
        for (int u = 0; u < kUnits; ++u)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[u][4 * j + e] *= corr[e >> 1];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pa[ks][r] = pack_bf16(sc[8 * ks + 2 * r], sc[8 * ks + 2 * r + 1]);
      }
    } else {
      // O[:, unit] += P v[tile, unit]: depth = the 64 kv rows, columns = the unit's 64
      const int unit = ph - chunks;
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        if (u != unit) continue;
        fence_registers(o[u]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          WgmmaRS<64>::run(o[u], pa[ks], make_desc(slot + ks * 256, 128, kPlane), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_registers(o[u]);
      }
    }
    if (++ph == per_tile) {
      ph = 0;
      ++t;
    }
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    row_l[hf] += __shfl_xor_sync(0xffffffffu, row_l[hf], 1);
    row_l[hf] += __shfl_xor_sync(0xffffffffu, row_l[hf], 2);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + wg * kRows + 16 * warp + 8 * hf + lane / 4;
    if (row >= s) continue;
    const float inv = 1.f / row_l[hf];
    __nv_bfloat16* dst = out + head + static_cast<size_t>(row) * d + col0 + 2 * (lane % 4);
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      if (u >= units) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + kUnit * u + 8 * j) =
            pack_bf16(o[u][4 * j + 2 * hf] * inv, o[u][4 * j + 2 * hf + 1] * inv);
    }
    if (lse != nullptr && slice == 0 && lane % 4 == 0)
      lse[static_cast<size_t>(blockIdx.y) * s + row] = row_m[hf] * 0.6931471805599453f + logf(row_l[hf]);
  }
}

using KernelFn = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                          __nv_bfloat16*, float*, int, int, int, float);

KernelFn kernel_for(int d) {
  return d <= kResidentMaxD ? flash_fwd_wide_kernel<true> : flash_fwd_wide_kernel<false>;
}

bool takes(int d) { return d > 128 && d % kUnit == 0; }

}  // namespace

// Shared memory per block (bytes) and resident blocks per SM at head dim d.
extern "C" int flash_attention_wide_wgmma_occupancy(int d, int* smem, int* blocks_per_sm) {
  if (!takes(d)) return static_cast<int>(cudaErrorInvalidValue);
  *smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(kernel_for(d), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         *smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel_for(d), kThreads, *smem));
}

// q, k, v, out: contiguous bf16 [bh, s, d], 16-byte aligned, d a multiple of 64 above 128;
// lse: null or contiguous f32 [bh, s]. bh <= 65535.
extern "C" int flash_attention_wide_wgmma_fwd(const void* q, const void* k, const void* v,
                                              void* out, void* lse, int bh, int s, int d,
                                              float scale, void* stream) {
  if (bh < 1 || s < 1 || bh > 65535 || !takes(d)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(d);
  const KernelFn kernel = kernel_for(d);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_slices = (d + kSlice - 1) / kSlice;
  const int n_qblocks = (s + kWarpgroups * kRows - 1) / (kWarpgroups * kRows);
  const dim3 grid(n_qblocks * n_slices, bh);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), s, d, n_slices, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}
