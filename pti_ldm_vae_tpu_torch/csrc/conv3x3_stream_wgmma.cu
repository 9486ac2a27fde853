// 3x3 stride-1 SAME convolution for Hopper (sm_90a), NHWC, bf16, on the
// tensor cores, for input channels too wide to keep a block's weights in
// shared memory: the weights stream through a TMA ring, the pixels stay.
//
// Replaces the TPU kernel pti_ldm_vae_tpu/ops/pallas/conv2d.py
// (_conv3x3_fwd_pallas, body _fwd_kernel) for bf16 operands at Cin above 176
// (the padded Cin) and Cout of 64 or more: y[b,h,w,:] = sum over the nine taps
// of x[b,h+ky-1,w+kx-1,:] @ W[ky,kx], weights as the tap-major matrix
// [9*Cin, Cout] (row (ky*3+kx)*Cin + ci), bf16 products summed in f32 over the
// whole chain of 9*Cin, the output rounded once to bf16, no bias. On dy with
// the spatially flipped, channel-transposed matrix the same kernel computes
// the input gradient. Every other bf16 shape stays on conv3x3_wgmma.cu, whose
// blocks keep their [9, Cin, TN] weight slab resident; the wrapper
// (ops/kernels/conv3x3.py: forward_kernel) picks by (Cin, Cout) alone.
//
// Bound on an H100: 2*9*Cin*Cout FLOP per output pixel against 989 TFLOP/s
// of bf16 tensor-core rate (0.039 ms at 8 x 64^2 x 256 -> 256, 0.156 ms at
// 8 x 128^2 x 256 -> 256). What held the resident-slab kernel to about a
// quarter of that at Cin 256: its slab fits only 32 output columns there, so
// each halo tile was staged once per 32 of them (8 times over at 256 -> 256,
// ~180 MB of L2 reads at 8 x 64^2), its m64n32k16 products reread their A
// operand for every 32 columns (192 bytes of shared memory a cycle against the
// SM's 128), and the threads' own cp.async copies of the halo added to the
// products instead of hiding under them.
//
// Design.
// - GEMM view as in conv3x3_wgmma.cu: M = output pixels in 8 x 8 patches, N =
//   output channels, K = 9 taps x Cin. A tile is 4 patches side by side (8
//   rows x 32 columns of pixels) by 128 output channels; a block walks tiles
//   t, t + grid, ... (persistent, one block per SM), N-groups of a pixel tile
//   next to each other so that its halo is read from L2 the second time.
// - K is walked in chunks of 64 input channels. Per chunk one halo stage (the
//   10 x 34 pixels around the tile, 64 channels) is staged once for all 128
//   output columns and serves all nine taps: a tap is the same staged tile
//   read from a descriptor whose start is moved by ky halo rows and kx pixels
//   (conv3x3_wgmma.cu's layout: 8 planes of 8 channels, [plane][halo row][halo
//   column][8 bf16], no swizzle). Against it stream nine [64, 128] weight
//   tiles, one per tap.
// - Products m64n128k16 (96 bytes of shared memory a cycle: under the SM's
//   128, where m64n32k16 was over it). B is MN-major (output channels
//   contiguous, the global rows as they are) in two [64 rows][64 columns]
//   halves with the 128-byte swizzle, which TMA writes and wgmma reads alike
//   (the descriptor's LBO steps from one 64-column half to the other, SBO from
//   8 rows of depth to the next 8).
// - TMA for both operands, no copy instruction on the threads. The halo: a
//   4-D tensor map [B][H][W][C] with a box of 8 channels x 34 x 10 pixels, one
//   box per plane; its out-of-bounds zero fill is the SAME padding, the ragged
//   right and bottom edges, and the channels past Cin. The weights: a 3-D map
//   [9][Cin][ldw] with a box of 64 columns x 64 rows of one tap, zero past Cin
//   (so no row of the next tap leaks in) and past ldw.
// - Warp specialisation: one producer warp (its warpgroup drops to 40
//   registers) keeps the TMA loads in flight through two rings guarded by
//   mbarriers, 2 halo stages and 7 weight stages; two consumer warpgroups
//   (raised to 232 registers) share every staged halo and weight tile, each
//   owning two of the tile's four patches (2 x 64 accumulators a thread). A
//   consumer commits each tap's products as one group and waits only for the
//   group before it, so the tensor cores always hold work while it waits for
//   the next stage; it releases a stage as soon as the products that read it
//   are done. The producer runs ahead into the next tile while the consumers
//   write the current one out.
// - Epilogue: each consumer thread rounds its accumulators to bf16 pairs and
//   stores them where they belong (rows, columns and channels past the edges
//   masked; an odd Cout takes 2-byte stores).
// - No cluster multicast: the weight tiles are 9 * 128 / 340 times the halo's
//   bytes per chunk, but leaving every weight load out saves at most 4% of the
//   time (tools/ablate_conv3x3_stream.py, PERF.md), so L2 does not bound the
//   kernel. What does not hide is the epilogue (16-27%): both consumers store
//   at once while the tensor cores wait.
// - Shared memory: 1024 bytes of alignment slack, 7 x 16,384 weight stages,
//   2 x 8 x 5,504 halo stages, 18 mbarriers: 203,920 bytes, one block per SM.
//
// The weight matrix arrives with its columns padded to a multiple of 8
// (ldw, zeros), as for conv3x3_wgmma.cu, so that its rows are 16-byte aligned.
//
// C interface (loaded with ctypes): conv3x3_stream_wgmma_fwd returns
// cudaGetLastError() after the launch (or the error that kept it from
// launching); any other value than 0 is a failure.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched from the driver at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int kPatches = 4;                  // 8 x 8 patches per tile, side by side
constexpr int kTileN = 128;                  // output channels per tile
constexpr int kChunk = 64;                   // input channels per K-chunk
constexpr int kHaloStages = 2;
constexpr int kWeightStages = 7;
constexpr int kConsumers = 2;                // consumer warpgroups, kPatches / 2 patches each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kHaloRows = 10;
constexpr int kHaloCols = 8 * kPatches + 2;  // 34
constexpr int kPlanes = kChunk / 8;
constexpr int kPlaneBox = kHaloRows * kHaloCols * 16;        // bytes one plane's box writes
constexpr int kPlaneBytes = (kPlaneBox + 127) / 128 * 128;   // its slot (TMA writes 128-aligned)
constexpr int kHaloStageBytes = kPlanes * kPlaneBytes;
constexpr int kHalfBytes = kChunk * 128;                     // [64 rows][64 columns] of bf16
constexpr int kWeightStageBytes = (kTileN / 64) * kHalfBytes;
constexpr int kAlign = 1024;                                 // the 128-byte swizzle's period
constexpr int kBarriers = 2 * (kHaloStages + kWeightStages);
constexpr int kSmemBytes = kAlign + kWeightStages * kWeightStageBytes +
                           kHaloStages * kHaloStageBytes + 8 * kBarriers;
constexpr int kMaxSmem = 232448;  // what a block may ask for on sm_90
static_assert(kSmemBytes <= kMaxSmem, "the rings fit in shared memory");
static_assert(kWeightStageBytes % kAlign == 0 && kHaloStageBytes % 128 == 0, "stage alignment");

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar), "r"(parity)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}
// Descriptor of an operand stored with the 128-byte swizzle (layout type 1); start 1024-aligned
__device__ __forceinline__ uint64_t make_desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return make_desc(addr, lbo, sbo) | (1ull << 62);
}

__global__ void __launch_bounds__(kThreads, 1)
conv3x3_stream_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                            const __grid_constant__ CUtensorMap w_map,
                            __nv_bfloat16* __restrict__ y, int h, int w, int cin, int cout,
                            int tiles_h, int tiles_w, int n_groups, int n_tiles) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (smem_addr(smem) + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1);
  const uint32_t w_smem = base;
  const uint32_t a_smem = w_smem + kWeightStages * kWeightStageBytes;
  const uint32_t bars = a_smem + kHaloStages * kHaloStageBytes;
  // full: the producer's arrival and the stage's bytes; empty: every consumer thread's arrival
  const auto halo_full = [&](int s) { return bars + 8 * s; };
  const auto halo_empty = [&](int s) { return bars + 8 * (kHaloStages + s); };
  const auto w_full = [&](int s) { return bars + 8 * (2 * kHaloStages + s); };
  const auto w_empty = [&](int s) { return bars + 8 * (2 * kHaloStages + kWeightStages + s); };

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kHaloStages; ++s) {
      mbar_init(halo_full(s), 1);
      mbar_init(halo_empty(s), 128 * kConsumers);
    }
    for (int s = 0; s < kWeightStages; ++s) {
      mbar_init(w_full(s), 1);
      mbar_init(w_empty(s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_chunks = (cin + kChunk - 1) / kChunk;
  // tile t: N-group t % n_groups of pixel tile t / n_groups
  const auto tile_origin = [&](int t, int& img, int& th0, int& tw0, int& co0) {
    const int pix = t / n_groups;
    co0 = (t % n_groups) * kTileN;
    img = pix / (tiles_h * tiles_w);
    const int r = pix % (tiles_h * tiles_w);
    th0 = (r / tiles_w) * 8;
    tw0 = (r % tiles_w) * (8 * kPatches);
  };

  if (tid < 128) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&x_map)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&w_map)) : "memory");
      int hs = 0, h_phase = 0, ws = 0, w_phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int img, th0, tw0, co0;
        tile_origin(t, img, th0, tw0, co0);
        for (int c = 0; c < n_chunks; ++c) {
          const int c0 = c * kChunk;
          mbar_wait(halo_empty(hs), h_phase ^ 1);
          mbar_expect_tx(halo_full(hs), kPlanes * kPlaneBox);
          for (int p = 0; p < kPlanes; ++p)
            tma_load_4d(a_smem + hs * kHaloStageBytes + p * kPlaneBytes, &x_map, c0 + 8 * p,
                        tw0 - 1, th0 - 1, img, halo_full(hs));
          if (++hs == kHaloStages) {
            hs = 0;
            h_phase ^= 1;
          }
          for (int tap = 0; tap < 9; ++tap) {
            mbar_wait(w_empty(ws), w_phase ^ 1);
            mbar_expect_tx(w_full(ws), kWeightStageBytes);
            for (int half = 0; half < kTileN / 64; ++half)
              tma_load_3d(w_smem + ws * kWeightStageBytes + half * kHalfBytes, &w_map,
                          co0 + 64 * half, c0, tap, w_full(ws));
            if (++ws == kWeightStages) {
              ws = 0;
              w_phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int consumer = tid / 128 - 1;  // owns patches 2*consumer and 2*consumer + 1
    const int warp = (tid / 32) % 4, lane = tid % 32;
    float acc[2][kTileN / 2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < kTileN / 2; ++i) acc[m][i] = 0.f;

    int hs = 0, h_phase = 0, ws = 0, w_phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int prev_ws = 0, prev_hs = 0;
      for (int c = 0; c < n_chunks; ++c) {
        mbar_wait(halo_full(hs), h_phase);
        const uint32_t a_base = a_smem + hs * kHaloStageBytes;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int ky = tap / 3, kx = tap % 3;
          mbar_wait(w_full(ws), w_phase);
          const uint32_t b_base = w_smem + ws * kWeightStageBytes;
#pragma unroll
          for (int m = 0; m < 2; ++m) fence_registers(acc[m]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kChunk / 16; ++kk) {
            // B: 16 rows of depth (two swizzle atoms of 8, 1024 bytes apart) x 128 columns
            // (two 64-column halves, kHalfBytes apart)
            const uint64_t desc_b = make_desc_sw128(b_base + kk * 16 * 128, kHalfBytes, 1024);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              // A: 8 output rows (one halo row apart) x 8 pixels; depth: two planes
              const uint64_t desc_a = make_desc(
                  a_base + 2 * kk * kPlaneBytes + (ky * kHaloCols + 8 * (2 * consumer + m) + kx) * 16,
                  kPlaneBytes, kHaloCols * 16);
              WgmmaSS<kTileN, 0, 1>::run(acc[m], desc_a, desc_b, 1);
            }
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous group is done: release what it read
#pragma unroll
          for (int m = 0; m < 2; ++m) fence_registers(acc[m]);
          if (tap > 0 || c > 0) mbar_arrive(w_empty(prev_ws));
          if (tap == 0 && c > 0) mbar_arrive(halo_empty(prev_hs));
          prev_ws = ws;
          if (++ws == kWeightStages) {
            ws = 0;
            w_phase ^= 1;
          }
        }
        prev_hs = hs;
        if (++hs == kHaloStages) {
          hs = 0;
          h_phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < 2; ++m) fence_registers(acc[m]);
      mbar_arrive(w_empty(prev_ws));
      mbar_arrive(halo_empty(prev_hs));

      // epilogue: accumulator row 16*warp + lane/4 (+8) of patch p is pixel (2*warp (+1), lane/4)
      int img, th0, tw0, co0;
      tile_origin(t, img, th0, tw0, co0);
      const bool pairs = cout % 2 == 0;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int gh = th0 + 2 * warp + half, gw = tw0 + 8 * (2 * consumer + m) + lane / 4;
          const bool live = gh < h && gw < w;
          __nv_bfloat16* const row =
              y + ((static_cast<size_t>(img) * h + (live ? gh : 0)) * w + (live ? gw : 0)) * cout;
#pragma unroll
          for (int j = 0; j < kTileN / 8; ++j) {
            const int co = co0 + 8 * j + 2 * (lane % 4);
            const float v0 = acc[m][4 * j + 2 * half], v1 = acc[m][4 * j + 2 * half + 1];
            acc[m][4 * j + 2 * half] = 0.f;
            acc[m][4 * j + 2 * half + 1] = 0.f;
            if (!live || co >= cout) continue;
            if (pairs) {
              *reinterpret_cast<uint32_t*>(row + co) = pack_bf16(v0, v1);
            } else {
              row[co] = __float2bfloat16_rn(v0);
              if (co + 1 < cout) row[co + 1] = __float2bfloat16_rn(v1);
            }
          }
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, fetched through the runtime (no link against the driver library)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The two tensor maps: x as [B][H][W][Cin] in boxes of 8 channels x 34 x 10 pixels, the
// weight matrix as [9][Cin][ldw] in boxes of 64 columns x 64 rows, 128-byte swizzled
cudaError_t make_maps(const void* x, const void* wmat, int b, int h, int w, int cin, int ldw,
                      CUtensorMap* x_map, CUtensorMap* w_map) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t px = 2ull * cin;
  const cuuint64_t x_dims[4] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(w),
                                static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t x_strides[3] = {px, px * w, px * w * h};  // bytes, of W, H and B
  const cuuint32_t x_box[4] = {8, kHaloCols, kHaloRows, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult res = encode(x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), x_dims,
                        x_strides, x_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(ldw), static_cast<cuuint64_t>(cin), 9};
  const cuuint64_t w_strides[2] = {2ull * ldw, 2ull * ldw * cin};
  const cuuint32_t w_box[3] = {64, kChunk, 1};
  res = encode(w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(wmat), w_dims, w_strides,
               w_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The kernel's shared-memory limit, raised once per device, and the device's SM count
cudaError_t prepare(int* n_sm) {
  static int raised_on = -1, sm_count = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (raised_on != device) {
    err = cudaFuncSetAttribute(conv3x3_stream_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    raised_on = device;
  }
  *n_sm = sm_count;
  return cudaSuccess;
}

}  // namespace

// Shared memory per block (bytes) and resident blocks per SM.
extern "C" int conv3x3_stream_wgmma_occupancy(int* smem, int* blocks_per_sm) {
  int n_sm = 0;
  cudaError_t err = prepare(&n_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem = kSmemBytes;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, conv3x3_stream_wgmma_kernel,
                                                      kThreads, kSmemBytes);
  return static_cast<int>(err);
}

// x: contiguous bf16 [b, h, w, cin], cin a multiple of 8; wmat: contiguous bf16 [9*cin, ldw],
// ldw a multiple of 8, columns cout .. ldw-1 zero; y: contiguous bf16 [b, h, w, cout]; x and
// wmat 16-byte aligned.
extern "C" int conv3x3_stream_wgmma_fwd(const void* x, const void* wmat, void* y, int b, int h,
                                        int w, int cin, int cout, int ldw, void* stream) {
  if (b < 1 || h < 1 || w < 1 || cin < 8 || cin % 8 != 0 || cout < 1 || ldw < cout ||
      ldw % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int n_sm = 0;
  cudaError_t err = prepare(&n_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap x_map, w_map;
  err = make_maps(x, wmat, b, h, w, cin, ldw, &x_map, &w_map);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_h = (h + 7) / 8, tiles_w = (w + 8 * kPatches - 1) / (8 * kPatches);
  const int n_groups = (cout + kTileN - 1) / kTileN;
  const long long tiles = static_cast<long long>(b) * tiles_h * tiles_w * n_groups;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = static_cast<int>(tiles);
  const int grid = n_tiles < n_sm ? n_tiles : n_sm;
  conv3x3_stream_wgmma_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x_map, w_map, static_cast<__nv_bfloat16*>(y), h, w, cin, cout, tiles_h, tiles_w, n_groups,
      n_tiles);
  return static_cast<int>(cudaGetLastError());
}
