// Filter gradient of the 3x3 stride-1 SAME convolution for Hopper (sm_90a),
// bf16 NHWC operands, on the tensor cores (wgmma) with asynchronously staged
// tiles.
//
// Replaces the TPU kernel pti_ldm_vae_tpu/ops/pallas/conv2d.py
// (_conv3x3_dw_pallas, body _dw_kernel) for bf16 operands:
//   dW[(ky*3+kx)*Cin + ci, co] = sum over b, h, w of
//                                x[b, h+ky-1, w+kx-1, ci] * dy[b, h, w, co]
// in f32 (x read as zero outside the image). bf16 products are exact in f32,
// so this kernel differs from the f32-FMA kernel of conv3x3_wgrad.cu (which
// keeps f32 operands, and bf16 operands with Cin or Cout no multiple of 8)
// only in the order of summation.
//
// Bound on an H100: a matrix product [9*Cin, P] x [P, Cout] over P = B*H*W
// pixels (524 288 at 8 x 256^2) with a small result (at most 1152 x 128):
// 2*9*Cin*Cout operations and 2*(Cin + Cout) bytes per pixel against 989
// TFLOP/s and 3.35 TB/s, so the 32- and 64-channel levels are bytes-bound,
// the 128-channel ones operations-bound. The FMA kernel is held by the CUDA
// cores' 67 TFLOP/s and widens both operands to f32 in shared memory.
//
// Design. GEMM view: M = 64 input channels of one tap, N = 32 output
// channels, depth = pixels. In NHWC both operands are MN-major along that
// depth (channels contiguous, pixels the depth), so both go in with the
// transpose bit (hopper_mma.cuh). M = Cin rather than M = Cout because the
// accumulator's columns are then Cout, dW's contiguous axis (a quad stores a
// run of contiguous f32), and because x, the operand that moves with the tap,
// is then A, whose descriptor is the only one that changes from tap to tap:
// dy's B descriptor serves the nine taps of a step.
// - A warpgroup (128 threads) owns all nine taps x 64 input channels x 32
//   output channels of dW: 144 f32 accumulators a thread (64 output channels
//   would need 288). A block is WG such warpgroups (1 or 2) on neighbouring
//   32-channel groups of Cout: they multiply the same staged x halo, each
//   with its own planes of dy, so a second warpgroup halves the x a block
//   copies per output channel. The copies, not the tensor cores, are what
//   holds this kernel back (tools/ablate_wgmma_bwd.py; variants that owned
//   three taps x 64 x 64, so that x was copied three times, or one-patch
//   tiles, were slower at every flagship shape). A block walks the pixel
//   tiles of one slab, 9 * 2 * 4 wgmma m64n32k16 per tile and warpgroup, and
//   writes its share of dW once as f32 partial sums of that slab:
//   partials[slab][9*Cin][Cout]. The caller folds the slabs in a fixed order
//   (one torch.sum): no float atomics, two runs give the same bits. Grid:
//   (slab, 64-channel group of Cin x (32*WG)-group of Cout). Every block of
//   one slab reads the slab's x and dy again (from L2): x once per Cout
//   group, dy once per Cin group.
// - Operands straight from the staged tiles, no im2col copy, no transpose in
//   shared memory. A pixel tile is MT = 2 patches of 8 x 8 pixels side by side.
//   x's halo (10 x 18 pixels) is staged as [plane of 8 channels][halo
//   row][halo column][8 bf16] (the layout of conv3x3_wgmma.cu): 8 pixels of
//   a halo row are one 128-byte core matrix along the depth, the next 8
//   pixels of the patch (its next row) lie one halo row further (LBO), the
//   next 8 channels one plane further (SBO). A tap (ky, kx) is the same
//   staged halo read from a start moved by ky halo rows and kx pixels, a
//   multiple of 16 bytes. dy's tile is staged the same way without a halo.
//   One k16 step of depth is two rows of a patch, four steps a patch; a pixel
//   tile is two patches side by side (8 x 16 pixels).
// - Channels past Cin or Cout within a group stay zero: their planes are
//   cleared once and never copied into. Pixels outside the image are
//   zero-filled by the copies (for x: the padding of SAME; for dy: past the
//   ragged edge).
// - Staging is asynchronous: every 16-byte piece is one cp.async, through a
//   ring of three stages loaded two tiles ahead and started right behind the
//   tile's products. Pieces are handed out with the plane fastest, so a
//   warp's copies read a pixel's channels, then the next pixel's: contiguous
//   runs in NHWC.
// - The caller (ops/kernels/conv3x3.py) picks WG (wgrad_warpgroups: 1 at
//   Cout up to 32, else 2) and the number of slabs (wgrad_wgmma_slabs).
//   Shared memory per block: 3 * (8 * 2960 + WG * 4 * 2064) bytes (three
//   stages of 8 x-planes of 10 x 18 pixels and WG * 4 dy-planes of 8 x 16
//   pixels, each padded): 95,808 at WG 1 (two blocks per SM), 120,576 at WG 2
//   (one block of 256 threads per SM).
//
// C interface (loaded with ctypes): conv3x3_wgrad_wgmma returns
// cudaGetLastError() after the launch; any other value than 0 is a failure.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int kHaloRows = 10;
constexpr int kCiGroup = 64;  // M: input channels of one tap per warpgroup
constexpr int NT = 32;        // N: output channels per warpgroup
constexpr int MT = 2;         // 8 x 8 patches side by side in a pixel tile
constexpr int kStages = 3;    // ring of (x halo, dy tile)
constexpr int kAhead = 2;     // tiles loaded ahead of the one being multiplied
constexpr int HC = 8 * MT + 2;  // halo columns
constexpr int TW = 8 * MT;      // pixel columns of a tile
// one plane of 8 channels, padded to 16 bytes past a multiple of 128 (copies of one pixel's
// planes spread over the banks)
constexpr int XP = (kHaloRows * HC * 16 + 127) / 128 * 128 + 16;
constexpr int DP = 8 * TW * 16 + 16;
constexpr int NG = NT / 8;  // dy planes of a warpgroup

template <int WG>
__host__ __device__ constexpr int stage_bytes() { return (kCiGroup / 8) * XP + WG * NG * DP; }
template <int WG>
__host__ __device__ constexpr int smem_bytes() { return kStages * stage_bytes<WG>(); }

template <int WG>
__global__ void __launch_bounds__(128 * WG)
conv3x3_wgrad_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                           float* __restrict__ partials, int h, int w, int cin, int cout,
                           int tiles_h, int tiles_w, int n_tiles, int n_co) {
  constexpr int DG = WG * NG;  // dy planes of the block
  constexpr int kThreads = 128 * WG;
  constexpr int kStage = stage_bytes<WG>();
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem);

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int ci0 = (blockIdx.y / n_co) * kCiGroup, co0 = (blockIdx.y % n_co) * DG * 8;
  const int x_planes = min(kCiGroup / 8, (cin - ci0) / 8);  // live planes (Cin, Cout multiples of 8)
  const int dy_planes = min(DG, (cout - co0) / 8);
  // slab i: tiles [i * n_tiles / n_slab, (i + 1) * n_tiles / n_slab), sizes within one tile
  const int first = static_cast<int>(static_cast<long long>(blockIdx.x) * n_tiles / gridDim.x);
  const int n_steps =
      static_cast<int>(static_cast<long long>(blockIdx.x + 1) * n_tiles / gridDim.x) - first;

  // planes of channels past Cin / Cout: zero in every stage, once
  for (int slot = 0; slot < kStages; ++slot) {
    unsigned char* xs = smem + slot * kStage;
    for (int i = x_planes * XP / 16 + tid; i < (kCiGroup / 8) * XP / 16; i += kThreads)
      reinterpret_cast<uint4*>(xs)[i] = make_uint4(0, 0, 0, 0);
    unsigned char* dys = xs + (kCiGroup / 8) * XP;
    for (int i = dy_planes * DP / 16 + tid; i < DG * DP / 16; i += kThreads)
      reinterpret_cast<uint4*>(dys)[i] = make_uint4(0, 0, 0, 0);
  }

  // x halo and dy tile of step s into its ring slot; pieces with the plane fastest
  auto stage = [&](int s) {
    if (s >= n_steps) return;
    const int t = first + s;
    const int img = t / (tiles_h * tiles_w);
    const int r = t % (tiles_h * tiles_w);
    const int th0 = (r / tiles_w) * 8, tw0 = (r % tiles_w) * TW;
    const size_t img_px = static_cast<size_t>(img) * h * w;
    const uint32_t xs = base + (s % kStages) * kStage;
    const uint32_t dys = xs + (kCiGroup / 8) * XP;
    for (int i = tid; i < (kCiGroup / 8) * kHaloRows * HC; i += kThreads) {
      const int plane = i % (kCiGroup / 8), p = i / (kCiGroup / 8);
      if (plane >= x_planes) continue;
      const int gh = th0 + p / HC - 1, gw = tw0 + p % HC - 1;
      const bool live = gh >= 0 && gh < h && gw >= 0 && gw < w;
      const __nv_bfloat16* src =
          live ? x + (img_px + static_cast<size_t>(gh) * w + gw) * cin + ci0 + 8 * plane : x;
      cp_async_16(xs + plane * XP + p * 16, src, live);
    }
    for (int i = tid; i < DG * 8 * TW; i += kThreads) {
      const int plane = i % DG, p = i / DG;
      if (plane >= dy_planes) continue;
      const int gh = th0 + p / TW, gw = tw0 + p % TW;
      const bool live = gh < h && gw < w;
      const __nv_bfloat16* src =
          live ? dy + (img_px + static_cast<size_t>(gh) * w + gw) * cout + co0 + 8 * plane : dy;
      cp_async_16(dys + plane * DP + p * 16, src, live);
    }
  };

  stage(0);
  cp_async_commit();
  stage(1);
  cp_async_commit();

  float acc[9][NT / 2];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[t][i] = 0.f;

  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<1>();  // all groups but the newest: step s has landed
    fence_proxy_async();
    __syncthreads();  // every thread's pieces of step s are in; step s-1 is consumed

    const uint32_t xs = base + (s % kStages) * kStage;
    const uint32_t dys = xs + (kCiGroup / 8) * XP + wg * NG * DP;  // this warpgroup's dy planes
#pragma unroll
    for (int t = 0; t < 9; ++t) fence_registers(acc[t]);
    wgmma_fence();
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // depth: pixel rows 2kk, 2kk+1 of patch m (two groups of 8 pixels, one tile row apart)
        const uint64_t desc_b = make_desc(dys + (2 * kk * TW + 8 * m) * 16, TW * 16, DP);
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int ky = tap / 3, kx = tap % 3;
          // the same pixels shifted by the tap: one halo row per 8 pixels of depth
          const uint64_t desc_a =
              make_desc(xs + ((2 * kk + ky) * HC + 8 * m + kx) * 16, HC * 16, XP);
          WgmmaSS<NT, 1, 1>::run(acc[tap], desc_a, desc_b, 1);
        }
      }
    wgmma_commit();
    stage(s + kAhead);  // into the slot step s-1 left, started under this step's products
    cp_async_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < 9; ++t) fence_registers(acc[t]);
  }

  // this block's share of dW for its slab: rows (tap, ci), columns co, f32 pairs
  float* const out = partials + static_cast<size_t>(blockIdx.x) * 9 * cin * cout;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int ci = ci0 + 16 * warp + 8 * hf + lane / 4;
      if (ci >= cin) continue;
      float* const row = out + (static_cast<size_t>(t) * cin + ci) * cout;
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        const int co = co0 + wg * NT + 8 * j + 2 * (lane % 4);
        if (co < cout)
          *reinterpret_cast<float2*>(row + co) = make_float2(acc[t][4 * j + 2 * hf], acc[t][4 * j + 2 * hf + 1]);
      }
    }
}

template <int WG>
cudaError_t occupancy(int* smem, int* blocks_per_sm) {
  *smem = smem_bytes<WG>();
  cudaError_t err = cudaFuncSetAttribute(conv3x3_wgrad_wgmma_kernel<WG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, conv3x3_wgrad_wgmma_kernel<WG>,
                                                       128 * WG, *smem);
}

template <int WG>
cudaError_t launch(const void* x, const void* dy, float* partials, int b, int h, int w, int cin,
                   int cout, int n_slab, cudaStream_t stream) {
  constexpr int smem = smem_bytes<WG>();
  cudaError_t err = cudaFuncSetAttribute(conv3x3_wgrad_wgmma_kernel<WG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_h = (h + 7) / 8, tiles_w = (w + TW - 1) / TW;
  const long long n_tiles_ll = static_cast<long long>(b) * tiles_h * tiles_w;
  if (n_tiles_ll > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int n_tiles = static_cast<int>(n_tiles_ll);
  if (n_slab > n_tiles) return cudaErrorInvalidValue;
  const int n_ci = (cin + kCiGroup - 1) / kCiGroup, n_co = (cout + WG * NT - 1) / (WG * NT);
  const dim3 grid(n_slab, n_ci * n_co);
  conv3x3_wgrad_wgmma_kernel<WG><<<grid, 128 * WG, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy), partials, h, w,
      cin, cout, tiles_h, tiles_w, n_tiles, n_co);
  return cudaGetLastError();
}

}  // namespace

// Shared memory per block (bytes) and resident blocks per SM of the instantiation with wg
// warpgroups per block (1 or 2).
extern "C" int conv3x3_wgrad_wgmma_occupancy(int wg, int* smem, int* blocks_per_sm) {
  switch (wg) {
    case 1: return static_cast<int>(occupancy<1>(smem, blocks_per_sm));
    case 2: return static_cast<int>(occupancy<2>(smem, blocks_per_sm));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x: contiguous bf16 [b, h, w, cin]; dy: contiguous bf16 [b, h, w, cout]; both 16-byte
// aligned, cin and cout multiples of 8; partials: contiguous f32 [n_slab, 9*cin, cout], every
// entry of which is written; n_slab at most the number of 8 x 16-pixel tiles. wg: warpgroups
// per block (1 or 2), the caller's choice.
extern "C" int conv3x3_wgrad_wgmma(const void* x, const void* dy, void* partials, int b, int h,
                                   int w, int cin, int cout, int n_slab, int wg, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* const out = static_cast<float*>(partials);
  if (b < 1 || h < 1 || w < 1 || cin < 8 || cout < 8 || cin % 8 != 0 || cout % 8 != 0 ||
      n_slab < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (wg) {
    case 1: return static_cast<int>(launch<1>(x, dy, out, b, h, w, cin, cout, n_slab, st));
    case 2: return static_cast<int>(launch<2>(x, dy, out, b, h, w, cin, cout, n_slab, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
