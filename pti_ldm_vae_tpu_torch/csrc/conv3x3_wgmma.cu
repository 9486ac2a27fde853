// 3x3 stride-1 SAME convolution for Hopper (sm_90a), NHWC, bf16, on the
// tensor cores: an implicit GEMM on wgmma fed by asynchronous copies.
//
// Replaces the TPU kernel pti_ldm_vae_tpu/ops/pallas/conv2d.py
// (_conv3x3_fwd_pallas, body _fwd_kernel) for bf16 operands: y[b,h,w,:] = sum
// over the nine taps of x[b,h+ky-1,w+kx-1,:] @ W[ky,kx], weights as the
// tap-major matrix [9*Cin, Cout] (row (ky*3+kx)*Cin + ci), bf16 products
// summed in f32, the output rounded once to bf16, no bias. On dy with the
// spatially flipped, channel-transposed matrix the same kernel computes the
// input gradient. It takes every Cin that is a multiple of 8 up to kMaxCin =
// 1520; the wrapper (ops/kernels/conv3x3.py) pads a thinner or ragged Cin
// (1, 4, 10, 20) with zero channels up to the next multiple of 8, x as well as
// each tap's rows of the matrix. f32 operands, unaligned bf16 ones and Cin
// above kMaxCin stay on the f32-FMA kernel of conv3x3.cu.
//
// Bound on an H100: 2*9*Cin*Cout FLOP per output pixel against 989 TFLOP/s
// of bf16 tensor-core rate, and 2*(Cin + Cout) bytes per pixel against 3.35
// TB/s: the 32- and 64-channel levels of the VAE are bytes-bound, the 128-
// and 256-channel levels operations-bound (0.039 ms at 8 x 64^2 x 256 -> 256,
// 38.7 GFLOP). The f32-FMA kernel is bounded by the CUDA cores' 67 TFLOP/s
// instead and converts its operands to f32 on staging; this kernel keeps them
// in bf16 from global memory to the tensor cores.
//
// Design.
// - GEMM view: M = output pixels, N = output channels, K = 9 taps x Cin.
//   One wgmma M-tile of 64 rows is an 8 x 8 patch of pixels of one image.
//   A block is one warpgroup (128 threads); a tile is MT patches side by side
//   (8 rows x 8*MT columns) by TN output channels, its accumulators MT * TN /
//   2 f32 registers per thread.
// - Weights stay, pixels stream. What a block pulls from L2 is scarcer here
//   than tensor-core time, and a [9, 16, TN] weight slab per chunk is larger
//   than the halo tile it multiplies: restaging it with every tile costs more
//   traffic than the pixels do. A block therefore loads the whole [9, Cin,
//   TN] slab of its output channels once and walks over many tiles (a
//   persistent grid: blocks = resident blocks per SM x SMs, shared out over
//   the N-groups, tile t, t + blocks, ...), streaming only halo tiles.
// - The slab is 9 * (TN/8) * (16 * Cin + 16) bytes (Cin rounded up to whole
//   steps of KC): at TN 64 it fits up to Cin 128 (148,608 bytes); at Cin 256
//   only TN 32 fits (148,032 bytes), at Cin 512 TN 16 (147,744), and TN 8
//   carries Cin up to kMaxCin (1520: 219,024 bytes, with a ring of 16 channels
//   and one patch per tile). So the caller (wgmma_tile) narrows the block's
//   output columns as Cin grows, and the halo of a tile is staged once per
//   N-group: 8 times over at 256 -> 256 (TN 32) against 2 times at 128 -> 128
//   (TN 64). At Cin 256 that restaging (~180 MB of L2 reads at 8 x 64^2 x 256
//   -> 256), the narrow m64n32k16 products (their A operand is read from
//   shared memory once per 32 output columns instead of 64) and the copies'
//   waits bound the kernel (PERF.md, row 6, measures it). So those shapes
//   (Cin above 176, Cout 64 or more) go to conv3x3_stream_wgmma.cu instead,
//   which streams the weights through a TMA ring at 128 output columns; this
//   kernel keeps Cin up to 176 and the narrow Cout.
// - A comes from the halo tile, with no im2col copy. Per step of KC input
//   channels (16, 32 or 64) the block stages the 10 x (8*MT+2) halo of its
//   tile as KC/8 planes of 8 channels, [plane][halo row][halo column][8
//   bf16]: a pixel is 16 bytes of a plane, 8 pixels of a halo row are one
//   core matrix of wgmma (hopper_mma.cuh), the next output row's core matrix
//   lies one halo row further (SBO), the next 8 channels one plane further
//   (LBO). A tap (ky, kx) is the same tile read from a descriptor whose start
//   address is moved by ky halo rows and kx pixels: the move is a multiple of
//   16 bytes and keeps the spacing, so the nine taps reuse one staged tile.
//   The 8 x 8 patch makes this hold at every image width, the W = 32 levels
//   included (a tile of 64 pixels of one row would span two rows there).
// - B is the weight slab as [tap][TN/8][Cin rows][8 bf16]: the global rows
//   are copied as they are, N contiguous, which is wgmma's MN-major B
//   (transpose bit set); 16 rows further per k16 product.
// - Staging is asynchronous: every 16-byte piece is one cp.async (zero-filled
//   outside the image, past Cin and past the padded Cout: the padding is a
//   mask, there is no padded copy). Halo tiles go through a ring of three
//   stages, loaded two (tile, chunk) steps ahead across tile boundaries and
//   started right behind the step's 9 * MT * KC/16 wgmmas, so that the copy
//   instructions are sent while the tensor cores work. The slab rides along
//   with the first tile: chunks 0 and 1 with its first two halo stages, the
//   rest in one group behind them. Pieces are handed to threads so that
//   global reads are contiguous (a pixel's KC channels are one run of 2*KC
//   bytes) and shared-memory writes spread over the banks (16 bytes of
//   padding after each plane and each of B's N-groups).
// - What bounds it at Cin <= 128 (tools/ablate_conv3x3_wgmma.py leaves parts
//   of the kernel out and times the rest): the products alone run near the
//   tensor cores' rate, but the halo copies hide under them only in part,
//   and about a third of the time is neither (the slab's copy, barriers,
//   waits). Each 16-byte piece of a pixel lies in another 128-byte line than
//   its neighbour pixel's, so a warp's copy instruction touches up to 16
//   lines. Deeper steps (KC 32, 64) make the runs longer and the barriers
//   fewer; one TMA box per stage (a 5-D map [B][H][W][C/8][8] writes this
//   very layout) would take the copies off the threads altogether, and a
//   second warpgroup per block would fill the first one's waits: both are
//   later work.
// - Epilogue, per tile: each warp rounds its 16 rows of a patch to bf16 into
//   a padded buffer of its own in shared memory and sends them out as
//   16-byte vectors, one contiguous run of TN channels per pixel, while the
//   next tiles' copies are in flight; rows, columns and channels past the
//   edges are masked (a Cout that is no multiple of 8 takes 2-byte stores).
// - Tiles: the caller (wgmma_tile in ops/kernels/conv3x3.py) picks TN = 8, 16,
//   32 or 64 (the smallest that covers Cout, else 64, narrowed until the slab
//   fits), MT = 4, 2 or 1 and KC. Shared memory per block: 9*(TN/8)*(16*Cin+16)
//   + 3*(KC/8)*plane(MT) + 64*(2*TN+16) bytes with plane(4) = 5520: 224,064 at
//   Cin 128, TN 64, MT 4, KC 32 and 219,392 at Cin 256, TN 32, MT 4, KC 32 (one
//   block per SM), 90,368 at Cin 32, TN 32, MT 4, KC 32 (two).
//
// The weight matrix arrives with its columns padded to a multiple of 8
// (ldw, zeros) so that every 16-byte piece of a row is aligned.
//
// C interface (loaded with ctypes): conv3x3_wgmma_fwd returns
// cudaGetLastError() after the launch; any other value than 0 is a failure.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 128;
constexpr int kHaloRows = 10;
constexpr int kStages = 3;     // halo ring
constexpr int kAhead = 2;      // steps loaded ahead of the one being multiplied

template <int MT>
__host__ __device__ constexpr int halo_cols() { return 8 * MT + 2; }
// one plane of 8 channels of a halo tile, padded to 16 bytes past a multiple of 128 so that
// copies of one pixel's planes spread over the banks
template <int MT>
__host__ __device__ constexpr int a_plane_bytes() {
  return (kHaloRows * halo_cols<MT>() * 16 + 127) / 128 * 128 + 16;
}
template <int TN>
__host__ __device__ constexpr int out_pitch() { return TN * 2 + 16; }  // bytes per pixel, epilogue
// one N-group of 8 output channels of one tap: 16 bytes per input channel of whole chunks,
// and padding
__host__ __device__ constexpr int group_bytes(int cin, int kc) {
  return (cin + kc - 1) / kc * kc * 16 + 16;
}
template <int MT, int TN, int KC>
__host__ __device__ constexpr int smem_bytes(int cin) {
  return 9 * (TN / 8) * group_bytes(cin, KC) + kStages * (KC / 8) * a_plane_bytes<MT>() +
         64 * out_pitch<TN>();
}

// KC: input channels per step (16, 32 or 64): KC/16 k16 products per tap and patch.
template <int MT, int TN, int KC>
__global__ void __launch_bounds__(kThreads)
conv3x3_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wmat,
                     __nv_bfloat16* __restrict__ y, int h, int w, int cin, int cout, int ldw,
                     int tiles_h, int tiles_w, int n_tiles) {
  constexpr int HC = halo_cols<MT>();
  constexpr int kPlane = a_plane_bytes<MT>();
  constexpr int NG = TN / 8;
  constexpr int kPitch = out_pitch<TN>();
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int PL = KC / 8;  // planes per stage
  const int n_chunks = (cin + KC - 1) / KC;
  const int kGroup = group_bytes(cin, KC);
  const uint32_t b_smem = smem_addr(smem);
  const uint32_t a_smem = b_smem + 9 * NG * kGroup;
  unsigned char* const out_smem = smem + 9 * NG * kGroup + kStages * PL * kPlane;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int co0 = blockIdx.y * TN;
  const int my_tiles = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int n_steps = my_tiles * n_chunks;  // a step: one chunk of one tile

  // the tile of this block's i-th turn: image and pixel origin
  auto tile_origin = [&](int i, int& img, int& th0, int& tw0) {
    const int t = blockIdx.x + i * gridDim.x;
    img = t / (tiles_h * tiles_w);
    const int r = t % (tiles_h * tiles_w);
    th0 = (r / tiles_w) * 8;
    tw0 = (r % tiles_w) * (8 * MT);
  };
  // halo tile of step s into its ring slot: piece i = (halo pixel, plane), the plane fastest
  // (a pixel's KC channels are 2*KC contiguous bytes)
  auto stage_halo = [&](int s) {
    if (s >= n_steps) return;
    int img, th0, tw0;
    tile_origin(s / n_chunks, img, th0, tw0);
    const int c0 = (s % n_chunks) * KC;
    const uint32_t base = a_smem + (s % kStages) * PL * kPlane;
    const size_t img_px = static_cast<size_t>(img) * h * w;
    for (int i = tid; i < PL * kHaloRows * HC; i += kThreads) {
      const int plane = i % PL, p = i / PL;
      const int r = p / HC, c = p % HC;
      const int gh = th0 + r - 1, gw = tw0 + c - 1;
      const int ci = c0 + 8 * plane;
      const bool live = gh >= 0 && gh < h && gw >= 0 && gw < w && ci < cin;
      const __nv_bfloat16* src =
          live ? x + (img_px + static_cast<size_t>(gh) * w + gw) * cin + ci : x;
      cp_async_16(base + plane * kPlane + p * 16, src, live);
    }
  };
  // chunks [first, last) of the weight slab: a thread keeps its N-group and walks the
  // rows of every tap (8 lanes copy one row's 128 contiguous bytes at TN 64)
  auto stage_weights = [&](int first, int last) {
    constexpr int kRowsPerPass = kThreads / NG;
    const int g = tid % NG, co = co0 + 8 * g;
    const bool col_live = co < ldw;
    for (int tap = 0; tap < 9; ++tap) {
      const __nv_bfloat16* src = wmat + static_cast<size_t>(tap) * cin * ldw + co;
      const uint32_t dst = b_smem + (tap * NG + g) * kGroup;
      for (int k = first * KC + tid / NG; k < last * KC; k += kRowsPerPass) {
        const bool live = col_live && k < cin;
        cp_async_16(dst + k * 16, live ? src + static_cast<size_t>(k) * ldw : wmat, live);
      }
    }
  };

  // groups 0 and 1: the first two steps with their slab chunks; group 2: the rest of the slab
  stage_weights(0, 1);
  stage_halo(0);
  cp_async_commit();
  if (n_chunks > 1) stage_weights(1, 2);
  stage_halo(1);
  cp_async_commit();
  if (n_chunks > 2) stage_weights(2, n_chunks);
  cp_async_commit();

  float acc[MT][TN / 2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[m][i] = 0.f;

  for (int s = 0; s < n_steps; ++s) {
    // groups so far: the three above and one per earlier step (the halo two steps on).
    // Step 0 needs group 0, step 1 group 1, every later step all but the newest.
    if (s < 2) {
      cp_async_wait<2>();
    } else {
      cp_async_wait<1>();
    }
    fence_proxy_async();
    __syncthreads();  // every thread's pieces of this step have landed; step s-1 is consumed

    const int chunk = s % n_chunks;
    const uint32_t a_base = a_smem + (s % kStages) * PL * kPlane;
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_registers(acc[m]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      // (channels past Cin are zero fill on both sides: their products add nothing)
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap % 3;
        // B: 16 rows of depth (two groups of 8, 128 bytes apart) x TN columns (N-groups)
        const uint64_t desc_b = make_desc(
            b_smem + tap * NG * kGroup + (chunk * KC + 16 * kk) * 16, 128, kGroup);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          // A: 8 output rows (one halo row apart) x 8 pixels; depth: two planes
          const uint64_t desc_a = make_desc(
              a_base + 2 * kk * kPlane + (ky * HC + 8 * m + kx) * 16, kPlane, HC * 16);
          WgmmaSS<TN, 0, 1>::run(acc[m], desc_a, desc_b, 1);
        }
      }
    }
    wgmma_commit();
    stage_halo(s + kAhead);  // into the slot step s-1 left, started under this step's products
    cp_async_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_registers(acc[m]);
    if (chunk + 1 < n_chunks) continue;

    // epilogue of the tile: each warp's 16 rows of a patch -> its padded bf16 buffer -> global
    int img, th0, tw0;
    tile_origin(s / n_chunks, img, th0, tw0);
    const size_t img_px = static_cast<size_t>(img) * h * w;
    unsigned char* const mine = out_smem + warp * 16 * kPitch;
    const bool vector_ok = cout % 8 == 0;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          const uint32_t v = pack_bf16(acc[m][4 * j + 2 * half], acc[m][4 * j + 2 * half + 1]);
          *reinterpret_cast<uint32_t*>(mine + (8 * half + lane / 4) * kPitch +
                                       (8 * j + 2 * (lane % 4)) * 2) = v;
          acc[m][4 * j + 2 * half] = 0.f;
          acc[m][4 * j + 2 * half + 1] = 0.f;
        }
      __syncwarp();
      for (int i = lane; i < 16 * NG; i += 32) {
        const int g = i % NG, r = i / NG;  // row r of the warp's 16: patch row 2*warp + r/8
        const int gh = th0 + 2 * warp + r / 8, gw = tw0 + 8 * m + r % 8, co = co0 + 8 * g;
        if (gh >= h || gw >= w || co >= cout) continue;
        const unsigned char* src = mine + r * kPitch + g * 16;
        __nv_bfloat16* dst = y + (img_px + static_cast<size_t>(gh) * w + gw) * cout + co;
        if (vector_ok) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          const __nv_bfloat16* e_src = reinterpret_cast<const __nv_bfloat16*>(src);
          for (int e = 0; e < 8 && co + e < cout; ++e) dst[e] = e_src[e];
        }
      }
      __syncwarp();
    }
  }
}

constexpr int kMaxSmem = 232448;  // what a block may ask for on sm_90
// the widest Cin whose slab fits in shared memory: at TN 8, beside the smallest ring
constexpr int kMaxCin = 1520;
static_assert(smem_bytes<1, 8, 16>(kMaxCin) <= kMaxSmem &&
                  smem_bytes<1, 8, 16>(kMaxCin + 8) > kMaxSmem,
              "kMaxCin is the widest multiple of 8 that fits");

// Shared memory per block and resident blocks per SM of an instantiation at this Cin. The
// kernel's shared-memory limit is raised once per device, the occupancy asked once per
// number of chunks (the writes to the caches are idempotent).
template <int MT, int TN, int KC>
cudaError_t occupancy(int cin, int* smem, int* blocks_per_sm, int* n_sm) {
  static int raised_on = -1, sm_count = 0;
  static int cached[kMaxCin / 16 + 1] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (raised_on != device) {
    err = cudaFuncSetAttribute(conv3x3_wgmma_kernel<MT, TN, KC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<MT, TN, KC>(kMaxCin) < kMaxSmem ? smem_bytes<MT, TN, KC>(kMaxCin)
                                                                       : kMaxSmem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    for (int& c : cached) c = 0;
    raised_on = device;
  }
  *smem = smem_bytes<MT, TN, KC>(cin);
  *n_sm = sm_count;
  *blocks_per_sm = 0;
  if (*smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  int& slot = cached[(cin + 15) / 16];
  if (slot == 0) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, conv3x3_wgmma_kernel<MT, TN, KC>,
                                                        kThreads, *smem);
    if (err != cudaSuccess) return err;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    slot = blocks;
  }
  *blocks_per_sm = slot;
  return cudaSuccess;
}

template <int MT, int TN, int KC>
cudaError_t launch(const void* x, const void* wmat, void* y, int b, int h, int w, int cin,
                   int cout, int ldw, cudaStream_t stream) {
  int smem = 0, blocks_per_sm = 0, n_sm = 0;
  const cudaError_t err = occupancy<MT, TN, KC>(cin, &smem, &blocks_per_sm, &n_sm);
  if (err != cudaSuccess) return err;
  const int tiles_h = (h + 7) / 8, tiles_w = (w + 8 * MT - 1) / (8 * MT);
  const int n_tiles = b * tiles_h * tiles_w;
  const int n_groups = (cout + TN - 1) / TN;
  // persistent: as many blocks as the card holds at once, shared out over the N-groups (no
  // more: a block beyond them would start only when another ends, and double the time)
  int walkers = blocks_per_sm * n_sm / n_groups;
  if (walkers < 1) walkers = 1;
  if (walkers > n_tiles) walkers = n_tiles;
  const dim3 grid(walkers, n_groups);
  conv3x3_wgmma_kernel<MT, TN, KC><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wmat),
      static_cast<__nv_bfloat16*>(y), h, w, cin, cout, ldw, tiles_h, tiles_w, n_tiles);
  return cudaGetLastError();
}

}  // namespace

#define PTI_FOR_KC(CASE, TN, KC) CASE(4, TN, KC) CASE(2, TN, KC) CASE(1, TN, KC)
#define PTI_FOR_TN(CASE, KC) \
  PTI_FOR_KC(CASE, 64, KC) PTI_FOR_KC(CASE, 32, KC) PTI_FOR_KC(CASE, 16, KC) PTI_FOR_KC(CASE, 8, KC)
#define PTI_FOR_EACH_TILE(CASE) PTI_FOR_TN(CASE, 16) PTI_FOR_TN(CASE, 32) PTI_FOR_TN(CASE, 64)

// Shared memory per block (bytes) and resident blocks per SM of the instantiation with
// mt patches per tile (4, 2, 1), tn output channels per block (64, 32, 16, 8) and kc input
// channels per step (16, 32, 64), at cin input channels; cudaErrorInvalidConfiguration
// (9) with blocks_per_sm 0 where it does not fit.
extern "C" int conv3x3_wgmma_occupancy(int mt, int tn, int kc, int cin, int* smem,
                                       int* blocks_per_sm) {
  cudaError_t err = cudaErrorInvalidValue;
  int n_sm = 0;
  if (cin < 8 || cin > kMaxCin) return static_cast<int>(err);
#define PTI_CASE(MT, TN, KC) \
  if (mt == MT && tn == TN && kc == KC) err = occupancy<MT, TN, KC>(cin, smem, blocks_per_sm, &n_sm);
  PTI_FOR_EACH_TILE(PTI_CASE)
#undef PTI_CASE
  return static_cast<int>(err);
}

// x: contiguous bf16 [b, h, w, cin], cin a multiple of 8 up to kMaxCin (the weight slab of
// a block stays in shared memory); wmat: contiguous bf16 [9*cin, ldw], ldw a multiple of 8,
// columns cout .. ldw-1 zero; y: contiguous bf16 [b, h, w, cout]; x and wmat 16-byte
// aligned. The tile is the caller's choice: mt patches of 8 x 8 pixels side by side (4, 2
// or 1), tn output channels per block (64, 32, 16 or 8), kc input channels per step (16,
// 32 or 64); it must fit in shared memory (conv3x3_wgmma_occupancy).
extern "C" int conv3x3_wgmma_fwd(const void* x, const void* wmat, void* y, int b, int h, int w,
                                 int cin, int cout, int ldw, int mt, int tn, int kc,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || h < 1 || w < 1 || cin < 8 || cin % 8 != 0 || cout < 1 || ldw < cout ||
      ldw % 8 != 0 || cin > kMaxCin)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
#define PTI_CASE(MT, TN, KC) \
  if (mt == MT && tn == TN && kc == KC) \
    err = launch<MT, TN, KC>(x, wmat, y, b, h, w, cin, cout, ldw, st);
  PTI_FOR_EACH_TILE(PTI_CASE)
#undef PTI_CASE
  return static_cast<int>(err);
}
