// Filter gradient of the 3x3 stride-1 SAME convolution for Hopper (sm_90a),
// f32-FMA kernel: the f32 (parity) route, and bf16 views whose base address
// is not 16-byte aligned. Aligned bf16 operands take the tensor-core kernel
// of conv3x3_wgrad_wgmma.cu (ops/kernels/conv3x3.py:wgrad_kernel).
//
// Replaces the TPU kernel pti_ldm_vae_tpu/ops/pallas/conv2d.py
// (_conv3x3_dw_pallas, body _dw_kernel):
//   dW[(ky*3+kx)*Cin + ci, co] = sum over b, h, w of
//                                x[b, h+ky-1, w+kx-1, ci] * dy[b, h, w, co]
// in f32, for NHWC x and dy of type f32 (or unaligned bf16; x read as zero
// outside the image). It is a matrix product [9*Cin, B*H*W] x [B*H*W, Cout] with a small
// result (at most 1152 x 128 here) and a long reduction (524 288 pixels at
// 8x256x256).
//
// Bound on an H100: 2*9*Cin*Cout FLOP per pixel, x and dy read once; in f32
// the products run on the CUDA cores' 67 TFLOP/s, as FMAs.
//
// Design. The TPU kernel adds into one resident [9*Cin, Cout] block across a
// sequential grid. Blocks on a GPU run in no order, so here the pixels are cut
// into n_slab slabs of consecutive 4 x 32 tiles; a block of 256 threads owns
// one slab, 16 input channels and TC output channels (TC = 64, 32 or 16),
// keeps its [9, 16, TC] share of dW in registers (9 * TC/16 sums a thread)
// over all tiles of its slab, and writes it once to partials[slab]. The
// caller folds the partials over the slabs in a fixed order: no atomics, so
// two runs give the same bits. Per tile the block stages the 6 x 34 halo of x
// for its 16 channels (channel-major) and the 128 x TC tile of dy in shared
// memory as f32. A thread is (input channel ci, group of TC/16 output
// channels); it slides a 3 x 3 window of x along each row, so a pixel costs
// 3 scalar shared loads of x and one vector load of dy for 9 * TC/16 FMAs.
// Half-warps share an x address (broadcast). Channel tiles and ragged edges
// are masked; global offsets are 64-bit.
//
// C interface (loaded with ctypes): conv3x3_wgrad returns cudaGetLastError()
// after the launch; any other value than 0 is a failure.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 4;
constexpr int kTileW = 32;
constexpr int kThreads = 256;
constexpr int kCi = 16;                               // input channels per block
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloStride = kHaloH * kHaloW + 1;      // odd: channel-major stores spread over banks
static_assert((kCi * kHaloStride) % 4 == 0, "the dy tile must start 16-byte aligned");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int CPT>
constexpr int smem_floats() {
  return kCi * kHaloStride + kTileH * kTileW * 16 * CPT;
}

// CPT: output channels per thread; the block's output-channel tile is 16 * CPT.
template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads)
conv3x3_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     float* __restrict__ partials, int h, int w, int cin, int cout, int tiles_h,
                     int tiles_w, int n_tiles, int tiles_per_slab) {
  constexpr int TC = 16 * CPT;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                               // [kCi][kHaloStride]
  float* gs = smem + kCi * kHaloStride;           // [kTileH*kTileW][TC]; the offset is 16-byte aligned

  const int tid = threadIdx.x;
  const int cog = tid % 16;                       // output channels cog*CPT ..
  const int cil = tid / 16;                       // input channel within the block
  const int ci0 = blockIdx.y * kCi;
  const int co0 = blockIdx.z * TC;
  const int live = min(kCi, cin - ci0);

  float acc[9][CPT];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[t][c] = 0.f;

  const int first = blockIdx.x * tiles_per_slab;
  const int last = min(n_tiles, first + tiles_per_slab);
  for (int tile = first; tile < last; ++tile) {
    const int b = tile / (tiles_h * tiles_w);
    const int rest = tile % (tiles_h * tiles_w);
    const int th0 = (rest / tiles_w) * kTileH, tw0 = (rest % tiles_w) * kTileW;
    const size_t img = static_cast<size_t>(b) * h * w;

    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kHaloH * kHaloW * live; i += kThreads) {
      const int ci = i % live, p = i / live;
      const int gh = th0 + p / kHaloW - 1, gw = tw0 + p % kHaloW - 1;
      float v = 0.f;
      if (gh >= 0 && gh < h && gw >= 0 && gw < w)
        v = to_f32(x[(img + static_cast<size_t>(gh) * w + gw) * cin + ci0 + ci]);
      xs[ci * kHaloStride + p] = v;
    }
    for (int i = tid; i < kTileH * kTileW * TC; i += kThreads) {
      const int co = i % TC, p = i / TC;
      const int gh = th0 + p / kTileW, gw = tw0 + p % kTileW;
      float v = 0.f;
      if (gh < h && gw < w && co0 + co < cout)
        v = to_f32(dy[(img + static_cast<size_t>(gh) * w + gw) * cout + co0 + co]);
      gs[i] = v;
    }
    __syncthreads();

    if (cil < live) {
      const float* xc = xs + cil * kHaloStride;
#pragma unroll
      for (int r = 0; r < kTileH; ++r) {
        // window columns: left = halo column c, mid = c + 1, right = c + 2
        float left[3], mid[3], right[3];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          left[ky] = xc[(r + ky) * kHaloW];
          mid[ky] = xc[(r + ky) * kHaloW + 1];
        }
#pragma unroll 8
        for (int c = 0; c < kTileW; ++c) {
          const float* grow = gs + (r * kTileW + c) * TC + cog * CPT;
          float gv[CPT];
          if constexpr (CPT == 4) {
            const float4 t = *reinterpret_cast<const float4*>(grow);
            gv[0] = t.x; gv[1] = t.y; gv[2] = t.z; gv[3] = t.w;
          } else if constexpr (CPT == 2) {
            const float2 t = *reinterpret_cast<const float2*>(grow);
            gv[0] = t.x; gv[1] = t.y;
          } else {
#pragma unroll
            for (int k = 0; k < CPT; ++k) gv[k] = grow[k];
          }
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
            right[ky] = xc[(r + ky) * kHaloW + c + 2];
#pragma unroll
            for (int k = 0; k < CPT; ++k) {
              acc[ky * 3 + 0][k] = fmaf(left[ky], gv[k], acc[ky * 3 + 0][k]);
              acc[ky * 3 + 1][k] = fmaf(mid[ky], gv[k], acc[ky * 3 + 1][k]);
              acc[ky * 3 + 2][k] = fmaf(right[ky], gv[k], acc[ky * 3 + 2][k]);
            }
            left[ky] = mid[ky];
            mid[ky] = right[ky];
          }
        }
      }
    }
  }

  if (cil < live) {
    float* out = partials + static_cast<size_t>(blockIdx.x) * 9 * cin * cout;
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int co = co0 + cog * CPT + k;
        if (co < cout) out[(static_cast<size_t>(t) * cin + ci0 + cil) * cout + co] = acc[t][k];
      }
  }
}

template <typename T, int CPT>
cudaError_t launch(const void* x, const void* dy, float* partials, int b, int h, int w, int cin,
                   int cout, int n_slab, cudaStream_t stream) {
  constexpr int TC = 16 * CPT;
  constexpr int smem = smem_floats<CPT>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(conv3x3_wgrad_kernel<T, CPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_h = (h + kTileH - 1) / kTileH, tiles_w = (w + kTileW - 1) / kTileW;
  const long long n_tiles_ll = static_cast<long long>(b) * tiles_h * tiles_w;
  if (n_tiles_ll > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int n_tiles = static_cast<int>(n_tiles_ll);
  const int tiles_per_slab = (n_tiles + n_slab - 1) / n_slab;
  const dim3 grid(n_slab, (cin + kCi - 1) / kCi, (cout + TC - 1) / TC);
  conv3x3_wgrad_kernel<T, CPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), partials, h, w, cin, cout, tiles_h,
      tiles_w, n_tiles, tiles_per_slab);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dy, float* partials, int b, int h, int w, int cin,
                     int cout, int n_slab, cudaStream_t stream) {
  if (cout <= 16) return launch<T, 1>(x, dy, partials, b, h, w, cin, cout, n_slab, stream);
  if (cout <= 32) return launch<T, 2>(x, dy, partials, b, h, w, cin, cout, n_slab, stream);
  return launch<T, 4>(x, dy, partials, b, h, w, cin, cout, n_slab, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x: contiguous [b, h, w, cin]; dy: contiguous
// [b, h, w, cout] of x's type; partials: contiguous f32 [n_slab, 9*cin, cout], every
// entry of which is written (a slab past the last tile writes zeros).
extern "C" int conv3x3_wgrad(const void* x, const void* dy, void* partials, int b, int h, int w,
                             int cin, int cout, int n_slab, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* const out = static_cast<float*>(partials);
  cudaError_t err;
  if (b < 1 || h < 1 || w < 1 || cin < 1 || cout < 1 || n_slab < 1 || cin > 65535 * kCi) {
    err = cudaErrorInvalidValue;
  } else if (dtype == 0) {
    err = dispatch<float>(x, dy, out, b, h, w, cin, cout, n_slab, st);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(x, dy, out, b, h, w, cin, cout, n_slab, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
