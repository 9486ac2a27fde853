// 3x3 stride-1 SAME convolution for Hopper (sm_90a), NHWC, f32 and bf16.
//
// Replaces the TPU kernel pti_ldm_vae_tpu/ops/pallas/conv2d.py
// (_conv3x3_fwd_pallas, body _fwd_kernel): y[b,h,w,:] = sum over the nine
// taps of x[b,h+ky-1,w+kx-1,:] @ W[ky,kx], with the weights given as the
// tap-major matrix [9*Cin, Cout] (row (ky*3+kx)*Cin + ci), products and sums
// in f32, the output rounded once to x's type, no bias. Given dy and the
// spatially flipped, channel-transposed matrix [9*Cout, Cin] the same kernel
// computes the input gradient.
//
// Bound on an H100: 2*9*Cin*Cout FLOP per output pixel. At 8x256x256x32->32
// that is 9.66 GFLOP on 67 MB of bf16 input and output: bytes-bound in bf16
// against the tensor cores' 989 TFLOP/s, operations-bound in f32 against the
// CUDA cores' 67 TFLOP/s. This first kernel is an implicit GEMM on f32 FMAs
// for both types, so it is measured against the f32 rate; wgmma on bf16
// tiles fed by TMA is later work.
//
// Design. The TPU kernel holds one whole padded image in VMEM per grid step
// (grid = batch); a Hopper block has 227 KB and the card has 132 SMs, so here
// a block of 256 threads owns an output tile of 4 rows x 32 columns x TC
// output channels (TC = 64, 32 or 8, the smallest that covers Cout, else 64)
// of one image. It walks Cin in chunks of 16: per chunk it stages the 6 x 34
// input halo tile (zero outside the image: the padding is a mask, no padded
// copy) channel-major in shared memory and the [9, 16, TC] weight slab, the
// on-chip im2col. A warp is one group of TC/8 output channels; lane l owns
// column l of the tile's four rows. Per input channel a thread loads its 6x3
// window once and reuses it for the nine taps: 18 + 9*TC/8/4 shared loads
// (weights as broadcast vectors) for 36*TC/8 FMAs. Channel tiles, the last
// Cin chunk and the ragged right and bottom edges are masked; no load assumes
// a channel count divisible by anything. Global offsets are 64-bit.
//
// C interface (loaded with ctypes): conv3x3_fwd returns cudaGetLastError()
// after the launch; any other value than 0 is a failure.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 4;
constexpr int kTileW = 32;
constexpr int kThreads = 256;
constexpr int kChunk = 16;                           // input channels per stage
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloStride = kHaloH * kHaloW + 1;     // odd: channel-major stores spread over banks

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int CPT>
constexpr int smem_floats() {
  return kChunk * kHaloStride + 9 * kChunk * 8 * CPT;
}

// CPT: output channels per thread; the block's channel tile is 8 * CPT.
template <typename T, int CPT>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ wmat, T* __restrict__ y,
               int h, int w, int cin, int cout, int tiles_w) {
  constexpr int TC = 8 * CPT;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // [kChunk][kHaloStride]
  float* ws = smem + kChunk * kHaloStride;   // [9][kChunk][TC]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int cg = tid / 32;                   // channel group: channels cg*CPT ..
  const int th0 = (blockIdx.x / tiles_w) * kTileH;
  const int tw0 = (blockIdx.x % tiles_w) * kTileW;
  const int co0 = blockIdx.y * TC;
  const size_t img = static_cast<size_t>(blockIdx.z) * h * w;

  float acc[kTileH][CPT];
#pragma unroll
  for (int j = 0; j < kTileH; ++j)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[j][c] = 0.f;

  for (int c0 = 0; c0 < cin; c0 += kChunk) {
    const int live = min(kChunk, cin - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < kHaloH * kHaloW * live; i += kThreads) {
      const int ci = i % live, p = i / live;
      const int gh = th0 + p / kHaloW - 1, gw = tw0 + p % kHaloW - 1;
      float v = 0.f;
      if (gh >= 0 && gh < h && gw >= 0 && gw < w)
        v = to_f32(x[(img + static_cast<size_t>(gh) * w + gw) * cin + c0 + ci]);
      xs[ci * kHaloStride + p] = v;
    }
    for (int i = tid; i < 9 * live * TC; i += kThreads) {
      const int co = i % TC, ci = (i / TC) % live, tap = i / (TC * live);
      float v = 0.f;
      if (co0 + co < cout)
        v = to_f32(wmat[(static_cast<size_t>(tap) * cin + c0 + ci) * cout + co0 + co]);
      ws[(tap * kChunk + ci) * TC + co] = v;
    }
    __syncthreads();

    for (int ci = 0; ci < live; ++ci) {
      float xv[kHaloH][3];
#pragma unroll
      for (int r = 0; r < kHaloH; ++r)
#pragma unroll
        for (int k = 0; k < 3; ++k) xv[r][k] = xs[ci * kHaloStride + r * kHaloW + lane + k];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* wrow = ws + ((ky * 3 + kx) * kChunk + ci) * TC + cg * CPT;
          float wv[CPT];
          if constexpr (CPT % 4 == 0) {
#pragma unroll
            for (int c = 0; c < CPT; c += 4) {
              const float4 t = *reinterpret_cast<const float4*>(wrow + c);
              wv[c] = t.x; wv[c + 1] = t.y; wv[c + 2] = t.z; wv[c + 3] = t.w;
            }
          } else {
#pragma unroll
            for (int c = 0; c < CPT; ++c) wv[c] = wrow[c];
          }
#pragma unroll
          for (int j = 0; j < kTileH; ++j)
#pragma unroll
            for (int c = 0; c < CPT; ++c) acc[j][c] = fmaf(xv[j + ky][kx], wv[c], acc[j][c]);
        }
    }
  }

  const int gw = tw0 + lane;
  if (gw >= w) return;
#pragma unroll
  for (int j = 0; j < kTileH; ++j) {
    const int gh = th0 + j;
    if (gh >= h) break;
    T* out = y + (img + static_cast<size_t>(gh) * w + gw) * cout + co0 + cg * CPT;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      if (co0 + cg * CPT + c < cout) out[c] = from_f32<T>(acc[j][c]);
  }
}

template <typename T, int CPT>
cudaError_t launch(const void* x, const void* wmat, void* y, int b, int h, int w, int cin,
                   int cout, cudaStream_t stream) {
  constexpr int TC = 8 * CPT;
  constexpr int smem = smem_floats<CPT>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(conv3x3_kernel<T, CPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_h = (h + kTileH - 1) / kTileH, tiles_w = (w + kTileW - 1) / kTileW;
  const dim3 grid(tiles_h * tiles_w, (cout + TC - 1) / TC, b);
  conv3x3_kernel<T, CPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wmat), static_cast<T*>(y), h, w, cin, cout,
      tiles_w);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* wmat, void* y, int b, int h, int w, int cin,
                     int cout, cudaStream_t stream) {
  if (cout <= 8) return launch<T, 1>(x, wmat, y, b, h, w, cin, cout, stream);
  if (cout <= 32) return launch<T, 4>(x, wmat, y, b, h, w, cin, cout, stream);
  return launch<T, 8>(x, wmat, y, b, h, w, cin, cout, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x: contiguous [b, h, w, cin]; wmat: contiguous
// [9*cin, cout] of x's type; y: contiguous [b, h, w, cout] of x's type. b <= 65535.
extern "C" int conv3x3_fwd(const void* x, const void* wmat, void* y, int b, int h, int w, int cin,
                           int cout, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (b < 1 || h < 1 || w < 1 || cin < 1 || cout < 1 || b > 65535) {
    err = cudaErrorInvalidValue;
  } else if (dtype == 0) {
    err = dispatch<float>(x, wmat, y, b, h, w, cin, cout, st);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(x, wmat, y, b, h, w, cin, cout, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
