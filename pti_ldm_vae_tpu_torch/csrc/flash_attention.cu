// Flash-attention forward for Hopper (sm_90a), f32 and bf16 inputs.
//
// Replaces the TPU kernel pti_ldm_vae_tpu/ops/pallas/flash_attention.py
// (_forward, body _kernel): softmax(q k^T * d^-0.5) v over [B, H, S, D]
// tensors, self-attention only (k and v have q's length S), online softmax
// with the running max and sum in f32. When the caller passes a buffer it also
// writes each row's logsumexp of the scaled scores, lse = m + log(l), [B*H, S]
// f32, which the backward (flash_attention_bwd.cu) reads to recompute p.
//
// Bound on an H100: at the VAE bottleneck ([8, 1, 1024, 128]) one call does
// 4*B*H*S^2*D = 4.3 GFLOP on 8 MB of bf16 inputs, ~540 FLOP per byte, so the
// bound is arithmetic. This first kernel computes both products, q.k^T and
// p.v, with f32 FMAs from shared memory (f32 CUDA-core peak 67 TFLOP/s, not
// the 989 TFLOP/s of the bf16 tensor cores): simple and exact to f32, and
// slow. Moving the two products onto wgmma with TMA-fed tiles is later work.
//
// Design: one block of 256 threads per (b*h, q-tile of 64 rows). The block
// keeps its q tile (pre-scaled by d^-0.5) in shared memory and walks the kv
// sequence in tiles of 64 rows staged in shared memory (converted to f32 on
// load). Per kv tile: S = q k^T (each thread a 4x4 patch), then one warp per
// 8 rows updates the running max m, the correction exp(m_old - m_new) and the
// running sum l, writing p = exp(s - m_new) back in place; then every thread
// rescales and accumulates its 4 x D/16 patch of the output in registers.
// Rows and columns past S (the ragged last tile) are masked: q rows are
// zero-filled and never stored, k columns score -inf and so weigh 0. Shared
// memory is ~113 KB at D=128 in f32 tiles, above the 48 KB static limit, so
// the launcher raises the kernel's dynamic shared-memory limit first.
//
// Head dims 16, 32, 64, 128 and 256. D = 256 (one head over the 256 channels
// of a 64-128-256 VAE's mid block) takes this kernel in both types, since the
// tensor-core kernel stops at 128: 214,272 bytes of shared memory, one block
// per SM, 16 output columns of f32 accumulators a thread.
//
// C interface (loaded with ctypes): flash_attention_fwd returns
// cudaGetLastError() after the launch; any other value than 0 is a failure.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

template <int D>
constexpr int smem_floats() {
  // q [BQ][D] + k [BK][D+1] + v [BK][D] + p [BQ][BK+1] + m, l, correction [BQ]
  return kBlockQ * D + kBlockK * (D + 1) + kBlockK * D + kBlockQ * (kBlockK + 1) + 3 * kBlockQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int s, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kPadK = D + 1;        // odd row stride: column reads hit distinct banks
  constexpr int kPadP = kBlockK + 1;
  constexpr int kCols = D / 16;       // output columns per thread

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockQ * D;
  float* vs = ks + kBlockK * kPadK;
  float* ps = vs + kBlockK * D;
  float* row_m = ps + kBlockQ * kPadP;
  float* row_l = row_m + kBlockQ;
  float* row_c = row_l + kBlockQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;            // column group
  const int ty = tid / 16;            // rows ty*4 .. ty*4+3
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * kBlockQ;
  const size_t base = static_cast<size_t>(blockIdx.y) * s * D;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D;
    qs[i] = (q0 + r < s) ? to_f32(q[base + static_cast<size_t>(q0) * D + i]) * scale : 0.f;
  }
  if (tid < kBlockQ) {
    row_m[tid] = -CUDART_INF_F;
    row_l[tid] = 0.f;
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < s; k0 += kBlockK) {
    __syncthreads();  // the previous tile's p and v are consumed
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool live = k0 + r < s;
      const size_t g = base + static_cast<size_t>(k0) * D + i;
      ks[r * kPadK + c] = live ? to_f32(k[g]) : 0.f;
      vs[i] = live ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty*4+i, columns tx+16*j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * kPadK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        ps[(ty * 4 + i) * kPadP + col] = (k0 + col < s) ? sc[i][j] : -CUDART_INF_F;
      }
    __syncthreads();

    // online softmax: warp w owns rows w*8 .. w*8+7, two columns per lane
    for (int rr = 0; rr < kBlockQ / kWarps; ++rr) {
      const int row = warp * (kBlockQ / kWarps) + rr;
      const float a = ps[row * kPadP + lane];
      const float b = ps[row * kPadP + lane + 32];
      float mx = fmaxf(a, b);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = row_m[row];
      const float m_new = fmaxf(m_old, mx);  // finite: every tile has a live column
      const float pa = expf(a - m_new);
      const float pb = expf(b - m_new);
      float sum = pa + pb;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ps[row * kPadP + lane] = pa;
      ps[row * kPadP + lane + 32] = pb;
      __syncwarp();
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        row_c[row] = c;
        row_l[row] = row_l[row] * c + sum;
        row_m[row] = m_new;
      }
    }
    __syncthreads();

    // out = out * correction + p v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = row_c[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= c;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * kPadP + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = vs[kk * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < s) {
      const float inv = 1.f / row_l[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        out[base + static_cast<size_t>(row) * D + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
      if (lse != nullptr && tx == 0)
        lse[static_cast<size_t>(blockIdx.y) * s + row] = row_m[ty * 4 + i] + logf(row_l[ty * 4 + i]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                   int s, float scale, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, s, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                     int s, int d, float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, lse, bh, s, scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, lse, bh, s, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, lse, bh, s, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, lse, bh, s, scale, stream);
    case 256: return launch<T, 256>(q, k, v, out, lse, bh, s, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, out: contiguous [bh, s, d]; lse: null or
// contiguous f32 [bh, s].
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int bh, int s, int d, int dtype, float scale,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* const lse_f = static_cast<float*>(lse);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(q, k, v, out, lse_f, bh, s, d, scale, st);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(q, k, v, out, lse_f, bh, s, d, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
