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
// Head dims 16, 32, 64, 128, 256 and 512 (ops/kernels/flash_attention.py
// zero-pads any other head dim up to the next of these). D = 256 (one head
// over the 256 channels of a 64-128-256 VAE's mid block) takes this kernel in
// both types, since the tensor-core kernel stops at 128: 214,272 bytes of
// shared memory, one block per SM, 16 output columns of f32 accumulators a
// thread. D = 512 (a [128, 256, 512, 512] VAE's mid block) does the same with
// q and kv tiles of 32 rows (block_rows): 64-row tiles would need 410,880
// bytes, over the 232,448 a block may have; 32-row ones need 201,344. Each
// thread then holds 2 rows x 32 columns of the output.
//
// C interface (loaded with ctypes): flash_attention_fwd returns
// cudaGetLastError() after the launch; any other value than 0 is a failure.
// flash_attention_fwd_smem reports the tile rows and the dynamic shared
// memory at a head dim (ops/kernels/flash_attention.py: fwd_fma_smem_bytes is
// the same formula).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

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

// rows of a q tile and of a kv tile at a head dim
template <int D>
constexpr int block_rows() { return D <= 256 ? 64 : 32; }

template <int D>
constexpr int smem_floats() {
  // q [BQ][D] + k [BK][D+1] + v [BK][D] + p [BQ][BK+1] + m, l, correction [BQ]
  constexpr int kBlockQ = block_rows<D>(), kBlockK = block_rows<D>();
  return kBlockQ * D + kBlockK * (D + 1) + kBlockK * D + kBlockQ * (kBlockK + 1) + 3 * kBlockQ;
}

template <typename T, int D, int kBlockQ, int kBlockK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int s, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static_assert(kBlockQ % 16 == 0 && kBlockK % 32 == 0, "16 row groups, 32 lanes a row");
  constexpr int kPadK = D + 1;        // odd row stride: column reads hit distinct banks
  constexpr int kPadP = kBlockK + 1;
  constexpr int kCols = D / 16;       // output columns per thread
  constexpr int kRows = kBlockQ / 16; // output and score rows per thread
  constexpr int kSc = kBlockK / 16;   // score columns per thread
  constexpr int kLane = kBlockK / 32; // score columns per lane in the softmax

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
  const int ty = tid / 16;            // rows ty*kRows .. ty*kRows+kRows-1
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

  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
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

    // scores: rows ty*kRows+i, columns tx+16*j
    float sc[kRows][kSc];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kSc; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kSc];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty * kRows + i) * D + d];
#pragma unroll
      for (int j = 0; j < kSc; ++j) kv[j] = ks[(tx + 16 * j) * kPadK + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kSc; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kSc; ++j) {
        const int col = tx + 16 * j;
        ps[(ty * kRows + i) * kPadP + col] = (k0 + col < s) ? sc[i][j] : -CUDART_INF_F;
      }
    __syncthreads();

    // online softmax: warp w owns rows w*kBlockQ/8 .., kLane columns per lane
    for (int rr = 0; rr < kBlockQ / kWarps; ++rr) {
      const int row = warp * (kBlockQ / kWarps) + rr;
      float pc[kLane];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < kLane; ++c) {
        pc[c] = ps[row * kPadP + lane + 32 * c];
        mx = fmaxf(mx, pc[c]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = row_m[row];
      const float m_new = fmaxf(m_old, mx);  // finite: every tile has a live column
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kLane; ++c) {
        pc[c] = expf(pc[c] - m_new);
        sum += pc[c];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
      for (int c = 0; c < kLane; ++c) ps[row * kPadP + lane + 32 * c] = pc[c];
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
    for (int i = 0; i < kRows; ++i) {
      const float c = row_c[ty * kRows + i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= c;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty * kRows + i) * kPadP + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = vs[kk * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row < s) {
      const float inv = 1.f / row_l[ty * kRows + i];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        out[base + static_cast<size_t>(row) * D + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
      if (lse != nullptr && tx == 0)
        lse[static_cast<size_t>(blockIdx.y) * s + row] =
            row_m[ty * kRows + i] + logf(row_l[ty * kRows + i]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                   int s, float scale, cudaStream_t stream) {
  constexpr int kBlock = block_rows<D>();
  constexpr int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D, kBlock, kBlock>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kBlock - 1) / kBlock, bh);
  flash_fwd_kernel<T, D, kBlock, kBlock><<<grid, kThreads, smem, stream>>>(
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
    case 512: return launch<T, 512>(q, k, v, out, lse, bh, s, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
void smem_of(int* rows, int* bytes) {
  *rows = block_rows<D>();
  *bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
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

// The tile rows and the dynamic shared memory (bytes) of the kernel at head dim
// d; returns cudaErrorInvalidValue for a head dim it does not instantiate.
extern "C" int flash_attention_fwd_smem(int d, int* rows, int* bytes) {
  switch (d) {
    case 16: smem_of<16>(rows, bytes); break;
    case 32: smem_of<32>(rows, bytes); break;
    case 64: smem_of<64>(rows, bytes); break;
    case 128: smem_of<128>(rows, bytes); break;
    case 256: smem_of<256>(rows, bytes); break;
    case 512: smem_of<512>(rows, bytes); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}
