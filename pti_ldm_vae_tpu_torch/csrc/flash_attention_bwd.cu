// Flash-attention backward for Hopper (sm_90a), f32-FMA kernel: the f32
// (parity) route, and bf16 tensors whose base address is not 16-byte aligned.
// Aligned bf16 inputs take the tensor-core kernel of
// flash_attention_bwd_wgmma.cu (ops/kernels/flash_attention.py:backward_kernel).
//
// Replaces the TPU kernel pti_ldm_vae_tpu/ops/pallas/flash_attention.py
// (_bwd_pallas, body _bwd_kernel): with s = q k^T * d^-0.5 and p = softmax(s),
//   dv = p^T g,  dp = g v^T,  ds = p * (dp - rowsum(dp * p)),
//   dq = ds k * d^-0.5,  dk = ds^T q * d^-0.5
// over [B, H, S, D] tensors, self-attention only.
//
// The TPU kernel is one whole-matrix program per (b, h): it holds the [S, S]
// f32 matrix on chip (4 MB at S = 1024). An SM has 227 KB of shared memory,
// so this is a tiled FlashAttention-2 backward instead:
//
// 1. flash_bwd_delta_kernel: delta = rowsum(dO * O), one warp per row. It
//    equals the TPU kernel's rowsum(dp * p), since O = p v.
// 2. flash_bwd_dkdv_kernel: one block per (b*h, kv tile of 64 rows). It keeps
//    its k and v tiles in shared memory and walks the q sequence in tiles of
//    64 rows (q pre-scaled by d^-0.5, dO, and the rows' lse and delta). Per q
//    tile it recomputes p = exp(s - lse) from the forward's saved logsumexp,
//    computes dp = dO v^T and ds = p * (dp - delta), stages p and ds in shared
//    memory, and accumulates dv += p^T dO and dk += ds^T (q * d^-0.5) in
//    registers (each thread a 4 x D/16 patch of both).
// 3. flash_bwd_dq_kernel: one block per (b*h, q tile of 64 rows). It keeps q,
//    dO, lse and delta of its rows and walks the kv sequence, recomputing p
//    and ds the same way, and accumulates dq += ds k, scaled once at the end.
//
// dq sums over kv tiles and dk / dv sum over q tiles. Each sum runs inside one
// block, in tile order: there are no float atomics, so the results are
// bit-identical from run to run. The price is that p and ds are computed
// twice (once in each of kernels 2 and 3): seven tile products per (q tile,
// kv tile) pair where the five of the formula would do.
//
// Precision: inputs are converted to f32 on load; p, ds, delta and every
// accumulator are f32 (the TPU kernel rounds p and ds to the input dtype
// before its products; keeping them in f32 is at least as exact). Outputs are
// rounded once to the input dtype.
//
// Bound on an H100: 5 products of 2*S^2*D operations per (b, h), 10.7 GFLOP
// at [8, 1, 1024, 128]: in f32 the CUDA cores' 67 TFLOP/s, as FMAs from
// shared memory.
//
// Rows and columns past S (the ragged last tile) are zero-filled on load and
// their p and ds are forced to 0; their outputs are never stored. Shared
// memory is ~166 KB (dk/dv kernel) at D = 128, above the 48 KB static limit,
// so the launcher raises each kernel's dynamic shared-memory limit first.
//
// C interface (loaded with ctypes): flash_attention_bwd returns the first
// error of its three launches (cudaGetLastError() after each); any other
// value than 0 is a failure.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;          // rows of a q tile and of a kv tile
constexpr int kThreads = 256;
constexpr int kPadP = kTile + 1;   // odd row stride of the staged p / ds tiles

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

// Rows row0 .. row0+63 of a [s, D] matrix into a [64][D+1] f32 tile, times mul;
// rows past s are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, size_t base,
                                          int row0, int s, float mul, int tid) {
  constexpr int kPad = D + 1;
  for (int i = tid; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * kPad + c] =
        (row0 + r < s) ? to_f32(src[base + static_cast<size_t>(row0) * D + i]) * mul : 0.f;
  }
}

// lse and delta of rows row0 .. row0+63 (0 past s).
__device__ __forceinline__ void load_rows(float* row_lse, float* row_delta,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta, size_t stat_base,
                                          int row0, int s, int tid) {
  if (tid < kTile) {
    const bool live = row0 + tid < s;
    row_lse[tid] = live ? lse[stat_base + row0 + tid] : 0.f;
    row_delta[tid] = live ? delta[stat_base + row0 + tid] : 0.f;
  }
}

// p and ds of one 64 x 64 (q rows x k columns) tile pair. Thread (tx, ty) holds
// q rows ty*4+i and k columns tx+16*j. qs holds q * d^-0.5.
template <int D>
__device__ __forceinline__ void tile_p_ds(const float* qs, const float* ks, const float* dos,
                                          const float* vs, const float* row_lse,
                                          const float* row_delta, int q0, int k0, int s, int tx,
                                          int ty, float (&p)[4][4], float (&ds)[4][4]) {
  constexpr int kPad = D + 1;  // odd row stride: column reads hit distinct banks
  float dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = qs[(ty * 4 + i) * kPad + d];
      gv[i] = dos[(ty * 4 + i) * kPad + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = ks[(tx + 16 * j) * kPad + d];
      vv[j] = vs[(tx + 16 * j) * kPad + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = fmaf(qv[i], kv[j], p[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    const float l = row_lse[row];
    const float dl = row_delta[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool live = (q0 + row < s) && (k0 + tx + 16 * j < s);
      const float pv = live ? expf(p[i][j] - l) : 0.f;
      p[i][j] = pv;
      ds[i][j] = pv * (dp[i][j] - dl);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int d) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;  // one warp per row
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(to_f32(out[base + c]), to_f32(dout[base + c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int D>
constexpr int dkdv_smem_floats() {
  // k, v, q, dO tiles [64][D+1] + p, ds tiles [64][65] + lse, delta [64]
  return 4 * kTile * (D + 1) + 2 * kTile * kPadP + 2 * kTile;
}

template <int D>
constexpr int dq_smem_floats() {
  // q, dO, k, v tiles [64][D+1] + ds tile [64][65] + lse, delta [64]
  return 4 * kTile * (D + 1) + kTile * kPadP + 2 * kTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int s, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kPad = D + 1;
  constexpr int kCols = D / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * kPad;
  float* qs = vs + kTile * kPad;
  float* dos = qs + kTile * kPad;
  float* ps = dos + kTile * kPad;
  float* dss = ps + kTile * kPadP;
  float* row_lse = dss + kTile * kPadP;
  float* row_delta = row_lse + kTile;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(blockIdx.y) * s * D;
  const size_t stat_base = static_cast<size_t>(blockIdx.y) * s;

  load_tile<T, D>(ks, k, base, k0, s, 1.f, tid);
  load_tile<T, D>(vs, v, base, k0, s, 1.f, tid);

  // this thread's patch of dk and dv: kv rows ty*4+i, columns tx+16*j
  float acc_dk[4][kCols], acc_dv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      acc_dk[i][j] = 0.f;
      acc_dv[i][j] = 0.f;
    }

  for (int q0 = 0; q0 < s; q0 += kTile) {
    __syncthreads();  // the previous q tile, p and ds are consumed
    load_tile<T, D>(qs, q, base, q0, s, scale, tid);
    load_tile<T, D>(dos, dout, base, q0, s, 1.f, tid);
    load_rows(row_lse, row_delta, lse, delta, stat_base, q0, s, tid);
    __syncthreads();

    float p[4][4], ds[4][4];
    tile_p_ds<D>(qs, ks, dos, vs, row_lse, row_delta, q0, k0, s, tx, ty, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ps[(ty * 4 + i) * kPadP + tx + 16 * j] = p[i][j];
        dss[(ty * 4 + i) * kPadP + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();

    // dv += p^T dO, dk += ds^T (q * scale): sums over the 64 q rows of the tile
#pragma unroll 2
    for (int r = 0; r < kTile; ++r) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[r * kPadP + ty * 4 + i];
        dsv[i] = dss[r * kPadP + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float gv = dos[r * kPad + tx + 16 * j];
        const float qv = qs[r * kPad + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_dv[i][j] = fmaf(pv[i], gv, acc_dv[i][j]);
          acc_dk[i][j] = fmaf(dsv[i], qv, acc_dk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row < s) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const size_t at = base + static_cast<size_t>(row) * D + tx + 16 * j;
        dk[at] = from_f32<T>(acc_dk[i][j]);
        dv[at] = from_f32<T>(acc_dv[i][j]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int s, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kPad = D + 1;
  constexpr int kCols = D / 16;

  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * kPad;
  float* ks = dos + kTile * kPad;
  float* vs = ks + kTile * kPad;
  float* dss = vs + kTile * kPad;
  float* row_lse = dss + kTile * kPadP;
  float* row_delta = row_lse + kTile;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(blockIdx.y) * s * D;
  const size_t stat_base = static_cast<size_t>(blockIdx.y) * s;

  load_tile<T, D>(qs, q, base, q0, s, scale, tid);
  load_tile<T, D>(dos, dout, base, q0, s, 1.f, tid);
  load_rows(row_lse, row_delta, lse, delta, stat_base, q0, s, tid);

  // this thread's patch of dq: q rows ty*4+i, columns tx+16*j
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < s; k0 += kTile) {
    __syncthreads();  // the previous kv tile and ds are consumed
    load_tile<T, D>(ks, k, base, k0, s, 1.f, tid);
    load_tile<T, D>(vs, v, base, k0, s, 1.f, tid);
    __syncthreads();

    float p[4][4], ds[4][4];
    tile_p_ds<D>(qs, ks, dos, vs, row_lse, row_delta, q0, k0, s, tx, ty, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dss[(ty * 4 + i) * kPadP + tx + 16 * j] = ds[i][j];
    __syncthreads();

    // dq += ds k: sums over the 64 kv rows of the tile
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty * 4 + i) * kPadP + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float kv = ks[c * kPad + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < s) {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        dq[base + static_cast<size_t>(row) * D + tx + 16 * j] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int bh, int s,
                   float scale, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(dout);

  const int rows = bh * s;
  constexpr int kRowsPerBlock = kThreads / 32;
  flash_bwd_delta_kernel<T><<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0, stream>>>(
      static_cast<const T*>(out), gp, delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid((s + kTile - 1) / kTile, bh);
  constexpr int smem_kv = dkdv_smem_floats<D>() * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D><<<grid, kThreads, smem_kv, stream>>>(
      qp, kp, vp, gp, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), s, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int smem_q = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem_q, stream>>>(
      qp, kp, vp, gp, lse, delta, static_cast<T*>(dq), s, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* out,
                     const void* dout, const float* lse, float* delta, void* dq, void* dk,
                     void* dv, int bh, int s, int d, float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh, s, scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh, s, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh, s, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh, s, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, out, dout, dq, dk, dv: contiguous
// [bh, s, d]; lse (from flash_attention_fwd) and delta (scratch): contiguous f32 [bh, s].
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int bh, int s, int d, int dtype,
                                   float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* const lse_f = static_cast<const float*>(lse);
  float* const delta_f = static_cast<float*>(delta);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(q, k, v, out, dout, lse_f, delta_f, dq, dk, dv, bh, s, d, scale, st);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(q, k, v, out, dout, lse_f, delta_f, dq, dk, dv, bh, s, d, scale,
                                  st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
