// Flash-attention backward for Hopper (sm_90a), f32-FMA kernel: the f32
// (parity) route. bf16 inputs take the tensor-core kernels of
// flash_attention_bwd_wgmma.cu (head dims up to 128) and
// flash_attention_bwd_wide_wgmma.cu (above)
// (ops/kernels/flash_attention.py:backward_kernel).
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
// 2. flash_bwd_dkdv_kernel: one block per (b*h, kv tile of TILE rows). It
//    keeps its k and v tiles in shared memory and walks the q sequence in
//    tiles of TILE rows (q pre-scaled by d^-0.5, dO, and the rows' lse and
//    delta). Per q tile it recomputes p = exp(s - lse) from the forward's saved logsumexp,
//    computes dp = dO v^T and ds = p * (dp - delta), stages p and ds in shared
//    memory, and accumulates dv += p^T dO and dk += ds^T (q * d^-0.5) in
//    registers (each thread a TILE/16 x D/16 patch of both).
// 3. flash_bwd_dq_kernel: one block per (b*h, q tile of TILE rows). It keeps q,
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
// Tile rows: the rows of a q tile and of a kv tile are a template parameter
// TILE, 64 for D <= 128, 32 for D = 256 (one head over the 256 channels of a
// 64-128-256 VAE's mid block, in f32) and 16 for D = 512 (a [128, 256, 512,
// 512] VAE's mid block). Four staged [TILE][D+1] f32 tiles of 64 rows would
// need 296,960 bytes (dk/dv) and 280,320 (dq) at D = 256, over the 232,448 a
// block may have; with 32 rows they need 140,288 and 136,064. At D = 512, 32
// rows would need 271,360 (dk/dv); 16 rows need 133,632 and 132,544. Any other
// head dim up to 512 is zero-padded up to one of 16 ... 512 by the wrapper.
// The 16 x 16 threads keep their layout: each holds TILE/16 rows and TILE/16
// columns of a p / ds tile and TILE/16 x D/16 of an accumulator. The delta
// pre-pass does not depend on TILE. flash_attention_bwd_smem reports the
// bytes each kernel asks for at a head dim (ops/kernels/flash_attention.py:
// bwd_fma_smem_bytes is the same formula).
//
// Head dims above 512 (any multiple of 64; the wrapper zero-pads others up to
// one) take the split kernels flash_bwd_dkdv_split_kernel and
// flash_bwd_dq_split_kernel, which never hold a whole-D tile: a grid
// dimension walks slices of 128 columns of dk and dv (dq), and p and dp (p
// and dp again in the dq kernel) are summed over depth chunks of 64 columns,
// chunks of k, v, q and dO staged as [64][65] f32 tiles. Then the q and dO
// (k) columns of the block's slice are staged as [64][129] tiles and the
// products accumulated as above (64-row tiles; each thread 4 rows x 8
// columns of each accumulator). p and dp are recomputed once per slice, the
// price of blocks that fit 166,400 (dk/dv) and 116,736 (dq) bytes at any head
// dim. Head dims up to 512 keep the kernels above.
//
// C interface (loaded with ctypes): flash_attention_bwd returns the first
// error of its three launches (cudaGetLastError() after each); any other
// value than 0 is a failure.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // 16 x 16: tx = column group, ty = row group

// rows of a q tile and of a kv tile at a head dim
template <int D>
constexpr int tile_rows() { return D <= 128 ? 64 : (D <= 256 ? 32 : 16); }

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

// Rows row0 .. row0+TILE-1 of a [s, D] matrix into a [TILE][D+1] f32 tile,
// times mul; rows past s are zero-filled.
template <typename T, int D, int TILE>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, size_t base,
                                          int row0, int s, float mul, int tid) {
  constexpr int kPad = D + 1;
  for (int i = tid; i < TILE * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * kPad + c] =
        (row0 + r < s) ? to_f32(src[base + static_cast<size_t>(row0) * D + i]) * mul : 0.f;
  }
}

// lse and delta of rows row0 .. row0+TILE-1 (0 past s).
template <int TILE>
__device__ __forceinline__ void load_rows(float* row_lse, float* row_delta,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta, size_t stat_base,
                                          int row0, int s, int tid) {
  if (tid < TILE) {
    const bool live = row0 + tid < s;
    row_lse[tid] = live ? lse[stat_base + row0 + tid] : 0.f;
    row_delta[tid] = live ? delta[stat_base + row0 + tid] : 0.f;
  }
}

// p and ds of one TILE x TILE (q rows x k columns) tile pair. Thread (tx, ty)
// holds q rows ty*R+i and k columns tx+16*j, R = TILE/16. qs holds q * d^-0.5.
template <int D, int TILE>
__device__ __forceinline__ void tile_p_ds(const float* qs, const float* ks, const float* dos,
                                          const float* vs, const float* row_lse,
                                          const float* row_delta, int q0, int k0, int s, int tx,
                                          int ty, float (&p)[TILE / 16][TILE / 16],
                                          float (&ds)[TILE / 16][TILE / 16]) {
  constexpr int R = TILE / 16;
  constexpr int kPad = D + 1;  // odd row stride: column reads hit distinct banks
  float dp[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      p[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[R], gv[R], kv[R], vv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qv[i] = qs[(ty * R + i) * kPad + d];
      gv[i] = dos[(ty * R + i) * kPad + d];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      kv[j] = ks[(tx + 16 * j) * kPad + d];
      vv[j] = vs[(tx + 16 * j) * kPad + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        p[i][j] = fmaf(qv[i], kv[j], p[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = ty * R + i;
    const float l = row_lse[row];
    const float dl = row_delta[row];
#pragma unroll
    for (int j = 0; j < R; ++j) {
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
  // k, v, q, dO tiles [TILE][D+1] + p, ds tiles [TILE][TILE+1] + lse, delta [TILE]
  constexpr int t = tile_rows<D>();
  return 4 * t * (D + 1) + 2 * t * (t + 1) + 2 * t;
}

template <int D>
constexpr int dq_smem_floats() {
  // q, dO, k, v tiles [TILE][D+1] + ds tile [TILE][TILE+1] + lse, delta [TILE]
  constexpr int t = tile_rows<D>();
  return 4 * t * (D + 1) + t * (t + 1) + 2 * t;
}

template <typename T, int D, int TILE>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int s, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static_assert(TILE % 16 == 0 && TILE <= 64, "tile rows: a multiple of 16, at most 64");
  constexpr int R = TILE / 16;   // rows (and p / ds columns) per thread
  constexpr int kPad = D + 1;
  constexpr int kPadP = TILE + 1;  // odd row stride of the staged p / ds tiles
  constexpr int kCols = D / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + TILE * kPad;
  float* qs = vs + TILE * kPad;
  float* dos = qs + TILE * kPad;
  float* ps = dos + TILE * kPad;
  float* dss = ps + TILE * kPadP;
  float* row_lse = dss + TILE * kPadP;
  float* row_delta = row_lse + TILE;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k0 = blockIdx.x * TILE;
  const size_t base = static_cast<size_t>(blockIdx.y) * s * D;
  const size_t stat_base = static_cast<size_t>(blockIdx.y) * s;

  load_tile<T, D, TILE>(ks, k, base, k0, s, 1.f, tid);
  load_tile<T, D, TILE>(vs, v, base, k0, s, 1.f, tid);

  // this thread's patch of dk and dv: kv rows ty*R+i, columns tx+16*j
  float acc_dk[R][kCols], acc_dv[R][kCols];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      acc_dk[i][j] = 0.f;
      acc_dv[i][j] = 0.f;
    }

  for (int q0 = 0; q0 < s; q0 += TILE) {
    __syncthreads();  // the previous q tile, p and ds are consumed
    load_tile<T, D, TILE>(qs, q, base, q0, s, scale, tid);
    load_tile<T, D, TILE>(dos, dout, base, q0, s, 1.f, tid);
    load_rows<TILE>(row_lse, row_delta, lse, delta, stat_base, q0, s, tid);
    __syncthreads();

    float p[R][R], ds[R][R];
    tile_p_ds<D, TILE>(qs, ks, dos, vs, row_lse, row_delta, q0, k0, s, tx, ty, p, ds);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        ps[(ty * R + i) * kPadP + tx + 16 * j] = p[i][j];
        dss[(ty * R + i) * kPadP + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();

    // dv += p^T dO, dk += ds^T (q * scale): sums over the TILE q rows of the tile
#pragma unroll 2
    for (int r = 0; r < TILE; ++r) {
      float pv[R], dsv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pv[i] = ps[r * kPadP + ty * R + i];
        dsv[i] = dss[r * kPadP + ty * R + i];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float gv = dos[r * kPad + tx + 16 * j];
        const float qv = qs[r * kPad + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          acc_dv[i][j] = fmaf(pv[i], gv, acc_dv[i][j]);
          acc_dk[i][j] = fmaf(dsv[i], qv, acc_dk[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = k0 + ty * R + i;
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

template <typename T, int D, int TILE>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int s, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static_assert(TILE % 16 == 0 && TILE <= 64, "tile rows: a multiple of 16, at most 64");
  constexpr int R = TILE / 16;
  constexpr int kPad = D + 1;
  constexpr int kPadP = TILE + 1;
  constexpr int kCols = D / 16;

  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + TILE * kPad;
  float* ks = dos + TILE * kPad;
  float* vs = ks + TILE * kPad;
  float* dss = vs + TILE * kPad;
  float* row_lse = dss + TILE * kPadP;
  float* row_delta = row_lse + TILE;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * TILE;
  const size_t base = static_cast<size_t>(blockIdx.y) * s * D;
  const size_t stat_base = static_cast<size_t>(blockIdx.y) * s;

  load_tile<T, D, TILE>(qs, q, base, q0, s, scale, tid);
  load_tile<T, D, TILE>(dos, dout, base, q0, s, 1.f, tid);
  load_rows<TILE>(row_lse, row_delta, lse, delta, stat_base, q0, s, tid);

  // this thread's patch of dq: q rows ty*R+i, columns tx+16*j
  float acc[R][kCols];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < s; k0 += TILE) {
    __syncthreads();  // the previous kv tile and ds are consumed
    load_tile<T, D, TILE>(ks, k, base, k0, s, 1.f, tid);
    load_tile<T, D, TILE>(vs, v, base, k0, s, 1.f, tid);
    __syncthreads();

    float p[R][R], ds[R][R];
    tile_p_ds<D, TILE>(qs, ks, dos, vs, row_lse, row_delta, q0, k0, s, tx, ty, p, ds);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) dss[(ty * R + i) * kPadP + tx + 16 * j] = ds[i][j];
    __syncthreads();

    // dq += ds k: sums over the TILE kv rows of the tile
#pragma unroll 4
    for (int c = 0; c < TILE; ++c) {
      float dsv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = dss[(ty * R + i) * kPadP + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float kv = ks[c * kPad + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
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
  constexpr int kTile = tile_rows<D>();
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
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D, kTile>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D, kTile><<<grid, kThreads, smem_kv, stream>>>(
      qp, kp, vp, gp, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), s, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int smem_q = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D, kTile>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D, kTile><<<grid, kThreads, smem_q, stream>>>(
      qp, kp, vp, gp, lse, delta, static_cast<T*>(dq), s, scale);
  return cudaGetLastError();
}

// The split kernels for head dims above 512 (see the note at the top).
constexpr int kSplitTile = 64;   // rows of a q tile and of a kv tile
constexpr int kSplitChunk = 64;  // depth columns of a staged chunk
constexpr int kSplitCols = 128;  // output columns of a block

// Rows row0 .. row0+63, columns col0 .. col0+COLS-1 of a [s, d] matrix into a
// [64][COLS+1] f32 tile, times mul; zero past s and past d.
template <typename T, int COLS>
__device__ __forceinline__ void load_block(float* dst, const T* __restrict__ src, size_t base,
                                           int row0, int col0, int s, int d, float mul, int tid) {
  constexpr int kPad = COLS + 1;
  for (int i = tid; i < kSplitTile * COLS; i += kThreads) {
    const int r = i / COLS, c = i % COLS;
    dst[r * kPad + c] = (row0 + r < s && col0 + c < d)
                            ? to_f32(src[base + static_cast<size_t>(row0 + r) * d + col0 + c]) * mul
                            : 0.f;
  }
}

// p and dp of one 64 x 64 tile pair summed over one depth chunk: the A tiles (q, dO) give the
// rows, the B tiles (k, v) the columns; thread (tx, ty) holds rows ty*4+i, columns tx+16*j.
__device__ __forceinline__ void chunk_p_dp(const float* qs, const float* ks, const float* dos,
                                           const float* vs, int tx, int ty, float (&p)[4][4],
                                           float (&dp)[4][4]) {
  constexpr int kPad = kSplitChunk + 1;
#pragma unroll 4
  for (int dd = 0; dd < kSplitChunk; ++dd) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = qs[(ty * 4 + i) * kPad + dd];
      gv[i] = dos[(ty * 4 + i) * kPad + dd];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = ks[(tx + 16 * j) * kPad + dd];
      vv[j] = vs[(tx + 16 * j) * kPad + dd];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = fmaf(qv[i], kv[j], p[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
}

// p = exp(s - lse) and ds = p (dp - delta) of a tile pair, masked past s.
__device__ __forceinline__ void finish_p_ds(const float* row_lse, const float* row_delta, int q0,
                                            int k0, int s, int tx, int ty, float (&p)[4][4],
                                            float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    const float l = row_lse[row], dl = row_delta[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool live = (q0 + row < s) && (k0 + tx + 16 * j < s);
      const float pv = live ? expf(p[i][j] - l) : 0.f;
      p[i][j] = pv;
      dp[i][j] = pv * (dp[i][j] - dl);  // ds
    }
  }
}

constexpr int dkdv_split_smem_floats() {
  // k, v, q, dO chunks [64][65] + q, dO slices [64][129] + p, ds [64][65] + lse, delta [64]
  constexpr int t = kSplitTile;
  return 4 * t * (kSplitChunk + 1) + 2 * t * (kSplitCols + 1) + 2 * t * (t + 1) + 2 * t;
}

constexpr int dq_split_smem_floats() {
  // q, dO, k, v chunks [64][65] + k slice [64][129] + ds [64][65] + lse, delta [64]
  constexpr int t = kSplitTile;
  return 4 * t * (kSplitChunk + 1) + t * (kSplitCols + 1) + t * (t + 1) + 2 * t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            T* __restrict__ dk, T* __restrict__ dv, int s, int d, int n_slices,
                            float scale) {
  constexpr int kT = kSplitTile, kC = kSplitChunk, kW = kSplitCols;
  constexpr int kPadC = kC + 1, kPadW = kW + 1, kPadP = kT + 1;
  constexpr int kCols = kW / 16;

  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kT * kPadC;
  float* qs = vs + kT * kPadC;
  float* dos = qs + kT * kPadC;
  float* qw = dos + kT * kPadC;
  float* dow = qw + kT * kPadW;
  float* ps = dow + kT * kPadW;
  float* dss = ps + kT * kPadP;
  float* row_lse = dss + kT * kPadP;
  float* row_delta = row_lse + kT;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int slice = static_cast<int>(blockIdx.x) % n_slices;
  const int k0 = static_cast<int>(blockIdx.x) / n_slices * kT;
  const int col0 = slice * kW;
  const size_t base = static_cast<size_t>(blockIdx.y) * s * d;
  const size_t stat_base = static_cast<size_t>(blockIdx.y) * s;

  // this thread's patch of dk and dv: kv rows ty*4+i, columns col0+tx+16*j
  float acc_dk[4][kCols], acc_dv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      acc_dk[i][j] = 0.f;
      acc_dv[i][j] = 0.f;
    }

  for (int q0 = 0; q0 < s; q0 += kT) {
    float p[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
    for (int c0 = 0; c0 < d; c0 += kC) {
      __syncthreads();  // the previous chunk (and the previous tile's slices, p, ds) are consumed
      load_block<T, kC>(ks, k, base, k0, c0, s, d, 1.f, tid);
      load_block<T, kC>(vs, v, base, k0, c0, s, d, 1.f, tid);
      load_block<T, kC>(qs, q, base, q0, c0, s, d, scale, tid);
      load_block<T, kC>(dos, dout, base, q0, c0, s, d, 1.f, tid);
      if (c0 == 0) load_rows<kT>(row_lse, row_delta, lse, delta, stat_base, q0, s, tid);
      __syncthreads();
      // rows = q rows of the tile, columns = the block's kv rows
      chunk_p_dp(qs, ks, dos, vs, tx, ty, p, dp);
    }
    finish_p_ds(row_lse, row_delta, q0, k0, s, tx, ty, p, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ps[(ty * 4 + i) * kPadP + tx + 16 * j] = p[i][j];
        dss[(ty * 4 + i) * kPadP + tx + 16 * j] = dp[i][j];
      }
    load_block<T, kW>(qw, q, base, q0, col0, s, d, scale, tid);
    load_block<T, kW>(dow, dout, base, q0, col0, s, d, 1.f, tid);
    __syncthreads();

    // dv += p^T dO, dk += ds^T (q * scale) over the slice: sums over the tile's q rows
#pragma unroll 2
    for (int r = 0; r < kT; ++r) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[r * kPadP + ty * 4 + i];
        dsv[i] = dss[r * kPadP + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float gv = dow[r * kPadW + tx + 16 * j];
        const float qv = qw[r * kPadW + tx + 16 * j];
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
        const int col = col0 + tx + 16 * j;
        if (col < d) {
          const size_t at = base + static_cast<size_t>(row) * d + col;
          dk[at] = from_f32<T>(acc_dk[i][j]);
          dv[at] = from_f32<T>(acc_dv[i][j]);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dq, int s, int d, int n_slices, float scale) {
  constexpr int kT = kSplitTile, kC = kSplitChunk, kW = kSplitCols;
  constexpr int kPadC = kC + 1, kPadW = kW + 1, kPadP = kT + 1;
  constexpr int kCols = kW / 16;

  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kT * kPadC;
  float* ks = dos + kT * kPadC;
  float* vs = ks + kT * kPadC;
  float* kw = vs + kT * kPadC;
  float* dss = kw + kT * kPadW;
  float* row_lse = dss + kT * kPadP;
  float* row_delta = row_lse + kT;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int slice = static_cast<int>(blockIdx.x) % n_slices;
  const int q0 = static_cast<int>(blockIdx.x) / n_slices * kT;
  const int col0 = slice * kW;
  const size_t base = static_cast<size_t>(blockIdx.y) * s * d;
  const size_t stat_base = static_cast<size_t>(blockIdx.y) * s;

  load_rows<kT>(row_lse, row_delta, lse, delta, stat_base, q0, s, tid);
  // this thread's patch of dq: q rows ty*4+i, columns col0+tx+16*j
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < s; k0 += kT) {
    float p[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
    for (int c0 = 0; c0 < d; c0 += kC) {
      __syncthreads();  // the previous chunk (and the previous tile's k slice and ds) are consumed
      load_block<T, kC>(qs, q, base, q0, c0, s, d, scale, tid);
      load_block<T, kC>(dos, dout, base, q0, c0, s, d, 1.f, tid);
      load_block<T, kC>(ks, k, base, k0, c0, s, d, 1.f, tid);
      load_block<T, kC>(vs, v, base, k0, c0, s, d, 1.f, tid);
      __syncthreads();
      chunk_p_dp(qs, ks, dos, vs, tx, ty, p, dp);
    }
    finish_p_ds(row_lse, row_delta, q0, k0, s, tx, ty, p, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dss[(ty * 4 + i) * kPadP + tx + 16 * j] = dp[i][j];
    load_block<T, kW>(kw, k, base, k0, col0, s, d, 1.f, tid);
    __syncthreads();

    // dq += ds k over the slice: sums over the tile's kv rows
#pragma unroll 4
    for (int c = 0; c < kT; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty * 4 + i) * kPadP + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float kv = kw[c * kPadW + tx + 16 * j];
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
      for (int j = 0; j < kCols; ++j) {
        const int col = col0 + tx + 16 * j;
        if (col < d) dq[base + static_cast<size_t>(row) * d + col] = from_f32<T>(acc[i][j] * scale);
      }
    }
  }
}

template <typename T>
cudaError_t launch_split(const void* q, const void* k, const void* v, const void* out,
                         const void* dout, const float* lse, float* delta, void* dq, void* dk,
                         void* dv, int bh, int s, int d, float scale, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(dout);
  const int rows = bh * s;
  constexpr int kRowsPerBlock = kThreads / 32;
  flash_bwd_delta_kernel<T><<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0, stream>>>(
      static_cast<const T*>(out), gp, delta, rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int n_slices = (d + kSplitCols - 1) / kSplitCols;
  const dim3 grid((s + kSplitTile - 1) / kSplitTile * n_slices, bh);
  constexpr int smem_kv = dkdv_split_smem_floats() * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(flash_bwd_dkdv_split_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_split_kernel<T><<<grid, kThreads, smem_kv, stream>>>(
      qp, kp, vp, gp, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), s, d, n_slices, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int smem_q = dq_split_smem_floats() * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(flash_bwd_dq_split_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_split_kernel<T><<<grid, kThreads, smem_q, stream>>>(
      qp, kp, vp, gp, lse, delta, static_cast<T*>(dq), s, d, n_slices, scale);
  return cudaGetLastError();
}

// a head dim the split kernels take
bool split_head_dim(int d) { return d > 512 && d % kSplitChunk == 0; }

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
    case 256:
      return launch<T, 256>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh, s, scale, stream);
    case 512:
      return launch<T, 512>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh, s, scale, stream);
    default:
      if (split_head_dim(d))
        return launch_split<T>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh, s, d, scale, stream);
      return cudaErrorInvalidValue;
  }
}

template <int D>
void smem_of(int* tile, int* dkdv_bytes, int* dq_bytes) {
  *tile = tile_rows<D>();
  *dkdv_bytes = dkdv_smem_floats<D>() * static_cast<int>(sizeof(float));
  *dq_bytes = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, out, dout, dq, dk, dv: contiguous
// [bh, s, d], d one of 16 ... 512 (powers of two) or a multiple of 64 above 512; lse (from
// flash_attention_fwd) and delta (scratch): contiguous f32 [bh, s].
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

// The tile rows and the dynamic shared memory (bytes) of the dk/dv and the dq
// kernels at head dim d (the split kernels above 512); returns
// cudaErrorInvalidValue for a head dim they do not take.
extern "C" int flash_attention_bwd_smem(int d, int* tile, int* dkdv_bytes, int* dq_bytes) {
  switch (d) {
    case 16: smem_of<16>(tile, dkdv_bytes, dq_bytes); break;
    case 32: smem_of<32>(tile, dkdv_bytes, dq_bytes); break;
    case 64: smem_of<64>(tile, dkdv_bytes, dq_bytes); break;
    case 128: smem_of<128>(tile, dkdv_bytes, dq_bytes); break;
    case 256: smem_of<256>(tile, dkdv_bytes, dq_bytes); break;
    case 512: smem_of<512>(tile, dkdv_bytes, dq_bytes); break;
    default:
      if (!split_head_dim(d)) return static_cast<int>(cudaErrorInvalidValue);
      *tile = kSplitTile;
      *dkdv_bytes = dkdv_split_smem_floats() * static_cast<int>(sizeof(float));
      *dq_bytes = dq_split_smem_floats() * static_cast<int>(sizeof(float));
  }
  return 0;
}
