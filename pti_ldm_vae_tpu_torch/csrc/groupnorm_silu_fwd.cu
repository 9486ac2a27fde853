// GroupNorm + SiLU forward for Hopper (sm_90a), f32 and bf16 NHWC tensors: one
// launch per call, one thread-block cluster per (image, slice of whole groups).
//
// Replaces the TPU kernel pti_ldm_vae_tpu/ops/pallas/groupnorm_silu.py
// (_forward, body _kernel): per image and group the f32 mean and the one-pass
// biased variance (clamped at 0), then silu(x * mul + add) with
// mul = gamma * rsqrt(var + eps), add = beta - mean * mul, computed in f32 and
// rounded once to x's dtype; when the caller passes buffers, also the [B, G]
// f32 mean and inverse std, which the backward reads.
//
// Bound on an H100: a few operations per element, so bytes: one read of x and
// one write of y (67 MB at 8 x 256^2 x 64 in bf16, more than the 50 MB L2). A
// group's statistics need all of its image's rows before the first output, so
// a kernel that streams x from global memory twice reads 1.5x the bound. Here
// the cluster that owns an (image, slice) stages the slice in its blocks'
// shared memory while it sums, folds the statistics through distributed shared
// memory, and writes y from the staged copy: x is read from HBM once. The plan
// stages a slice where a cluster of up to 16 blocks holds it with room for two
// blocks per SM (every flagship shape up to 128^2); at 256^2 it stages nothing
// and both passes stream, the second mostly from L2, which measured faster
// than staging part of each slice (the kernel takes any number of staged rows:
// the rest are read twice). See groupnorm_silu.cuh for the work split and the
// fixed summation order (no float atomics: bit-identical runs).
//
// C interface (loaded with ctypes): groupnorm_silu_fwd returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue when the
// arguments disagree with the plan's shared memory); any other value than 0 is
// a failure. groupnorm_silu_fwd_clusters reports how many clusters of a plan
// the card can hold at once (0: the plan cannot be scheduled).

#include "groupnorm_silu.cuh"

namespace {

using gn::Vec;

struct FwdArgs {
  const void* x;
  void* y;
  const float* scale;
  const float* bias;
  float* mean_out;  // [B, G] or nullptr
  float* inv_out;
  int hw, c, cg, sc, cs, rows_per_block, staged, nv;
  float eps, count;
};

template <typename T, int V>
__global__ void __launch_bounds__(gn::kMaxThreads, gn::kMinBlocksFwd)
groupnorm_silu_fwd_kernel(FwdArgs a) {
  using VT = Vec<T, V>;
  using Raw = typename VT::Raw;
  constexpr bool kStage = V > 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int nv = a.nv;
  const int rit = blockDim.x / nv;
  const int tr = tid / nv, j = tid % nv;
  const gn::Layout l = gn::layout(a.sc, a.cs, blockDim.x, nv, a.staged, 0, sizeof(T));
  const gn::Place p = gn::place(a.hw, a.c, a.sc, a.cs, a.rows_per_block);
  const int ch0 = p.slice * a.sc + j * V;
  const T* x = static_cast<const T*>(a.x) + (static_cast<int64_t>(p.b) * a.hw + p.row0) * a.c + ch0;
  T* y = static_cast<T*>(a.y) + (static_cast<int64_t>(p.b) * a.hw + p.row0) * a.c + ch0;
  T* xs = reinterpret_cast<T*>(smem + l.stage_x) + j * V;
  // gamma and beta of the slice, read now, off the path from the last sum to the first output
  float* coef = reinterpret_cast<float*>(smem + l.coef);
  for (int e = tid; e < a.sc; e += blockDim.x) {
    coef[e] = a.scale[p.slice * a.sc + e];
    coef[a.sc + e] = a.bias[p.slice * a.sc + e];
  }

  // this thread's rows: local rows tr + k * rit for k < k_all; the first k_st staged
  const int staged = min(a.staged, p.nrows);
  const int k_all = p.nrows > tr ? (p.nrows - tr + rit - 1) / rit : 0;
  const int k_st = staged > tr ? (staged - tr + rit - 1) / rit : 0;
  const int per = (k_st + gn::kChunks - 1) / gn::kChunks;
  auto goff = [&](int k) { return static_cast<int64_t>(tr + k * rit) * a.c; };
  auto soff = [&](int k) { return (tr + k * rit) * a.sc; };
  auto from_global = [&](int k) { return VT::raw_global(x + goff(k)); };
  auto from_shared = [&](int k) { return VT::raw_shared(xs + soff(k)); };

  float s1[V], s2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s1[v] = s2[v] = 0.f;
  auto add = [&](int, const Raw& raw) {
    float xv[V];
    VT::unpack(xv, raw);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      s1[v] += xv[v];
      s2[v] = fmaf(xv[v], xv[v], s2[v]);
    }
  };

  if constexpr (kStage) {
#pragma unroll 1
    for (int q = 0; q < gn::kChunks; ++q) {
      for (int k = q * per; k < min((q + 1) * per, k_st); ++k) {
        hopper::cp_async_16(hopper::smem_addr(xs + soff(k)), x + goff(k), true);
      }
      hopper::cp_async_commit();
    }
  }
  // rows past the staged ones, straight from global memory, while the copies land
  gn::rows_in_groups<gn::kUnrollFwd>(k_st, k_all, from_global, add);
  if constexpr (kStage) {
#pragma unroll 1
    for (int q = 0; q < gn::kChunks; ++q) {
      gn::wait_chunk(q);
      gn::rows_in_groups<gn::kUnrollFwd>(q * per, min((q + 1) * per, k_st), from_shared, add);
    }
  }

  const float* tot = gn::cluster_fold<V>(s1, s2, smem, l, a.sc, a.cs, nv);

  // groups of the slice: mean, inverse std, then per-channel mul / add in
  // place of gamma / beta (each group's thread reads and writes only its own)
  const int groups = a.sc / a.cg;
  for (int gi = tid; gi < groups; gi += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int k = 0; k < a.cg; ++k) {
      t1 += tot[gi * a.cg + k];
      t2 += tot[a.sc + gi * a.cg + k];
    }
    const float mean = t1 / a.count;
    const float var = fmaxf(t2 / a.count - mean * mean, 0.f);
    const float inv = 1.f / sqrtf(var + a.eps);
    if (p.rank == 0 && a.mean_out != nullptr) {
      const int g = p.b * (a.c / a.cg) + p.slice * groups + gi;
      a.mean_out[g] = mean;
      a.inv_out[g] = inv;
    }
    for (int k = 0; k < a.cg; ++k) {
      const int cl = gi * a.cg + k;
      const float mul = inv * coef[cl];
      coef[a.sc + cl] -= mean * mul;
      coef[cl] = mul;
    }
  }
  __syncthreads();
  float mul[V], off[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    mul[v] = coef[j * V + v];
    off[v] = coef[a.sc + j * V + v];
  }

  auto write = [&](int k, const Raw& raw) {
    float yv[V];
    VT::unpack(yv, raw);
#pragma unroll
    for (int v = 0; v < V; ++v) yv[v] = gn::silu(fmaf(yv[v], mul[v], off[v]));
    VT::store_global(y + goff(k), yv);
  };
  gn::rows_in_groups<gn::kUnrollFwd>(0, k_st, from_shared, write);
  gn::rows_in_groups<gn::kUnrollFwd>(k_st, k_all, from_global, write);
  gn::cluster_wait();  // no block leaves while another may still read its partials
}

// Raises the instantiation's dynamic shared-memory limit (once per new maximum)
// and allows clusters of 16 (non-portable: the portable limit is 8).
template <typename T, int V>
cudaError_t prepare(int smem_bytes) {
  static int limit = -1;
  if (smem_bytes <= limit) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(groupnorm_silu_fwd_kernel<T, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(groupnorm_silu_fwd_kernel<T, V>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess) limit = smem_bytes;
  return err;
}

void config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int blocks, int cs, int threads,
            int smem_bytes, cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

template <typename T, int V>
cudaError_t launch(const FwdArgs& a, int b, int threads, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = prepare<T, V>(smem_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  config(cfg, attr, b * (a.c / a.sc) * a.cs, a.cs, threads, smem_bytes, stream);
  err = cudaLaunchKernelEx(&cfg, groupnorm_silu_fwd_kernel<T, V>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t clusters(int cs, int threads, int smem_bytes, int* out) {
  cudaError_t err = prepare<T, V>(smem_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  config(cfg, attr, cs, cs, threads, smem_bytes, nullptr);
  return cudaOccupancyMaxActiveClusters(out, groupnorm_silu_fwd_kernel<T, V>, &cfg);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; vec: 16 / sizeof(element) or 1.
extern "C" int groupnorm_silu_fwd_clusters(int dtype, int vec, int cs, int threads, int smem_bytes,
                                           int* out) {
  if (dtype == 0 && vec == 4) return static_cast<int>(clusters<float, 4>(cs, threads, smem_bytes, out));
  if (dtype == 0 && vec == 1) return static_cast<int>(clusters<float, 1>(cs, threads, smem_bytes, out));
  if (dtype == 1 && vec == 8)
    return static_cast<int>(clusters<__nv_bfloat16, 8>(cs, threads, smem_bytes, out));
  if (dtype == 1 && vec == 1)
    return static_cast<int>(clusters<__nv_bfloat16, 1>(cs, threads, smem_bytes, out));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int groupnorm_silu_fwd(const void* x, void* y, const float* scale, const float* bias,
                                  float* mean_out, float* inv_out, int b, int hw, int c, int cg,
                                  int sc, int cs, int rows_per_block, int staged, int vec,
                                  int threads, int smem_bytes, int dtype, float eps, void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  const int nv = sc / vec;
  const bool shape_ok = sc % vec == 0 && sc % cg == 0 && c % sc == 0 && threads % nv == 0 &&
                        threads <= gn::kMaxThreads && cs * rows_per_block >= hw &&
                        (vec > 1 || staged == 0) && staged <= rows_per_block;
  if (!shape_ok || gn::layout(sc, cs, threads, nv, staged, 0, esize).total !=
                       static_cast<size_t>(smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FwdArgs a{x, y, scale, bias, mean_out, inv_out, hw, c, cg, sc, cs, rows_per_block, staged, nv,
            eps, static_cast<float>(hw) * cg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4) return static_cast<int>(launch<float, 4>(a, b, threads, smem_bytes, s));
  if (dtype == 0 && vec == 1) return static_cast<int>(launch<float, 1>(a, b, threads, smem_bytes, s));
  if (dtype == 1 && vec == 8)
    return static_cast<int>(launch<__nv_bfloat16, 8>(a, b, threads, smem_bytes, s));
  if (dtype == 1 && vec == 1)
    return static_cast<int>(launch<__nv_bfloat16, 1>(a, b, threads, smem_bytes, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- the split form (see groupnorm_silu.cuh, namespace gn::split) -----------
//
// For an image whose rows lie on several ranks (spatial sharding), the
// forward is two entries around the caller's all-reduce of the statistics:
//
//   groupnorm_silu_split_stats: per (image, group) the f32 sums of x and x^2
//     over this rank's rows, [B, G, 2] (two launches: per-tile partials, then
//     their fold in a fixed order);
//   groupnorm_silu_split_apply: from the given [B, G] mean and inverse std
//     (the one-pass formula on the all-reduced sums, computed by the caller),
//     y = silu(x * mul + add) with mul = inv * gamma, add = beta - mean * mul,
//     in f32, rounded once to x's dtype: the fused kernel's arithmetic.
//
// Replaces, with the backward's two split entries, the TPU kernel
// pti_ldm_vae_tpu/ops/pallas/groupnorm_silu.py (_forward, body _kernel) where
// the image is cut by height. Bound on an H100: bytes. The statistics read x
// once; the apply reads x and writes y once. Summed, the split forward moves
// 1.5x the fused kernel's bytes (x is read twice), the price of the
// all-reduce between the two reads. Both return cudaGetLastError() after
// their launches (cudaErrorInvalidValue on arguments that disagree with the
// cut); any other value than 0 is a failure.

namespace {

struct StatsOp {
  static constexpr bool kNeedsCoef = false;
  template <int V>
  __device__ __forceinline__ static void add(float (&s1)[V], float (&s2)[V], const float (&xv)[V],
                                             const float (&)[V], const gn::split::Coef<V>&) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      s1[v] += xv[v];
      s2[v] = fmaf(xv[v], xv[v], s2[v]);
    }
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(gn::kMaxThreads) split_apply_kernel(gn::split::Args a) {
  using VT = Vec<T, V>;
  const gn::split::Tile t = gn::split::tile(a);
  const int ch0 = t.j * V;
  gn::split::Coef<V> cf;
  cf.load(a, t.b, ch0);
  float mul[V], off[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    mul[v] = cf.inv[v] * cf.gam[v];
    off[v] = cf.bet[v] - cf.mean[v] * mul[v];
  }
  const int64_t base = (static_cast<int64_t>(t.b) * a.hw + t.row0) * a.c + ch0;
  const T* x = static_cast<const T*>(a.x) + base;
  T* y = static_cast<T*>(a.out) + base;
  for (int row = t.tr; row < t.nrows; row += t.rit) {
    const int64_t o = static_cast<int64_t>(row) * a.c;
    float v_[V];
    VT::unpack(v_, VT::raw_global(x + o));
#pragma unroll
    for (int v = 0; v < V; ++v) v_[v] = gn::silu(fmaf(v_[v], mul[v], off[v]));
    VT::store_global(y + o, v_);
  }
}

gn::split::Args split_args(const void* x, const void* g, void* out, const float* scale,
                           const float* bias, const float* mean, const float* inv, const float* r,
                           float* partial, int hw, int c, int cg, int tiles, int rows_per_tile,
                           int vec, float count) {
  return gn::split::Args{x, g, out, scale, bias, mean, inv, r, partial,
                         hw, c, cg, tiles, rows_per_tile, c / vec, count};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; vec: 16 / sizeof(element) or 1.
extern "C" int groupnorm_silu_split_stats(const void* x, float* partial, float* stats, int b, int hw,
                                          int c, int cg, int tiles, int rows_per_tile, int vec,
                                          int threads, int dtype, void* stream) {
  if (!gn::split::args_ok(c, cg, vec, threads, tiles, rows_per_tile, hw))
    return static_cast<int>(cudaErrorInvalidValue);
  const gn::split::Args a = split_args(x, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                       nullptr, partial, hw, c, cg, tiles, rows_per_tile, vec, 0.f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    return static_cast<int>(gn::split::reduce<float, 4, StatsOp>(a, b, threads, stats, 1, s));
  if (dtype == 0 && vec == 1)
    return static_cast<int>(gn::split::reduce<float, 1, StatsOp>(a, b, threads, stats, 1, s));
  if (dtype == 1 && vec == 8)
    return static_cast<int>(gn::split::reduce<__nv_bfloat16, 8, StatsOp>(a, b, threads, stats, 1, s));
  if (dtype == 1 && vec == 1)
    return static_cast<int>(gn::split::reduce<__nv_bfloat16, 1, StatsOp>(a, b, threads, stats, 1, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int groupnorm_silu_split_apply(const void* x, void* y, const float* scale,
                                          const float* bias, const float* mean, const float* inv,
                                          int b, int hw, int c, int cg, int tiles,
                                          int rows_per_tile, int vec, int threads, int dtype,
                                          void* stream) {
  if (!gn::split::args_ok(c, cg, vec, threads, tiles, rows_per_tile, hw))
    return static_cast<int>(cudaErrorInvalidValue);
  const gn::split::Args a = split_args(x, nullptr, y, scale, bias, mean, inv, nullptr, nullptr, hw,
                                       c, cg, tiles, rows_per_tile, vec, 0.f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles, b);
  if (dtype == 0 && vec == 4) split_apply_kernel<float, 4><<<grid, threads, 0, s>>>(a);
  else if (dtype == 0 && vec == 1) split_apply_kernel<float, 1><<<grid, threads, 0, s>>>(a);
  else if (dtype == 1 && vec == 8) split_apply_kernel<__nv_bfloat16, 8><<<grid, threads, 0, s>>>(a);
  else if (dtype == 1 && vec == 1) split_apply_kernel<__nv_bfloat16, 1><<<grid, threads, 0, s>>>(a);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
