// GroupNorm + SiLU backward for Hopper (sm_90a), f32 and bf16 NHWC tensors: one
// launch per call, one thread-block cluster per (image, slice of whole groups).
//
// Replaces both kernels of the TPU backward
// pti_ldm_vae_tpu/ops/pallas/groupnorm_silu.py (_bwd_pallas: _bwd_reduce_kernel
// and _bwd_dx_kernel). With the saved [B, G] mean and inverse std,
//   xhat = (x - mean) * inv,  n = xhat * gamma + beta,
//   dn = g * sigmoid(n) * (1 + n * (1 - sigmoid(n)))   (through the SiLU),
//   r1 = sum_rows dn,  r2 = sum_rows dn * xhat         per (image, channel),
//   A_g = sum_{c in g} gamma_c r1_c,  B_g = sum_{c in g} gamma_c r2_c,
//   dx = inv * (dn * gamma - A_g / m - xhat * B_g / m),  m = HW * C / G.
// The kernel writes dx (rounded once to x's dtype) and r1, r2 as [B, 2, C] f32;
// dgamma = sum_b r2 and dbeta = sum_b r1 are one small torch.sum on the host
// side, as the JAX package leaves that sum to XLA.
//
// Bound on an H100: bytes. One read of x and g and one write of dx. dx needs
// A_g and B_g, which need every row of the image, so a kernel that streams
// x and g twice reads 5/3 of the bound. Here the cluster that owns an (image,
// slice) reads x and g once from HBM in pass 1, staging in its blocks' shared
// memory the tensors the plan names ("x", "g", both or neither, as far as
// they fit), folds r1 / r2 through distributed shared memory, and in pass 2
// reads the staged rows from shared memory and the rest from L2, which the
// same cluster has just filled. The plan stages both where they fit whole
// (every flagship shape up to 128^2) and neither at 256^2. See
// groupnorm_silu.cuh for the work split and the fixed summation order (no
// float atomics: bit-identical runs).
//
// C interface (loaded with ctypes): groupnorm_silu_bwd returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue when the
// arguments disagree with the plan's shared memory); any other value than 0 is
// a failure. groupnorm_silu_bwd_clusters reports how many clusters of a plan
// the card can hold at once (0: the plan cannot be scheduled).

#include "groupnorm_silu.cuh"

namespace {

using gn::Vec;

struct BwdArgs {
  const void* x;
  const void* g;
  void* dx;
  const float* scale;
  const float* bias;
  const float* mean;  // [B, G]
  const float* inv;
  float* r_out;  // [B, 2, C]: r1, r2
  int hw, c, cg, sc, cs, rows_per_block, staged_x, staged_g, nv;
  float count;
};

template <typename T, int V>
__global__ void __launch_bounds__(gn::kMaxThreads, gn::kMinBlocksBwd<V>)
groupnorm_silu_bwd_kernel(BwdArgs a) {
  using VT = Vec<T, V>;
  using Raw = typename VT::Raw;
  struct Pair {
    Raw x, g;
  };
  constexpr bool kStage = V > 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int nv = a.nv;
  const int rit = blockDim.x / nv;
  const int tr = tid / nv, j = tid % nv;
  const gn::Layout l = gn::layout(a.sc, a.cs, blockDim.x, nv, a.staged_x, a.staged_g, sizeof(T));
  const gn::Place p = gn::place(a.hw, a.c, a.sc, a.cs, a.rows_per_block);
  const int ch0 = p.slice * a.sc + j * V;
  const int64_t base = (static_cast<int64_t>(p.b) * a.hw + p.row0) * a.c + ch0;
  const T* x = static_cast<const T*>(a.x) + base;
  const T* g = static_cast<const T*>(a.g) + base;
  T* dx = static_cast<T*>(a.dx) + base;
  T* xs = reinterpret_cast<T*>(smem + l.stage_x) + j * V;
  T* gs = reinterpret_cast<T*>(smem + l.stage_g) + j * V;
  // gamma of the slice, read now, off the path from the last sum to the first output
  float* coef = reinterpret_cast<float*>(smem + l.coef);
  for (int e = tid; e < a.sc; e += blockDim.x) coef[e] = a.scale[p.slice * a.sc + e];

  float mean[V], inv[V], gam[V], bet[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int grp = p.b * (a.c / a.cg) + (ch0 + v) / a.cg;
    mean[v] = a.mean[grp];
    inv[v] = a.inv[grp];
    gam[v] = a.scale[ch0 + v];
    bet[v] = a.bias[ch0 + v];
  }

  // this thread's rows: local rows tr + k * rit for k < k_all; x staged for
  // k < k_x, g for k < k_g; copies go out in chunks over k < k_st = max
  const int k_all = p.nrows > tr ? (p.nrows - tr + rit - 1) / rit : 0;
  const int sx = min(a.staged_x, p.nrows), sg = min(a.staged_g, p.nrows);
  const int k_x = sx > tr ? (sx - tr + rit - 1) / rit : 0;
  const int k_g = sg > tr ? (sg - tr + rit - 1) / rit : 0;
  const int k_st = max(k_x, k_g);
  const int per = (k_st + gn::kChunks - 1) / gn::kChunks;
  auto goff = [&](int k) { return static_cast<int64_t>(tr + k * rit) * a.c; };
  auto soff = [&](int k) { return (tr + k * rit) * a.sc; };
  auto load = [&](int k) {
    Pair r;
    r.x = (kStage && k < k_x) ? VT::raw_shared(xs + soff(k)) : VT::raw_global(x + goff(k));
    r.g = (kStage && k < k_g) ? VT::raw_shared(gs + soff(k)) : VT::raw_global(g + goff(k));
    return r;
  };
  // xv <- xhat, gv <- dn
  auto grads = [&](float (&xv)[V], float (&gv)[V], const Pair& r) {
    VT::unpack(xv, r.x);
    VT::unpack(gv, r.g);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float xh = (xv[v] - mean[v]) * inv[v];
      const float n = fmaf(xh, gam[v], bet[v]);
      const float sig = gn::sigmoid(n);
      xv[v] = xh;
      gv[v] = gv[v] * sig * fmaf(n, 1.f - sig, 1.f);
    }
  };

  float r1[V], r2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) r1[v] = r2[v] = 0.f;
  auto add = [&](int, const Pair& r) {
    float xv[V], gv[V];
    grads(xv, gv, r);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      r1[v] += gv[v];
      r2[v] = fmaf(gv[v], xv[v], r2[v]);
    }
  };

  if constexpr (kStage) {
#pragma unroll 1
    for (int q = 0; q < gn::kChunks; ++q) {
      for (int k = q * per; k < min((q + 1) * per, k_st); ++k) {
        if (k < k_x) hopper::cp_async_16(hopper::smem_addr(xs + soff(k)), x + goff(k), true);
        if (k < k_g) hopper::cp_async_16(hopper::smem_addr(gs + soff(k)), g + goff(k), true);
      }
      hopper::cp_async_commit();
    }
  }
  // rows with nothing staged, straight from global memory, while the copies land
  gn::rows_in_groups<gn::kUnrollBwd>(k_st, k_all, load, add);
  if constexpr (kStage) {
#pragma unroll 1
    for (int q = 0; q < gn::kChunks; ++q) {
      gn::wait_chunk(q);
      gn::rows_in_groups<gn::kUnrollBwd>(q * per, min((q + 1) * per, k_st), load, add);
    }
  }

  const float* tot = gn::cluster_fold<V>(r1, r2, smem, l, a.sc, a.cs, nv);

  if (p.rank == 0) {  // this image's r1 / r2 of the slice's channels
    for (int e = tid; e < 2 * a.sc; e += blockDim.x) {
      const int which = e / a.sc;
      a.r_out[(static_cast<int64_t>(p.b) * 2 + which) * a.c + p.slice * a.sc + (e - which * a.sc)] = tot[e];
    }
  }
  // group fold: A_g / m and B_g / m for every channel of the slice, in place
  // of gamma (each group's thread reads and writes only its own channels)
  const int groups = a.sc / a.cg;
  for (int gi = tid; gi < groups; gi += blockDim.x) {
    float ag = 0.f, bg = 0.f;
    for (int k = 0; k < a.cg; ++k) {
      const float gk = coef[gi * a.cg + k];
      ag = fmaf(gk, tot[gi * a.cg + k], ag);
      bg = fmaf(gk, tot[a.sc + gi * a.cg + k], bg);
    }
    for (int k = 0; k < a.cg; ++k) {
      coef[gi * a.cg + k] = ag / a.count;
      coef[a.sc + gi * a.cg + k] = bg / a.count;
    }
  }
  __syncthreads();
  float ac[V], bc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    ac[v] = coef[j * V + v];
    bc[v] = coef[a.sc + j * V + v];
  }

  auto write = [&](int k, const Pair& r) {
    float xv[V], gv[V];
    grads(xv, gv, r);
#pragma unroll
    for (int v = 0; v < V; ++v) xv[v] = inv[v] * (gv[v] * gam[v] - ac[v] - xv[v] * bc[v]);
    VT::store_global(dx + goff(k), xv);
  };
  gn::rows_in_groups<gn::kUnrollBwd>(0, k_all, load, write);
  gn::cluster_wait();  // no block leaves while another may still read its partials
}

// Raises the instantiation's dynamic shared-memory limit (once per new maximum)
// and allows clusters of 16 (non-portable: the portable limit is 8).
template <typename T, int V>
cudaError_t prepare(int smem_bytes) {
  static int limit = -1;
  if (smem_bytes <= limit) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(groupnorm_silu_bwd_kernel<T, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(groupnorm_silu_bwd_kernel<T, V>,
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
cudaError_t launch(const BwdArgs& a, int b, int threads, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = prepare<T, V>(smem_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  config(cfg, attr, b * (a.c / a.sc) * a.cs, a.cs, threads, smem_bytes, stream);
  err = cudaLaunchKernelEx(&cfg, groupnorm_silu_bwd_kernel<T, V>, a);
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
  return cudaOccupancyMaxActiveClusters(out, groupnorm_silu_bwd_kernel<T, V>, &cfg);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; vec: 16 / sizeof(element) or 1.
extern "C" int groupnorm_silu_bwd_clusters(int dtype, int vec, int cs, int threads, int smem_bytes,
                                           int* out) {
  if (dtype == 0 && vec == 4) return static_cast<int>(clusters<float, 4>(cs, threads, smem_bytes, out));
  if (dtype == 0 && vec == 1) return static_cast<int>(clusters<float, 1>(cs, threads, smem_bytes, out));
  if (dtype == 1 && vec == 8)
    return static_cast<int>(clusters<__nv_bfloat16, 8>(cs, threads, smem_bytes, out));
  if (dtype == 1 && vec == 1)
    return static_cast<int>(clusters<__nv_bfloat16, 1>(cs, threads, smem_bytes, out));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int groupnorm_silu_bwd(const void* x, const void* g, void* dx, const float* scale,
                                  const float* bias, const float* mean, const float* inv,
                                  float* r_out, int b, int hw, int c, int cg, int sc, int cs,
                                  int rows_per_block, int staged_x, int staged_g, int vec,
                                  int threads, int smem_bytes, int dtype, void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  const int nv = sc / vec;
  const bool shape_ok = sc % vec == 0 && sc % cg == 0 && c % sc == 0 && threads % nv == 0 &&
                        threads <= gn::kMaxThreads && cs * rows_per_block >= hw &&
                        (vec > 1 || (staged_x == 0 && staged_g == 0)) &&
                        staged_x <= rows_per_block && staged_g <= rows_per_block;
  if (!shape_ok || gn::layout(sc, cs, threads, nv, staged_x, staged_g, esize).total !=
                       static_cast<size_t>(smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdArgs a{x, g, dx, scale, bias, mean, inv, r_out, hw, c, cg, sc, cs, rows_per_block,
            staged_x, staged_g, nv, static_cast<float>(hw) * cg};
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
// backward is two entries around the caller's all-reduce of the sums, as the
// TPU backward is two kernels (_bwd_reduce_kernel, _bwd_dx_kernel):
//
//   groupnorm_silu_split_bwd_reduce: per (image, channel) r1 = sum dn and
//     r2 = sum dn * xhat over this rank's rows, [B, 2, C] f32 (two launches:
//     per-tile partials, then their fold over the tiles in order); they are
//     also this rank's partials of dbeta and dgamma;
//   groupnorm_silu_split_bwd_dx: from the all-reduced [B, 2, C] sums, A_g and
//     B_g per group (gamma-weighted, channels in order, as the fused kernel
//     folds them) and dx = inv * (dn * gamma - A_g / m - xhat * B_g / m),
//     m = the group's elements over the whole image (the count argument).
//
// Bound on an H100: bytes. The reduce reads x and g once; the dx reads them
// again and writes dx: 5/3 of the fused kernel's bytes. Both return
// cudaGetLastError() after their launches (cudaErrorInvalidValue on
// arguments that disagree with the cut).

namespace {

// xv <- xhat, gv <- dn (the fused kernel's arithmetic)
template <int V>
__device__ __forceinline__ void split_grads(float (&xv)[V], float (&gv)[V],
                                            const gn::split::Coef<V>& cf) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float xh = (xv[v] - cf.mean[v]) * cf.inv[v];
    const float n = fmaf(xh, cf.gam[v], cf.bet[v]);
    const float sig = gn::sigmoid(n);
    xv[v] = xh;
    gv[v] = gv[v] * sig * fmaf(n, 1.f - sig, 1.f);
  }
}

struct BwdReduceOp {
  static constexpr bool kNeedsCoef = true;
  template <int V>
  __device__ __forceinline__ static void add(float (&s1)[V], float (&s2)[V], const float (&x)[V],
                                             const float (&g)[V], const gn::split::Coef<V>& cf) {
    float xv[V], gv[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      xv[v] = x[v];
      gv[v] = g[v];
    }
    split_grads<V>(xv, gv, cf);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      s1[v] += gv[v];
      s2[v] = fmaf(gv[v], xv[v], s2[v]);
    }
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(gn::kMaxThreads) split_dx_kernel(gn::split::Args a) {
  using VT = Vec<T, V>;
  const gn::split::Tile t = gn::split::tile(a);
  const int ch0 = t.j * V;
  gn::split::Coef<V> cf;
  cf.load(a, t.b, ch0);
  const float* r1 = a.r + static_cast<int64_t>(t.b) * 2 * a.c;
  const float* r2 = r1 + a.c;
  float ac[V], bc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int first = (ch0 + v) / a.cpg * a.cpg;
    float ag = 0.f, bg = 0.f;
    for (int k = 0; k < a.cpg; ++k) {
      const float gk = a.scale[first + k];
      ag = fmaf(gk, r1[first + k], ag);
      bg = fmaf(gk, r2[first + k], bg);
    }
    ac[v] = ag / a.count;
    bc[v] = bg / a.count;
  }
  const int64_t base = (static_cast<int64_t>(t.b) * a.hw + t.row0) * a.c + ch0;
  const T* x = static_cast<const T*>(a.x) + base;
  const T* g = static_cast<const T*>(a.g) + base;
  T* dx = static_cast<T*>(a.out) + base;
  for (int row = t.tr; row < t.nrows; row += t.rit) {
    const int64_t o = static_cast<int64_t>(row) * a.c;
    float xv[V], gv[V];
    VT::unpack(xv, VT::raw_global(x + o));
    VT::unpack(gv, VT::raw_global(g + o));
    split_grads<V>(xv, gv, cf);
#pragma unroll
    for (int v = 0; v < V; ++v) xv[v] = cf.inv[v] * (gv[v] * cf.gam[v] - ac[v] - xv[v] * bc[v]);
    VT::store_global(dx + o, xv);
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
extern "C" int groupnorm_silu_split_bwd_reduce(const void* x, const void* g, const float* scale,
                                               const float* bias, const float* mean,
                                               const float* inv, float* partial, float* r_out,
                                               int b, int hw, int c, int cg, int tiles,
                                               int rows_per_tile, int vec, int threads, int dtype,
                                               void* stream) {
  if (!gn::split::args_ok(c, cg, vec, threads, tiles, rows_per_tile, hw))
    return static_cast<int>(cudaErrorInvalidValue);
  const gn::split::Args a = split_args(x, g, nullptr, scale, bias, mean, inv, nullptr, partial, hw,
                                       c, cg, tiles, rows_per_tile, vec, 0.f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 4)
    return static_cast<int>(gn::split::reduce<float, 4, BwdReduceOp>(a, b, threads, r_out, 0, s));
  if (dtype == 0 && vec == 1)
    return static_cast<int>(gn::split::reduce<float, 1, BwdReduceOp>(a, b, threads, r_out, 0, s));
  if (dtype == 1 && vec == 8)
    return static_cast<int>(
        gn::split::reduce<__nv_bfloat16, 8, BwdReduceOp>(a, b, threads, r_out, 0, s));
  if (dtype == 1 && vec == 1)
    return static_cast<int>(
        gn::split::reduce<__nv_bfloat16, 1, BwdReduceOp>(a, b, threads, r_out, 0, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int groupnorm_silu_split_bwd_dx(const void* x, const void* g, void* dx,
                                           const float* scale, const float* bias,
                                           const float* mean, const float* inv, const float* r,
                                           int b, int hw, int c, int cg, int tiles,
                                           int rows_per_tile, int vec, int threads, int dtype,
                                           float count, void* stream) {
  if (!gn::split::args_ok(c, cg, vec, threads, tiles, rows_per_tile, hw))
    return static_cast<int>(cudaErrorInvalidValue);
  const gn::split::Args a = split_args(x, g, dx, scale, bias, mean, inv, r, nullptr, hw, c, cg,
                                       tiles, rows_per_tile, vec, count);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles, b);
  if (dtype == 0 && vec == 4) split_dx_kernel<float, 4><<<grid, threads, 0, s>>>(a);
  else if (dtype == 0 && vec == 1) split_dx_kernel<float, 1><<<grid, threads, 0, s>>>(a);
  else if (dtype == 1 && vec == 8) split_dx_kernel<__nv_bfloat16, 8><<<grid, threads, 0, s>>>(a);
  else if (dtype == 1 && vec == 1) split_dx_kernel<__nv_bfloat16, 1><<<grid, threads, 0, s>>>(a);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
