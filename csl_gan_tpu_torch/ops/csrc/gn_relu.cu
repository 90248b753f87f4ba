// Fused GroupNorm + ReLU, forward (K4) and backward (K5), for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas pair in csl_gan_tpu/ops/pallas_groupnorm.py:
//   K4  _fwd_kernel (:111, via _pallas_fwd :152)
//   K5  _bwd_kernel (:119, via _pallas_bwd :173)
// and follows the rules of its default XLA formulation _gn_relu_xla (:223):
// per-(sample, group) statistics in fp32 (mean, then var = max(E[x^2] -
// mean^2, 0)), the affine a = rstd * gamma, d = beta - (mean * rstd) * gamma
// in fp32, the ReLU mask taken from the fp32 affine x * a + d (:297-309), and
// the output rounded once to x's dtype. The backward recomputes the
// statistics from x and forms
//     dz = dy * 1[x * a + d > 0]
//     dx = rstd * (dz * gamma - mean_grp(dz * gamma) - xhat * mean_grp(dz * gamma * xhat))
//     dgamma = sum(dz * xhat), dbeta = sum(dz)
// Every sum is fp32 in an order fixed by the launch plan, with no atomics, so
// two calls on the same inputs give the same bits. The element-wise formulas
// use the _rn intrinsics in the plain version's order of operations (no
// contraction into FMAs), so the kernels differ from it only through the
// order of the sums.
//
// Layout: x, y, dy, dx are [B, HW, C] (a channels-last activation), fp32 or
// bf16, 16-byte aligned; gamma, beta, dgamma, dbeta are [C] fp32.
//
// Bound on an H100 SXM: bytes. K4 must read x once and write y once (4 bytes
// an element in bf16), K5 read x and dy and write dx once (6 bytes); the
// arithmetic is ~10 flop an element. Over the generator's nine bf16 norms at
// B 128 (126.9 M elements) that is 507 MB, 0.152 ms, and 761 MB, 0.227 ms, at
// 3.35 TB/s. The TPU kernel held one whole sample in VMEM and read it once; a
// sample of the largest norm is 512 KiB of bf16 (1 MiB with dy), more than an
// SM's shared memory. So the one-pass variant cuts a sample across a
// thread-block cluster of n CTAs (n <= 16, on neighbouring SMs). Each CTA
// copies its row slice of x (and dy) into shared memory once with bulk
// asynchronous copies (cp.async.bulk, in pieces on mbarriers so that the sums
// start on the first piece), sums it per channel in a fixed order, and
// publishes the sums in its shared memory; after a cluster barrier every CTA
// reads the n CTAs' sums through distributed shared memory in rank order, so
// all derive the same statistics, and writes y (K4) from the resident slice
// with 16-byte stores. K5 exchanges twice (the statistics, then the
// per-channel sums of dz and dz * xhat), writes dx from the slice, and its
// rank-0 CTA writes the sample's sums to a [B, 2, C] scratch that a second,
// batch-parallel launch sums over B in a fixed order into dgamma and dbeta.
// x and dy are read from device memory once: one launch per norm for K4, two
// for K5.
//
// A geometry whose slice does not fit even at n = 16 (C = 1024 at a large
// HW) takes the two-pass variant: per-chunk channel sums with 16-byte
// loads, the statistics once per sample into a [B, groups] buffer, then the
// element-wise pass (and for K5 the same for dz, then dx). The variant, the
// cluster size, the rows per CTA, the threads and the dynamic shared memory
// come from the launch plan that pallas_groupnorm.launch_plan computes from
// the geometry; the launchers check the plan against the geometry and return
// an error code if it does not fit. K4 takes K5's cut of a geometry (variant,
// n, rows, threads), so both sum the statistics in the same order and K5's
// ReLU mask is the one K4 applied.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace coop = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxC = 1024;
constexpr int kMaxCluster = 16;
constexpr int kMaxSmem = 232448;
constexpr int kPieces = 4;          // bulk-copy pieces of a one-pass slice
constexpr int kOnePass = 1, kTwoPass = 2;

enum Err {
  kErrDtype = 1000, kErrGeometry = 1001, kErrEmpty = 1002, kErrAlign = 1003,
  kErrPlan = 1004
};

struct Geo {
  int b, hw, c, groups;
  int variant, n, rows, threads, smem, chunks;
  float eps;
};

// ---- 16-byte vectors: V elements of T --------------------------------------

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void load(const float* p, float (&f)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[8]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {   // a bf16 is the high half of its fp32
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Thread t of a CTA owns the channel vector cv = t % vr (channels cv * V ..
// cv * V + V - 1) of vr = c / V; iteration i of a slice visits its vector j =
// t + i * threads. threads is a multiple of vr, so a CTA's iteration covers
// threads consecutive vectors (coalesced, and each thread always meets the
// same channels). Where vr < 32 a warp holds 32 / vr threads of each channel
// vector, which the lane sums first add by shuffles; the shared-memory
// scratch then holds one row a warp: rl = threads / max(vr, 32) rows of c
// floats per quantity, row rlane written by the writer threads.
struct Lay {
  int vr, cv, rl, rlane;
  bool writer;
  __device__ Lay(int c, int v) {
    vr = c / v;
    cv = threadIdx.x % vr;
    const int span = vr < 32 ? 32 : vr;
    rl = blockDim.x / span;
    rlane = threadIdx.x / span;
    writer = vr >= 32 || (threadIdx.x & 31) < vr;
  }
};

// Per-channel sums of the lanes' register partials acc0 / acc1 [V], added in
// a fixed order (a shuffle butterfly inside the warp, then the warps in
// order), into out0 / out1 [c] (shared or global). red holds 2 * rl * c
// floats. Starts and ends with a barrier.
template <int V>
__device__ void lane_sums(float (&acc0)[V], float (&acc1)[V], const Lay& lay, int c,
                          float* red, float* out0, float* out1) {
  for (int off = lay.vr; off < 32; off *= 2) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      acc0[e] += __shfl_xor_sync(0xffffffffu, acc0[e], off);
      acc1[e] += __shfl_xor_sync(0xffffffffu, acc1[e], off);
    }
  }
  __syncthreads();
  if (lay.writer) {
    float* r0 = red + (size_t)lay.rlane * c + lay.cv * V;
    float* r1 = red + (size_t)(lay.rl + lay.rlane) * c + lay.cv * V;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      r0[e] = acc0[e];
      r1[e] = acc1[e];
    }
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float s0 = 0.f, s1 = 0.f;
    for (int l = 0; l < lay.rl; ++l) {
      s0 += red[(size_t)l * c + ch];
      s1 += red[(size_t)(lay.rl + l) * c + ch];
    }
    out0[ch] = s0;
    out1[ch] = s1;
  }
  __syncthreads();
}

// Group mean and rstd from the per-channel sums of x and x^2 of one sample,
// in the plain version's order of operations.
__device__ void group_stats(const float* s, const float* ss, const Geo& g,
                            float* mean, float* rstd) {
  const int cg = g.c / g.groups;
  const float n = (float)g.hw * (float)cg;
  for (int gr = threadIdx.x; gr < g.groups; gr += blockDim.x) {
    float t = 0.f, tt = 0.f;
    for (int k = 0; k < cg; ++k) {
      t += s[gr * cg + k];
      tt += ss[gr * cg + k];
    }
    const float m = __fdiv_rn(t, n);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(tt, n), __fmul_rn(m, m)), 0.f);
    mean[gr] = m;
    rstd[gr] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, g.eps)));
  }
}

// mean_grp(dz * gamma) and mean_grp(dz * gamma * xhat) of one sample from the
// per-channel sums of dz and dz * xhat.
__device__ void group_grad_means(const float* s1, const float* s2,
                                 const float* __restrict__ gamma, const Geo& g,
                                 float* m2, float* m1) {
  const int cg = g.c / g.groups;
  const float n = (float)g.hw * (float)cg;
  for (int gr = threadIdx.x; gr < g.groups; gr += blockDim.x) {
    float t2 = 0.f, t1 = 0.f;
    for (int k = 0; k < cg; ++k) {
      const int ch = gr * cg + k;
      t2 += __fmul_rn(s1[ch], gamma[ch]);
      t1 += __fmul_rn(s2[ch], gamma[ch]);
    }
    m2[gr] = __fdiv_rn(t2, n);
    m1[gr] = __fdiv_rn(t1, n);
  }
}

// The thread's channels' affine from the group statistics (mean, rstd [groups]).
template <int V>
struct ChanAffine {
  float a[V], d[V], mean[V], rstd[V];
  __device__ void load(const float* gmean, const float* grstd,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta, int c0, int cg) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int gr = (c0 + e) / cg;
      mean[e] = gmean[gr];
      rstd[e] = grstd[gr];
      a[e] = __fmul_rn(rstd[e], gamma[c0 + e]);
      d[e] = __fsub_rn(beta[c0 + e], __fmul_rn(__fmul_rn(mean[e], rstd[e]), gamma[c0 + e]));
    }
  }
  __device__ __forceinline__ float z(float x, int e) const {
    return __fadd_rn(__fmul_rn(x, a[e]), d[e]);
  }
  __device__ __forceinline__ float xhat(float x, int e) const {
    return __fmul_rn(__fsub_rn(x, mean[e]), rstd[e]);
  }
};

// dz and the two per-channel terms of the backward for one vector.
template <int V>
__device__ __forceinline__ void bwd_terms(const ChanAffine<V>& af, const float (&xv)[V],
                                          const float (&dyv)[V], float (&s1)[V],
                                          float (&s2)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float dz = af.z(xv[e], e) > 0.f ? dyv[e] : 0.f;
    s1[e] += dz;
    s2[e] += __fmul_rn(dz, af.xhat(xv[e], e));
  }
}

template <int V>
__device__ __forceinline__ void dx_of(const ChanAffine<V>& af, const float* gamma_v,
                                      const float* m2, const float* m1,
                                      const float (&xv)[V], const float (&dyv)[V],
                                      float (&out)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float dz = af.z(xv[e], e) > 0.f ? dyv[e] : 0.f;
    const float t = __fsub_rn(__fsub_rn(__fmul_rn(dz, gamma_v[e]), m2[e]),
                              __fmul_rn(af.xhat(xv[e], e), m1[e]));
    out[e] = __fmul_rn(af.rstd[e], t);
  }
}

// ---- the one-pass (cluster) variant ----------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Shared memory of a one-pass CTA, in this order (each part 128-byte aligned):
// the x slice (and the dy slice), the lane-sum scratch red [2 * lanes * c],
// the published sums [2 * c] (and a second exchange [2 * c]), the group
// statistics [4 * groups], the mbarriers. pallas_groupnorm.launch_plan
// computes the same sizes.
__host__ __device__ inline size_t align128(size_t v) { return (v + 127) & ~size_t(127); }

// The lane-sum scratch red [2 * rl * c] floats (Lay).
__host__ __device__ inline size_t red_bytes(const Geo& g, int esize) {
  const int vr = g.c / (16 / esize);
  return align128((size_t)2 * (g.threads / (vr < 32 ? 32 : vr)) * g.c * 4);
}

struct OnePassSmem {
  size_t slice, red, xch, grp, bars, total;
  __host__ __device__ OnePassSmem(const Geo& g, int esize, bool backward) {
    slice = align128((size_t)g.rows * g.c * esize);
    red = red_bytes(g, esize);
    xch = align128((size_t)(backward ? 4 : 2) * g.c * 4);
    grp = align128((size_t)4 * g.groups * 4);
    bars = align128((size_t)kPieces * 8);
    total = slice * (backward ? 2 : 1) + red + xch + grp + bars;
  }
};

// The cluster's slice of sample b for this CTA: rows [r0, r1).
struct Slice {
  int b, rank, r0, r1, nvec, iters;
  size_t off;   // element offset of row r0 of sample b
};

__device__ Slice slice_of(const Geo& g, const coop::cluster_group& cluster, int vr) {
  Slice s;
  s.rank = (int)cluster.block_rank();
  s.b = blockIdx.x / g.n;
  s.r0 = s.rank * g.rows;
  s.r1 = min(g.hw, s.r0 + g.rows);
  s.nvec = (s.r1 - s.r0) * vr;
  s.iters = (s.nvec + blockDim.x - 1) / blockDim.x;
  s.off = ((size_t)s.b * g.hw + s.r0) * g.c;
  return s;
}

__device__ __forceinline__ int piece_begin(int p, int pieces, int iters) {
  return (int)(((long long)p * iters) / pieces);
}

// Thread 0 starts the bulk copies of the slice (of up to two tensors) in
// pieces of whole iterations, one mbarrier each; returns the piece count.
template <typename T>
__device__ int start_slice(const Slice& s, const T* src0, T* dst0, const T* src1,
                           T* dst1, uint64_t* bars, int v) {
  const int pieces = min(kPieces, s.iters);
  if (threadIdx.x == 0) {
    for (int p = 0; p < pieces; ++p)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(bars + p))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int p = 0; p < pieces; ++p) {
      const int j0 = piece_begin(p, pieces, s.iters) * blockDim.x;
      const int j1 = min(s.nvec, piece_begin(p + 1, pieces, s.iters) * (int)blockDim.x);
      const uint32_t bytes = (uint32_t)(j1 - j0) * 16u;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(smem_addr(bars + p)), "r"(bytes * (src1 ? 2u : 1u)) : "memory");
      bulk_load(dst0 + (size_t)j0 * v, src0 + s.off + (size_t)j0 * v, bytes, bars + p);
      if (src1) bulk_load(dst1 + (size_t)j0 * v, src1 + s.off + (size_t)j0 * v, bytes, bars + p);
    }
  }
  return pieces;
}

// Sums over the n CTAs of the cluster of their published [2 * c] sums, in
// rank order, into out [2 * c]; then this CTA no longer reads remote memory.
__device__ void cluster_sums(const coop::cluster_group& cluster, float* xch, int c,
                             int n, float* out) {
  for (int ch = threadIdx.x; ch < 2 * c; ch += blockDim.x) {
    float t = 0.f;
    for (int k = 0; k < n; ++k) t += cluster.map_shared_rank(xch, k)[ch];
    out[ch] = t;
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");   // release
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");      // acquire
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
gn_fwd_cluster(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, T* __restrict__ y, Geo g) {
  constexpr int V = Vec<T>::V;
  extern __shared__ __align__(128) unsigned char smem[];
  coop::cluster_group cluster = coop::this_cluster();
  const OnePassSmem L(g, sizeof(T), false);
  T* xs = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + L.slice);
  float* xch = reinterpret_cast<float*>(smem + L.slice + L.red);
  float* grp = reinterpret_cast<float*>(smem + L.slice + L.red + L.xch);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.slice + L.red + L.xch + L.grp);
  const Lay lay(g.c, V);
  const Slice s = slice_of(g, cluster, lay.vr);
  const int pieces = start_slice<T>(s, x, xs, nullptr, nullptr, bars, V);

  float acc0[V], acc1[V], xv[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc0[e] = acc1[e] = 0.f;
  for (int p = 0; p < pieces; ++p) {
    mbar_wait(bars + p, 0);
    const int i1 = piece_begin(p + 1, pieces, s.iters);
    for (int i = piece_begin(p, pieces, s.iters); i < i1; ++i) {
      const int j = threadIdx.x + i * blockDim.x;
      if (j >= s.nvec) break;
      Vec<T>::load(xs + (size_t)j * V, xv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        acc0[e] += xv[e];
        acc1[e] += __fmul_rn(xv[e], xv[e]);
      }
    }
  }
  lane_sums<V>(acc0, acc1, lay, g.c, red, xch, xch + g.c);
  cluster.sync();                               // every CTA's sums published
  cluster_sums(cluster, xch, g.c, g.n, red);
  cluster_arrive();                             // done reading the others' sums
  __syncthreads();
  group_stats(red, red + g.c, g, grp, grp + g.groups);
  __syncthreads();
  ChanAffine<V> af;
  af.load(grp, grp + g.groups, gamma, beta, lay.cv * V, g.c / g.groups);
  float out[V];
  for (int i = 0; i < s.iters; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    if (j >= s.nvec) break;
    Vec<T>::load(xs + (size_t)j * V, xv);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float z = af.z(xv[e], e);
      out[e] = z > 0.f ? z : 0.f;
    }
    Vec<T>::store(y + s.off + (size_t)j * V, out);
  }
  cluster_wait();                               // no CTA exits while read
}

// K5, one pass. psum [B, 2, C]: the sample's per-channel sums of dz and
// dz * xhat, written by the cluster's rank-0 CTA.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
gn_bwd_cluster(const T* __restrict__ x, const T* __restrict__ dy,
               const float* __restrict__ gamma, const float* __restrict__ beta,
               T* __restrict__ dx, float* __restrict__ psum, Geo g) {
  constexpr int V = Vec<T>::V;
  extern __shared__ __align__(128) unsigned char smem[];
  coop::cluster_group cluster = coop::this_cluster();
  const OnePassSmem L(g, sizeof(T), true);
  T* xs = reinterpret_cast<T*>(smem);
  T* dys = reinterpret_cast<T*>(smem + L.slice);
  unsigned char* rest = smem + 2 * L.slice;
  float* red = reinterpret_cast<float*>(rest);
  float* xch = reinterpret_cast<float*>(rest + L.red);
  float* xch2 = xch + 2 * g.c;
  float* grp = reinterpret_cast<float*>(rest + L.red + L.xch);
  uint64_t* bars = reinterpret_cast<uint64_t*>(rest + L.red + L.xch + L.grp);
  const Lay lay(g.c, V);
  const Slice s = slice_of(g, cluster, lay.vr);
  const int pieces = start_slice<T>(s, x, xs, dy, dys, bars, V);

  float acc0[V], acc1[V], xv[V], dyv[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc0[e] = acc1[e] = 0.f;
  for (int p = 0; p < pieces; ++p) {
    mbar_wait(bars + p, 0);
    const int i1 = piece_begin(p + 1, pieces, s.iters);
    for (int i = piece_begin(p, pieces, s.iters); i < i1; ++i) {
      const int j = threadIdx.x + i * blockDim.x;
      if (j >= s.nvec) break;
      Vec<T>::load(xs + (size_t)j * V, xv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        acc0[e] += xv[e];
        acc1[e] += __fmul_rn(xv[e], xv[e]);
      }
    }
  }
  // Exchange 1: the statistics.
  lane_sums<V>(acc0, acc1, lay, g.c, red, xch, xch + g.c);
  cluster.sync();
  cluster_sums(cluster, xch, g.c, g.n, red);
  __syncthreads();
  float* gmean = grp;
  float* grstd = grp + g.groups;
  float* gm2 = grp + 2 * g.groups;
  float* gm1 = grp + 3 * g.groups;
  group_stats(red, red + g.c, g, gmean, grstd);
  __syncthreads();
  const int c0 = lay.cv * V, cgs = g.c / g.groups;
  ChanAffine<V> af;
  af.load(gmean, grstd, gamma, beta, c0, cgs);

  // Exchange 2: the per-channel sums of dz and dz * xhat.
#pragma unroll
  for (int e = 0; e < V; ++e) acc0[e] = acc1[e] = 0.f;
  for (int i = 0; i < s.iters; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    if (j >= s.nvec) break;
    Vec<T>::load(xs + (size_t)j * V, xv);
    Vec<T>::load(dys + (size_t)j * V, dyv);
    bwd_terms<V>(af, xv, dyv, acc0, acc1);
  }
  lane_sums<V>(acc0, acc1, lay, g.c, red, xch2, xch2 + g.c);
  cluster.sync();                               // also: all exchange-1 reads done
  cluster_sums(cluster, xch2, g.c, g.n, red);
  cluster_arrive();
  __syncthreads();
  if (s.rank == 0) {
    for (int ch = threadIdx.x; ch < 2 * g.c; ch += blockDim.x)
      psum[(size_t)s.b * 2 * g.c + ch] = red[ch];
  }
  group_grad_means(red, red + g.c, gamma, g, gm2, gm1);
  __syncthreads();
  float gam[V], m2[V], m1[V], out[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    gam[e] = gamma[c0 + e];
    m2[e] = gm2[(c0 + e) / cgs];
    m1[e] = gm1[(c0 + e) / cgs];
  }
  for (int i = 0; i < s.iters; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    if (j >= s.nvec) break;
    Vec<T>::load(xs + (size_t)j * V, xv);
    Vec<T>::load(dys + (size_t)j * V, dyv);
    dx_of<V>(af, gam, m2, m1, xv, dyv, out);
    Vec<T>::store(dx + s.off + (size_t)j * V, out);
  }
  cluster_wait();
}

// ---- the two-pass variant --------------------------------------------------
// Grid (chunks, B); chunk k of sample b covers rows [k * rows, (k + 1) * rows).

struct Chunk {
  int b, k, nvec, iters;
  size_t off;
};

__device__ Chunk chunk_of(const Geo& g, int vr) {
  Chunk ch;
  ch.k = blockIdx.x;
  ch.b = blockIdx.y;
  const int r0 = ch.k * g.rows, r1 = min(g.hw, r0 + g.rows);
  ch.nvec = (r1 - r0) * vr;
  ch.iters = (ch.nvec + blockDim.x - 1) / blockDim.x;
  ch.off = ((size_t)ch.b * g.hw + r0) * g.c;
  return ch;
}

// ps [B, chunks, 2, C]: per-chunk channel sums of x and x^2.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_chunk_stats(const T* __restrict__ x, float* __restrict__ ps, Geo g) {
  constexpr int V = Vec<T>::V;
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  const Lay lay(g.c, V);
  const Chunk ch = chunk_of(g, lay.vr);
  float acc0[V], acc1[V], xv[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc0[e] = acc1[e] = 0.f;
  for (int i = 0; i < ch.iters; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    if (j >= ch.nvec) break;
    Vec<T>::load(x + ch.off + (size_t)j * V, xv);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      acc0[e] += xv[e];
      acc1[e] += __fmul_rn(xv[e], xv[e]);
    }
  }
  float* out = ps + ((size_t)ch.b * g.chunks + ch.k) * 2 * g.c;
  lane_sums<V>(acc0, acc1, lay, g.c, red, out, out + g.c);
}

// One CTA per sample: the [chunks, 2, C] partials summed over the chunks in
// order, into tot [2, C] in shared memory.
__device__ void sum_chunks(const float* __restrict__ part, const Geo& g, float* tot) {
  const float* pb = part + (size_t)blockIdx.x * g.chunks * 2 * g.c;
  for (int ch = threadIdx.x; ch < 2 * g.c; ch += blockDim.x) {
    float t = 0.f;
    for (int k = 0; k < g.chunks; ++k) t += pb[(size_t)k * 2 * g.c + ch];
    tot[ch] = t;
  }
  __syncthreads();
}

// stats [B, 2, groups]: mean and rstd of each group.
__global__ void __launch_bounds__(kMaxThreads)
gn_sample_stats(const float* __restrict__ ps, float* __restrict__ stats, Geo g) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* tot = reinterpret_cast<float*>(smem);
  sum_chunks(ps, g, tot);
  float* st = stats + (size_t)blockIdx.x * 2 * g.groups;
  group_stats(tot, tot + g.c, g, st, st + g.groups);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_apply(const T* __restrict__ x, const float* __restrict__ stats,
         const float* __restrict__ gamma, const float* __restrict__ beta,
         T* __restrict__ y, Geo g) {
  constexpr int V = Vec<T>::V;
  const Lay lay(g.c, V);
  const Chunk ch = chunk_of(g, lay.vr);
  const float* st = stats + (size_t)ch.b * 2 * g.groups;
  ChanAffine<V> af;
  af.load(st, st + g.groups, gamma, beta, lay.cv * V, g.c / g.groups);
  float xv[V], out[V];
  for (int i = 0; i < ch.iters; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    if (j >= ch.nvec) break;
    Vec<T>::load(x + ch.off + (size_t)j * V, xv);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float z = af.z(xv[e], e);
      out[e] = z > 0.f ? z : 0.f;
    }
    Vec<T>::store(y + ch.off + (size_t)j * V, out);
  }
}

// pd [B, chunks, 2, C]: per-chunk channel sums of dz and dz * xhat.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_bwd_chunk(const T* __restrict__ x, const T* __restrict__ dy,
             const float* __restrict__ stats, const float* __restrict__ gamma,
             const float* __restrict__ beta, float* __restrict__ pd, Geo g) {
  constexpr int V = Vec<T>::V;
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  const Lay lay(g.c, V);
  const Chunk ch = chunk_of(g, lay.vr);
  const float* st = stats + (size_t)ch.b * 2 * g.groups;
  ChanAffine<V> af;
  af.load(st, st + g.groups, gamma, beta, lay.cv * V, g.c / g.groups);
  float acc0[V], acc1[V], xv[V], dyv[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc0[e] = acc1[e] = 0.f;
  for (int i = 0; i < ch.iters; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    if (j >= ch.nvec) break;
    Vec<T>::load(x + ch.off + (size_t)j * V, xv);
    Vec<T>::load(dy + ch.off + (size_t)j * V, dyv);
    bwd_terms<V>(af, xv, dyv, acc0, acc1);
  }
  float* out = pd + ((size_t)ch.b * g.chunks + ch.k) * 2 * g.c;
  lane_sums<V>(acc0, acc1, lay, g.c, red, out, out + g.c);
}

// One CTA per sample: psum [B, 2, C] (the sample's sums of dz, dz * xhat) and
// gm [B, 2, groups] (mean_grp(dz * gamma), mean_grp(dz * gamma * xhat)).
__global__ void __launch_bounds__(kMaxThreads)
gn_bwd_sample(const float* __restrict__ pd, const float* __restrict__ gamma,
              float* __restrict__ psum, float* __restrict__ gm, Geo g) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* tot = reinterpret_cast<float*>(smem);
  sum_chunks(pd, g, tot);
  for (int ch = threadIdx.x; ch < 2 * g.c; ch += blockDim.x)
    psum[(size_t)blockIdx.x * 2 * g.c + ch] = tot[ch];
  float* m = gm + (size_t)blockIdx.x * 2 * g.groups;
  group_grad_means(tot, tot + g.c, gamma, g, m, m + g.groups);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_bwd_dx(const T* __restrict__ x, const T* __restrict__ dy,
          const float* __restrict__ stats, const float* __restrict__ gm,
          const float* __restrict__ gamma, const float* __restrict__ beta,
          T* __restrict__ dx, Geo g) {
  constexpr int V = Vec<T>::V;
  const Lay lay(g.c, V);
  const Chunk ch = chunk_of(g, lay.vr);
  const int c0 = lay.cv * V, cgs = g.c / g.groups;
  const float* st = stats + (size_t)ch.b * 2 * g.groups;
  const float* m = gm + (size_t)ch.b * 2 * g.groups;
  ChanAffine<V> af;
  af.load(st, st + g.groups, gamma, beta, c0, cgs);
  float gam[V], m2[V], m1[V], xv[V], dyv[V], out[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    gam[e] = gamma[c0 + e];
    m2[e] = m[(c0 + e) / cgs];
    m1[e] = m[g.groups + (c0 + e) / cgs];
  }
  for (int i = 0; i < ch.iters; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    if (j >= ch.nvec) break;
    Vec<T>::load(x + ch.off + (size_t)j * V, xv);
    Vec<T>::load(dy + ch.off + (size_t)j * V, dyv);
    dx_of<V>(af, gam, m2, m1, xv, dyv, out);
    Vec<T>::store(dx + ch.off + (size_t)j * V, out);
  }
}

// ---- dgamma, dbeta: psum [B, 2, C] summed over B ---------------------------
// Block (32, 32): 32 channels by 32 row lanes. Lane l sums the samples l, l +
// 32, ... in order, then lane 0 adds the 32 lanes in order: batch-parallel,
// fixed order, no atomics.

constexpr int kParamLanes = 32;

__global__ void __launch_bounds__(32 * kParamLanes)
gn_param_grads(const float* __restrict__ psum, int b, int c,
               float* __restrict__ dgamma, float* __restrict__ dbeta) {
  __shared__ float red[2][kParamLanes][33];
  const int ch = blockIdx.x * 32 + threadIdx.x;
  const int lane = threadIdx.y;
  float s1 = 0.f, s2 = 0.f;
  if (ch < c) {
    for (int r = lane; r < b; r += kParamLanes) {
      s1 += psum[(size_t)r * 2 * c + ch];
      s2 += psum[(size_t)r * 2 * c + c + ch];
    }
  }
  red[0][lane][threadIdx.x] = s1;
  red[1][lane][threadIdx.x] = s2;
  __syncthreads();
  if (lane == 0 && ch < c) {
    float t1 = 0.f, t2 = 0.f;
    for (int l = 0; l < kParamLanes; ++l) {
      t1 += red[0][l][threadIdx.x];
      t2 += red[1][l][threadIdx.x];
    }
    dbeta[ch] = t1;
    dgamma[ch] = t2;
  }
}

// ---- plans and launchers ---------------------------------------------------

// The geometry geo = [B, HW, C, groups] with the plan = [variant, cluster n,
// rows per CTA, threads, dynamic shared memory] of pallas_groupnorm.
// launch_plan; 0 if the kernels take both, else the error code.
int geo_of(const int* geo, const int* plan, int dtype, int backward, float eps, Geo& g) {
  g = Geo{geo[0], geo[1], geo[2], geo[3], plan[0], plan[1], plan[2], plan[3], plan[4], 0, eps};
  if (dtype != 0 && dtype != 1) return kErrDtype;
  if (g.b <= 0 || g.hw <= 0) return kErrEmpty;
  if (g.c < 8 || g.c > kMaxC || g.c % 8 != 0 || g.groups <= 0 || g.c % g.groups != 0)
    return kErrGeometry;
  if (g.c <= 256 ? 256 % g.c != 0 : g.c % 256 != 0) return kErrGeometry;
  const int esize = dtype == 1 ? 2 : 4;
  const int vr = g.c / (16 / esize);
  if (g.threads < 32 || g.threads > kMaxThreads || g.threads % 32 != 0 || g.threads % vr != 0)
    return kErrPlan;
  if (g.rows < 1 || g.smem < 0 || g.smem > kMaxSmem) return kErrPlan;
  g.chunks = (g.hw + g.rows - 1) / g.rows;
  if (g.variant == kOnePass) {
    if (g.n < 1 || g.n > kMaxCluster || g.n != g.chunks) return kErrPlan;
    if ((size_t)g.smem < OnePassSmem(g, esize, backward != 0).total) return kErrPlan;
  } else if (g.variant == kTwoPass) {
    if (g.n != 1 || (size_t)g.smem < red_bytes(g, esize)) return kErrPlan;
  } else {
    return kErrPlan;
  }
  return 0;
}

bool misaligned(const void* p) { return ((uintptr_t)p & 15u) != 0; }

// Allows every kernel that takes dynamic shared memory up to kMaxSmem of it,
// and the cluster kernels clusters of up to 16 CTAs, once per device (the
// attributes persist): a plan asks for at most kMaxSmem.
cudaError_t prepare() {
  constexpr int kMaxDevices = 64;
  static std::once_flag once[kMaxDevices];
  static cudaError_t err[kMaxDevices];
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(once[device], [device] {
    const void* clusters[] = {
        (const void*)gn_fwd_cluster<float>, (const void*)gn_fwd_cluster<__nv_bfloat16>,
        (const void*)gn_bwd_cluster<float>, (const void*)gn_bwd_cluster<__nv_bfloat16>};
    const void* others[] = {
        (const void*)gn_chunk_stats<float>, (const void*)gn_chunk_stats<__nv_bfloat16>,
        (const void*)gn_bwd_chunk<float>, (const void*)gn_bwd_chunk<__nv_bfloat16>,
        (const void*)gn_sample_stats, (const void*)gn_bwd_sample};
    cudaError_t r = cudaSuccess;
    for (const void* k : clusters) {
      if (r == cudaSuccess)
        r = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (r == cudaSuccess)
        r = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    for (const void* k : others)
      if (r == cudaSuccess)
        r = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    err[device] = r;
  });
  return err[device];
}

// CUDA launches issued without error by gn_relu_fwd ([0]) and gn_relu_bwd
// ([1]) in this process (read by gn_relu_launches).
std::atomic<long long> launched[2];

template <typename... Exp, typename... Act>
int launch(int dir, void (*kern)(Exp...), dim3 grid, int threads, int smem, int cluster,
           cudaStream_t st, Act... args) {
  cudaError_t e = prepare();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  if (cluster > 0) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return (int)e;
  launched[dir]++;
  return (int)cudaGetLastError();
}

int param_grads(const float* psum, const Geo& g, float* dgamma, float* dbeta,
                cudaStream_t st) {
  dim3 block(32, kParamLanes);
  gn_param_grads<<<(g.c + 31) / 32, block, 0, st>>>(psum, g.b, g.c, dgamma, dbeta);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) launched[1]++;
  return (int)e;
}

template <typename T>
int fwd(const T* x, const float* gamma, const float* beta, T* y, float* scratch,
        const Geo& g, cudaStream_t st) {
  if (g.variant == kOnePass)
    return launch(0, gn_fwd_cluster<T>, dim3(g.b * g.n), g.threads, g.smem, g.n, st,
                  x, gamma, beta, y, g);
  float* ps = scratch;
  float* stats = scratch + (size_t)g.b * g.chunks * 2 * g.c;
  const dim3 grid(g.chunks, g.b);
  int rc = launch(0, gn_chunk_stats<T>, grid, g.threads, g.smem, 0, st, x, ps, g);
  if (rc) return rc;
  rc = launch(0, gn_sample_stats, dim3(g.b), g.threads, g.smem, 0, st,
              (const float*)ps, stats, g);
  if (rc) return rc;
  return launch(0, gn_apply<T>, grid, g.threads, 0, 0, st, x, (const float*)stats, gamma,
                beta, y, g);
}

template <typename T>
int bwd(const T* x, const T* dy, const float* gamma, const float* beta, T* dx,
        float* dgamma, float* dbeta, float* scratch, const Geo& g, cudaStream_t st) {
  float* psum = scratch;                                   // [B, 2, C]
  int rc;
  if (g.variant == kOnePass) {
    rc = launch(1, gn_bwd_cluster<T>, dim3(g.b * g.n), g.threads, g.smem, g.n, st,
                x, dy, gamma, beta, dx, psum, g);
  } else {
    float* part = psum + (size_t)g.b * 2 * g.c;              // [B, chunks, 2, C]
    float* stats = part + (size_t)g.b * g.chunks * 2 * g.c;  // [B, 2, groups]
    float* gm = stats + (size_t)g.b * 2 * g.groups;          // [B, 2, groups]
    const dim3 grid(g.chunks, g.b);
    rc = launch(1, gn_chunk_stats<T>, grid, g.threads, g.smem, 0, st, x, part, g);
    if (rc) return rc;
    rc = launch(1, gn_sample_stats, dim3(g.b), g.threads, g.smem, 0, st,
                (const float*)part, stats, g);
    if (rc) return rc;
    rc = launch(1, gn_bwd_chunk<T>, grid, g.threads, g.smem, 0, st, x, dy,
                (const float*)stats, gamma, beta, part, g);
    if (rc) return rc;
    rc = launch(1, gn_bwd_sample, dim3(g.b), g.threads, g.smem, 0, st,
                (const float*)part, gamma, psum, gm, g);
    if (rc) return rc;
    rc = launch(1, gn_bwd_dx<T>, grid, g.threads, 0, 0, st, x, dy, (const float*)stats,
                (const float*)gm, gamma, beta, dx, g);
  }
  if (rc) return rc;
  return param_grads(psum, g, dgamma, dbeta, st);
}

}  // namespace

// geo = [B, HW, C, groups]; plan = [variant (1 one-pass, 2 two-pass), cluster
// n, rows per CTA, threads, dynamic shared memory bytes]; dtype 0 = fp32, 1 =
// bf16. C is 8..256 dividing 256, or a multiple of 256 up to 1024.
// gn_relu_scratch gives the fp32 device scratch, in floats, of the forward
// (backward = 0) or the backward (1); -1 if the kernels do not take the
// geometry and plan.
extern "C" long long gn_relu_scratch(const int* geo, const int* plan, int dtype, int backward) {
  Geo g;
  if (geo_of(geo, plan, dtype, backward, 0.f, g)) return -1;
  const long long bc = 2LL * g.b * g.c, part = 2LL * g.b * g.chunks * g.c;
  const long long stats = 2LL * g.b * g.groups;
  if (g.variant == kOnePass) return backward ? bc : 0;
  return backward ? bc + part + 2 * stats : part + stats;
}

extern "C" int gn_relu_fwd(const void* x, const float* gamma, const float* beta,
                           void* y, float* scratch, const int* geo, const int* plan,
                           int dtype, float eps, void* stream) {
  Geo g;
  if (int rc = geo_of(geo, plan, dtype, 0, eps, g)) return rc;
  if (misaligned(x) || misaligned(y)) return kErrAlign;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return fwd<float>((const float*)x, gamma, beta, (float*)y, scratch, g, st);
  return fwd<__nv_bfloat16>((const __nv_bfloat16*)x, gamma, beta, (__nv_bfloat16*)y,
                            scratch, g, st);
}

extern "C" int gn_relu_bwd(const void* x, const void* dy, const float* gamma,
                           const float* beta, void* dx, float* dgamma, float* dbeta,
                           float* scratch, const int* geo, const int* plan, int dtype,
                           float eps, void* stream) {
  Geo g;
  if (int rc = geo_of(geo, plan, dtype, 1, eps, g)) return rc;
  if (misaligned(x) || misaligned(dy) || misaligned(dx)) return kErrAlign;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return bwd<float>((const float*)x, (const float*)dy, gamma, beta, (float*)dx, dgamma,
                      dbeta, scratch, g, st);
  return bwd<__nv_bfloat16>((const __nv_bfloat16*)x, (const __nv_bfloat16*)dy, gamma, beta,
                            (__nv_bfloat16*)dx, dgamma, dbeta, scratch, g, st);
}

// How many clusters of a one-pass plan can be resident at once on the
// current card (cudaOccupancyMaxActiveClusters), 0 if none; for a two-pass
// plan, the resident CTAs of its element-wise kernel per SM. Negative: an
// error code.
extern "C" int gn_relu_occupancy(const int* geo, const int* plan, int dtype, int backward) {
  Geo g;
  if (int rc = geo_of(geo, plan, dtype, backward, 0.f, g)) return -rc;
  const void* kern;
  if (g.variant == kOnePass) {
    kern = backward ? (dtype ? (const void*)gn_bwd_cluster<__nv_bfloat16>
                             : (const void*)gn_bwd_cluster<float>)
                    : (dtype ? (const void*)gn_fwd_cluster<__nv_bfloat16>
                             : (const void*)gn_fwd_cluster<float>);
  } else {
    kern = backward ? (dtype ? (const void*)gn_bwd_dx<__nv_bfloat16>
                             : (const void*)gn_bwd_dx<float>)
                    : (dtype ? (const void*)gn_apply<__nv_bfloat16>
                             : (const void*)gn_apply<float>);
    int blocks = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, g.threads, 0);
    return e == cudaSuccess ? blocks : -(int)e;
  }
  cudaError_t e = prepare();
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.b * g.n);
  cfg.blockDim = dim3(g.threads);
  cfg.dynamicSmemBytes = g.smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

// CUDA launches issued so far by gn_relu_fwd (backward = 0) or gn_relu_bwd
// (1): one (one pass) or three (two pass) a forward, two or six a backward.
// A count kept where each launch is issued, which a profiler trace can be
// held to (a trace can drop events).
extern "C" long long gn_relu_launches(int backward) { return launched[backward ? 1 : 0]; }

extern "C" const char* gn_error_string(int rc) {
  if (rc == kErrDtype) return "unsupported dtype";
  if (rc == kErrGeometry) return "unsupported channel / group count";
  if (rc == kErrEmpty) return "empty batch or spatial extent";
  if (rc == kErrAlign) return "a tensor is not 16-byte aligned";
  if (rc == kErrPlan) return "the launch plan does not fit the geometry";
  return cudaGetErrorString((cudaError_t)rc);
}
