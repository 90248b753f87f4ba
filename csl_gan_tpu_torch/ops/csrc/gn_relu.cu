// Fused GroupNorm + ReLU, forward (K4) and backward (K5), for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas pair in csl_gan_tpu/ops/pallas_groupnorm.py:
//   K4  _fwd_kernel (:111, via _pallas_fwd :152)
//   K5  _bwd_kernel (:119, via _pallas_bwd :173)
// and follows the rules of its default XLA formulation _gn_relu_xla (:223):
// per-(sample, group) statistics in fp32 (mean, then var = E[x^2] - mean^2),
// the affine a = rstd * gamma, d = beta - (mean * rstd) * gamma in fp32, the
// ReLU mask taken from the fp32 affine x * a + d (:297-309), and the output
// rounded once to x's dtype. The backward recomputes the statistics from x
// and forms
//     dz = dy * 1[x * a + d > 0]
//     dx = rstd * (dz * gamma - mean_grp(dz * gamma) - xhat * mean_grp(dz * gamma * xhat))
//     dgamma = sum(dz * xhat), dbeta = sum(dz)
// with every reduction in fp32 and in a fixed order (no atomics), so results
// are reproducible run to run.
//
// Layout: x, y, dy, dx are [B, HW, C] (a channels-last activation), fp32 or
// bf16; gamma, beta, dgamma, dbeta are [C] fp32.
//
// Bound on an H100 SXM: bytes. At the generator's largest norm, [128, 4096,
// 64] bf16 (33.5M elements, 67 MB), K4 must read x once and write y once
// (134 MB, 40 us at 3.35 TB/s) and K5 read x and dy and write dx (201 MB,
// 60 us); the arithmetic is ~10 flop per element. The TPU kernel held one
// whole sample block in VMEM; here a sample is cut into row chunks so that
// B * chunks CTAs fill the 132 SMs:
//   gn_channel_sums   per-(sample, chunk, channel) sums of x and x^2
//   gn_relu_apply     K4: group stats from those sums, then the fused affine + ReLU
//   gn_bwd_partials   K5: per-(sample, chunk, channel) sums of dz and dz * xhat
//   gn_bwd_dx         K5: group means of those sums, then dx
//   gn_param_grads    K5: dgamma, dbeta summed over (sample, chunk) in order
// A sample's statistics are re-derived in each chunk's CTA from the [chunks, C]
// partial sums (a few KB), which costs one more read of x in K5 and nothing else.
// Loads are one element per thread with neighbouring threads on neighbouring
// channels (coalesced); making it fast (vector loads, one pass with the stats
// kept on chip) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Geo {
  int b, hw, c, groups, rows, chunks;
  float eps;
};

// Sums over the rows [r0, r1) of a sample of two per-element quantities f0, f1
// of (row, channel), per channel, reduced across the row lanes in a fixed
// order; written to out0 / out1 [c]. For c <= kThreads (a divisor of it) each
// thread owns one channel and every (kThreads / c)-th row; otherwise each
// thread owns the channels tid, tid + kThreads, ... and all rows.
template <typename F>
__device__ void chunk_channel_sums(int r0, int r1, int c, F f, float* out0,
                                   float* out1, float* sh0, float* sh1) {
  if (c <= kThreads) {
    const int lanes = kThreads / c;
    const int ch = threadIdx.x % c, lane = threadIdx.x / c;
    float s0 = 0.f, s1 = 0.f;
    for (int r = r0 + lane; r < r1; r += lanes) {
      float v0, v1;
      f(r, ch, v0, v1);
      s0 += v0;
      s1 += v1;
    }
    sh0[threadIdx.x] = s0;
    sh1[threadIdx.x] = s1;
    __syncthreads();
    if (threadIdx.x < c) {
      float t0 = 0.f, t1 = 0.f;
      for (int l = 0; l < lanes; ++l) {
        t0 += sh0[l * c + threadIdx.x];
        t1 += sh1[l * c + threadIdx.x];
      }
      out0[threadIdx.x] = t0;
      out1[threadIdx.x] = t1;
    }
  } else {
    for (int ch = threadIdx.x; ch < c; ch += kThreads) {
      float s0 = 0.f, s1 = 0.f;
      for (int r = r0; r < r1; ++r) {
        float v0, v1;
        f(r, ch, v0, v1);
        s0 += v0;
        s1 += v1;
      }
      out0[ch] = s0;
      out1[ch] = s1;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_channel_sums(const T* __restrict__ x, Geo g, float* __restrict__ ps,
                float* __restrict__ pss) {
  __shared__ float sh0[kThreads], sh1[kThreads];
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int r0 = chunk * g.rows, r1 = min(g.hw, r0 + g.rows);
  const T* xb = x + (size_t)b * g.hw * g.c;
  const size_t o = ((size_t)b * g.chunks + chunk) * g.c;
  chunk_channel_sums(r0, r1, g.c, [&](int r, int ch, float& v0, float& v1) {
    const float v = to_f(xb[(size_t)r * g.c + ch]);
    v0 = v;
    v1 = v * v;
  }, ps + o, pss + o, sh0, sh1);
}

// The affine of sample b from the [B, chunks, C] partial sums, into shared
// memory: a[c] = rstd * gamma, d[c] = beta - (mean * rstd) * gamma, and the
// group mean / rstd. Ends with a barrier.
struct Affine {
  float sum[kMaxC], sq[kMaxC], a[kMaxC], d[kMaxC];
  float mean[kMaxC], rstd[kMaxC];
};

__device__ void sample_affine(const float* __restrict__ ps,
                              const float* __restrict__ pss, const Geo& g,
                              int b, const float* __restrict__ gamma,
                              const float* __restrict__ beta, Affine& sh) {
  for (int ch = threadIdx.x; ch < g.c; ch += kThreads) {
    float s = 0.f, ss = 0.f;
    for (int k = 0; k < g.chunks; ++k) {
      const size_t o = ((size_t)b * g.chunks + k) * g.c + ch;
      s += ps[o];
      ss += pss[o];
    }
    sh.sum[ch] = s;
    sh.sq[ch] = ss;
  }
  __syncthreads();
  const int cg = g.c / g.groups;
  const float n = (float)g.hw * (float)cg;
  for (int gr = threadIdx.x; gr < g.groups; gr += kThreads) {
    float s = 0.f, ss = 0.f;
    for (int j = 0; j < cg; ++j) {
      s += sh.sum[gr * cg + j];
      ss += sh.sq[gr * cg + j];
    }
    const float mean = s / n;
    const float var = fmaxf(ss / n - mean * mean, 0.f);
    sh.mean[gr] = mean;
    sh.rstd[gr] = 1.f / sqrtf(var + g.eps);
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < g.c; ch += kThreads) {
    const int gr = ch / cg;
    const float rstd = sh.rstd[gr];
    sh.a[ch] = rstd * gamma[ch];
    sh.d[ch] = beta[ch] - (sh.mean[gr] * rstd) * gamma[ch];
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_relu_apply(const T* __restrict__ x, const float* __restrict__ ps,
              const float* __restrict__ pss, Geo g,
              const float* __restrict__ gamma, const float* __restrict__ beta,
              T* __restrict__ y) {
  __shared__ Affine sh;
  const int chunk = blockIdx.x, b = blockIdx.y;
  sample_affine(ps, pss, g, b, gamma, beta, sh);
  const int r0 = chunk * g.rows, r1 = min(g.hw, r0 + g.rows);
  const size_t base = ((size_t)b * g.hw + r0) * g.c;
  const int n = (r1 - r0) * g.c;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int ch = i % g.c;
    const float z = to_f(x[base + i]) * sh.a[ch] + sh.d[ch];
    y[base + i] = from_f<T>(z > 0.f ? z : 0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_bwd_partials(const T* __restrict__ x, const T* __restrict__ dy,
                const float* __restrict__ ps, const float* __restrict__ pss,
                Geo g, const float* __restrict__ gamma,
                const float* __restrict__ beta, float* __restrict__ pd1,
                float* __restrict__ pd2) {
  __shared__ Affine sh;
  __shared__ float sh0[kThreads], sh1[kThreads];
  const int chunk = blockIdx.x, b = blockIdx.y;
  sample_affine(ps, pss, g, b, gamma, beta, sh);
  const int cg = g.c / g.groups;
  const int r0 = chunk * g.rows, r1 = min(g.hw, r0 + g.rows);
  const size_t xb = (size_t)b * g.hw * g.c;
  const size_t o = ((size_t)b * g.chunks + chunk) * g.c;
  chunk_channel_sums(r0, r1, g.c, [&](int r, int ch, float& v0, float& v1) {
    const size_t i = xb + (size_t)r * g.c + ch;
    const float xv = to_f(x[i]);
    const float dz = (xv * sh.a[ch] + sh.d[ch] > 0.f) ? to_f(dy[i]) : 0.f;
    const int gr = ch / cg;
    v0 = dz;
    v1 = dz * ((xv - sh.mean[gr]) * sh.rstd[gr]);
  }, pd1 + o, pd2 + o, sh0, sh1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_bwd_dx(const T* __restrict__ x, const T* __restrict__ dy,
          const float* __restrict__ ps, const float* __restrict__ pss,
          const float* __restrict__ pd1, const float* __restrict__ pd2, Geo g,
          const float* __restrict__ gamma, const float* __restrict__ beta,
          T* __restrict__ dx) {
  __shared__ Affine sh;
  __shared__ float s1g[kMaxC], s2g[kMaxC];
  const int chunk = blockIdx.x, b = blockIdx.y;
  sample_affine(ps, pss, g, b, gamma, beta, sh);
  // Reuse sum / sq for the per-channel totals of dz and dz * xhat.
  for (int ch = threadIdx.x; ch < g.c; ch += kThreads) {
    float d1 = 0.f, d2 = 0.f;
    for (int k = 0; k < g.chunks; ++k) {
      const size_t o = ((size_t)b * g.chunks + k) * g.c + ch;
      d1 += pd1[o];
      d2 += pd2[o];
    }
    sh.sum[ch] = d1 * gamma[ch];
    sh.sq[ch] = d2 * gamma[ch];
  }
  __syncthreads();
  const int cg = g.c / g.groups;
  const float n = (float)g.hw * (float)cg;
  for (int gr = threadIdx.x; gr < g.groups; gr += kThreads) {
    float t2 = 0.f, t1 = 0.f;
    for (int j = 0; j < cg; ++j) {
      t2 += sh.sum[gr * cg + j];
      t1 += sh.sq[gr * cg + j];
    }
    s2g[gr] = t2 / n;   // mean_grp(dz * gamma)
    s1g[gr] = t1 / n;   // mean_grp(dz * gamma * xhat)
  }
  __syncthreads();
  const int r0 = chunk * g.rows, r1 = min(g.hw, r0 + g.rows);
  const size_t base = ((size_t)b * g.hw + r0) * g.c;
  const int n_el = (r1 - r0) * g.c;
  for (int i = threadIdx.x; i < n_el; i += kThreads) {
    const int ch = i % g.c, gr = ch / cg;
    const float xv = to_f(x[base + i]);
    const float dz = (xv * sh.a[ch] + sh.d[ch] > 0.f) ? to_f(dy[base + i]) : 0.f;
    const float xhat = (xv - sh.mean[gr]) * sh.rstd[gr];
    const float v = sh.rstd[gr] * (dz * gamma[ch] - s2g[gr] - xhat * s1g[gr]);
    dx[base + i] = from_f<T>(v);
  }
}

__global__ void __launch_bounds__(kThreads)
gn_param_grads(const float* __restrict__ pd1, const float* __restrict__ pd2,
               int n_rows, int c, float* __restrict__ dgamma,
               float* __restrict__ dbeta) {
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  if (ch >= c) return;
  float s1 = 0.f, s2 = 0.f;
  for (int r = 0; r < n_rows; ++r) {
    s1 += pd1[(size_t)r * c + ch];
    s2 += pd2[(size_t)r * c + ch];
  }
  dbeta[ch] = s1;
  dgamma[ch] = s2;
}

// Elements of one sample that one CTA covers: a sample of [HW, C] is cut into
// chunks of max(1, kChunkElems / C) rows.
constexpr int kChunkElems = 16384;

// The geometry of geo = [B, HW, C, groups], with its row chunks; 0 if the
// kernels take it, else the error code.
int geo_of(const int* geo, float eps, Geo& g) {
  g = Geo{geo[0], geo[1], geo[2], geo[3], 1, 1, eps};
  if (g.b <= 0 || g.hw <= 0) return 1002;
  if (g.c <= 0 || g.c > kMaxC || g.groups <= 0 || g.c % g.groups != 0) return 1001;
  if (g.c <= kThreads && kThreads % g.c != 0) return 1001;
  if (g.c > kThreads && g.c % kThreads != 0) return 1001;
  g.rows = std::max(1, std::min(g.hw, kChunkElems / g.c));
  g.chunks = (g.hw + g.rows - 1) / g.rows;
  return 0;
}

template <typename T>
int fwd(const void* x, const float* gamma, const float* beta, void* y,
        float* scratch, const Geo& g, cudaStream_t st) {
  const size_t part = (size_t)g.b * g.chunks * g.c;
  float* ps = scratch;
  float* pss = scratch + part;
  dim3 grid(g.chunks, g.b);
  gn_channel_sums<T><<<grid, kThreads, 0, st>>>((const T*)x, g, ps, pss);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gn_relu_apply<T><<<grid, kThreads, 0, st>>>((const T*)x, ps, pss, g, gamma,
                                              beta, (T*)y);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* x, const void* dy, const float* gamma, const float* beta,
        void* dx, float* dgamma, float* dbeta, float* scratch, const Geo& g,
        cudaStream_t st) {
  const size_t part = (size_t)g.b * g.chunks * g.c;
  float* ps = scratch;
  float* pss = scratch + part;
  float* pd1 = scratch + 2 * part;
  float* pd2 = scratch + 3 * part;
  dim3 grid(g.chunks, g.b);
  gn_channel_sums<T><<<grid, kThreads, 0, st>>>((const T*)x, g, ps, pss);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gn_bwd_partials<T><<<grid, kThreads, 0, st>>>((const T*)x, (const T*)dy, ps,
                                                pss, g, gamma, beta, pd1, pd2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gn_bwd_dx<T><<<grid, kThreads, 0, st>>>((const T*)x, (const T*)dy, ps, pss,
                                          pd1, pd2, g, gamma, beta, (T*)dx);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gn_param_grads<<<(g.c + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      pd1, pd2, g.b * g.chunks, g.c, dgamma, dbeta);
  return (int)cudaGetLastError();
}

}  // namespace

// geo = [B, HW, C, groups]; dtype 0 = fp32, 1 = bf16. C is 32..256 dividing
// 256, or a multiple of 256 up to 1024. gn_relu_scratch gives the fp32
// scratch, in floats, of the forward (backward = 0) or the backward (1); -1
// if the kernels do not take the geometry.
extern "C" long long gn_relu_scratch(const int* geo, int backward) {
  Geo g;
  if (geo_of(geo, 0.f, g)) return -1;
  return (backward ? 4LL : 2LL) * g.b * g.chunks * g.c;
}

extern "C" int gn_relu_fwd(const void* x, const float* gamma, const float* beta,
                           void* y, float* scratch, const int* geo, int dtype,
                           float eps, void* stream) {
  Geo g;
  if (int rc = geo_of(geo, eps, g)) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return fwd<float>(x, gamma, beta, y, scratch, g, st);
  if (dtype == 1) return fwd<__nv_bfloat16>(x, gamma, beta, y, scratch, g, st);
  return 1000;
}

extern "C" int gn_relu_bwd(const void* x, const void* dy, const float* gamma,
                           const float* beta, void* dx, float* dgamma,
                           float* dbeta, float* scratch, const int* geo,
                           int dtype, float eps, void* stream) {
  Geo g;
  if (int rc = geo_of(geo, eps, g)) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return bwd<float>(x, dy, gamma, beta, dx, dgamma, dbeta, scratch, g, st);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(x, dy, gamma, beta, dx, dgamma, dbeta, scratch, g, st);
  return 1000;
}

extern "C" const char* gn_error_string(int rc) {
  if (rc == 1000) return "unsupported dtype";
  if (rc == 1001) return "unsupported channel / group count";
  if (rc == 1002) return "empty batch or spatial extent";
  return cudaGetErrorString((cudaError_t)rc);
}
