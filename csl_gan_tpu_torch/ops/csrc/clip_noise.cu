// Fused clip-weighted per-sample-gradient sum + Gaussian DP noise for Hopper
// (sm_90a): K6.
//
// Replaces the JAX package's Pallas kernel in csl_gan_tpu/ops/pallas_clip.py:
//   K6  _kernel (:61, via weighted_sum_noise_2d :76 / leaf_weighted_sum_noise :111)
//
//   out[p] = sum_b w[b] * g[b, p] + std * N(0, 1)(seed, p)
//
// g [B, P] fp32 row-major is one leaf of the materialized per-sample
// gradients, w [B] the clip factors, std = sigma * C. The sum is the DP
// signal: fp32 FFMA in a fixed order (the counterpart of the TPU kernel's
// Precision.HIGHEST product; no TF32, no bf16).
//
// Bound: bytes. g is read once, 4 B P bytes (243.9 MB at B 600, P 101,632:
// 0.073 ms at 3.35 TB/s); two operations per element read, far below the
// fp32 rate. So the design is a streaming reduction:
//   - consecutive threads take consecutive p, four each as one 16-byte load
//     where P is a multiple of 4 (rows then stay 16-byte aligned), else one
//     element each with a guarded tail; no padding of P and no copy of g;
//   - each thread walks its rows with eight loads in flight;
//   - a grid over p alone cannot fill 132 SMs at small P (P 16,384: 16
//     blocks), so B is split across blocks. Each split writes its partial sum
//     [splits, P] and a second kernel adds the partials in a fixed order and
//     adds the noise. No atomics: the sum is reproducible run to run.
//
// Noise. The TPU kernel seeds a per-core generator per tile; here the bits
// come from Philox4x32-10 (Salmon et al., Random123), written out below, keyed
// by the 64-bit seed with the element index p as the counter, so the stream
// does not depend on the launch geometry and can be rebuilt with integer
// tensor operations (ops/pallas_clip.py philox4x32_10). Words 0 and 1 of the
// block become one normal by the TPU kernel's Box-Muller (_normal_from_bits,
// :44-58): 24-bit uniforms u1 = (b1 >> 8) 2^-24 + 2^-25, u2 = (b2 >> 8) 2^-24,
// z = sqrt(-2 log u1) cos(2 pi u2), with logf / cosf / sqrtf (built without
// fast math). seed and std are read from device memory, so a step draws its
// seeds on the device and never waits for the host. std = 0 still runs the
// generator and adds 0 * z, as the TPU kernel does.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;          // row loads in flight per thread
constexpr int kBlocksPerSm = 8;     // blocks wanted per SM before B is split no further
constexpr int kMinRows = 8;         // fewest rows worth a split of their own

struct Plan {
  int vec;        // elements of p per thread: 4 (16-byte loads) or 1
  int col_blocks; // blocks along p
  int rows_per;   // rows of g per split
  int splits;     // blocks along B
};

Plan plan_of(int B, long long P, bool aligned) {
  Plan pl;
  pl.vec = (P % 4 == 0 && aligned) ? 4 : 1;
  const long long per_block = (long long)kThreads * pl.vec;
  pl.col_blocks = (int)((P + per_block - 1) / per_block);
  int dev = 0, n_sm = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const int want = (kBlocksPerSm * n_sm + pl.col_blocks - 1) / pl.col_blocks;
  const int splits = std::max(1, std::min(want, B / kMinRows));
  pl.rows_per = (B + splits - 1) / splits;
  pl.splits = (B + pl.rows_per - 1) / pl.rows_per;
  return pl;
}

// partial[s, p] = sum over the rows of split s of w[b] * g[b, p], rows in
// ascending order.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
wsum_partial(const float* __restrict__ g, const float* __restrict__ w, int B,
             long long P, int rows_per, float* __restrict__ partial) {
  const long long p0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * VEC;
  if (p0 >= P) return;
  const int b0 = blockIdx.y * rows_per;
  const int b1 = min(B, b0 + rows_per);
  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
  const float* col = g + p0;
  int b = b0;
  for (; b + kUnroll <= b1; b += kUnroll) {
    float x[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float* src = col + (size_t)(b + u) * P;
      if constexpr (VEC == 4) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(src));
        x[u][0] = t.x; x[u][1] = t.y; x[u][2] = t.z; x[u][3] = t.w;
      } else {
        x[u][0] = __ldg(src);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float wb = __ldg(w + b + u);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = fmaf(wb, x[u][v], acc[v]);
    }
  }
  for (; b < b1; ++b) {
    const float* src = col + (size_t)b * P;
    const float wb = __ldg(w + b);
    if constexpr (VEC == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(src));
      acc[0] = fmaf(wb, t.x, acc[0]);
      acc[1] = fmaf(wb, t.y, acc[1]);
      acc[2] = fmaf(wb, t.z, acc[2]);
      acc[3] = fmaf(wb, t.w, acc[3]);
    } else {
      acc[0] = fmaf(wb, __ldg(src), acc[0]);
    }
  }
  float* dst = partial + (size_t)blockIdx.y * P + p0;
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    dst[0] = acc[0];
  }
}

// Philox4x32-10 (Random123): ten rounds on the counter c with the key bumped
// by the Weyl constants between rounds.
__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
  constexpr uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  constexpr uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(M0, c[0]), lo0 = M0 * c[0];
    const uint32_t hi1 = __umulhi(M1, c[2]), lo1 = M1 * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0; c[1] = lo1; c[2] = n2; c[3] = lo0;
    k0 += W0; k1 += W1;
  }
}

// One standard normal from two 32-bit words: the TPU kernel's Box-Muller.
__device__ __forceinline__ float normal_from_bits(uint32_t b1, uint32_t b2) {
  const float u1 = __fadd_rn(__fmul_rn((float)(b1 >> 8), 1.0f / 16777216.0f),
                             0.5f / 16777216.0f);
  const float u2 = __fmul_rn((float)(b2 >> 8), 1.0f / 16777216.0f);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(6.283185307179586f, u2)));
}

// out[p] = sum_s partial[s, p] (ascending s) + std * N(0, 1)(seed, p).
__global__ void __launch_bounds__(kThreads)
sum_noise(const float* __restrict__ partial, int splits, long long P,
          const long long* __restrict__ seed, const float* __restrict__ std_dev,
          float* __restrict__ out) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  float acc = partial[p];
  for (int s = 1; s < splits; ++s) acc += partial[(size_t)s * P + p];
  const unsigned long long key = (unsigned long long)seed[0];
  uint32_t c[4] = {(uint32_t)p, (uint32_t)((unsigned long long)p >> 32), 0u, 0u};
  philox4x32_10(c, (uint32_t)key, (uint32_t)(key >> 32));
  const float z = normal_from_bits(c[0], c[1]);
  // Rounded product, then the sum: the plain version's two steps.
  out[p] = __fadd_rn(acc, __fmul_rn(std_dev[0], z));
}

}  // namespace

// fp32 elements of scratch (the [splits, P] partial sums) that clip_noise
// needs at this shape.
extern "C" long long clip_noise_scratch(int B, long long P) {
  const Plan pl = plan_of(B, P, true);
  return (long long)pl.splits * P;
}

// out[p] = sum_b w[b] g[b, p] + std[0] * N(0, 1)(seed[0], p); every pointer is
// device memory. Returns 0 or an error code for cn_error_string.
extern "C" int clip_noise(const float* g, const float* w, const long long* seed,
                          const float* std_dev, int B, long long P, float* partial,
                          float* out, void* stream) {
  if (B < 1 || P < 1) return 1000;
  cudaStream_t st = (cudaStream_t)stream;
  const bool aligned = (reinterpret_cast<uintptr_t>(g) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(partial) % 16 == 0);
  const Plan pl = plan_of(B, P, aligned);
  const dim3 grid((unsigned)pl.col_blocks, (unsigned)pl.splits);
  if (pl.vec == 4)
    wsum_partial<4><<<grid, kThreads, 0, st>>>(g, w, B, P, pl.rows_per, partial);
  else
    wsum_partial<1><<<grid, kThreads, 0, st>>>(g, w, B, P, pl.rows_per, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_noise<<<(unsigned)((P + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      partial, pl.splits, P, seed, std_dev, out);
  return (int)cudaGetLastError();
}

extern "C" const char* cn_error_string(int rc) {
  if (rc == 1000) return "empty batch or leaf";
  return cudaGetErrorString((cudaError_t)rc);
}
