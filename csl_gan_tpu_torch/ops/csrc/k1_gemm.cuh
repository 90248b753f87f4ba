// K1's tiled fp32 GEMM (see k1_epoch.cu for the whole kernel): the tile
// kernel, the split-K second pass and the launcher of k1::gemm, included by
// each k1_gemm_<form>.cu, which instantiates the launcher for its form.

#pragma once

#include "k1_epoch.cuh"

namespace {

using namespace k1;

__device__ __forceinline__ void epilogue(const Epi& e, int m, int n, float v,
                                         float* C, int ldc) {
  if (e.oh) {
    float s = 0.f;
    for (int q = 0; q < e.n_oh; ++q)
      s = fmaf(ld_any(e.oh, e.oh_bf16, (size_t)m * e.ld_oh + q),
               e.wy[(size_t)n * e.ld_wy + q], s);
    v = v + s;
  }
  if (e.bias) v = v + e.bias[n];
  if (e.act == 1) v = fmaxf(v, 0.f);
  else if (e.act == 2) v = sigmoidf_(v);
  if (e.sig) {
    const float s = e.sig[(size_t)m * e.ld_sig + n];
    v = v * s * (1.f - s);
  }
  if (e.mask) v = e.mask[(size_t)m * e.ld_mask + n] > 0.f ? v : v * 0.f;
  float* c = C + (size_t)m * ldc + n;
  *c = e.accumulate ? *c + v : v;
}

// One fp32 FFMA tile kernel for every product. A CTA of 256 threads owns a
// BM x BN output tile (64x64, 32x64 or 32x32 with BK = 16; 16x32 with BK =
// 64; each thread BM/16 x BN/16 outputs) and walks K in BK stages, each
// output one FMA chain in the order k = 0, 1, .... Each stage is staged through
// registers into one of two shared-memory buffers: the next stage's global
// loads are issued before this stage's FFMAs, and one __syncthreads() per
// stage suffices. With split-K, blockIdx.z = s sums only K in [s * kc,
// (s + 1) * kc) and writes its raw tile to part[s] ([S, M, N]); the
// epilogue then runs in splitk_reduce after the S partials are added in the
// order s = 0, 1, ..., S - 1. Without split-K (part null) it runs here.
template <int BM, int BN, int BK, bool TA, bool TB, typename TTA, typename TTB>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(int M, int N, int K, int kc, const TTA* __restrict__ A, int lda,
            const TTB* __restrict__ B, int ldb, const float* __restrict__ rs,
            float* C, int ldc, float* __restrict__ part, Epi e) {
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int LA = BM * BK / kGemmThreads, LB = BN * BK / kGemmThreads;
  __shared__ float As[2][BK][BM + 4];
  __shared__ float Bs[2][BK][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * kc, ke = min(K, kb + kc);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float ra[LA], rb[LB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int i = tid + l * kGemmThreads;
      const int mm = TA ? i % BM : i / BK, kk = TA ? i / BM : i % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      float v = 0.f;
      if (gm < M && gk < ke)
        v = TA ? ldf(A + (size_t)gk * lda + gm) : ldf(A + (size_t)gm * lda + gk);
      ra[l] = v;
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int i = tid + l * kGemmThreads;
      const int nn = TB ? i / BK : i % BN, kk = TB ? i % BK : i / BN;
      const int gn = n0 + nn, gk = k0 + kk;
      float v = 0.f;
      if (gn < N && gk < ke) {
        v = TB ? ldf(B + (size_t)gn * ldb + gk) : ldf(B + (size_t)gk * ldb + gn);
        if (rs) v = rs[gk] * v;
      }
      rb[l] = v;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int i = tid + l * kGemmThreads;
      As[buf][TA ? i / BM : i % BK][TA ? i % BM : i / BK] = ra[l];
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int i = tid + l * kGemmThreads;
      Bs[buf][TB ? i % BK : i / BN][TB ? i / BK : i % BN] = rb[l];
    }
  };

  fetch(kb);
  int buf = 0;
  for (int k0 = kb; k0 < ke; k0 += BK) {
    // Buffer `buf` was last read two stages ago, before every thread passed
    // the previous stage's barrier.
    stash(buf);
    __syncthreads();
    if (k0 + BK < ke) fetch(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[buf][kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[buf][kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    buf ^= 1;
  }

  float* out = part ? part + (size_t)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      if (out) out[(size_t)m * N + n] = acc[i][j];
      else epilogue(e, m, n, acc[i][j], C, ldc);
    }
  }
}

// The split-K second pass: C[m, n] (=|+=) epilogue(sum_s part[s, m, n]),
// the S partials added in the order s = 0, 1, ..., S - 1 (no atomics, so an
// epoch is bitwise repeatable).
__global__ void splitk_reduce(int M, int N, int S, const float* __restrict__ part,
                              float* C, int ldc, Epi e) {
  const size_t mn = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float v = part[i];
  for (int s = 1; s < S; ++s) v += part[(size_t)s * mn + i];
  epilogue(e, (int)(i / N), (int)(i % N), v, C, ldc);
}

template <int BM, int BN, int BK, bool TA, bool TB, typename TTA, typename TTB>
void launch_tile(const Ctx& cx, dim3 grid, int M, int N, int K, int kc, const TTA* A,
                 int lda, const TTB* B, int ldb, const float* rs, float* C, int ldc,
                 float* part, const Epi& e) {
  gemm_kernel<BM, BN, BK, TA, TB, TTA, TTB><<<grid, kGemmThreads, 0, cx.st>>>(
      M, N, K, kc, A, lda, B, ldb, rs, C, ldc, part, e);
}

}  // namespace

namespace k1 {

template <bool TA, bool TB, typename TTA, typename TTB>
int gemm(const Ctx& cx, int M, int N, int K, const TTA* A, int lda,
         const TTB* B, int ldb, const float* rs, float* C, int ldc,
         const Epi& e) {
  const Plan pl = plan_of(M, N, K, e.act == 1);
  float* part = nullptr;
  if (pl.s > 1) {
    if ((long long)pl.s * M * N > cx.ws_floats) return kErrWorkspace;
    part = cx.ws;
  }
  const dim3 grid(cdiv(N, kTile[pl.t][1]), cdiv(M, kTile[pl.t][0]), pl.s);
  switch (pl.t) {
    case 0: launch_tile<64, 64, 16, TA, TB>(cx, grid, M, N, K, pl.kc, A, lda, B, ldb, rs, C, ldc, part, e); break;
    case 1: launch_tile<32, 64, 16, TA, TB>(cx, grid, M, N, K, pl.kc, A, lda, B, ldb, rs, C, ldc, part, e); break;
    case 2: launch_tile<32, 32, 16, TA, TB>(cx, grid, M, N, K, pl.kc, A, lda, B, ldb, rs, C, ldc, part, e); break;
    default: launch_tile<16, 32, 64, TA, TB>(cx, grid, M, N, K, pl.kc, A, lda, B, ldb, rs, C, ldc, part, e); break;
  }
  CK();
  if (pl.s > 1) {
    splitk_reduce<<<cdiv(M * N, 256), 256, 0, cx.st>>>(M, N, pl.s, part, C, ldc, e);
    CK();
  }
  return 0;
}

}  // namespace k1
