// K1's declarations shared by its translation units: k1_epoch.cu (the
// epoch's host loop, the row, bias-sum, Adam and metric kernels, the C entry
// points) and k1_gemm_<form>.cu, one a product form of the tiled GEMM
// (k1_gemm.cuh), which _build.py compiles at once and links into one library.
// Each product form is instantiated in its own unit, so the twenty tile
// kernels compile in parallel.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace k1 {

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ float ld_any(const void* p, int bf16, size_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

// ---------------------------------------------------------------- GEMM ------
// C[m, n] (=|+=) epilogue(sum_k A(m, k) * B(k, n)), where
//   A(m, k) = TA ? A[k * lda + m] : A[m * lda + k]
//   B(k, n) = (TB ? B[n * ldb + k] : B[k * ldb + n]) * (rs ? rs[k] : 1)
struct Epi {
  const float* bias;                 // [N], added after the one-hot term
  const void* oh; int oh_bf16; int ld_oh; int n_oh;   // acc += sum_j oh[m, j] * wy[n * ld_wy + j]
  const float* wy; int ld_wy;
  int act;                           // 0 none, 1 ReLU, 2 sigmoid
  const float* sig; int ld_sig;      // acc = acc * s * (1 - s)
  const float* mask; int ld_mask;    // acc = mask > 0 ? acc : acc * 0
  int accumulate;                    // C = C + acc
};

constexpr int kGemmThreads = 256;
constexpr int kMinSlice = 64;   // a split-K slice is at least 4 stages of 16

constexpr int kErrBadArgs = 100000;
constexpr int kErrWorkspace = 100001;

#define CK()                                   \
  do {                                         \
    cudaError_t err_ = cudaGetLastError();     \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// SMs of the current device, asked once.
inline int sm_count() {
  static const int n_sm = [] {
    int dev = 0, n = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return n_sm;
}

// How one product M x N x K is cut across the SMs: tile kTile[t] (rows,
// columns, BK) and S splits of K, kc long each (a multiple of BK). The
// largest of the first three tiles that alone gives a CTA per SM runs
// unsplit, with its epilogue fused. A product whose epilogue is a ReLU is
// never split: its mask is a decision, and a pre-activation within rounding
// of 0 takes the other side under another order of the sum (one such unit
// of the fake pass's hidden layer moved a step's G gradient by 1.6e-3
// against the plain version on an H100). It keeps one chain per output, on
// the 16x32 tile with BK 64 (more CTAs, fewer stages). Every other product
// splits K on the largest tile that, with slices of at least kMinSlice,
// reaches one CTA per SM, aiming at two (so an SM holds two CTAs and one's
// loads overlap the other's FFMAs); where none does, 32x32 takes the most
// splits K allows.
inline constexpr int kTile[4][3] = {{64, 64, 16}, {32, 64, 16}, {32, 32, 16}, {16, 32, 64}};
struct Plan { int t, s, kc; };

inline Plan plan_of(int M, int N, int K, bool relu) {
  const int n_sm = sm_count();
  auto tiles = [&](int t) { return cdiv(M, kTile[t][0]) * cdiv(N, kTile[t][1]); };
  for (int t = 0; t < 3; ++t)
    if (tiles(t) >= n_sm) return Plan{t, 1, K};
  if (relu) return Plan{3, 1, K};
  const int max_s = K / kMinSlice > 1 ? K / kMinSlice : 1;
  int t = 2;
  for (int u = 0; u < 3; ++u)
    if (tiles(u) * max_s >= n_sm) { t = u; break; }
  const int want = cdiv(2 * n_sm, tiles(t)) < max_s ? cdiv(2 * n_sm, tiles(t)) : max_s;
  const int bk = kTile[t][2];
  const int kc = cdiv(cdiv(K, want), bk) * bk;
  return Plan{t, cdiv(K, kc), kc};
}

struct Ctx {
  cudaStream_t st;
  float* ws;
  long long ws_floats;
};

// C (M x N) from A and B in the operand form <TA, TB> with A, B of types
// TTA, TTB, as the launcher of k1_gemm.cuh cuts and runs it; defined in the
// unit of its form (k1_gemm_<form>.cu). Returns 0, a cudaError_t or
// kErrWorkspace.
template <bool TA, bool TB, typename TTA, typename TTB>
int gemm(const Ctx& cx, int M, int N, int K, const TTA* A, int lda,
         const TTB* B, int ldb, const float* rs, float* C, int ldc,
         const Epi& e);

}  // namespace k1
