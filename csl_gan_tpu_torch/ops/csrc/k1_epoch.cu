// K1 on Hopper: one whole epoch of the MNIST conditional ACGAN DP-gc step.
//
// Replaces the TPU kernel csl_gan_tpu/ops/pallas_epoch.py:184 (`kernel`, built
// by `_make_kernel` at :109, launched at :515). Each step of the epoch does,
// as there: (1) a G forward on the pre-drawn z_d; (2) the ghost-clipped real D
// pass (per-sample leaf norms, flat factor min(1, C/(||g||+1e-12)), clip-
// weighted sums); (3) the clean fake pass; (4) adding the pre-drawn DP noise,
// then dividing by bs; (5) Adam for D; (6) the G step against the UPDATED D;
// (7) the metric sums into a 40-slot device vector.
//
// Bound on an H100 (SXM, 67 TFLOP/s fp32 outside the tensor cores; a card set
// below 700 W runs slower): ~1.28 GFLOP per step at bs 600 (G forward 137
// MFLOP, real D pass with its weighted sums 250, fake pass 250, G step 640),
// so ~128 GFLOP per 100-step epoch, ~1.9 ms at the fp32 peak. A step moves
// only ~2 MB (0.95 MB of bf16 rows, 0.48 MB of z, 0.41 MB of noise), ~0.6 us
// at 3.35 TB/s, so the kernel is bound by operations and, at this size, by
// launches, not by bytes.
//
// Design. The TPU kernel keeps params and Adam moments (2.6 MB) in VMEM across
// its sequential grid. A Hopper block has 227 KB of shared memory and blocks
// run in no order, so here the state lives in device memory as one flat fp32
// buffer per model (D 103,179 floats, G 115,344), which stays resident in the
// 50 MB L2 for the whole epoch, and each step is a fixed sequence of launches
// on the caller's stream: a tiled fp32 GEMM (NT, NN and TN operand forms, with
// fused prologue row scale and epilogues: one-hot product, bias, ReLU,
// sigmoid, sigmoid-derivative, ReLU mask, accumulate), one row-wise kernel
// (per-sample cotangents, the six ghost norms, the clip factor and per-row
// metric terms; one warp per row), a bias-sum kernel, one Adam kernel per
// model over its flat buffer, and a one-block metric reduction. The host loop
// of the epoch runs here in C, so Python makes one call per epoch and reads
// the metric vector once per epoch. Every product is fp32 FFMA: no TF32 and
// no tensor cores, since the weighted sums are the DP signal and the TPU
// kernel runs them at HIGHEST. Noise is consumed pre-drawn; there is no RNG
// here.
//
// Filling the card. At bs 600 on 132 SMs one CTA per 64x64 output tile gives
// the heavy products 20-26 CTAs, so the launcher (plan_of) cuts each product
// from (M, N, K) and the SM count: split-K for the weighted sums (K = bs =
// 600: 208 CTAs of 5 BK stages for the 128x794, 128x784 and 784x128 sums)
// and for G's masked backward product (200 CTAs), each followed by a pass
// that adds the S partials in a fixed order and applies the epilogue;
// 32x64 tiles for the N = 784 products (247 CTAs); a 16x32 tile with BK 64
// for the ReLU products, which are never split (plan_of says why). Stages are
// double-buffered through registers, with one barrier each. The bias sums
// are batch-parallel (32 row slices per column, met in shared memory), up
// to three to a launch. No atomics anywhere, so an epoch is bitwise repeatable: a step
// is 38 launches.
//
// What bounds it now (NVIDIA H100 80GB HBM3, 700 W, profile of one 100-step
// epoch in chip_smoke.py; PERF.md has the run): ~35 ms an epoch against
// 121 ms before, with the device busy ~86% of it and 3,807 launches, so the
// gaps between dependent launches take ~5 ms. Of ~32 ms on the device the
// unsplit ReLU products (NT forwards, bf16 rows included) take ~12 ms: one
// chain of 794 FMAs per output at 2 outputs a thread leaves the 16x32 tile
// bound by shared-memory reads and latency. Then the row, Adam and metric
// kernels ~5, the fp32 weighted sums ~4.5, the reduce passes ~2.6, the N =
// 784 forwards ~2.6, G's NN products ~2.5, the bf16 weighted sums ~1.7 and
// the bias sums ~1. Open: more outputs a thread for the ReLU products, one
// persistent kernel or a CUDA graph over the launch chain, and 3xTF32-style
// tensor-core products if fp32 accuracy can be shown.

// Layouts (torch): Linear weight [out, in] row-major. Flat D buffer, in the JAX
// leaf order: lin1.b [H] | lin1.W [H, A0] | lin2.b [1] | lin2.W [1, H] |
// aux.b [nc] | aux.W [nc, H]. Flat G buffer: lin1.b [H] | lin1.W [H, L+nc] |
// lin2.b [F] | lin2.W [F, H]. Table rows are [x (F) | one-hot (nc) | label].
//
// Build. This file and the five k1_gemm_<form>.cu (the tile kernel of
// k1_gemm.cuh instantiated for one product form each) are compiled at once
// and linked into one library (_build.py, UNITS); k1_epoch.cuh holds what
// they share.

#include "k1_epoch.cuh"

namespace {

using namespace k1;

constexpr int kMaxNc = 16;
constexpr int kRowStats = 16;   // per-row metric terms, see row_kernel

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------ row-wise ------
// One warp per batch row. Mode 0: real D pass (c_out = sigmoid(out) - 1, ghost
// norms and clip factor under DP). Mode 1: clean fake pass (c_out =
// sigmoid(out), aux term only when d_fake_aux). Mode 2: G step through the
// updated D (cotangents pre-scaled by 1/bs). Writes c_z1 = c_h * (h > 0),
// c_out, c_aux and the row's metric terms:
//   0 BCE(out,1)  1 out>0  2 CE  3 aux-acc  4..9 norms  10 clipped
//   11 BCE(outf,0)  12 outf<0  13 BCE(outg,1)  14 CE_g  15 aux-acc_g
struct RowJob {
  const float* H;                    // [B, Hd] post-ReLU activations
  const void* oh; int oh_bf16; int ld_oh;
  const void* a0; int a0_bf16; int ld_a0;   // mode 0: D input rows [x | one-hot]
  float* CZ; float* CO; float* CA;
  int mode;
};

struct RowArgs {
  RowJob job[2];
  int B, Hd, nc, A0, use_dp, d_fake_aux;
  const float* W2; const float* b2; const float* Wa; const float* ba;
  float aux_scalar, inv_b, C;
  float* fac; float* RS;
};

__global__ void __launch_bounds__(256) row_kernel(RowArgs a) {
  const RowJob& J = a.job[blockIdx.y];
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (r >= a.B) return;
  const int nc = a.nc, Hd = a.Hd;
  const float* h = J.H + (size_t)r * Hd;

  float po = 0.f, pa[kMaxNc];
#pragma unroll
  for (int j = 0; j < kMaxNc; ++j) pa[j] = 0.f;
  for (int k = lane; k < Hd; k += 32) {
    const float hv = h[k];
    po = fmaf(hv, a.W2[k], po);
#pragma unroll
    for (int j = 0; j < kMaxNc; ++j)
      if (j < nc) pa[j] = fmaf(hv, a.Wa[(size_t)j * Hd + k], pa[j]);
  }
  const float out = warp_sum(po) + a.b2[0];
  float aux[kMaxNc], oh[kMaxNc];
  float mx = -INFINITY, tl = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxNc; ++j) {
    aux[j] = 0.f; oh[j] = 0.f;
    if (j < nc) {
      aux[j] = warp_sum(pa[j]) + a.ba[j];
      oh[j] = ld_any(J.oh, J.oh_bf16, (size_t)r * J.ld_oh + j);
      mx = fmaxf(mx, aux[j]);
      tl = fmaf(oh[j], aux[j], tl);
    }
  }
  float se = 0.f, ex[kMaxNc];
#pragma unroll
  for (int j = 0; j < kMaxNc; ++j) {
    ex[j] = 0.f;
    if (j < nc) { ex[j] = expf(aux[j] - mx); se += ex[j]; }
  }
  const float lse = logf(se);
  float ce = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxNc; ++j)
    if (j < nc) ce = fmaf((aux[j] - mx) - lse, oh[j], ce);
  ce = -ce;

  const int mode = J.mode;
  const bool has_aux = mode != 1 || a.d_fake_aux;
  float c_out = sigmoidf_(out) - (mode == 1 ? 0.f : 1.f);
  float ca_scale = a.aux_scalar;
  if (mode == 2) { c_out = c_out * a.inv_b; ca_scale = a.aux_scalar * a.inv_b; }
  float c_aux[kMaxNc];
  float sq_ca = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxNc; ++j) {
    c_aux[j] = 0.f;
    if (j < nc && has_aux) {
      c_aux[j] = ca_scale * (ex[j] / se - oh[j]);
      sq_ca = fmaf(c_aux[j], c_aux[j], sq_ca);
    }
  }

  float sq_h = 0.f, sq_cz = 0.f;
  float* cz = J.CZ + (size_t)r * Hd;
  for (int k = lane; k < Hd; k += 32) {
    const float hv = h[k];
    float d = 0.f;
    if (has_aux) {
#pragma unroll
      for (int j = 0; j < kMaxNc; ++j)
        if (j < nc) d = fmaf(c_aux[j], a.Wa[(size_t)j * Hd + k], d);
    }
    const float ch = c_out * a.W2[k] + d;
    const float c = hv > 0.f ? ch : ch * 0.f;
    cz[k] = c;
    sq_h = fmaf(hv, hv, sq_h);
    sq_cz = fmaf(c, c, sq_cz);
  }
  sq_h = warp_sum(sq_h);
  sq_cz = warp_sum(sq_cz);

  float sq_a0 = 0.f;
  const bool ghost = mode == 0 && a.use_dp;
  if (ghost) {
    for (int k = lane; k < a.A0; k += 32) {
      const float v = ld_any(J.a0, J.a0_bf16, (size_t)r * J.ld_a0 + k);
      sq_a0 = fmaf(v, v, sq_a0);
    }
    sq_a0 = warp_sum(sq_a0);
  }
  if (lane != 0) return;

  if (J.CO) J.CO[r] = c_out;
  if (J.CA)
    for (int j = 0; j < nc; ++j) J.CA[(size_t)r * nc + j] = c_aux[j];
  float* rs = a.RS + (size_t)r * kRowStats;
  const float softplus = log1pf(expf(-fabsf(out)));
  const float acc = tl >= mx ? 1.f : 0.f;
  if (mode == 0) {
    rs[0] = fmaxf(out, 0.f) - out * 1.f + softplus;
    rs[1] = out > 0.f ? 1.f : 0.f;
    rs[2] = ce;
    rs[3] = acc;
    if (ghost) {
      const float sq_co = c_out * c_out;
      const float n0 = sqrtf(sq_cz), n1 = sqrtf(sq_a0 * sq_cz);
      const float n2 = sqrtf(sq_co), n3 = sqrtf(sq_h * sq_co);
      const float n4 = sqrtf(sq_ca), n5 = sqrtf(sq_h * sq_ca);
      const float flat = sqrtf(n0 * n0 + n1 * n1 + n2 * n2 + n3 * n3 + n4 * n4 + n5 * n5);
      const float f = fminf(1.f, a.C / (flat + 1e-12f));
      a.fac[r] = f;
      rs[4] = n0; rs[5] = n1; rs[6] = n2; rs[7] = n3; rs[8] = n4; rs[9] = n5;
      rs[10] = f < 0.999f ? 1.f : 0.f;
    }
  } else if (mode == 1) {
    rs[11] = fmaxf(out, 0.f) - out * 0.f + softplus;
    rs[12] = out < 0.f ? 1.f : 0.f;
  } else {
    rs[13] = fmaxf(out, 0.f) - out * 1.f + softplus;
    rs[14] = ce;
    rs[15] = acc;
  }
}

// ----------------------------------------------------- bias gradients -------
// out[i] = sum_b X1[b * ld1 + i] * (rs1 ? rs1[b] : 1)  [+ sum_b X2[b * ld2 + i]]
// Up to three such sums per launch (blockIdx.y). A block of 32 warps covers
// 32 columns: warp w sums rows w, w + 32, ... of each column (lanes on
// neighbouring columns), the 32 slices meet in shared memory, and warp c
// adds column c's slices with a fixed butterfly. Fixed order, no atomics.
struct ColJob {
  const float* X1; int ld1; const float* rs1;
  const float* X2; int ld2;
  int ncols; float* out;
};
struct ColArgs { ColJob job[3]; int B; };
constexpr int kColThreads = 1024;

// The column sum of rows [0, B) for column c0 + (warp index), in every lane.
__device__ float block_colsum(const float* X, int ld, const float* rs, int B,
                              int col, bool valid, float (*sh)[33]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float s = 0.f;
  if (valid)
    for (int b = w; b < B; b += 32) {
      float v = X[(size_t)b * ld + col];
      if (rs) v = v * rs[b];
      s += v;
    }
  __syncthreads();
  sh[w][lane] = s;
  __syncthreads();
  return warp_sum(sh[lane][w]);
}

__global__ void __launch_bounds__(kColThreads) colsum_kernel(ColArgs a) {
  __shared__ float sh[32][33];
  const ColJob& J = a.job[blockIdx.y];
  const int c0 = blockIdx.x * 32;
  if (J.out == nullptr || c0 >= J.ncols) return;   // uniform over the block
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const bool valid = c0 + lane < J.ncols;
  float t = block_colsum(J.X1, J.ld1, J.rs1, a.B, c0 + lane, valid, sh);
  if (J.X2) t = t + block_colsum(J.X2, J.ld2, nullptr, a.B, c0 + lane, valid, sh);
  if (lane == 0 && c0 + w < J.ncols) J.out[c0 + w] = t;
}

// ---------------------------------------------------------------- Adam ------
// optax scale_by_adam (eps_root 0) + scale(-lr), with g = (grad [+ noise]) *
// gscale over one model's flat buffer. Leaf l covers [off[l], off[l+1]).
struct Noise { const float* p[6]; long long off[7]; };

__global__ void adam_kernel(long long P, float* p, float* m, float* v,
                            const float* __restrict__ g, Noise nz, int use_noise,
                            float gscale, float lr, float b1, float b2,
                            float omb1, float omb2, float bc1, float bc2,
                            float eps) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < P;
       i += (long long)gridDim.x * blockDim.x) {
    float gr = g[i];
    if (use_noise) {
      int l = 0;
      while (i >= nz.off[l + 1]) ++l;
      gr = gr + nz.p[l][i - nz.off[l]];
    }
    gr = gr * gscale;
    const float mm = b1 * m[i] + omb1 * gr;
    const float vv = b2 * v[i] + omb2 * (gr * gr);
    m[i] = mm;
    v[i] = vv;
    const float u = (mm / bc1) / (sqrtf(vv / bc2) + eps);
    p[i] = p[i] - lr * u;
  }
}

// ------------------------------------------------------------ metrics -------
__device__ float block_reduce(float v, bool is_max, float* sh) {
  v = is_max ? v : warp_sum(v);
  if (is_max)
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int w = threadIdx.x / 32, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) sh[w] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = sh[0];
    for (int i = 1; i < (int)(blockDim.x / 32); ++i) t = is_max ? fmaxf(t, sh[i]) : t + sh[i];
    sh[32] = t;
  }
  __syncthreads();
  return sh[32];
}

__global__ void metrics_kernel(const float* __restrict__ RS, int B, int use_dp,
                               float aux_scalar, float* met) {
  __shared__ float sh[33];
  __shared__ float mean[kRowStats];
  const float inv_b = 1.f / (float)B;
  for (int c = 0; c < kRowStats; ++c) {
    float s = 0.f;
    for (int r = threadIdx.x; r < B; r += blockDim.x) s += RS[(size_t)r * kRowStats + c];
    s = block_reduce(s, false, sh);
    if (threadIdx.x == 0) mean[c] = s * inv_b;
  }
  __syncthreads();
  float std_[6], mx_[6];
  if (use_dp) {
    for (int l = 0; l < 6; ++l) {
      const float mu = mean[4 + l];
      float s = 0.f, m = -INFINITY;
      for (int r = threadIdx.x; r < B; r += blockDim.x) {
        const float x = RS[(size_t)r * kRowStats + 4 + l];
        s += (x - mu) * (x - mu);
        m = fmaxf(m, x);
      }
      std_[l] = sqrtf(block_reduce(s, false, sh) * inv_b);
      mx_[l] = block_reduce(m, true, sh);
    }
  }
  if (threadIdx.x != 0) return;
  const float r_loss = mean[0], f_loss = mean[11];
  met[0] += r_loss + f_loss;
  met[1] += r_loss;
  met[2] += f_loss;
  met[3] += 100.f * mean[1];
  met[4] += 100.f * mean[12];
  met[5] += aux_scalar * mean[2];
  met[6] += 100.f * mean[3];
  met[7] += mean[13];
  met[8] += aux_scalar * mean[14];
  met[9] += 100.f * mean[15];
  if (use_dp) {
    for (int l = 0; l < 6; ++l) {
      met[10 + l] += mean[4 + l];
      met[16 + l] += std_[l];
      met[22 + l] += mx_[l];
      met[28 + l] += mean[10];
    }
  }
}

// ------------------------------------------------------------- host ---------
enum Ptr {
  P_ROWS, P_ZD, P_ZG, P_OHG, P_N0, P_N1, P_N2, P_N3, P_N4, P_N5,
  P_PD, P_MD, P_VD, P_PG, P_MG, P_VG, P_MET,
  P_GH, P_FIMG, P_HR, P_HF, P_CZR, P_CZF, P_COR, P_COF, P_CAR, P_CAF, P_FAC,
  P_RS, P_GD, P_GHB, P_IMG, P_HG, P_CZG, P_CGLOG, P_CGZ1, P_GG, P_WS, P_COUNT
};
enum Int { I_N, I_BS, I_F, I_NC, I_LAT, I_H, I_DP, I_FAUX, I_TD, I_TG, I_RBF16, I_COUNT };
enum Flt { F_AUX, F_B1, F_B2, F_OMB1, F_OMB2, F_LNB1, F_LNB2, F_GLR, F_DLR, F_EPS, F_C, F_COUNT };

Epi epi() {
  Epi e{};
  return e;
}

// The products of one step as (M, N, K, ReLU epilogue), in run_epoch's
// order (the fake pass's aux product only when d_fake_aux), for the
// workspace size and the printed plan. run_epoch checks each launch against
// the workspace.
int step_products(const int* in, int (*out)[4]) {
  const int bs = in[I_BS], F = in[I_F], nc = in[I_NC], L = in[I_LAT], H = in[I_H];
  const int A0 = F + nc;
  const int prods[][4] = {
      {bs, H, L, 1}, {bs, F, H, 0}, {bs, H, A0, 1}, {bs, H, F, 1},          // G fwd, D hidden
      {H, A0, bs, 0}, {1, H, bs, 0}, {nc, H, bs, 0},                        // real sums
      {H, F, bs, 0}, {H, nc, bs, 0}, {1, H, bs, 0}, {nc, H, bs, 0},         // fake sums
      {bs, H, L, 1}, {bs, F, H, 0}, {bs, H, F, 1},                          // G step forward
      {bs, F, H, 0}, {F, H, bs, 0}, {bs, H, F, 0}, {H, L, bs, 0}, {H, nc, bs, 0}  // G step backward
  };
  int k = 0;
  for (int i = 0; i < (int)(sizeof(prods) / sizeof(prods[0])); ++i) {
    if (i == 10 && !in[I_FAUX]) continue;
    for (int j = 0; j < 4; ++j) out[k][j] = prods[i][j];
    ++k;
  }
  return k;
}

constexpr int kMaxProducts = 24;

// Floats of split-K workspace the step needs: the largest S * M * N.
long long workspace_floats(const int* in) {
  int pr[kMaxProducts][4];
  const int np = step_products(in, pr);
  long long need = 0;
  for (int i = 0; i < np; ++i) {
    const Plan pl = plan_of(pr[i][0], pr[i][1], pr[i][2], pr[i][3]);
    const long long w = pl.s > 1 ? (long long)pl.s * pr[i][0] * pr[i][1] : 0;
    need = w > need ? w : need;
  }
  return need;
}

// The jobs of `a` are filled from job[0] on.
int colsum(cudaStream_t st, const ColArgs& a) {
  int blocks = 0, jobs = 0;
  for (const ColJob& j : a.job)
    if (j.out) {
      ++jobs;
      if (cdiv(j.ncols, 32) > blocks) blocks = cdiv(j.ncols, 32);
    }
  colsum_kernel<<<dim3(blocks, jobs), kColThreads, 0, st>>>(a);
  CK();
  return 0;
}

int adam(cudaStream_t st, long long P, float* p, float* m, float* v,
         const float* g, const Noise& nz, int use_noise, float gscale, float lr,
         const float* f, int t) {
  const float tt = (float)t;
  const float bc1 = 1.f - expf(tt * f[F_LNB1]);
  const float bc2 = 1.f - expf(tt * f[F_LNB2]);
  int blocks = (int)((P + 255) / 256);
  if (blocks > 1024) blocks = 1024;
  adam_kernel<<<blocks, 256, 0, st>>>(P, p, m, v, g, nz, use_noise, gscale, lr,
                                      f[F_B1], f[F_B2], f[F_OMB1], f[F_OMB2],
                                      bc1, bc2, f[F_EPS]);
  CK();
  return 0;
}

#define RUN(call)             \
  do {                        \
    int rc_ = (call);         \
    if (rc_ != 0) return rc_; \
  } while (0)

template <typename RowT>
int run_epoch(void* const* p, const int* in, const float* f, cudaStream_t st) {
  const int n = in[I_N], bs = in[I_BS], F = in[I_F], nc = in[I_NC];
  const int L = in[I_LAT], H = in[I_H], dp = in[I_DP], faux = in[I_FAUX];
  const int rbf = in[I_RBF16];
  const int A0 = F + nc, W = A0 + 1, LG = L + nc;
  const float inv_b = 1.f / (float)bs;

  const RowT* rows = static_cast<const RowT*>(p[P_ROWS]);
  const float* zd_all = static_cast<const float*>(p[P_ZD]);
  const float* zg_all = static_cast<const float*>(p[P_ZG]);
  const float* ohg_all = static_cast<const float*>(p[P_OHG]);
  float* pD = static_cast<float*>(p[P_PD]);
  float* pG = static_cast<float*>(p[P_PG]);
  auto S = [&](int i) { return static_cast<float*>(p[i]); };
  const Ctx cx{st, S(P_WS), workspace_floats(in)};

  // Flat offsets (see the layout note at the top).
  const long long oDb1 = 0, oDW1 = H, oDb2 = oDW1 + (long long)H * A0,
                  oDW2 = oDb2 + 1, oDba = oDW2 + H, oDWa = oDba + nc,
                  PD = oDWa + (long long)nc * H;
  const long long oGb1 = 0, oGW1 = H, oGb2 = oGW1 + (long long)H * LG,
                  oGW2 = oGb2 + F, PG = oGW2 + (long long)F * H;
  const long long dsz[6] = {H, (long long)H * A0, 1, H, nc, (long long)nc * H};
  float *Db1 = pD + oDb1, *DW1 = pD + oDW1, *Db2 = pD + oDb2, *DW2 = pD + oDW2,
        *Dba = pD + oDba, *DWa = pD + oDWa;
  float *Gb1 = pG + oGb1, *GW1 = pG + oGW1, *Gb2 = pG + oGb2, *GW2 = pG + oGW2;
  float *GD = S(P_GD), *GG = S(P_GG);

  for (int s = 0; s < n; ++s) {
    const RowT* R = rows + (size_t)s * bs * W;
    const RowT* OHD = R + F;
    const float* zd = zd_all + (size_t)s * bs * L;
    const float* zg = zg_all + (size_t)s * bs * L;
    const float* ohg = ohg_all + (size_t)s * bs * nc;

    // (1) G forward on z_d: the input product split into z and one-hot parts.
    Epi e = epi();
    e.oh = OHD; e.oh_bf16 = rbf; e.ld_oh = W; e.n_oh = nc; e.wy = GW1 + L; e.ld_wy = LG;
    e.bias = Gb1; e.act = 1;
    RUN((gemm<false, true, float, float>(cx, bs, H, L, zd, L, GW1, LG, nullptr, S(P_GH), H, e)));
    e = epi(); e.bias = Gb2; e.act = 2;
    RUN((gemm<false, true, float, float>(cx, bs, F, H, S(P_GH), H, GW2, H, nullptr, S(P_FIMG), F, e)));
    // (2)-(3) D hidden layer on the real rows and on the fakes.
    e = epi(); e.bias = Db1; e.act = 1;
    RUN((gemm<false, true, RowT, float>(cx, bs, H, A0, R, W, DW1, A0, nullptr, S(P_HR), H, e)));
    e = epi();
    e.oh = OHD; e.oh_bf16 = rbf; e.ld_oh = W; e.n_oh = nc; e.wy = DW1 + F; e.ld_wy = A0;
    e.bias = Db1; e.act = 1;
    RUN((gemm<false, true, float, float>(cx, bs, H, F, S(P_FIMG), F, DW1, A0, nullptr, S(P_HF), H, e)));
    // Per-sample cotangents, ghost norms, clip factors, row metrics.
    RowArgs ra{};
    ra.job[0] = RowJob{S(P_HR), OHD, rbf, W, R, rbf, W, S(P_CZR), S(P_COR), S(P_CAR), 0};
    ra.job[1] = RowJob{S(P_HF), OHD, rbf, W, nullptr, 0, 0, S(P_CZF), S(P_COF), S(P_CAF), 1};
    ra.B = bs; ra.Hd = H; ra.nc = nc; ra.A0 = A0; ra.use_dp = dp; ra.d_fake_aux = faux;
    ra.W2 = DW2; ra.b2 = Db2; ra.Wa = DWa; ra.ba = Dba;
    ra.aux_scalar = f[F_AUX]; ra.inv_b = inv_b; ra.C = f[F_C];
    ra.fac = S(P_FAC); ra.RS = S(P_RS);
    row_kernel<<<dim3((bs + 7) / 8, 2), 256, 0, st>>>(ra);
    CK();
    // Real-pass sums (clip-weighted under DP): the activation side is scaled.
    const float* fac = dp ? S(P_FAC) : nullptr;
    e = epi();
    RUN((gemm<true, false, float, RowT>(cx, H, A0, bs, S(P_CZR), H, R, W, fac, GD + oDW1, A0, e)));
    RUN((gemm<true, false, float, float>(cx, 1, H, bs, S(P_COR), 1, S(P_HR), H, fac, GD + oDW2, H, e)));
    RUN((gemm<true, false, float, float>(cx, nc, H, bs, S(P_CAR), nc, S(P_HR), H, fac, GD + oDWa, H, e)));
    // Clean fake-pass sums, accumulated onto the real ones.
    e = epi(); e.accumulate = 1;
    RUN((gemm<true, false, float, float>(cx, H, F, bs, S(P_CZF), H, S(P_FIMG), F, nullptr, GD + oDW1, A0, e)));
    RUN((gemm<true, false, float, RowT>(cx, H, nc, bs, S(P_CZF), H, OHD, W, nullptr, GD + oDW1 + F, A0, e)));
    RUN((gemm<true, false, float, float>(cx, 1, H, bs, S(P_COF), 1, S(P_HF), H, nullptr, GD + oDW2, H, e)));
    if (faux)
      RUN((gemm<true, false, float, float>(cx, nc, H, bs, S(P_CAF), nc, S(P_HF), H, nullptr, GD + oDWa, H, e)));
    // Bias sums of both passes in one launch: (real, clip-weighted) + fake.
    ColArgs cs{};
    cs.B = bs;
    cs.job[0] = ColJob{S(P_CZR), H, fac, S(P_CZF), H, H, GD + oDb1};
    cs.job[1] = ColJob{S(P_COR), 1, fac, S(P_COF), 1, 1, GD + oDb2};
    cs.job[2] = ColJob{S(P_CAR), nc, fac, faux ? S(P_CAF) : nullptr, nc, nc, GD + oDba};
    RUN(colsum(st, cs));
    // (4)-(5) + noise, / bs, Adam for D.
    Noise nz{};
    long long off = 0;
    for (int l = 0; l < 6; ++l) {
      nz.off[l] = off;
      nz.p[l] = dp ? static_cast<const float*>(p[P_N0 + l]) + (size_t)s * dsz[l] : nullptr;
      off += dsz[l];
    }
    nz.off[6] = off;
    RUN(adam(st, PD, pD, S(P_MD), S(P_VD), GD, nz, dp, inv_b, f[F_DLR], f,
             in[I_TD] + s + 1));

    // (6) G step against the updated D.
    e = epi();
    e.oh = ohg; e.oh_bf16 = 0; e.ld_oh = nc; e.n_oh = nc; e.wy = GW1 + L; e.ld_wy = LG;
    e.bias = Gb1; e.act = 1;
    RUN((gemm<false, true, float, float>(cx, bs, H, L, zg, L, GW1, LG, nullptr, S(P_GHB), H, e)));
    e = epi(); e.bias = Gb2; e.act = 2;
    RUN((gemm<false, true, float, float>(cx, bs, F, H, S(P_GHB), H, GW2, H, nullptr, S(P_IMG), F, e)));
    e = epi();
    e.oh = ohg; e.oh_bf16 = 0; e.ld_oh = nc; e.n_oh = nc; e.wy = DW1 + F; e.ld_wy = A0;
    e.bias = Db1; e.act = 1;
    RUN((gemm<false, true, float, float>(cx, bs, H, F, S(P_IMG), F, DW1, A0, nullptr, S(P_HG), H, e)));
    RowArgs rg = ra;
    rg.job[0] = RowJob{S(P_HG), ohg, 0, nc, nullptr, 0, 0, S(P_CZG), nullptr, nullptr, 2};
    row_kernel<<<dim3((bs + 7) / 8, 1), 256, 0, st>>>(rg);
    CK();
    e = epi(); e.sig = S(P_IMG); e.ld_sig = F;   // c_glog = (c_z1 W1_img) * img * (1 - img)
    RUN((gemm<false, false, float, float>(cx, bs, F, H, S(P_CZG), H, DW1, A0, nullptr, S(P_CGLOG), F, e)));
    e = epi();
    RUN((gemm<true, false, float, float>(cx, F, H, bs, S(P_CGLOG), F, S(P_GHB), H, nullptr, GG + oGW2, H, e)));
    ColArgs cg{};
    cg.B = bs;
    cg.job[0] = ColJob{S(P_CGLOG), F, nullptr, nullptr, 0, F, GG + oGb2};
    RUN(colsum(st, cg));
    e = epi(); e.mask = S(P_GHB); e.ld_mask = H;
    RUN((gemm<false, false, float, float>(cx, bs, H, F, S(P_CGLOG), F, GW2, H, nullptr, S(P_CGZ1), H, e)));
    e = epi();
    RUN((gemm<true, false, float, float>(cx, H, L, bs, S(P_CGZ1), H, zg, L, nullptr, GG + oGW1, LG, e)));
    RUN((gemm<true, false, float, float>(cx, H, nc, bs, S(P_CGZ1), H, ohg, nc, nullptr, GG + oGW1 + L, LG, e)));
    cg.job[0] = ColJob{S(P_CGZ1), H, nullptr, nullptr, 0, H, GG + oGb1};
    RUN(colsum(st, cg));
    Noise none{};
    RUN(adam(st, PG, pG, S(P_MG), S(P_VG), GG, none, 0, 1.f, f[F_GLR], f,
             in[I_TG] + s + 1));

    // (7) Metric sums for the step.
    metrics_kernel<<<1, 256, 0, st>>>(S(P_RS), bs, dp, f[F_AUX], S(P_MET));
    CK();
  }
  return 0;
}

bool bad_args(int n_ptrs, const int* ints, int n_ints, int n_floats) {
  return n_ptrs != P_COUNT || n_ints != I_COUNT || n_floats != F_COUNT ||
         ints[I_NC] > kMaxNc || ints[I_H] % 32 != 0;
}

}  // namespace

extern "C" {

// Floats of split-K workspace (the last pointer of k1_epoch) for these ints,
// or -1 for bad arguments.
long long k1_epoch_scratch(const int* ints, int n_ints) {
  if (bad_args(P_COUNT, ints, n_ints, F_COUNT)) return -1;
  return workspace_floats(ints);
}

// The split plan of one step: for each product, 8 ints (M, N, K, tile rows,
// tile columns, BK, splits S, CTAs) into out[0 .. 8 * max_rows). Returns
// the number of products, or -1 for bad arguments.
int k1_epoch_plan(const int* ints, int n_ints, int* out, int max_rows) {
  if (bad_args(P_COUNT, ints, n_ints, F_COUNT)) return -1;
  int pr[kMaxProducts][4];
  const int np = step_products(ints, pr);
  for (int i = 0; i < np && i < max_rows; ++i) {
    const Plan pl = plan_of(pr[i][0], pr[i][1], pr[i][2], pr[i][3]);
    const int bm = kTile[pl.t][0], bn = kTile[pl.t][1];
    const int row[8] = {pr[i][0], pr[i][1], pr[i][2], bm, bn, kTile[pl.t][2], pl.s,
                        cdiv(pr[i][0], bm) * cdiv(pr[i][1], bn) * pl.s};
    for (int j = 0; j < 8; ++j) out[8 * i + j] = row[j];
  }
  return np;
}

// One epoch of K1 on `stream`. Returns 0, a cudaError_t, kErrBadArgs or
// kErrWorkspace.
int k1_epoch(void* const* ptrs, int n_ptrs, const int* ints, int n_ints,
             const float* floats, int n_floats, void* stream) {
  if (bad_args(n_ptrs, ints, n_ints, n_floats)) return kErrBadArgs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ints[I_RBF16]) return run_epoch<__nv_bfloat16>(ptrs, ints, floats, st);
  return run_epoch<float>(ptrs, ints, floats, st);
}

const char* k1_error_string(int code) {
  if (code == kErrBadArgs) return "bad argument counts or shapes";
  if (code == kErrWorkspace) return "split-K workspace smaller than a product's plan";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
