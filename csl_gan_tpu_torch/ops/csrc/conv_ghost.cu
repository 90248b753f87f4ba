// Conv ghost clipping for Hopper (sm_90a): per-sample conv-kernel-grad norms
// (K2) and the clip-weighted kernel-grad sum (K3).
//
// Replaces the JAX package's Pallas kernels in csl_gan_tpu/ops/pallas_conv_ghost.py:
//   K2  _norms_kernel (:170, via ghost_sq_norms :191)
//   K3  _wsum_kernel  (:234, via weighted_kernel_grad :263)
// For a conv layer with input a [B, H, W, Cin] (NHWC), output cotangent
// c [B, Ho, Wo, O] and kernel [kh, kw, Cin, O], let U_i [S, K] be sample i's
// im2col patches (S = Ho * Wo, K = kh * kw * Cin, column k = (dh * kw + dw) *
// Cin + ci) and C_i [S, O] its cotangent. Then
//   K2: ||g_W(i)||^2 = < U_i U_i^T, C_i C_i^T >         -> [B] fp32
//   K3: sum_i U_i^T (w_i C_i)                          -> [K, O] fp32
// with w_i C_i rounded to the input dtype before the product, exactly as the
// TPU kernel does (:281); the bf16 rounding is what the JAX package's
// _BF16_NORM_MARGIN (ops/conv_ghost.py:47) covers.
//
// Neither kernel forms the patch tensor: a patch element is read straight from
// the activation by address arithmetic (row s = (oh, ow), column k = (dh, dw,
// ci) -> a[oh * stride + dh - pad, ow * stride + dw - pad, ci], zero outside),
// which replaces the TPU kernel's stride-phase split (prepare_phases, :128-152;
// Mosaic had no strided slices). Operands are bf16 or fp32, converted to fp32
// on load, and every product accumulates in fp32 FFMA (bf16 x bf16 products
// are exact in fp32).
//
// K2: one CTA per (sample, tile pair) of the symmetric [S, S] Gram: the CTA
// accumulates its TS x TS tile of U U^T over K, then the same tile of C C^T
// over O, and reduces their elementwise product; off-diagonal tiles count
// twice. A [256, 256] fp32 Gram (conv2) would not fit in 227 KB of shared
// memory, so it is never formed. A second kernel sums each sample's tile
// partials in a fixed order.
// K3: a GEMM [K, B*S] x [B*S, O]. One CTA per (64 x 64 output tile, split of
// the B*S reduction); the splits fill the SMs when there are few output tiles
// (conv2: 50 tiles), and a second kernel adds the splits in a fixed order. No
// atomics: the DP sum is reproducible run to run.
//
// Bound on an H100 SXM at the CelebA flagship's ghost-order layers (B = 128,
// bf16, k 5, stride 2, pad 2), in operations (fp32 FFMA, 67 TFLOP/s; with bf16
// tensor cores, 989 TFLOP/s):
//   K2: the cheaper of the symmetric half of both Grams with their Frobenius
//       product, B S (S + 1) (K + O + 1), and the direct order's
//       2 B K O (S + 1) (form each U_i^T C_i, then its squares):
//       13.5 GFLOP (conv2, direct) + 1.84 (conv3, Grams) + 0.24 (conv4,
//       Grams) = 15.55 GFLOP per D step, 0.016 ms on the tensor cores
//   K3: 2 K O B S = 13.4 GFLOP per layer
// The bytes are small beside that (a and c read once: 17-25 MB per layer).
// These first kernels run on the CUDA cores; wgmma tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kChunk = 32;      // reduction depth staged in shared memory per step

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Geo {
  int b, h, w, cin, ho, wo, o, kh, kw, stride, pad;
  __host__ __device__ int s() const { return ho * wo; }
  __host__ __device__ int k() const { return kh * kw * cin; }
};

// Patch element U_b[s, k] (zero in the padding).
template <typename T>
__device__ __forceinline__ float patch(const T* __restrict__ a, const Geo& g,
                                       int b, int s, int k) {
  const int oh = s / g.wo, ow = s - oh * g.wo;
  const int dhw = k / g.cin, ci = k - dhw * g.cin;
  const int dh = dhw / g.kw, dw = dhw - dh * g.kw;
  const int ih = oh * g.stride + dh - g.pad, iw = ow * g.stride + dw - g.pad;
  if (ih < 0 || ih >= g.h || iw < 0 || iw >= g.w) return 0.f;
  return to_f(a[(((size_t)b * g.h + ih) * g.w + iw) * g.cin + ci]);
}

// Tile pair p -> (row tile i, column tile j), i <= j, of nt tiles.
__device__ __forceinline__ void tile_pair(int p, int nt, int& i, int& j) {
  i = 0;
  while (p >= nt - i) {
    p -= nt - i;
    ++i;
  }
  j = i + p;
}

// K2 body: the TS x TS tile (rows s0.., columns t0..) of the Gram of the rows
// of a [S, depth] operand fetched by `load(row, col)`, accumulated into acc.
// Thread (ty, tx) owns rows ty + 16 * m and columns tx + 16 * n.
template <int TS, typename Load>
__device__ void gram_tile(int s0, int t0, int depth, Load load,
                          float (&acc)[TS / 16][TS / 16],
                          float (*As)[TS + 1], float (*Bs)[TS + 1]) {
  constexpr int TM = TS / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k0 = 0; k0 < depth; k0 += kChunk) {
    for (int e = threadIdx.x; e < TS * kChunk; e += kThreads) {
      const int kk = e % kChunk, r = e / kChunk;
      const int k = k0 + kk;
      As[kk][r] = (k < depth) ? load(s0 + r, k) : 0.f;
      Bs[kk][r] = (k < depth) ? load(t0 + r, k) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kChunk; ++kk) {
      float av[TM], bv[TM];
#pragma unroll
      for (int m = 0; m < TM; ++m) av[m] = As[kk][ty + 16 * m];
#pragma unroll
      for (int n = 0; n < TM; ++n) bv[n] = Bs[kk][tx + 16 * n];
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TM; ++n) acc[m][n] += av[m] * bv[n];
    }
    __syncthreads();
  }
}

template <typename T, int TS>
__global__ void __launch_bounds__(kThreads)
ghost_norm_tiles(const T* __restrict__ a, const T* __restrict__ c, Geo g,
                 float* __restrict__ partial) {
  constexpr int TM = TS / 16;
  __shared__ float As[kChunk][TS + 1], Bs[kChunk][TS + 1];
  __shared__ float red[kThreads];
  const int S = g.s(), nt = (S + TS - 1) / TS;
  const int npairs = nt * (nt + 1) / 2;
  const int p = blockIdx.x, b = blockIdx.y;
  int ti, tj;
  tile_pair(p, nt, ti, tj);
  const int s0 = ti * TS, t0 = tj * TS;

  float gu[TM][TM] = {}, gc[TM][TM] = {};
  gram_tile<TS>(s0, t0, g.k(), [&](int s, int k) {
    return s < S ? patch(a, g, b, s, k) : 0.f;
  }, gu, As, Bs);
  const T* cb = c + (size_t)b * S * g.o;
  gram_tile<TS>(s0, t0, g.o, [&](int s, int o) {
    return s < S ? to_f(cb[(size_t)s * g.o + o]) : 0.f;
  }, gc, As, Bs);

  float v = 0.f;
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TM; ++n) v += gu[m][n] * gc[m][n];
  red[threadIdx.x] = v;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0)
    partial[(size_t)b * npairs + p] = (ti == tj ? 1.f : 2.f) * red[0];
}

__global__ void sum_rows(const float* __restrict__ partial, int n_rows,
                         int n_cols, float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  float s = 0.f;
  for (int j = 0; j < n_cols; ++j) s += partial[(size_t)r * n_cols + j];
  out[r] = s;
}

// K3: out tile [k0, k0 + 64) x [o0, o0 + 64) of sum_r U^T[k, r] cw[r, o] over
// the reduction rows r = b * S + s in [r_lo, r_hi).
template <typename T>
__global__ void __launch_bounds__(kThreads)
wsum_tiles(const T* __restrict__ a, const T* __restrict__ c,
           const float* __restrict__ wfac, Geo g, int rows_per_split,
           float* __restrict__ partial) {
  constexpr int TK = 64, TO = 64, TM = 4;
  __shared__ float As[kChunk][TK], Bs[kChunk][TO];
  const int S = g.s(), K = g.k(), R = g.b * S;
  const int k0 = blockIdx.x * TK, o0 = blockIdx.y * TO, split = blockIdx.z;
  const int r_lo = split * rows_per_split;
  const int r_hi = min(R, r_lo + rows_per_split);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[TM][TM] = {};
  for (int r0 = r_lo; r0 < r_hi; r0 += kChunk) {
    for (int e = threadIdx.x; e < kChunk * TK; e += kThreads) {
      const int kk = e % TK, rr = e / TK;
      const int r = r0 + rr, k = k0 + kk;
      float v = 0.f;
      if (r < r_hi && k < K) {
        const int b = r / S;
        v = patch(a, g, b, r - b * S, k);
      }
      As[rr][kk] = v;
    }
    for (int e = threadIdx.x; e < kChunk * TO; e += kThreads) {
      const int oo = e % TO, rr = e / TO;
      const int r = r0 + rr, o = o0 + oo;
      float v = 0.f;
      if (r < r_hi && o < g.o) {
        const int b = r / S;
        v = round_to(to_f(c[(size_t)r * g.o + o]) * wfac[b], c);
      }
      Bs[rr][oo] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < kChunk; ++rr) {
      float av[TM], bv[TM];
#pragma unroll
      for (int m = 0; m < TM; ++m) av[m] = As[rr][ty + 16 * m];
#pragma unroll
      for (int n = 0; n < TM; ++n) bv[n] = Bs[rr][tx + 16 * n];
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TM; ++n) acc[m][n] += av[m] * bv[n];
    }
    __syncthreads();
  }
  float* out = partial + (size_t)split * K * g.o;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int k = k0 + ty + 16 * m;
    if (k >= K) continue;
#pragma unroll
    for (int n = 0; n < TM; ++n) {
      const int o = o0 + tx + 16 * n;
      if (o < g.o) out[(size_t)k * g.o + o] = acc[m][n];
    }
  }
}

__global__ void sum_splits(const float* __restrict__ partial, int splits,
                           size_t n, float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += partial[(size_t)sp * n + i];
  out[i] = s;
}

Geo geo_of(const int* v) {
  return Geo{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], v[8], v[9], v[10]};
}

// K2's Gram tile edge for S output positions.
int gram_tile_edge(int s) { return s >= 256 ? 64 : (s >= 64 ? 32 : 16); }

int tile_pairs(const Geo& g) {
  const int ts = gram_tile_edge(g.s()), nt = (g.s() + ts - 1) / ts;
  return nt * (nt + 1) / 2;
}

// K3's split of the B * S reduction: enough splits that the 64 x 64 output
// tiles times the splits give about two CTAs per SM, each split a multiple of
// 32 rows and at least 1024 of them.
struct Splits {
  int n, rows;
};

Splits wsum_splits(const Geo& g) {
  int dev = 0, n_sm = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const int r = g.b * g.s();
  const int tiles = ((g.k() + 63) / 64) * ((g.o + 63) / 64);
  const int want = std::max(1, std::min((2 * n_sm + tiles - 1) / tiles, r / 1024));
  int rows = (r + want - 1) / want;
  rows = (rows + 31) / 32 * 32;
  return Splits{(r + rows - 1) / rows, rows};
}

template <typename T, int TS>
int launch_norms(const void* a, const void* c, const Geo& g, float* partial,
                 float* out, cudaStream_t st) {
  const int npairs = tile_pairs(g);
  ghost_norm_tiles<T, TS><<<dim3(npairs, g.b), kThreads, 0, st>>>(
      (const T*)a, (const T*)c, g, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_rows<<<(g.b + 127) / 128, 128, 0, st>>>(partial, g.b, npairs, out);
  return (int)cudaGetLastError();
}

template <typename T>
int norms(const void* a, const void* c, const Geo& g, float* partial,
          float* out, cudaStream_t st) {
  switch (gram_tile_edge(g.s())) {
    case 64: return launch_norms<T, 64>(a, c, g, partial, out, st);
    case 32: return launch_norms<T, 32>(a, c, g, partial, out, st);
    default: return launch_norms<T, 16>(a, c, g, partial, out, st);
  }
}

template <typename T>
int wsum(const void* a, const void* c, const float* w, const Geo& g,
         float* partial, float* out, cudaStream_t st) {
  const int K = g.k();
  const Splits sp = wsum_splits(g);
  dim3 grid((K + 63) / 64, (g.o + 63) / 64, sp.n);
  float* dst = sp.n == 1 ? out : partial;
  wsum_tiles<T><<<grid, kThreads, 0, st>>>((const T*)a, (const T*)c, w, g,
                                           sp.rows, dst);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || sp.n == 1) return (int)e;
  const size_t n = (size_t)K * g.o;
  sum_splits<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(partial, sp.n, n, out);
  return (int)cudaGetLastError();
}

}  // namespace

// geo = [B, H, W, Cin, Ho, Wo, O, kh, kw, stride, pad]; dtype 0 = fp32, 1 = bf16.
// Each launcher chooses its own tiling; the *_scratch functions give the
// fp32 scratch, in floats, that the launcher of the same geometry needs.
extern "C" long long ghost_sq_norms_scratch(const int* geo) {
  const Geo g = geo_of(geo);
  return (long long)g.b * tile_pairs(g);
}

// partial: ghost_sq_norms_scratch floats; out: [B].
extern "C" int ghost_sq_norms(const void* a, const void* c, const int* geo,
                              int dtype, float* partial, float* out, void* stream) {
  const Geo g = geo_of(geo);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return norms<float>(a, c, g, partial, out, st);
  if (dtype == 1) return norms<__nv_bfloat16>(a, c, g, partial, out, st);
  return 1000;
}

extern "C" long long weighted_kernel_grad_scratch(const int* geo) {
  const Geo g = geo_of(geo);
  const Splits sp = wsum_splits(g);
  return sp.n > 1 ? (long long)sp.n * g.k() * g.o : 0;
}

// w: [B] fp32 clip factors; partial: weighted_kernel_grad_scratch floats;
// out: [K, O] = [kh, kw, Cin, O] fp32.
extern "C" int weighted_kernel_grad(const void* a, const void* c, const float* w,
                                    const int* geo, int dtype, float* partial,
                                    float* out, void* stream) {
  const Geo g = geo_of(geo);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return wsum<float>(a, c, w, g, partial, out, st);
  if (dtype == 1) return wsum<__nv_bfloat16>(a, c, w, g, partial, out, st);
  return 1000;
}

extern "C" const char* cg_error_string(int rc) {
  if (rc == 1000) return "unsupported dtype";
  return cudaGetErrorString((cudaError_t)rc);
}
