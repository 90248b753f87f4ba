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
// Neither kernel forms the patch tensor: a patch row is read straight from the
// activation by address arithmetic (row s = (oh, ow), column k = (dh, dw, ci)
// -> a[oh * stride + dh - pad, ow * stride + dw - pad, ci], zero outside),
// which replaces the TPU kernel's stride-phase split (prepare_phases, :128-152;
// Mosaic had no strided slices). No atomics anywhere: partial sums are added
// by a second kernel in a fixed order, so the DP sum is reproducible run to run.
//
// Bound on an H100 SXM at the CelebA flagship's ghost-order layers (B = 128,
// bf16, k 5, stride 2, pad 2): operations on the bf16 tensor cores (989
// TFLOP/s; fp32 FFMA is 67 TFLOP/s):
//   K2: the cheaper of the symmetric half of both Grams with their Frobenius
//       product, B S (S + 1) (K + O + 1), and the direct order's
//       2 B K O (S + 1) (form each U_i^T C_i, then its squares):
//       13.5 GFLOP (conv2, direct) + 1.84 (conv3, Grams) + 0.24 (conv4,
//       Grams) = 15.55 GFLOP per D step, 0.016 ms
//   K3: 2 K O B S = 13.4 GFLOP per layer, 0.041 ms per D step
// The bytes are small beside that (a and c read once: 6-25 MB per layer, which
// the 50 MB L2 holds); the tiles re-read them from L2 (K3: 64 FLOP a byte).
// On an H100 the tensor-core kernels below reach 20-30% of the bf16 rate (K3,
// K2 at conv2) and are bound by their own instruction stream, not by that
// traffic: every warp computes cp.async addresses, waits, fences and starts
// its wgmma in turn (a 256 x 128 tile of K3, a quarter less traffic, was no
// faster). A producer warp on TMA is the next step.
//
// Each kernel has two variants; the caller chooses by the operands (the
// `variant` argument; kernel_variant in ops/pallas_conv_ghost.py).
//
// Variant 1, tensor cores: bf16 operands with Cin and O multiples of 8, so
// that 8 channels are one aligned 16-byte line. wgmma.mma_async (bf16 in, fp32
// accumulators in registers) on 128-byte-swizzled tiles that cp.async (16
// bytes; the zero-fill form for the padding and the ragged edges) stages into
// a ring of dynamic shared memory. The loads run kStages - 2 stages ahead of
// the wgmma that consumes a stage, and the wgmma of a stage stays in flight
// while the next stage is synchronised. Address arithmetic is done once per
// thread and row and then advanced by additions: no division in the loops.
//   K3 (wsum_tc): the GEMM out[K, O] = U^T[K, R] cw[R, O], R = B * S, with
//     cw = bf16(w * c) written once by a pre-pass (scale_cotangent, 2-8 MB a
//     layer) and then streamed like any operand. A CTA is two warpgroups, each
//     one 64-row k tile (m64n128k16: 64 fp32 accumulators a thread) by 128
//     columns of o, sharing the cw stage. A stage is 32 rows of r: for a k
//     tile, 32 lines of 128 bytes of `a` (a tap's 64 channels; where Cin is
//     not a multiple of 64 each 16-byte chunk finds its own tap). Both
//     operands are read as they lie (k and o contiguous: MN-major, the
//     instruction's transpose bits), so nothing is transposed. 6 stages of 16
//     KB, two CTAs an SM. The launcher splits R so that tiles x splits fill
//     the SMs in whole waves of equal work, weighed against the partials'
//     bytes (wsum_tc_splits); sum_splits adds the splits in order.
//     The pre-pass, and not scaling in registers on the way into shared
//     memory: it keeps every load of the GEMM asynchronous and costs one read
//     and one write of c, which chip_smoke.py times beside the GEMM.
//   K2 (ghost_norm_tc): one warpgroup per (sample, pair of 64-row tiles of
//     S): U_i U_j^T over K and C_i C_j^T over O accumulate into two m64n64k16
//     register accumulators, are multiplied element by element in registers,
//     reduced by quad shuffles and one shared-memory step, and written as one
//     partial (off-diagonal pairs twice; a diagonal pair stages one tile and
//     uses it as both operands). Rows of U are the same 128-byte lines as in
//     K3, here depth-contiguous (K-major, the canonical layout). 6 stages of
//     16 KB, two CTAs an SM. With S <= 32 (conv4: S = 16), 64 / S samples
//     share one 64-row tile and only the diagonal S x S blocks of the two
//     accumulators are read (2 or 1 samples a tile, with more CTAs, took the
//     same time on an H100: a CTA there is bound by its own instruction
//     stream, whatever its rows hold). A sample's activation is not kept in shared
//     memory across its pairs: the swizzle atom fixes the pitch of a tile's
//     rows at 128 bytes, which an image in shared memory (neighbouring patch
//     rows stride * Cin elements apart) does not have, so pairs re-read their
//     rows from L2.
// Variant 0, FFMA: fp32 operands (fp32 products on bf16 tensor cores would
// change the numbers) and every other geometry (Cin = 1, ...). Operands are
// converted to fp32 on load and every product is an fp32 FFMA, 16 x 16 threads
// a CTA: K2 one CTA per (sample, tile pair) of TS x TS, K3 64 x 64 output
// tiles by splits of R.

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

// SMs of the current device, asked once.
int sm_count() {
  static const int n_sm = [] {
    int dev = 0, n = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return n_sm;
}

// K3's split of the B * S reduction: enough splits that the 64 x 64 output
// tiles times the splits give about two CTAs per SM, each split a multiple of
// 32 rows and at least 1024 of them.
struct Splits {
  int n, rows;
};

Splits wsum_splits(const Geo& g) {
  const int n_sm = sm_count();
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


// ===================== variant 1: tensor cores (bf16) =====================

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy into shared memory; zero-fill when !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// Makes shared-memory writes of this thread visible to wgmma's reads.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Byte offset of 16-byte chunk `chunk` (0..7) of 128-byte row `row` in a
// 128-byte-swizzled tile (rows 128 bytes apart, tile 1024-byte aligned).
__device__ __forceinline__ uint32_t sw128(int row, int chunk) {
  return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operand (depth
// contiguous): rows of 128 bytes, sbo = 1024 between groups of 8 rows, lbo
// unused (16). MN-major operand (m or n contiguous): each depth row holds 64
// elements of m/n in 128 bytes, sbo = 1024 between groups of 8 depth rows,
// lbo = bytes between blocks of 64 elements of m/n.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// D[64, N] = A[64, 16] B[16, N] + (scale_d ? D : 0), bf16 in, fp32 out; _kk:
// both operands K-major; _mn: both MN-major (the transpose bits set). The
// first wgmma of a kernel takes scale_d = 0, so that nothing but wgmma writes
// the accumulators (ptxas serialises the wgmma otherwise).
__device__ __forceinline__ void wgmma_m64n64k16_kk(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16_mn(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Row of the accumulator fragment that register i of this thread holds (plus
// 16 * warp of the warpgroup), and its column: PTX's m64nNk16 D layout.
__device__ __forceinline__ int frag_row(int lane, int i) { return (lane >> 2) + ((i >> 1) & 1) * 8; }
__device__ __forceinline__ int frag_col(int lane, int i) {
  return (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
}

// ---- K3 ----
constexpr int k3Rows = 32;                        // rows of r a stage (two k16 steps)
constexpr int k3Stages = 6;
constexpr int k3Ahead = k3Stages - 2;             // stages of loads in flight
constexpr int k3Threads = 256;                    // two warpgroups
constexpr int k3N = 128;
constexpr int k3TileBytes = k3Rows * 128;         // 32 lines of 64 bf16
constexpr int k3StageBytes = 4 * k3TileBytes;     // two k tiles of a, two 64-wide blocks of cw
constexpr int k3Smem = k3Stages * k3StageBytes + 1024;

// cw = bf16(float(c) * w[b]), 8 elements a thread.
__global__ void scale_cotangent(const bf16* __restrict__ c, const float* __restrict__ w,
                                int per_sample, long long n8, bf16* __restrict__ cw) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const float wf = w[(i * 8) / per_sample];
  uint4 v = reinterpret_cast<const uint4*>(c)[i];
  bf16* h = reinterpret_cast<bf16*>(&v);
#pragma unroll
  for (int q = 0; q < 8; ++q) h[q] = __float2bfloat16_rn(__bfloat162float(h[q]) * wf);
  reinterpret_cast<uint4*>(cw)[i] = v;
}

// k3Rows consecutive rows r = (b, oh, ow) further: k3Rows = db * S + doh * Wo + dow.
struct RowStep {
  int db, doh, dow;
};

// out tile [128 k, 128 o] of sum_r U^T[k, r] cw[r, o] over r in this split.
__global__ void __launch_bounds__(k3Threads, 2)
wsum_tc(const bf16* __restrict__ a, const bf16* __restrict__ cw, Geo g, RowStep step,
        int rows_per_split, float* __restrict__ partial) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int S = g.s(), K = g.k(), R = g.b * S;
  const int r_lo = blockIdx.z * rows_per_split;
  const int r_hi = min(R, r_lo + rows_per_split);
  const int n_it = (r_hi - r_lo + k3Rows - 1) / k3Rows;

  // a side: this thread copies chunk ach of row arow of both k tiles.
  const int arow = tid >> 3, ach = tid & 7;
  int dh[2], dw[2], ci[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int k = (blockIdx.x * 2 + j) * 64 + ach * 8;
    const int tap = k / g.cin;
    ci[j] = k - tap * g.cin;
    dh[j] = tap / g.kw;
    dw[j] = tap - dh[j] * g.kw;
    if (k >= K) dh[j] = -(1 << 20);               // never inside the image: zero-fill
  }
  int ar = r_lo + arow;
  int ab = ar / S, aoh, aow;
  {
    const int s = ar - ab * S;
    aoh = s / g.wo;
    aow = s - aoh * g.wo;
  }
  // cw side: chunk bch (of 16) of rows brow and brow + 16.
  const int brow = tid >> 4, bch = tid & 15;
  const int bo = blockIdx.y * k3N + bch * 8;
  const bool bov = bo < g.o;
  const uint32_t bdst = 2 * k3TileBytes + (bch >> 3) * k3TileBytes;

  auto load_stage = [&](int it) {                 // called with it = 0, 1, 2, ...
    const uint32_t st = smem + (it % k3Stages) * k3StageBytes;
    const bool rv = ar < r_hi;
    const int ih0 = aoh * g.stride - g.pad, iw0 = aow * g.stride - g.pad;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ih = ih0 + dh[j], iw = iw0 + dw[j];
      const bool ok = rv && (unsigned)ih < (unsigned)g.h && (unsigned)iw < (unsigned)g.w;
      const bf16* src = ok ? a + (((size_t)ab * g.h + ih) * g.w + iw) * g.cin + ci[j] : a;
      cp_async16(st + j * k3TileBytes + sw128(arow, ach), src, ok);
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int row = brow + 16 * p;
      const int r = r_lo + it * k3Rows + row;
      const bool ok = bov && r < r_hi;
      const bf16* src = ok ? cw + (size_t)r * g.o + bo : cw;
      cp_async16(st + bdst + sw128(row, bch & 7), src, ok);
    }
    ar += k3Rows;
    aow += step.dow;
    if (aow >= g.wo) { aow -= g.wo; ++aoh; }
    aoh += step.doh;
    if (aoh >= g.ho) { aoh -= g.ho; ++ab; }
    ab += step.db;
  };

  float acc[64];                                  // n_it >= 1: the first wgmma overwrites it
  for (int it = 0; it < k3Ahead; ++it) {
    if (it < n_it) load_stage(it);
    cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<k3Ahead - 1>();                 // stage `it` of this thread has landed
    fence_async_proxy();
    __syncthreads();                              // ... of every thread; stage it - 2 is free
    if (it + k3Ahead < n_it) load_stage(it + k3Ahead);
    cp_async_commit();
    const uint32_t st = smem + (it % k3Stages) * k3StageBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < k3Rows / 16; ++kk) {
      const uint64_t da = wgmma_desc(st + wg * k3TileBytes + kk * 2048, k3TileBytes, 1024);
      const uint64_t db = wgmma_desc(st + 2 * k3TileBytes + kk * 2048, k3TileBytes, 1024);
      wgmma_m64n128k16_mn(acc, da, db, (it | kk) != 0);
    }
    wgmma_commit();
    wgmma_wait<1>();                              // stage it - 1 is consumed
  }
  wgmma_wait<0>();

  const int lane = tid & 31, warp = (tid >> 5) & 3;
  float* out = partial + (size_t)blockIdx.z * K * g.o;
  const int k0 = (blockIdx.x * 2 + wg) * 64 + warp * 16;
  const int o0 = blockIdx.y * k3N;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int k = k0 + frag_row(lane, i), o = o0 + frag_col(lane, i);
    if (k < K && o < g.o)
      *reinterpret_cast<float2*>(out + (size_t)k * g.o + o) = make_float2(acc[i], acc[i + 1]);
  }
}

// ---- K2 ----
constexpr int k2Stages = 6;
constexpr int k2Ahead = k2Stages - 2;
constexpr int k2Threads = 128;                    // one warpgroup
constexpr int k2TileBytes = 64 * 128;             // 64 rows of 64 bf16 of depth
constexpr int k2StageBytes = 2 * k2TileBytes;     // row tile i, row tile j
constexpr int k2Smem = k2Stages * k2StageBytes + 1024;

// One CTA: sample(s) blockIdx.y * pack .., tile pair blockIdx.x of nt tiles
// of 64 rows of S. With pack > 1 (S <= 32) row slot rho of the one tile is
// row rho % S of sample rho / S.
__global__ void __launch_bounds__(k2Threads)
ghost_norm_tc(const bf16* __restrict__ a, const bf16* __restrict__ c, Geo g, int pack, int nt,
              float* __restrict__ partial) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ float rowsum[64];
  __shared__ int slot_sample[64];
  const uint32_t smem = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int S = g.s(), npairs = nt * (nt + 1) / 2;
  int ti, tj;
  tile_pair(blockIdx.x, nt, ti, tj);
  const bool diag = ti == tj;
  const int b0 = blockIdx.y * pack;

  // This thread copies chunk ch of rows row0 + 16 p of both tiles. Per row:
  // element offset of pixel (b, oh * stride - pad, ow * stride - pad) of a,
  // that pixel's coordinates, and the element offset of the row of c (-1:
  // no such row, zero-fill).
  const int ch = tid & 7, row0 = tid >> 3;
  int pix[2][4], ih0[2][4], iw0[2][4], cof[2][4];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int rho = row0 + 16 * p;
      int q = 0, s = (t == 0 ? ti : tj) * 64 + rho;
      bool valid = s < S;
      if (pack > 1) {
        q = rho / S;
        s = rho - q * S;
        valid = q < pack && b0 + q < g.b;
      }
      const int b = b0 + q;
      const int oh = s / g.wo, ow = s - oh * g.wo;
      ih0[t][p] = valid ? oh * g.stride - g.pad : -(1 << 20);
      iw0[t][p] = ow * g.stride - g.pad;
      pix[t][p] = valid ? ((b * g.h + ih0[t][p]) * g.w + iw0[t][p]) * g.cin : 0;
      cof[t][p] = valid ? (b * S + s) * g.o : -1;
    }
  }
  if (tid < 64) {
    int q = 0;
    if (pack > 1) {
      q = tid / S;
      if (q >= pack || b0 + q >= g.b) q = -1;
    }
    slot_sample[tid] = q;
  }

  const int n_u = (g.k() + 63) / 64, n_tot = n_u + (g.o + 63) / 64;
  // Tap and channel of this thread's chunk of the next depth chunk of U.
  int l_ci = ch * 8, l_dh = 0, l_dw = 0;
  auto wrap = [&]() {
    while (l_ci >= g.cin) {
      l_ci -= g.cin;
      if (++l_dw == g.kw) { l_dw = 0; ++l_dh; }
    }
  };
  wrap();

  auto load_stage = [&](int t) {                  // called with t = 0, 1, 2, ...
    const uint32_t st = smem + (t % k2Stages) * k2StageBytes;
    if (t < n_u) {
      const bool kv = l_dh < g.kh;
      const int koff = (l_dh * g.w + l_dw) * g.cin + l_ci;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && diag) continue;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int ih = ih0[u][p] + l_dh, iw = iw0[u][p] + l_dw;
          const bool ok = kv && (unsigned)ih < (unsigned)g.h && (unsigned)iw < (unsigned)g.w;
          cp_async16(st + u * k2TileBytes + sw128(row0 + 16 * p, ch),
                     ok ? a + (pix[u][p] + koff) : a, ok);
        }
      }
      l_ci += 64;
      wrap();
    } else {
      const int o = (t - n_u) * 64 + ch * 8;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && diag) continue;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const bool ok = o < g.o && cof[u][p] >= 0;
          cp_async16(st + u * k2TileBytes + sw128(row0 + 16 * p, ch),
                     ok ? c + (cof[u][p] + o) : c, ok);
        }
      }
    }
  };

  auto consume = [&](int t, int t_first, float (&acc)[32]) {
    cp_async_wait<k2Ahead - 1>();
    fence_async_proxy();
    __syncthreads();
    if (t + k2Ahead < n_tot) load_stage(t + k2Ahead);
    cp_async_commit();
    const uint32_t sa = smem + (t % k2Stages) * k2StageBytes;
    const uint32_t sb = diag ? sa : sa + k2TileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_kk(acc, wgmma_desc(sa + kk * 32, 16, 1024),
                         wgmma_desc(sb + kk * 32, 16, 1024), t != t_first || kk != 0);
    wgmma_commit();
    wgmma_wait<1>();
  };

  float gu[32], gc[32];                           // each overwritten by its first wgmma
  for (int t = 0; t < k2Ahead; ++t) {
    if (t < n_tot) load_stage(t);
    cp_async_commit();
  }
  for (int t = 0; t < n_u; ++t) consume(t, 0, gu);
  for (int t = n_u; t < n_tot; ++t) consume(t, n_u, gc);
  wgmma_wait<0>();

  // < U_i U_j^T, C_i C_j^T > over the entries whose row and column belong to
  // the same sample: per row in registers and over the quad, then per sample.
  const int lane = tid & 31, rbase = (tid >> 5) * 16;
  const int s_lo = slot_sample[rbase + frag_row(lane, 0)];
  const int s_hi = slot_sample[rbase + frag_row(lane, 2)];
  float v_lo = 0.f, v_hi = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int sc = slot_sample[frag_col(lane, i)];
    const float prod = gu[i] * gc[i];
    if ((i >> 1) & 1) v_hi += sc == s_hi ? prod : 0.f;
    else v_lo += sc == s_lo ? prod : 0.f;
  }
  v_lo += __shfl_xor_sync(0xffffffffu, v_lo, 1);
  v_lo += __shfl_xor_sync(0xffffffffu, v_lo, 2);
  v_hi += __shfl_xor_sync(0xffffffffu, v_hi, 1);
  v_hi += __shfl_xor_sync(0xffffffffu, v_hi, 2);
  if ((lane & 3) == 0) {
    rowsum[rbase + frag_row(lane, 0)] = v_lo;
    rowsum[rbase + frag_row(lane, 2)] = v_hi;
  }
  __syncthreads();
  if (tid < pack && b0 + tid < g.b) {
    const int lo = pack > 1 ? tid * S : 0, hi = pack > 1 ? lo + S : 64;
    float v = 0.f;
    for (int r = lo; r < hi; ++r) v += rowsum[r];
    partial[(size_t)(b0 + tid) * npairs + blockIdx.x] = (diag ? 1.f : 2.f) * v;
  }
}

// Samples a 64-row tile of K2 holds, and the tiles a sample has.
int norm_tc_pack(const Geo& g) { return g.s() <= 32 ? 64 / g.s() : 1; }
int norm_tc_tiles(const Geo& g) { return norm_tc_pack(g) > 1 ? 1 : (g.s() + 63) / 64; }

// Dynamic shared memory above 48 KB has to be asked for, once per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int norms_tc(const void* a, const void* c, const Geo& g, float* partial, float* out,
             cudaStream_t st) {
  const int pack = norm_tc_pack(g), nt = norm_tc_tiles(g), npairs = nt * (nt + 1) / 2;
  static const cudaError_t allowed = allow_smem(ghost_norm_tc, k2Smem);
  cudaError_t e = allowed;
  if (e != cudaSuccess) return (int)e;
  ghost_norm_tc<<<dim3(npairs, (g.b + pack - 1) / pack), k2Threads, k2Smem, st>>>(
      (const bf16*)a, (const bf16*)c, g, pack, nt, npairs == 1 ? out : partial);
  e = cudaGetLastError();
  if (e != cudaSuccess || npairs == 1) return (int)e;
  sum_rows<<<(g.b + 127) / 128, 128, 0, st>>>(partial, g.b, npairs, out);
  return (int)cudaGetLastError();
}

// K3's split of the B * S reduction. With n splits a CTA has `per` stages and
// an SM works through ceil(tiles * n / SMs) CTAs at ~0.35 us a stage (H100,
// measured); the partials cost n * K * O * 8 bytes written and read at ~2.5
// TB/s. The n that makes the sum least wins (n = 1 writes `out`
// itself).
Splits wsum_tc_splits(const Geo& g) {
  const int n_sm = sm_count();
  const int chunks = (g.b * g.s() + k3Rows - 1) / k3Rows;
  const int tiles = ((g.k() + 127) / 128) * ((g.o + k3N - 1) / k3N);
  const double out_us = (double)g.k() * g.o * 8 / 2.5e6;
  Splits best{1, chunks * k3Rows};
  double best_us = 0;
  for (int want = 1; want <= std::min(chunks, 64); ++want) {
    const int per = (chunks + want - 1) / want, n = (chunks + per - 1) / per;
    const int waves = (tiles * n + n_sm - 1) / n_sm;
    const double us = 0.35 * waves * per + (n > 1 ? n * out_us : 0.0);
    if (want == 1 || us < best_us) {
      best_us = us;
      best = Splits{n, per * k3Rows};
    }
  }
  return best;
}

// Floats of scratch before the split partials: cw, bf16 [B * S, O].
long long wsum_tc_cw_floats(const Geo& g) {
  return ((long long)g.b * g.s() * g.o / 2 + 3) / 4 * 4;
}

int wsum_tc_launch(const void* a, const void* c, const float* w, const Geo& g, float* scratch,
                   float* out, cudaStream_t st) {
  const int S = g.s();
  bf16* cw = (bf16*)scratch;
  float* partial = scratch + wsum_tc_cw_floats(g);
  const long long n8 = (long long)g.b * S * g.o / 8;
  scale_cotangent<<<(unsigned)((n8 + 255) / 256), 256, 0, st>>>((const bf16*)c, w, S * g.o, n8,
                                                                 cw);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const Splits sp = wsum_tc_splits(g);
  RowStep step;
  step.db = k3Rows / S;
  step.doh = (k3Rows - step.db * S) / g.wo;
  step.dow = k3Rows - step.db * S - step.doh * g.wo;
  static const cudaError_t allowed = allow_smem(wsum_tc, k3Smem);
  if (allowed != cudaSuccess) return (int)allowed;
  dim3 grid((g.k() + 127) / 128, (g.o + k3N - 1) / k3N, sp.n);
  wsum_tc<<<grid, k3Threads, k3Smem, st>>>((const bf16*)a, cw, g, step, sp.rows,
                                           sp.n == 1 ? out : partial);
  e = cudaGetLastError();
  if (e != cudaSuccess || sp.n == 1) return (int)e;
  const size_t n = (size_t)g.k() * g.o;
  sum_splits<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(partial, sp.n, n, out);
  return (int)cudaGetLastError();
}

}  // namespace

// geo = [B, H, W, Cin, Ho, Wo, O, kh, kw, stride, pad]; dtype 0 = fp32, 1 = bf16;
// variant 0 = FFMA, 1 = tensor cores (bf16 with Cin and O multiples of 8 and
// fewer than 2^31 elements an operand; anything else is refused). Each
// launcher chooses its own tiling; the *_scratch functions give the fp32
// scratch, in floats, that the launcher of the same geometry and variant needs.
namespace {

constexpr int kBadDtype = 1000, kBadVariant = 1001;

bool tc_takes(const Geo& g, int dtype) {
  const long long lim = 1ll << 31;
  return dtype == 1 && g.cin % 8 == 0 && g.o % 8 == 0 &&
         (long long)g.b * g.h * g.w * g.cin < lim && (long long)g.b * g.s() * g.o < lim;
}

}  // namespace

extern "C" long long ghost_sq_norms_scratch(const int* geo, int variant) {
  const Geo g = geo_of(geo);
  if (variant == 1) {
    const int nt = norm_tc_tiles(g);
    return (long long)g.b * (nt * (nt + 1) / 2);
  }
  return (long long)g.b * tile_pairs(g);
}

// partial: ghost_sq_norms_scratch floats; out: [B].
extern "C" int ghost_sq_norms(const void* a, const void* c, const int* geo, int dtype,
                              int variant, float* partial, float* out, void* stream) {
  const Geo g = geo_of(geo);
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 1)
    return tc_takes(g, dtype) ? norms_tc(a, c, g, partial, out, st) : kBadVariant;
  if (variant != 0) return kBadVariant;
  if (dtype == 0) return norms<float>(a, c, g, partial, out, st);
  if (dtype == 1) return norms<__nv_bfloat16>(a, c, g, partial, out, st);
  return kBadDtype;
}

extern "C" long long weighted_kernel_grad_scratch(const int* geo, int variant) {
  const Geo g = geo_of(geo);
  const Splits sp = variant == 1 ? wsum_tc_splits(g) : wsum_splits(g);
  const long long partials = sp.n > 1 ? (long long)sp.n * g.k() * g.o : 0;
  return partials + (variant == 1 ? wsum_tc_cw_floats(g) : 0);
}

// w: [B] fp32 clip factors; scratch: weighted_kernel_grad_scratch floats;
// out: [K, O] = [kh, kw, Cin, O] fp32.
extern "C" int weighted_kernel_grad(const void* a, const void* c, const float* w,
                                    const int* geo, int dtype, int variant, float* scratch,
                                    float* out, void* stream) {
  const Geo g = geo_of(geo);
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 1)
    return tc_takes(g, dtype) ? wsum_tc_launch(a, c, w, g, scratch, out, st) : kBadVariant;
  if (variant != 0) return kBadVariant;
  if (dtype == 0) return wsum<float>(a, c, w, g, scratch, out, st);
  if (dtype == 1) return wsum<__nv_bfloat16>(a, c, w, g, scratch, out, st);
  return kBadDtype;
}

extern "C" const char* cg_error_string(int rc) {
  if (rc == kBadDtype) return "unsupported dtype";
  if (rc == kBadVariant) return "the variant does not take these operands";
  return cudaGetErrorString((cudaError_t)rc);
}
