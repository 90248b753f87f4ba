// Fused clip-weighted per-sample-gradient sums + Gaussian DP noise for Hopper
// (sm_90a): K6, one launch over every large leaf of a D step.
//
// Replaces the JAX package's Pallas kernel in csl_gan_tpu/ops/pallas_clip.py:
//   K6  _kernel (:61, via weighted_sum_noise_2d :76 / leaf_weighted_sum_noise :111)
//
//   out_l[p] = sum_b w_l[b] * g_l[b, p] + std[s_l] * N(0, 1)(seed[s_l], base_l + p)
//
// for each leaf l of a group: g_l [B, P_l] fp32 row-major is one leaf of the
// materialized per-sample gradients (every leaf of a group has the same B),
// w_l [B] its clip factors, s_l its slot in the step's seeds [n] int64 and
// stds [n] fp32 (std = sigma * C), base_l the counter of its element 0. The
// sum is the DP signal: fp32 FFMA in a fixed order (the counterpart of the
// TPU kernel's Precision.HIGHEST product; no TF32, no bf16).
//
// Bound: bytes. The group must read each g_l once and write each out_l once,
// 4 (B P + B + P) bytes a leaf (243.9 MB at B 600, P 101,632: 0.073 ms at
// 3.35 TB/s), with two operations per element read: about 0.5 operations a
// byte, where the tensor cores pay off only above ~295 (bf16) and the CUDA
// cores' fp32 rate above ~20. So the tensor cores do not help: this is a
// batched GEMV, and the design only keeps bytes moving:
//   - one launch per group. The leaf table (pointers, P, base, slot, the
//     first tile, the load width) is passed by value as a __grid_constant__
//     struct: no host-to-device copy, no scratch, no second launch. The work
//     items are (leaf, column tile) pairs, flattened by a prefix sum over the
//     leaves' tile counts that pallas_clip.group_plan computes once a shape;
//   - where the tiles are too few to fill the card, a tile's B rows are cut
//     across a thread-block cluster of up to 8 CTAs (rows per CTA from the
//     plan; a long-lived CTA streams best, so the cluster is the smallest
//     that fills the card). Each CTA streams its rows in ascending
//     order into a per-thread sum and keeps the tile's partial sums in shared
//     memory; after a cluster barrier, CTA r sums the r-th slice of the
//     tile's columns over the cluster's CTAs in ascending rank through
//     distributed shared memory, adds the noise and stores. The order is fixed
//     and there are no atomics: the result is bitwise reproducible, and no
//     partial sum goes through device memory;
//   - consecutive threads take consecutive columns, four each as one 16-byte
//     load where P % 4 == 0 and g and out are 16-byte aligned, else four
//     columns a tile-quarter apart with guarded scalar loads; no padding of P
//     and no copy of g;
//   - the loads stay in flight in registers: each thread issues sixteen rows
//     of loads before it sums them. A ring of shared-memory stages filled by
//     cp.async.bulk on mbarriers was measured no faster on an H100 at path
//     1's leaf and path 2's largest (PERF.md), so it is not kept.
//
// Noise. The TPU kernel seeds a per-core generator per tile; here the bits
// come from Philox4x32-10 (Salmon et al., Random123), written out below, keyed
// by the 64-bit seed with the element's counter base + p, so the stream does
// not depend on the launch geometry and can be rebuilt with integer tensor
// operations (ops/pallas_clip.py philox4x32_10). Words 0 and 1 of the block
// become one normal by the TPU kernel's Box-Muller (_normal_from_bits,
// :44-58): 24-bit uniforms u1 = (b1 >> 8) 2^-24 + 2^-25, u2 = (b2 >> 8) 2^-24,
// z = sqrt(-2 log u1) cos(2 pi u2), with logf / cosf / sqrtf (built without
// fast math). seeds and stds are read from device memory, so a step draws its
// seeds on the device and never waits for the host. std = 0 still runs the
// generator and adds 0 * z, as the TPU kernel does.
//
// A launch the card refuses (an unsupported cluster, too much shared memory)
// returns its CUDA error; there is no fallback.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace coop = cooperative_groups;

namespace {

constexpr int kMaxLeaves = 16;
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kMaxTile = 1024;      // columns of a tile: four a thread
constexpr int kUnroll = 16;         // row loads in flight per thread
constexpr int kDescWords = 8;       // int64 words a leaf in the host's table

enum { kErrLeaf = 1000, kErrPlan = 1001, kErrAlign = 1002, kErrCount = 1003 };

struct Leaf {
  const float* g;
  const float* w;
  float* out;
  long long P;
  long long base;
  int slot;    // index into seeds / stds
  int tile0;   // first work item of the leaf
  int vec;     // 4: 16-byte loads; 1: guarded scalar loads
  int pad;
};

struct Table {
  Leaf leaf[kMaxLeaves];
  const long long* seeds;
  const float* stds;
  int n, B, rows, tile;
};

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

// The work item of this CTA: its leaf, the tile's first column and width,
// and the CTA's rows [r0, r1) of the tile.
struct Item {
  int l;
  long long col0;
  int width, r0, r1;
};

__device__ __forceinline__ Item item_of(const Table& t, const coop::cluster_group& cluster) {
  Item it;
  const int item = (int)(blockIdx.x / cluster.num_blocks());
  it.l = 0;
  while (it.l + 1 < t.n && t.leaf[it.l + 1].tile0 <= item) ++it.l;
  it.col0 = (long long)(item - t.leaf[it.l].tile0) * t.tile;
  it.width = (int)min((long long)t.tile, t.leaf[it.l].P - it.col0);
  it.r0 = (int)cluster.block_rank() * t.rows;
  it.r1 = min(t.B, it.r0 + t.rows);
  return it;
}

// Thread j (of tile / 4) sums rows [r0, r1) of its four
// columns into acc, sixteen rows of loads in flight, rows in ascending order.
// 16-byte leaves: columns 4j .. 4j + 3 of the tile; others: j + k tile / 4.
__device__ __forceinline__ void stream_registers(const Leaf& L, const Item& it, int j,
                                                 int quarter, float acc[4]) {
  const float* __restrict__ w = L.w;
  const long long P = L.P;
  if (L.vec == 4) {
    if (4 * j >= it.width) return;
    const float* col = L.g + it.col0 + 4 * j;
    int b = it.r0;
    for (; b + kUnroll <= it.r1; b += kUnroll) {
      float4 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        x[u] = __ldg(reinterpret_cast<const float4*>(col + (size_t)(b + u) * P));
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float wb = __ldg(w + b + u);
        acc[0] = fmaf(wb, x[u].x, acc[0]);
        acc[1] = fmaf(wb, x[u].y, acc[1]);
        acc[2] = fmaf(wb, x[u].z, acc[2]);
        acc[3] = fmaf(wb, x[u].w, acc[3]);
      }
    }
    for (; b < it.r1; ++b) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(col + (size_t)b * P));
      const float wb = __ldg(w + b);
      acc[0] = fmaf(wb, x.x, acc[0]);
      acc[1] = fmaf(wb, x.y, acc[1]);
      acc[2] = fmaf(wb, x.z, acc[2]);
      acc[3] = fmaf(wb, x.w, acc[3]);
    }
  } else {
    bool in[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) in[k] = j + k * quarter < it.width;
    const float* col = L.g + it.col0 + j;
    int b = it.r0;
    for (; b + kUnroll <= it.r1; b += kUnroll) {
      float x[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          x[u][k] = in[k] ? __ldg(col + (size_t)(b + u) * P + k * quarter) : 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float wb = __ldg(w + b + u);
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = fmaf(wb, x[u][k], acc[k]);
      }
    }
    for (; b < it.r1; ++b) {
      const float wb = __ldg(w + b);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (in[k]) acc[k] = fmaf(wb, __ldg(col + (size_t)b * P + k * quarter), acc[k]);
    }
  }
}

// Thread j's four sums into the tile's partial sums part [tile], at the
// columns stream_registers gave it.
__device__ __forceinline__ void publish(const Leaf& L, int j, int quarter, const float acc[4],
                                        float* part) {
  if (L.vec == 4) {
    *reinterpret_cast<float4*>(part + 4 * j) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) part[j + k * quarter] = acc[k];
  }
}

// After every CTA of the cluster has published its partial sums: CTA r sums
// columns [r tile / n, (r + 1) tile / n) of the tile over the n CTAs in
// ascending rank (ascending rows), adds the noise and stores. Ends on a
// cluster barrier, so no CTA exits while its shared memory is read.
__device__ __forceinline__ void reduce_noise_store(const Table& t, const Item& it,
                                                   const coop::cluster_group& cluster,
                                                   float* part) {
  cluster.sync();
  const Leaf& L = t.leaf[it.l];
  const int n = (int)cluster.num_blocks(), r = (int)cluster.block_rank();
  const int j0 = r * t.tile / n, j1 = min(it.width, (r + 1) * t.tile / n);
  const unsigned long long key = (unsigned long long)__ldg(t.seeds + L.slot);
  const float sd = __ldg(t.stds + L.slot);
  for (int j = j0 + (int)threadIdx.x; j < j1; j += (int)blockDim.x) {
    float acc = cluster.map_shared_rank(part, 0)[j];
    for (int k = 1; k < n; ++k) acc += cluster.map_shared_rank(part, k)[j];
    const unsigned long long q = (unsigned long long)(L.base + it.col0 + j);
    uint32_t c[4] = {(uint32_t)q, (uint32_t)(q >> 32), 0u, 0u};
    philox4x32_10(c, (uint32_t)key, (uint32_t)(key >> 32));
    const float z = normal_from_bits(c[0], c[1]);
    // Rounded product, then the sum: the plain version's two steps.
    L.out[it.col0 + j] = __fadd_rn(acc, __fmul_rn(sd, z));
  }
  cluster.sync();
}

// tile / 4 threads a CTA.
__global__ void __launch_bounds__(kMaxTile / 4, 2)
k6_registers(const __grid_constant__ Table t) {
  __shared__ __align__(16) float part[kMaxTile];
  const coop::cluster_group cluster = coop::this_cluster();
  const Item it = item_of(t, cluster);
  const Leaf& L = t.leaf[it.l];
  const int j = (int)threadIdx.x, quarter = t.tile / 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  stream_registers(L, it, j, quarter, acc);
  publish(L, j, quarter, acc, part);
  reduce_noise_store(t, it, cluster, part);
}

}  // namespace

// One launch over n leaves. desc [n * 8] int64 per leaf: g, w, out (device
// pointers), P, base, slot, first work item, load width (4 or 1); the plan
// (tile, cluster, rows) from pallas_clip.group_plan; seeds [*] int64 and
// stds [*] fp32 in device memory. Returns 0 or an error code for cn_error_string.
extern "C" int clip_noise_leaves(const long long* desc, int n, int B, int tile, int cluster,
                                 int rows, const long long* seeds, const float* stds,
                                 void* stream) {
  if (n < 1 || n > kMaxLeaves) return kErrCount;
  if (B < 1 || rows < 1 || cluster < 1 || cluster > kMaxCluster || cluster > B ||
      (long long)rows * cluster < B || (long long)rows * (cluster - 1) >= B ||
      (tile != 256 && tile != 512 && tile != kMaxTile))
    return kErrPlan;
  Table t = {};
  t.seeds = seeds;
  t.stds = stds;
  t.n = n;
  t.B = B;
  t.rows = rows;
  t.tile = tile;
  long long items = 0;
  for (int l = 0; l < n; ++l) {
    const long long* d = desc + (size_t)l * kDescWords;
    Leaf& L = t.leaf[l];
    L.g = reinterpret_cast<const float*>(d[0]);
    L.w = reinterpret_cast<const float*>(d[1]);
    L.out = reinterpret_cast<float*>(d[2]);
    L.P = d[3];
    L.base = d[4];
    L.slot = (int)d[5];
    L.tile0 = (int)d[6];
    L.vec = (int)d[7];
    if (L.P < 1 || L.base < 0 || d[5] < 0) return kErrLeaf;
    if (d[6] != items || (L.vec != 4 && L.vec != 1)) return kErrPlan;
    if (L.vec == 4 && (L.P % 4 != 0 || (d[0] & 15) != 0 || (d[2] & 15) != 0)) return kErrAlign;
    items += (L.P + tile - 1) / tile;
  }
  if (items * cluster > 0x7FFFFFFFLL) return kErrPlan;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(items * cluster));
  cfg.blockDim = dim3((unsigned)(tile / 4));
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, k6_registers, t);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" const char* cn_error_string(int rc) {
  switch (rc) {
    case kErrLeaf: return "an empty leaf, a negative counter base or a negative slot";
    case kErrPlan: return "a launch plan that does not fit the group";
    case kErrAlign: return "a 16-byte leaf whose P, g or out is not 16-byte aligned";
    case kErrCount: return "no leaf, or more leaves than one launch takes (16)";
    default: return cudaGetErrorString((cudaError_t)rc);
  }
}
