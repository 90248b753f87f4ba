// K1's tiled products in one form, TN (A transposed) on fp32 operands: the weighted sums:
// one translation unit of the K1 library (k1_epoch.cuh says why).

#include "k1_gemm.cuh"

template int k1::gemm<true, false, float, float>(
    const k1::Ctx&, int, int, int, const float*, int, const float*, int, const float*,
    float*, int, const k1::Epi&);
