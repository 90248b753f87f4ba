// K1's tiled products in one form, NN on fp32 operands: G's backward products:
// one translation unit of the K1 library (k1_epoch.cuh says why).

#include "k1_gemm.cuh"

template int k1::gemm<false, false, float, float>(
    const k1::Ctx&, int, int, int, const float*, int, const float*, int, const float*,
    float*, int, const k1::Epi&);
