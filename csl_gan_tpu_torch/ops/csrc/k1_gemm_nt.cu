// K1's tiled products in one form, NT (A row-major, B transposed) on fp32 operands: the forward products:
// one translation unit of the K1 library (k1_epoch.cuh says why).

#include "k1_gemm.cuh"

template int k1::gemm<false, true, float, float>(
    const k1::Ctx&, int, int, int, const float*, int, const float*, int, const float*,
    float*, int, const k1::Epi&);
