// K1's tiled products in one form, NT with the bf16 table rows as A: D's hidden layer on the real rows:
// one translation unit of the K1 library (k1_epoch.cuh says why).

#include "k1_gemm.cuh"

template int k1::gemm<false, true, __nv_bfloat16, float>(
    const k1::Ctx&, int, int, int, const __nv_bfloat16*, int, const float*, int, const float*,
    float*, int, const k1::Epi&);
