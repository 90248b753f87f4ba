// K1's tiled products in one form, TN with the bf16 table rows as B: the weighted sums over the real rows:
// one translation unit of the K1 library (k1_epoch.cuh says why).

#include "k1_gemm.cuh"

template int k1::gemm<true, false, float, __nv_bfloat16>(
    const k1::Ctx&, int, int, int, const float*, int, const __nv_bfloat16*, int, const float*,
    float*, int, const k1::Epi&);
