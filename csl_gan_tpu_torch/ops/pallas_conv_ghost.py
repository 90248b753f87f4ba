"""Conv ghost-clipping kernels: per-sample kernel-grad norms (K2) and the
clip-weighted kernel-grad sum (K3).

The port's counterpart of the JAX package's ops/pallas_conv_ghost.py. For a
conv layer with input a [B, H, W, Cin] (NHWC) and output cotangent
c [B, Ho, Wo, O]:

    ghost_sq_norms:       ||g_W(i)||^2 = < U_i U_i^T, C_i C_i^T >      [B] fp32
    weighted_kernel_grad: sum_i w_i U_i^T C_i            [kh, kw, Cin, O] fp32

with U_i the im2col patches of sample i. The clip factors scale the cotangent
at the input dtype (rounded to bf16 under bf16 compute) before the product,
as the TPU kernel does. CUDA tensors launch the hand-written kernels of
``csrc/conv_ghost.cu``, which never form the patch tensor; CPU tensors take
the plain versions (``F.unfold`` + products). The output layout is the JAX
kernel's [kh, kw, Cin, O]; convert.py maps it as it maps a conv kernel.

Each kernel has two hand-written variants, and ``kernel_variant`` chooses
between them by the operands' type and geometry: "tc" (wgmma on the tensor
cores) for bf16 operands whose Cin and O are multiples of 8, "ffma" (fp32
FFMA on the CUDA cores) for fp32 operands and every other geometry. This is a
dispatch between two kernels, not a fallback: a variant that fails to build
or to launch raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = {"ffma": 0, "tc": 1}


def kernel_variant(dtype: torch.dtype, geo) -> str:
    """Which variant of K2 / K3 takes operands of ``dtype`` at
    geo = [B, H, W, Cin, Ho, Wo, O, ...]. "tc": bf16 with Cin and O multiples
    of 8 (8 channels are one aligned 16-byte line) and fewer than 2^31
    elements an operand (32-bit offsets); "ffma": everything else."""
    b, h, w, cin, ho, wo, o = geo[:7]
    if (dtype == torch.bfloat16 and cin % 8 == 0 and o % 8 == 0
            and b * h * w * cin < 2 ** 31 and b * ho * wo * o < 2 ** 31):
        return "tc"
    return "ffma"


def _out_hw(h: int, k: int, stride: int, pad: int) -> int:
    return (h + 2 * pad - k) // stride + 1


def patches(a: torch.Tensor, kh: int, kw: int, stride: int, pad: int) -> torch.Tensor:
    """im2col of NHWC a: [B, S, K] fp32, K ordered (dh, dw, ci) (the row order
    of the kernel gradient [kh, kw, Cin, O])."""
    b, _, _, cin = a.shape
    u = F.unfold(a.permute(0, 3, 1, 2).float(), (kh, kw), padding=pad, stride=stride)
    s = u.shape[-1]                      # [B, Cin * kh * kw, S], (ci, dh, dw)
    return u.view(b, cin, kh * kw, s).permute(0, 3, 2, 1).reshape(b, s, kh * kw * cin)


def ghost_sq_norms_plain(a, c, kh: int, kw: int, stride: int, pad: int) -> torch.Tensor:
    """Plain version of K2: Gram matrices of the patches and the cotangents in
    fp32 (exact products of bf16 values), then their Frobenius product."""
    b, o = a.shape[0], c.shape[-1]
    u = patches(a, kh, kw, stride, pad)
    c3 = c.reshape(b, -1, o).float()
    gu = torch.bmm(u, u.transpose(1, 2))
    gc = torch.bmm(c3, c3.transpose(1, 2))
    return (gu * gc).sum(dim=(1, 2))


def weighted_kernel_grad_plain(a, c, w, kernel_shape, stride: int, pad: int) -> torch.Tensor:
    """Plain version of K3: sum_i w_i U_i^T C_i, the cotangent scaled by w and
    rounded to its own dtype first; fp32 products and output."""
    kh, kw, cin, cout = kernel_shape
    b = a.shape[0]
    cw = (c.float() * w.float()[:, None, None, None]).to(c.dtype).float()
    u = patches(a, kh, kw, stride, pad)
    g = torch.einsum("bsk,bso->ko", u, cw.reshape(b, -1, cout))
    return g.reshape(kh, kw, cin, cout)


# ---------------- CUDA (K2 / K3) ----------------

def _geo(a, c, kh, kw, stride, pad):
    if a.dim() != 4 or c.dim() != 4:
        raise ValueError(f"conv ghost kernels take NHWC a and c, got "
                         f"{tuple(a.shape)} and {tuple(c.shape)}")
    b, h, w, cin = a.shape
    ho, wo = _out_hw(h, kh, stride, pad), _out_hw(w, kw, stride, pad)
    if tuple(c.shape[:3]) != (b, ho, wo):
        raise ValueError(f"cotangent shape {tuple(c.shape)} does not match the "
                         f"conv of {tuple(a.shape)} (k {kh}x{kw}, stride "
                         f"{stride}, pad {pad})")
    for name, t in (("a", a), ("c", c)):
        if t.device != a.device or t.dtype != a.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"{name}: expected {a.device} fp32 or bf16 like a, "
                             f"got {t.device} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return [b, h, w, cin, ho, wo, c.shape[3], kh, kw, stride, pad]


def _dispatch(a, name):
    if a.device.type == "cpu":
        return False
    if a.device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {a.device}")
    return True


def _variant(a, geo, variant) -> str:
    chosen = kernel_variant(a.dtype, geo)
    if variant is None:
        return chosen
    if variant not in VARIANTS or (variant == "tc" and chosen != "tc"):
        raise ValueError(f"variant {variant!r} does not take {a.dtype} operands at "
                         f"geometry {list(geo)}")
    return variant


def _scratch(lib, name: str, geo, variant: str, device) -> torch.Tensor:
    """The fp32 scratch that the kernel's launcher asks for at this geometry
    and variant (the launcher chooses its own tiling)."""
    n = getattr(lib, f"{name}_scratch")(geo, VARIANTS[variant])
    return torch.empty(max(n, 1), dtype=torch.float32, device=device)


def ghost_sq_norms(a: torch.Tensor, c: torch.Tensor, kh: int, kw: int,
                   stride: int, pad: int, variant: str | None = None) -> torch.Tensor:
    """Per-sample squared kernel-grad norms [B] fp32: K2 for CUDA tensors,
    the plain version for CPU tensors. K2's variant is ``kernel_variant``'s
    unless ``variant`` names one ("ffma" takes everything). Adds one to
    ``ghost_sq_norms.launches`` per K2 launch, and to ``.launches_tc`` when
    it was the tensor-core variant."""
    if not _dispatch(a, "ghost_sq_norms"):
        return ghost_sq_norms_plain(a, c, kh, kw, stride, pad)
    from csl_gan_tpu_torch.ops import _build

    geo = _geo(a, c, kh, kw, stride, pad)
    variant = _variant(a, geo, variant)
    geo = (ctypes.c_int * 11)(*geo)
    out = torch.empty(a.shape[0], dtype=torch.float32, device=a.device)
    lib = _build.load("conv_ghost")
    partial = _scratch(lib, "ghost_sq_norms", geo, variant, a.device)
    rc = lib.ghost_sq_norms(a.data_ptr(), c.data_ptr(), geo, _DTYPES[a.dtype],
                            VARIANTS[variant], partial.data_ptr(), out.data_ptr(),
                            torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ghost_sq_norms failed: {lib.cg_error_string(rc).decode()}")
    ghost_sq_norms.launches += 1
    ghost_sq_norms.launches_tc += variant == "tc"
    return out


def weighted_kernel_grad(a: torch.Tensor, c: torch.Tensor, w: torch.Tensor,
                         kernel_shape, stride: int, pad: int,
                         variant: str | None = None) -> torch.Tensor:
    """sum_i w_i U_i^T C_i as [kh, kw, Cin, O] fp32: K3 for CUDA tensors, the
    plain version for CPU tensors. K3's variant is ``kernel_variant``'s
    unless ``variant`` names one ("ffma" takes everything). Adds one to
    ``weighted_kernel_grad.launches`` per K3 launch, and to ``.launches_tc``
    when it was the tensor-core variant."""
    if not _dispatch(a, "weighted_kernel_grad"):
        return weighted_kernel_grad_plain(a, c, w, kernel_shape, stride, pad)
    from csl_gan_tpu_torch.ops import _build

    kh, kw, cin, cout = kernel_shape
    geo = _geo(a, c, kh, kw, stride, pad)
    if (geo[3], geo[6]) != (cin, cout):
        raise ValueError(f"kernel shape {tuple(kernel_shape)} does not match "
                         f"a {tuple(a.shape)} / c {tuple(c.shape)}")
    b = geo[0]
    if w.device != a.device or w.dtype != torch.float32 or tuple(w.shape) != (b,) \
            or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous fp32 [{b}] tensor on {a.device}")
    variant = _variant(a, geo, variant)
    geo = (ctypes.c_int * 11)(*geo)
    out = torch.empty(kernel_shape, dtype=torch.float32, device=a.device)
    lib = _build.load("conv_ghost")
    scratch = _scratch(lib, "weighted_kernel_grad", geo, variant, a.device)
    rc = lib.weighted_kernel_grad(a.data_ptr(), c.data_ptr(), w.data_ptr(), geo,
                                  _DTYPES[a.dtype], VARIANTS[variant], scratch.data_ptr(),
                                  out.data_ptr(),
                                  torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"weighted_kernel_grad failed: {lib.cg_error_string(rc).decode()}")
    weighted_kernel_grad.launches += 1
    weighted_kernel_grad.launches_tc += variant == "tc"
    return out


ghost_sq_norms.launches = ghost_sq_norms.launches_tc = 0
weighted_kernel_grad.launches = weighted_kernel_grad.launches_tc = 0
