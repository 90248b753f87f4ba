"""Fused GroupNorm + ReLU (K4 forward, K5 backward).

The port's counterpart of the JAX package's ops/pallas_groupnorm.py, used by
every norm layer of the DCResNet generator under per-sample-grad mode
(models/dcresnet.py). ``group_norm_relu`` is a ``torch.autograd.Function``
whose forward is K4 and whose backward is K5, the hand-written CUDA kernels of
``csrc/gn_relu.cu``, for CUDA tensors; CPU tensors take the plain versions
``gn_relu_plain`` / ``gn_relu_bwd_plain`` beside them. Anything else raises.

Numerics follow the JAX package's default formulation ``_gn_relu_xla``:
per-(sample, group) statistics in fp32 (var = E[x^2] - mean^2), the affine
a = rstd * gamma, d = beta - (mean * rstd) * gamma, the ReLU mask from the
fp32 affine x * a + d (not from a bf16-rounded value), and the output in x's
dtype. The backward recomputes the statistics from x.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _stats(xf: torch.Tensor, groups: int, eps: float):
    """Per-channel (mean, rstd) of their group, [B, C], from fp32 x [B, HW, C]."""
    b, hw, c = xf.shape
    n = hw * (c // groups)
    s = xf.sum(dim=1).view(b, groups, -1).sum(dim=2)
    ss = (xf * xf).sum(dim=1).view(b, groups, -1).sum(dim=2)
    mean = s / n
    var = torch.clamp(ss / n - mean * mean, min=0.0)
    rstd = 1.0 / torch.sqrt(var + eps)
    rep = c // groups
    return mean.repeat_interleave(rep, dim=1), rstd.repeat_interleave(rep, dim=1)


def _affine(xf, scale, bias, groups, eps):
    mean, rstd = _stats(xf, groups, eps)
    a = rstd * scale
    d = bias - (mean * rstd) * scale
    return mean, rstd, a, d


def gn_relu_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """relu(GroupNorm(x) * scale + bias) over x [B, HW, C], output in x.dtype."""
    xf = x.float()
    _, _, a, d = _affine(xf, scale, bias, groups, eps)
    z = xf * a[:, None, :] + d[:, None, :]
    return torch.where(z > 0, z, torch.zeros_like(z)).to(x.dtype)


def gn_relu_bwd_plain(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, groups: int = 32, eps: float = 1e-5):
    """(dx in x.dtype, dgamma fp32, dbeta fp32) of gn_relu_plain."""
    xf = x.float()
    b, hw, c = xf.shape
    mean, rstd, a, d = _affine(xf, scale, bias, groups, eps)
    z = xf * a[:, None, :] + d[:, None, :]
    dz = torch.where(z > 0, dy.float(), torch.zeros_like(z))
    xhat = (xf - mean[:, None, :]) * rstd[:, None, :]
    dgamma = (dz * xhat).sum(dim=(0, 1))
    dbeta = dz.sum(dim=(0, 1))
    n = hw * (c // groups)
    rep = c // groups
    dxh = dz * scale

    def grp_mean(t):                     # [B, HW, C] -> [B, 1, C]
        g = t.sum(dim=1).view(b, groups, -1).sum(dim=2) / n
        return g.repeat_interleave(rep, dim=1)[:, None, :]

    dx = rstd[:, None, :] * (dxh - grp_mean(dxh) - xhat * grp_mean(dxh * xhat))
    return dx.to(x.dtype), dgamma, dbeta


# ---------------- CUDA (K4 / K5) ----------------

def _scratch(lib, x3: torch.Tensor, groups: int, backward: bool):
    """(geometry, fp32 scratch) of one launch; the launcher chooses its own
    row chunks and says what scratch they need."""
    b, hw, c = x3.shape
    geo = (ctypes.c_int * 4)(b, hw, c, groups)
    n = lib.gn_relu_scratch(geo, int(backward))
    if n < 0:
        raise ValueError(f"gn_relu kernels take C in 32..256 dividing 256 or a "
                         f"multiple of 256 up to 1024, divisible by groups; "
                         f"got x {tuple(x3.shape)}, groups={groups}")
    return geo, torch.empty(n, dtype=torch.float32, device=x3.device)


def _check_cuda(name, t, dev, dtype=None, shape=None):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_inputs(x3, scale, bias):
    if x3.dim() != 3 or x3.dtype not in _DTYPES:
        raise ValueError(f"gn_relu takes x [B, HW, C] in fp32 or bf16, got "
                         f"{tuple(x3.shape)} {x3.dtype}")
    c = x3.shape[2]
    _check_cuda("x", x3, x3.device)
    _check_cuda("scale", scale, x3.device, torch.float32, (c,))
    _check_cuda("bias", bias, x3.device, torch.float32, (c,))


def _raise(lib, rc, what):
    raise RuntimeError(f"{what} failed: {lib.gn_error_string(rc).decode()}")


def gn_relu_forward(x3: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    groups: int, eps: float) -> torch.Tensor:
    """K4 for CUDA tensors, gn_relu_plain for CPU tensors. Adds one to
    ``gn_relu_forward.launches`` per K4 launch."""
    if x3.device.type == "cpu":
        return gn_relu_plain(x3, scale, bias, groups, eps)
    if x3.device.type != "cuda":
        raise ValueError(f"gn_relu takes CPU or CUDA tensors, got {x3.device}")
    from csl_gan_tpu_torch.ops import _build

    _check_inputs(x3, scale, bias)
    lib = _build.load("gn_relu")
    geo, scratch = _scratch(lib, x3, groups, backward=False)
    y = torch.empty_like(x3)
    rc = lib.gn_relu_fwd(x3.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                         y.data_ptr(), scratch.data_ptr(), geo,
                         _DTYPES[x3.dtype], float(eps),
                         torch.cuda.current_stream(x3.device).cuda_stream)
    if rc != 0:
        _raise(lib, rc, "gn_relu_fwd")
    gn_relu_forward.launches += 1
    return y


def gn_relu_backward(x3: torch.Tensor, dy3: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, groups: int, eps: float):
    """K5 for CUDA tensors, gn_relu_bwd_plain for CPU tensors: (dx, dgamma,
    dbeta). Adds one to ``gn_relu_backward.launches`` per K5 launch."""
    if x3.device.type == "cpu":
        return gn_relu_bwd_plain(x3, dy3, scale, bias, groups, eps)
    if x3.device.type != "cuda":
        raise ValueError(f"gn_relu takes CPU or CUDA tensors, got {x3.device}")
    from csl_gan_tpu_torch.ops import _build

    _check_inputs(x3, scale, bias)
    _check_cuda("dy", dy3, x3.device, x3.dtype, x3.shape)
    lib = _build.load("gn_relu")
    geo, scratch = _scratch(lib, x3, groups, backward=True)
    c = x3.shape[2]
    dx = torch.empty_like(x3)
    dgamma = torch.empty(c, dtype=torch.float32, device=x3.device)
    dbeta = torch.empty(c, dtype=torch.float32, device=x3.device)
    rc = lib.gn_relu_bwd(x3.data_ptr(), dy3.data_ptr(), scale.data_ptr(),
                         bias.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
                         dbeta.data_ptr(), scratch.data_ptr(), geo,
                         _DTYPES[x3.dtype], float(eps),
                         torch.cuda.current_stream(x3.device).cuda_stream)
    if rc != 0:
        _raise(lib, rc, "gn_relu_bwd")
    gn_relu_backward.launches += 1
    return dx, dgamma, dbeta


gn_relu_forward.launches = 0
gn_relu_backward.launches = 0


class GroupNormReLU(torch.autograd.Function):
    """relu(GroupNorm(x)) on [B, HW, C]: K4 forward, K5 backward."""

    @staticmethod
    def forward(ctx, x3, scale, bias, groups, eps):
        ctx.save_for_backward(x3, scale, bias)
        ctx.groups, ctx.eps = groups, eps
        return gn_relu_forward(x3, scale, bias, groups, eps)

    @staticmethod
    def backward(ctx, dy3):
        x3, scale, bias = ctx.saved_tensors
        dx, dg, db = gn_relu_backward(x3, dy3.contiguous(), scale, bias,
                                      ctx.groups, ctx.eps)
        return dx, dg, db, None, None


def group_norm_relu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """relu(GroupNorm_groups(x) * scale + bias) over the last (channel) axis of
    x [B, ..., C] (NHWC); statistics in fp32, output in x.dtype."""
    c = x.shape[-1]
    if c % groups:
        raise ValueError(f"channels {c} not divisible by {groups} groups")
    x3 = x.reshape(x.shape[0], -1, c)
    if not x3.is_contiguous():
        x3 = x3.contiguous()
    return GroupNormReLU.apply(x3, scale, bias, groups, eps).view(x.shape)
