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

Each launch follows a plan that ``launch_plan`` computes from the geometry
alone: the one-pass variant (a thread-block cluster holds a sample in shared
memory and reads x, and dy, once) or, for a sample too large for 16 CTAs, the
two-pass variant; the kernels check the plan and refuse one that does not fit.
"""

from __future__ import annotations

import ctypes
import functools

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

ONE_PASS, TWO_PASS = 1, 2
MAX_SMEM = 232448            # dynamic shared memory a CTA may use (H100)
SLICE_BYTES = 128 * 1024     # a one-pass CTA's share of a sample
LARGE_SAMPLE = 256 * 1024    # above it, slices of half as much
MAX_CLUSTER = 16             # 9..16 need the non-portable cluster attribute
MAX_THREADS = 256
PIECES = 4                   # bulk-copy pieces of a one-pass slice
TWO_PASS_ELEMS = 16384       # elements of one chunk of the two-pass variant


def _align(v: int) -> int:
    return (v + 127) // 128 * 128


def red_bytes(c: int, esize: int, threads: int) -> int:
    """The lane-sum scratch of a CTA (csrc/gn_relu.cu Lay): two quantities by
    one row a warp (one row a lane where a channel vector spans warps)."""
    vr = c // (16 // esize)
    return _align(2 * (threads // max(vr, 32)) * c * 4)


def one_pass_smem(rows: int, c: int, groups: int, esize: int, threads: int,
                  backward: bool) -> int:
    """Dynamic shared memory of a one-pass CTA (csrc/gn_relu.cu OnePassSmem):
    the row slice of x (and dy), the lane-sum scratch, the exchanged sums,
    the group statistics and the mbarriers, each 128-byte aligned."""
    slice_ = _align(rows * c * esize)
    return (slice_ * (2 if backward else 1) + red_bytes(c, esize, threads)
            + _align((4 if backward else 2) * c * 4) + _align(4 * groups * 4)
            + _align(PIECES * 8))


def launch_plan(b: int, hw: int, c: int, groups: int, dtype: torch.dtype,
                backward: bool):
    """(variant, cluster n, rows per CTA, threads, dynamic shared memory) of
    one K4 (backward=False) or K5 launch, from the geometry alone.

    One pass: a cluster of n CTAs holds one sample, each CTA its rows of x
    (and dy) in shared memory. n is the smallest power of two (at most 16,
    at most HW) that cuts the sample's x and dy into slices of SLICE_BYTES,
    256 threads a CTA; x and dy of more than LARGE_SAMPLE bytes a sample are
    cut into slices of half that, 128 threads a CTA, so that three or four
    CTAs share an SM. (On an H100 a cluster costs more the larger it is, and
    small slices pay in waves: ``python3 chip_smoke.py --gn-plans`` times
    every n = 1..16 at 128 and 256 threads at the G's norms.) A slice that
    does not fit a CTA even at n = 16: the two-pass variant, chunks of
    TWO_PASS_ELEMS elements streamed from device memory.

    The forward takes the backward's cut (variant, n, rows, threads) and
    only its own shared memory: the statistics' sums then run in the same
    order in K4 and K5, so K5's ReLU mask is the one K4 applied."""
    if b < 1 or hw < 1:
        raise ValueError(f"gn_relu kernels need B, HW >= 1, got [{b}, {hw}, {c}]")
    if not (((8 <= c <= 256 and 256 % c == 0) or (256 < c <= 1024 and c % 256 == 0))
            and groups >= 1 and c % groups == 0):
        raise ValueError(f"gn_relu kernels take C from 8 to 256 dividing 256 or a "
                         f"multiple of 256 up to 1024, divisible by groups; got "
                         f"[{b}, {hw}, {c}], groups={groups}")
    if dtype not in _DTYPES:
        raise ValueError(f"gn_relu kernels take fp32 or bf16, got {dtype}")
    esize = 2 if dtype == torch.bfloat16 else 4
    vr = c // (16 // esize)
    sample = hw * c * esize * 2                      # x and dy: the backward's
    large = sample > LARGE_SAMPLE
    target = SLICE_BYTES // 2 if large else SLICE_BYTES
    threads = vr * max(1, (MAX_THREADS // 2 if large else MAX_THREADS) // vr)
    n = 1
    while n < MAX_CLUSTER and n < hw and sample > target * n:
        n *= 2
    rows = -(-hw // n)
    n = -(-hw // rows)                               # no CTA without rows
    if one_pass_smem(rows, c, groups, esize, threads, True) <= MAX_SMEM:
        return (ONE_PASS, n, rows, threads,
                one_pass_smem(rows, c, groups, esize, threads, backward))
    threads = vr * max(1, MAX_THREADS // vr)
    rows = max(1, min(hw, TWO_PASS_ELEMS // c))
    return (TWO_PASS, 1, rows, threads, red_bytes(c, esize, threads))


@functools.lru_cache(maxsize=None)
def _launch_args(shape, dtype, groups: int, backward: bool):
    """(geometry, plan as C arrays, fp32 scratch floats) of one K4 / K5 launch
    at x's shape. The plan raises on a geometry outside the kernels' rules
    before any build; the kernels' own check (gn_relu_scratch) runs once per
    geometry."""
    from csl_gan_tpu_torch.ops import _build

    plan = launch_plan(*shape, groups, dtype, backward)
    geo = (ctypes.c_int * 4)(*shape, groups)
    pl = (ctypes.c_int * 5)(*plan)
    n = _build.load("gn_relu").gn_relu_scratch(geo, pl, _DTYPES[dtype], int(backward))
    if n < 0:
        raise ValueError(f"gn_relu kernels refused the plan {plan} for x {shape}, "
                         f"groups={groups}")
    return geo, pl, max(n, 1)


def _args(x3: torch.Tensor, groups: int, backward: bool):
    """(library, geometry, plan, fp32 scratch) of a launch on CUDA tensor x3."""
    from csl_gan_tpu_torch.ops import _build

    geo, pl, n = _launch_args(tuple(x3.shape), x3.dtype, groups, backward)
    return (_build.load("gn_relu"), geo, pl,
            torch.empty(n, dtype=torch.float32, device=x3.device))


def occupancy(x3: torch.Tensor, groups: int, backward: bool):
    """(plan, resident count) of the K4 / K5 launch on CUDA tensor x3: how many
    clusters of a one-pass plan the card can hold at once
    (cudaOccupancyMaxActiveClusters), or CTAs per SM of the two-pass
    element-wise kernel. Printed by chip_smoke.py; a 0 would mean the plan
    cannot be scheduled."""
    from csl_gan_tpu_torch.ops import _build

    geo, pl, _ = _launch_args(tuple(x3.shape), x3.dtype, groups, backward)
    return tuple(pl), _build.load("gn_relu").gn_relu_occupancy(geo, pl, _DTYPES[x3.dtype],
                                                               int(backward))


def cuda_launches(backward: bool = False) -> int:
    """CUDA kernel launches that K4's (``backward``: K5's) C entry point has
    issued in this process, counted in gn_relu.cu where each is issued: one
    (one pass) or three (two pass) a K4 call, two or six a K5 call. A count
    that cannot drop events, beside the wrapper's count of calls."""
    from csl_gan_tpu_torch.ops import _build

    return int(_build.load("gn_relu").gn_relu_launches(int(backward)))


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
    _check_inputs(x3, scale, bias)
    lib, geo, pl, scratch = _args(x3, groups, backward=False)
    y = torch.empty_like(x3)
    rc = lib.gn_relu_fwd(x3.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                         y.data_ptr(), scratch.data_ptr(), geo, pl,
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
    _check_inputs(x3, scale, bias)
    _check_cuda("dy", dy3, x3.device, x3.dtype, x3.shape)
    lib, geo, pl, scratch = _args(x3, groups, backward=True)
    c = x3.shape[2]
    dx = torch.empty_like(x3)
    dgamma = torch.empty(c, dtype=torch.float32, device=x3.device)
    dbeta = torch.empty(c, dtype=torch.float32, device=x3.device)
    rc = lib.gn_relu_bwd(x3.data_ptr(), dy3.data_ptr(), scale.data_ptr(),
                         bias.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
                         dbeta.data_ptr(), scratch.data_ptr(), geo, pl,
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
