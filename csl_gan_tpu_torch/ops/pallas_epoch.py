"""One whole epoch of the MNIST conditional ACGAN DP-gc step (K1).

The CUDA counterpart of the JAX package's whole-epoch Pallas kernel
(csl_gan_tpu/ops/pallas_epoch.py ``_make_kernel``'s ``kernel``). Every step of
an epoch does, in order: a G forward; the ghost-clipped real D pass; the clean
fake pass; adding the pre-drawn DP noise, then dividing by bs; optax Adam for
D; the G step against the updated D; the metric sums.

- ``supports()`` is the JAX module's gate.
- ``epoch_kernel()`` runs the epoch through the hand-written CUDA kernels of
  ``csrc/k1_epoch.cu`` for CUDA tensors; for CPU tensors it takes
  ``epoch_plain()``, and for anything else it raises.
- ``epoch_plain()`` is the same function in plain PyTorch, built from the
  port's step math (training/steps.py).
- ``split_plan()`` reports how the CUDA launcher cuts each product of a step
  across the card's SMs (tile, splits of K, CTAs).

Both take exactly the inputs of the JAX kernel, all randomness pre-drawn:
gathered table rows [n*bs, F+nc+1], z_d / z_g [n, bs, latent], one_hot(y_g)
[n, bs, nc], the six D noise leaves [n, *leaf] (None without DP), the clip
value C, the Adam counts (t_d, t_g) (step i uses count + i + 1), and 10
params, 10 Adam mu, 10 Adam nu: D's six leaves then G's four, in the JAX leaf
order (models/mnist.py D_LEAVES, G_LEAVES) with torch layouts. Both return the
updated params, mu, nu and the 40-slot metric vector summed over the epoch.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence

import torch

from csl_gan_tpu_torch.models.mnist import (D_LEAVES, G_LEAVES, MNISTVanillaD,
                                            MNISTVanillaG)
from csl_gan_tpu_torch.training.steps import TrainState

# Metric slot map (sums over the epoch's steps), as in the JAX kernel.
M_D_ADV, M_D_REAL, M_D_FAKE, M_D_RACC, M_D_FACC = 0, 1, 2, 3, 4
M_D_RAUX_LOSS, M_D_RAUX_ACC = 5, 6
M_G_ADV, M_G_AUX, M_G_AUX_ACC = 7, 8, 9
M_NORM_MEAN, M_NORM_STD, M_NORM_MAX, M_FRAC = 10, 16, 22, 28
MET_SLOTS = 40

_D_KEYS = ("d_adv_loss", "d_real_loss", "d_fake_loss", "d_real_acc",
           "d_fake_acc", "d_real_aux_loss", "d_real_aux_acc")
_G_KEYS = ("g_adv_loss", "g_aux_loss", "g_aux_acc")


def supports(builder, use_dp: bool, n_devices: int) -> bool:
    """True when the epoch kernel reproduces this config exactly (the JAX
    module's gate, ops/pallas_epoch.py:66-106), with the CUDA kernel's own
    bound of 16 classes."""
    opt = builder.opt
    common = bool(
        not builder.penalty_types
        and not builder.use_bpc
        and builder.chunk is None
        and builder.compute_dtype is None
        and builder.conditional
        and builder.arch == "ACGAN"
        and builder.aux_type == "cross_entropy"
        and builder.use_aux
        and 2 <= builder.n_classes <= 16
        and isinstance(builder.G, MNISTVanillaG)
        and isinstance(builder.D, MNISTVanillaD)
        and not builder.g_has_bn
        and builder.labels_in_table
        and builder.onehot_in_table
        and builder.img_shape is not None
        and opt.n_d_steps <= 1
        and float(opt.train_d_until_threshold) >= 1e10
        and (opt.weight_decay or 0) == 0
        and opt.batch_size % 8 == 0
        and n_devices == 1
    )
    if not common:
        return False
    if use_dp:
        return bool(builder.dp_mode == "gc" and builder.use_ghost
                    and not builder.per_layer and not builder.adaptive
                    and not builder.poisson)
    return True


def state_from_leaves(params, mu, nu, C, t) -> TrainState:
    d, g = len(D_LEAVES), len(D_LEAVES) + len(G_LEAVES)
    return TrainState(
        dict(zip(D_LEAVES, params[:d])), dict(zip(G_LEAVES, params[d:g])),
        dict(zip(D_LEAVES, mu[:d])), dict(zip(D_LEAVES, nu[:d])),
        dict(zip(G_LEAVES, mu[d:g])), dict(zip(G_LEAVES, nu[d:g])),
        int(t[0]), int(t[1]), float(C))


def leaves_of(state: TrainState):
    params = [state.d_params[k] for k in D_LEAVES] + [state.g_params[k] for k in G_LEAVES]
    mu = [state.d_mu[k] for k in D_LEAVES] + [state.g_mu[k] for k in G_LEAVES]
    nu = [state.d_nu[k] for k in D_LEAVES] + [state.g_nu[k] for k in G_LEAVES]
    return params, mu, nu


def epoch_plain(builder, rows, z_d, z_g, ohg, noise, C, t, params, mu, nu,
                use_dp: bool = True):
    """The epoch in plain PyTorch: per step, the port's gc (or plain) D step
    then its G step, with the inputs given. On a CUDA device the caller
    keeps TF32 off (chip_smoke.py does), so every product is full fp32."""
    n, bs = z_d.shape[0], z_d.shape[1]
    state = state_from_leaves(params, mu, nu, C, t)
    met = torch.zeros(MET_SLOTS, dtype=torch.float32, device=z_d.device)
    for s in range(n):
        x, y, _ = builder.split_rows(rows[s * bs:(s + 1) * bs])
        step_noise = [l[s] for l in noise] if use_dp else None
        state, dm = builder.d_step(state, x, y, z_d[s], step_noise, use_dp)
        state, gm = builder.g_step(state, z_g[s], ohg[s])
        for slot, k in enumerate(_D_KEYS):
            met[slot] += dm[k]
        for slot, k in enumerate(_G_KEYS, start=M_G_ADV):
            met[slot] += gm[k]
        if use_dp:
            met[M_NORM_MEAN:M_NORM_MEAN + 6] += dm["norm_mean"]
            met[M_NORM_STD:M_NORM_STD + 6] += dm["norm_std"]
            met[M_NORM_MAX:M_NORM_MAX + 6] += dm["norm_max"]
            met[M_FRAC:M_FRAC + 6] += dm["frac_clipped"]
    p, m, v = leaves_of(state)
    return p, m, v, met


# Pointer slots of the C entry point k1_epoch (csrc/k1_epoch.cu, enum Ptr).
_N_PTRS = 38
_N_INTS = 11
_N_FLOATS = 11


def _check(name: str, x: torch.Tensor, shape: Sequence[int], dtypes, dev):
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if x.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {x.dtype}, expected one of {dtypes}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _ints(builder, rows, z_d, t, H: int, use_dp: bool) -> List[int]:
    """The Int slots of the C entry point (csrc/k1_epoch.cu, enum Int)."""
    n, bs, latent = z_d.shape
    return [n, bs, math.prod(builder.img_shape), builder.n_classes, latent, H,
            int(use_dp), int(builder.d_fake_aux and builder.use_aux), int(t[0]),
            int(t[1]), int(rows.dtype == torch.bfloat16)]


def split_plan(builder, rows, z_d, params):
    """How the CUDA launcher cuts each product of one step across the SMs of
    the current card: [(M, N, K, tile rows, tile columns, BK, splits, CTAs)],
    in the step's order."""
    from csl_gan_tpu_torch.ops import _build

    lib = _build.load("k1_epoch")
    ints = _ints(builder, rows, z_d, (0, 0), params[0].shape[0], True)
    out = (ctypes.c_int * (8 * 32))()
    k = lib.k1_epoch_plan((ctypes.c_int * _N_INTS)(*ints), _N_INTS, out, 32)
    if k < 0:
        raise ValueError(f"k1_epoch_plan refused the shapes {ints}")
    return [tuple(out[8 * i:8 * i + 8]) for i in range(k)]


def _launch_cuda(builder, rows, z_d, z_g, ohg, noise, C, t, params, mu, nu,
                 use_dp: bool):
    from csl_gan_tpu_torch.ops import _build

    opt = builder.opt
    dev = z_d.device
    n, bs, latent = z_d.shape
    nc = builder.n_classes
    F = 1
    for d in builder.img_shape:
        F *= d
    A0 = F + nc
    H = params[0].shape[0]
    if H % 32 != 0 or nc > 16:
        raise ValueError(f"epoch kernel needs H % 32 == 0 and nc <= 16, got H={H}, nc={nc}")
    f32 = (torch.float32,)
    _check("rows", rows, (n * bs, A0 + 1), (torch.bfloat16, torch.float32), dev)
    _check("z_d", z_d, (n, bs, latent), f32, dev)
    _check("z_g", z_g, (n, bs, latent), f32, dev)
    _check("ohg", ohg, (n, bs, nc), f32, dev)
    d_shapes = [(H,), (H, A0), (1,), (1, H), (nc,), (nc, H)]
    g_shapes = [(H,), (H, latent + nc), (F,), (F, H)]
    for group, name in ((params, "params"), (mu, "mu"), (nu, "nu")):
        for i, (x, s) in enumerate(zip(group, d_shapes + g_shapes)):
            _check(f"{name}[{i}]", x, s, f32, dev)
    if use_dp:
        for i, (x, s) in enumerate(zip(noise, d_shapes)):
            _check(f"noise[{i}]", x, (n,) + s, f32, dev)

    # Flat fp32 state per model (the kernel's layout: D then G leaves in the
    # JAX leaf order); Adam updates each buffer in one launch.
    def flat(group, lo, hi):
        return torch.cat([x.reshape(-1) for x in group[lo:hi]])

    pD, mD, vD = flat(params, 0, 6), flat(mu, 0, 6), flat(nu, 0, 6)
    pG, mG, vG = flat(params, 6, 10), flat(mu, 6, 10), flat(nu, 6, 10)
    met = torch.zeros(MET_SLOTS, dtype=torch.float32, device=dev)

    def e(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    scratch = [e(bs, H), e(bs, F), e(bs, H), e(bs, H),        # GH FIMG Hr Hf
               e(bs, H), e(bs, H), e(bs), e(bs),              # CZr CZf COr COf
               e(bs, nc), e(bs, nc), e(bs), e(bs, 16),        # CAr CAf fac RS
               e(pD.numel()),                                 # GD
               e(bs, H), e(bs, F), e(bs, H), e(bs, H),        # GHb IMG Hg CZg
               e(bs, F), e(bs, H), e(pG.numel())]             # CGLOG CGZ1 GG
    ints = _ints(builder, rows, z_d, t, H, use_dp)
    lib = _build.load("k1_epoch")
    c_ints = (ctypes.c_int * _N_INTS)(*ints)
    # Split-K workspace: the kernel's launcher sizes it from the step's plan.
    ws = lib.k1_epoch_scratch(c_ints, _N_INTS)
    if ws < 0:
        raise ValueError(f"k1_epoch_scratch refused the shapes {ints}")
    scratch.append(e(max(ws, 1)))                             # WS
    noise_ptrs = [x.data_ptr() for x in noise] if use_dp else [0] * 6
    ptr_list = ([rows.data_ptr(), z_d.data_ptr(), z_g.data_ptr(), ohg.data_ptr()]
                + noise_ptrs
                + [x.data_ptr() for x in (pD, mD, vD, pG, mG, vG, met)]
                + [x.data_ptr() for x in scratch])
    assert len(ptr_list) == _N_PTRS
    b1, b2 = float(opt.adam_b1), float(opt.adam_b2)
    floats = [builder.aux_scalar, b1, b2, 1.0 - b1, 1.0 - b2,
              math.log(b1), math.log(b2),
              float(opt.g_lr), float(opt.d_lr), 1e-8, float(C)]
    c_ptrs = (ctypes.c_void_p * _N_PTRS)(*ptr_list)
    c_floats = (ctypes.c_float * _N_FLOATS)(*floats)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.k1_epoch(c_ptrs, _N_PTRS, c_ints, _N_INTS, c_floats, _N_FLOATS,
                      ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"k1_epoch failed: {lib.k1_error_string(rc).decode()}")
    epoch_kernel.launches += 1

    def split(buf, shapes):
        out, o = [], 0
        for s in shapes:
            k = math.prod(s)
            out.append(buf[o:o + k].view(s))
            o += k
        return out

    p = split(pD, d_shapes) + split(pG, g_shapes)
    m = split(mD, d_shapes) + split(mG, g_shapes)
    v = split(vD, d_shapes) + split(vG, g_shapes)
    return p, m, v, met


def epoch_kernel(builder, rows: torch.Tensor, z_d: torch.Tensor,
                 z_g: torch.Tensor, ohg: torch.Tensor,
                 noise: Optional[List[torch.Tensor]], C: float, t,
                 params: List[torch.Tensor], mu: List[torch.Tensor],
                 nu: List[torch.Tensor], use_dp: bool = True):
    """One epoch through K1's CUDA kernels (CUDA tensors) or through
    ``epoch_plain`` (CPU tensors). Adds one to ``epoch_kernel.launches`` per
    CUDA epoch launched."""
    if z_d.device.type == "cpu":
        return epoch_plain(builder, rows, z_d, z_g, ohg, noise, C, t, params,
                           mu, nu, use_dp)
    if z_d.device.type != "cuda":
        raise ValueError(f"epoch_kernel takes CPU or CUDA tensors, got {z_d.device}")
    return _launch_cuda(builder, rows, z_d, z_g, ohg, noise, C, t, params, mu,
                        nu, use_dp)


epoch_kernel.launches = 0
