"""The port's GroupNorm+ReLU (csl_gan_tpu_torch/ops/pallas_groupnorm.py, the
plain versions of K4/K5 on the CPU) against the JAX package's default XLA
formulation and its Pallas kernels in interpret mode, forward and backward,
over tests/test_groupnorm.py's shapes.

Tolerances: fp32 agrees to reduction order (1e-5 forward, 1e-4 on the
gradients). bf16: the outputs are bf16 and the two packages round the affine
at different places (the port once from fp32, the XLA form per bf16 op), so
single elements may differ by an ulp of bf16 (2^-8 relative): forward
atol/rtol 5e-2 as in tests/test_groupnorm.py, gradients in normalised l2
(2e-2), since per-element comparison breaks where d(scale) terms cancel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csl_gan_tpu.ops import pallas_groupnorm as pgn
from csl_gan_tpu_torch.ops import pallas_groupnorm as tgn

SHAPES = [
    ((4, 8, 8, 64), 32),
    ((2, 4, 4, 128), 32),
    ((3, 7, 7, 64), 32),
    ((2, 5, 5, 8), 4),
]


@pytest.fixture
def pallas_interpret():
    old = pgn.FORCE, pgn.INTERPRET
    pgn.FORCE, pgn.INTERPRET = True, True
    yield
    pgn.FORCE, pgn.INTERPRET = old


def _data(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2.0 + 0.3).astype(np.float32)
    scale = (rng.standard_normal(c) + 1.0).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x, scale, bias


def _jax(fn, x, scale, bias):
    def loss(x, s, b):
        return jnp.sum(jnp.sin(fn(x, s, b).astype(jnp.float32) * 0.7))
    y = fn(x, scale, bias)
    return np.asarray(y, np.float32), [np.asarray(g, np.float32) for g in
                                       jax.grad(loss, argnums=(0, 1, 2))(x, scale, bias)]


def _port(x, scale, bias, groups, dtype):
    xt = torch.tensor(x).to(dtype).requires_grad_(True)
    st = torch.tensor(scale, requires_grad=True)
    bt = torch.tensor(bias, requires_grad=True)
    y = tgn.group_norm_relu(xt, st, bt, groups)
    assert y.dtype == dtype and y.shape == xt.shape
    torch.sin(y.float() * 0.7).sum().backward()
    return y.detach().float().numpy(), [t.grad.float().numpy() for t in (xt, st, bt)]


def _compare(got, want, dtype):
    (y, grads), (y_ref, grads_ref) = got, want
    if dtype == torch.float32:
        np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-5)
        for a, b in zip(grads, grads_ref):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(y, y_ref, rtol=5e-2, atol=5e-2)
        for a, b in zip(grads, grads_ref):
            assert np.linalg.norm(a - b) <= 2e-2 * (np.linalg.norm(b) + 1.0)


@pytest.mark.parametrize("shape,groups", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_relu_matches_jax_xla(shape, groups, dtype):
    x, scale, bias = _data(shape, 0)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj = jnp.asarray(x).astype(jdt)
    want = _jax(lambda x, s, b: pgn._gn_relu_xla(x, s, b, groups, 1e-5), xj,
                jnp.asarray(scale), jnp.asarray(bias))
    _compare(_port(np.asarray(xj, np.float32), scale, bias, groups, dtype), want, dtype)


@pytest.mark.parametrize("shape,groups", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_relu_matches_jax_pallas_interpret(shape, groups, dtype, pallas_interpret):
    x, scale, bias = _data(shape, 1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    xj = jnp.asarray(x).astype(jdt)
    want = _jax(lambda x, s, b: pgn.group_norm_relu(x, s, b, groups), xj,
                jnp.asarray(scale), jnp.asarray(bias))
    _compare(_port(np.asarray(xj, np.float32), scale, bias, groups, dtype), want, dtype)


def test_mask_from_fp32_affine():
    """Where the bf16-rounded affine and the fp32 affine disagree in sign,
    the ReLU mask follows the fp32 one (JAX _gn_relu_xla :297-309): the
    output is 0 and no gradient passes where the fp32 value is <= 0."""
    hw, c = 64, 32
    x = np.zeros((1, hw, c), np.float32)
    x[0, ::2, :] = 1.0
    x[0, 1::2, :] = -1.0
    x[0, 0, :] = 1.0 + 2.0 ** -7          # exactly representable in bf16
    xt = torch.tensor(x).to(torch.bfloat16)
    scale = torch.ones(c)
    mean, rstd = tgn._stats(xt.float(), 32, 1e-5)
    # A bias that puts the fp32 affine of x = -1 just below zero, while its
    # bf16 rounding (of a * x and of d) gives a value >= 0.
    a = float(rstd[0, 0])
    bias_val = a * (1.0 + float(mean[0, 0])) - 1e-6
    bias = torch.full((c,), bias_val)
    z32 = xt.float() * (rstd * scale) + (bias - mean * rstd * scale)
    z_bf = (xt * (rstd * scale).to(torch.bfloat16)) + (bias - mean * rstd * scale).to(torch.bfloat16)
    neg = (z32 <= 0)[0]
    assert neg[1].all() and (z_bf[0, 1] >= 0).all(), "construction must split the signs"
    xr = xt.clone().requires_grad_(True)
    sr = scale.clone().requires_grad_(True)
    br = bias.clone().requires_grad_(True)
    y = tgn.group_norm_relu(xr, sr, br, 32)
    assert (y[0][neg] == 0).all()
    dy = torch.ones_like(y)
    dx, dg, db = tgn.gn_relu_bwd_plain(xt, dy, scale, bias, 32)
    # dbeta counts exactly the rows whose fp32 affine is positive.
    assert torch.equal(db, (~neg).float().sum(dim=0))
    y.float().sum().backward()
    torch.testing.assert_close(br.grad, db)
    # The same rule as the JAX package's.
    yj = pgn._gn_relu_xla(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(scale.numpy()),
                          jnp.asarray(bias.numpy()), 32, 1e-5)
    np.testing.assert_array_equal(np.asarray(yj, np.float32) == 0, (y.detach().float() == 0).numpy())


def test_cuda_tensor_never_takes_the_plain_version():
    """The wrappers dispatch on the device: a CPU tensor takes the plain
    version, any other device raises instead of falling back."""
    x = torch.zeros(1, 4, 32, device="meta")
    s = torch.ones(32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tgn.gn_relu_forward(x, s, s, 32, 1e-5)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tgn.gn_relu_backward(x, x, s, s, 32, 1e-5)
    before = tgn.gn_relu_forward.launches
    tgn.gn_relu_forward(torch.zeros(1, 4, 32), torch.ones(32), torch.zeros(32), 32, 1e-5)
    assert tgn.gn_relu_forward.launches == before


# ---------------- K4 / K5 launch plans (csrc/gn_relu.cu) ----------------

# The G's norms (HW, C) at the flagship's batch and the fp32 check's, and
# ragged geometries with odd cuts and the two-pass variant ([B, HW, C]).
G_NORMS = [(16, 512), (64, 512), (256, 256), (1024, 128), (4096, 64)]
RAGGED = [(3, 49, 32), (5, 1, 1024), (3, 49, 1024), (3, 2500, 64), (2, 4096, 1024)]
PLAN_GEOMETRIES = ([(b, hw, c) for b in (128, 8) for hw, c in G_NORMS] + RAGGED)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("geo", PLAN_GEOMETRIES)
def test_launch_plan_fits_the_card_and_covers_every_row(geo, dtype):
    b, hw, c = geo
    esize = 2 if dtype == torch.bfloat16 else 4
    vr = c // (16 // esize)
    for backward in (False, True):
        variant, n, rows, threads, smem = tgn.launch_plan(b, hw, c, 32, dtype, backward)
        assert 0 < smem <= 232448 and 1 <= n <= 16
        assert threads % 32 == 0 and threads % vr == 0 and threads <= 256
        # The CTAs of a sample (a cluster's n, or the two-pass chunks) take
        # consecutive row ranges of `rows`, the last one possibly shorter:
        # every row once, no CTA empty.
        ctas = -(-hw // rows)
        assert (ctas - 1) * rows < hw <= ctas * rows
        if variant == tgn.ONE_PASS:
            assert n == ctas
            assert smem == tgn.one_pass_smem(rows, c, 32, esize, threads, backward)
        else:
            assert variant == tgn.TWO_PASS and n == 1
            assert smem >= tgn.red_bytes(c, esize, threads)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("geo", PLAN_GEOMETRIES)
def test_forward_takes_the_backwards_cut(geo, dtype):
    """K4 and K5 cut a sample alike (variant, n, rows, threads), so they sum
    the statistics in one order and K5's ReLU mask is the one K4 applied;
    only their shared memory differs."""
    fwd = tgn.launch_plan(*geo, 32, dtype, False)
    bwd = tgn.launch_plan(*geo, 32, dtype, True)
    assert fwd[:4] == bwd[:4]
    assert fwd[4] <= bwd[4]


@pytest.mark.parametrize("hw,c", G_NORMS)
def test_flagship_norms_take_the_one_pass_variant(hw, c):
    """All of the G's bf16 norms at B 128 read x (and dy) once: one-pass
    clusters."""
    for backward in (False, True):
        plan = tgn.launch_plan(128, hw, c, 32, torch.bfloat16, backward)
        assert plan[0] == tgn.ONE_PASS, plan


def test_a_sample_too_large_for_a_cluster_takes_two_passes():
    for dtype in (torch.bfloat16, torch.float32):
        assert tgn.launch_plan(2, 4096, 1024, 32, dtype, False)[0] == tgn.TWO_PASS
        assert tgn.launch_plan(2, 4096, 1024, 32, dtype, True)[0] == tgn.TWO_PASS


@pytest.mark.parametrize("geo,groups,dtype", [
    ((2, 16, 4), 4, torch.float32),        # C below 8
    ((2, 16, 12), 4, torch.bfloat16),      # C not dividing 256
    ((2, 16, 384), 32, torch.bfloat16),    # above 256, not a multiple of it
    ((2, 16, 2048), 32, torch.float32),    # above 1024
    ((2, 16, 64), 24, torch.float32),      # groups not dividing C
    ((0, 16, 64), 32, torch.float32),      # empty batch
    ((2, 0, 64), 32, torch.bfloat16),      # empty spatial extent
    ((2, 16, 64), 32, torch.float16),      # dtype
])
def test_geometry_outside_the_rules_raises_before_any_build(geo, groups, dtype, monkeypatch):
    from csl_gan_tpu_torch.ops import _build

    def no_build(name):
        raise AssertionError("the kernels were built for a geometry they refuse")

    monkeypatch.setattr(_build, "load", no_build)
    with pytest.raises(ValueError):
        tgn.launch_plan(*geo, groups, dtype, False)
    for backward in (False, True):
        with pytest.raises(ValueError):
            tgn._launch_args(geo, dtype, groups, backward)


def _c_entry_points(src):
    """{name: (return type, [parameter types])} of the extern "C" functions."""
    import re

    return {name: (ret, [p.strip().rsplit(" ", 1)[0] for p in params.split(",")])
            for ret, name, params in re.findall(r'extern "C" (.+?) (\w+)\(([^)]*)\)', src)}


def test_build_declares_the_gn_relu_entry_points():
    """_build binds every C entry point of gn_relu.cu with its own argument
    and result types (a pointer passed as a 32-bit int, or a long long
    result read as an int, would show only on the card)."""
    import ctypes
    from pathlib import Path

    from csl_gan_tpu_torch.ops import _build

    src = (Path(tgn.__file__).parent / "csrc" / "gn_relu.cu").read_text()
    entries = _c_entry_points(src)
    assert set(entries) == {"gn_relu_scratch", "gn_relu_fwd", "gn_relu_bwd",
                            "gn_relu_occupancy", "gn_relu_launches", "gn_error_string"}

    class Lib:
        def __getattr__(self, name):
            fn = type(name, (), {})()
            setattr(self, name, fn)
            return fn

    lib = Lib()
    _build._bind("gn_relu", lib)
    ctype = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong,
             "const int*": ctypes.POINTER(ctypes.c_int), "const char*": ctypes.c_char_p}
    for name, (ret, params) in entries.items():
        fn = getattr(lib, name)
        want = [ctype.get(t, ctypes.c_void_p if t.endswith("*") else None) for t in params]
        assert fn.argtypes == want, name
        assert fn.restype is ctype[ret], name
