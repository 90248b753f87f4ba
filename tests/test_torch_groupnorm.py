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
