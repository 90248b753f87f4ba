"""The port's conv ghost clipping against the JAX package's, on the CPU.

1. The plain versions of K2/K3 (csl_gan_tpu_torch/ops/pallas_conv_ghost.py)
   against the JAX Pallas kernels in interpret mode over
   tests/test_pallas_conv_ghost.py's geometries. fp32: rtol 1e-5 (reduction
   order only). bf16 inputs: both sides form exact fp32 products of the same
   bf16 values and accumulate in fp32, and both round w * c to bf16 the same
   way, so the bound stays at reduction order, 1e-5 relative, with an
   absolute floor of 1e-5 of the largest magnitude for the weighted sum's
   cancelling entries.
2. ``dcresnet_real_ghost`` (csl_gan_tpu_torch/ops/conv_ghost.py) against the
   JAX one on the MNIST DCResNet D (conv2 is ghost-order, conv1 direct), for
   both ACGAN aux types, fp32 and bf16 compute, with a clip bound low enough
   that most rows are clipped. fp32: 1e-4 relative. bf16: the two packages'
   bf16 convs round at different places (torch adds the bias inside the
   conv, XLA after it), so activations differ by about one bf16 ulp (2^-8)
   on some elements; norms and outputs are held to 2e-2 relative and the
   summed grads to 5e-2 in normalised l2.
3. The rule that sends a CUDA call of K2/K3 to the tensor-core or the FFMA
   variant (``kernel_variant``), which is plain Python: the flagship's
   conv2-conv4 at bf16 take the tensor cores; fp32 operands, and layers
   whose Cin or O is no multiple of 8, take FFMA. The CUDA kernels
   themselves run only on a card (chip_smoke.py holds them there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csl_gan_tpu import options
from csl_gan_tpu.models.registry import init_models
from csl_gan_tpu.ops import conv_ghost as cg
from csl_gan_tpu.ops import pallas_conv_ghost as pcg
from csl_gan_tpu.training.steps import TrainStepBuilder
from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch.ops import conv_ghost as tcg
from csl_gan_tpu_torch.ops import pallas_conv_ghost as tpcg

GEOMS = [
    (8, 32, 64, 128, 5, 2, 2),
    (4, 16, 128, 256, 5, 2, 2),
    (6, 28, 3, 16, 5, 2, 2),
    (8, 8, 16, 32, 3, 1, 1),
    (7, 16, 24, 40, 5, 2, 2),
    (2, 8, 256, 512, 5, 2, 2),           # the CelebA flagship's conv4
]


@pytest.fixture(autouse=True)
def interpret_mode():
    old = pcg.FORCE, pcg.INTERPRET
    pcg.FORCE, pcg.INTERPRET = True, True
    yield
    pcg.FORCE, pcg.INTERPRET = old


def _data(B, H, C, O, k, st, pad, dtype, seed=0):
    rng = np.random.default_rng(seed)
    Ho = (H + 2 * pad - k) // st + 1
    a = jnp.asarray(rng.standard_normal((B, H, H, C)), jnp.float32).astype(dtype)
    c = jnp.asarray(rng.standard_normal((B, Ho, Ho, O)), jnp.float32).astype(dtype)
    w = rng.uniform(0.1, 1.0, B).astype(np.float32)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    to_t = lambda v: torch.tensor(np.asarray(v, np.float32)).to(tdt)  # noqa: E731
    return (a, c, jnp.asarray(w)), (to_t(a), to_t(c), torch.tensor(w))


def _jax_norms(a, c, k, st, pad, dtype):
    """The JAX package's norms for this layer: the Pallas kernel (interpret
    mode), or its plain XLA expression where the kernel's accumulator gate
    refuses the layer (conv4), as dcresnet_real_ghost chooses."""
    if pcg.supported((k, k, a.shape[-1], c.shape[-1])):
        return pcg.ghost_sq_norms(a, c, k, k, st, pad)
    dt = None if dtype == jnp.float32 else dtype
    return cg._conv_kernel_sq_norms(cg._patches(a, k, k, st, pad, dt), c, dt)


def _jax_wsum(a, c, w, k, st, pad, dtype):
    kshape = (k, k, a.shape[-1], c.shape[-1])
    if pcg.supported(kshape):
        return pcg.weighted_kernel_grad(a, c, w, kshape, st, pad)
    dt = None if dtype == jnp.float32 else dtype
    return cg._conv_kernel_weighted_sum(cg._patches(a, k, k, st, pad, dt), c, w, kshape, dt)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("B,H,C,O,k,st,pad", GEOMS)
def test_ghost_sq_norms_plain_matches_pallas(B, H, C, O, k, st, pad, dtype):
    (a, c, _), (at, ct, _) = _data(B, H, C, O, k, st, pad, dtype)
    want = np.asarray(_jax_norms(a, c, k, st, pad, dtype))
    got = tpcg.ghost_sq_norms(at, ct, k, k, st, pad)
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("B,H,C,O,k,st,pad", GEOMS)
def test_weighted_kernel_grad_plain_matches_pallas(B, H, C, O, k, st, pad, dtype):
    (a, c, w), (at, ct, wt) = _data(B, H, C, O, k, st, pad, dtype, seed=1)
    want = np.asarray(_jax_wsum(a, c, w, k, st, pad, dtype))
    got = tpcg.weighted_kernel_grad(at, ct, wt, (k, k, C, O), st, pad)
    assert tuple(got.shape) == (k, k, C, O) and got.dtype == torch.float32
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("B,H,C,O,k,st,pad", [GEOMS[0], GEOMS[4], GEOMS[5]])
def test_weighted_kernel_grad_plain_rounds_the_scaled_cotangent(B, H, C, O, k, st, pad):
    """bf16 operands: w * c is rounded to bf16 before the product (the DP
    margin of the bf16 route rests on it). Against an independent float64
    sum over the rounded cotangent the plain version holds to 1e-5; the same
    sum without the rounding is 1e-3 away, so skipping it cannot pass."""
    (a, c, w), (at, ct, wt) = _data(B, H, C, O, k, st, pad, jnp.bfloat16, seed=2)
    got = tpcg.weighted_kernel_grad(at, ct, wt, (k, k, C, O), st, pad).numpy()
    u = tpcg.patches(at, k, k, st, pad).double().numpy()
    c32 = np.asarray(c.astype(jnp.float32)) * np.asarray(w)[:, None, None, None]
    rounded = np.asarray(jnp.asarray(c32).astype(jnp.bfloat16).astype(jnp.float32))
    want, skipped = (np.einsum("bsk,bso->ko", u, v.reshape(B, -1, O).astype(np.float64))
                     .reshape(k, k, C, O) for v in (rounded, c32))
    assert _rel(got, want) < 1e-5
    assert _rel(skipped, want) > 1e-3 and _rel(got, skipped) > 1e-3


# (dtype, [B, H, W, Cin, Ho, Wo, O]) -> variant. The CelebA flagship's
# conv2-conv4 (B 128), the MNIST DCResNet D's conv1 (Cin 1) and conv2.
FLAGSHIP_GEOS = [[128, 32, 32, 64, 16, 16, 128], [128, 16, 16, 128, 8, 8, 256],
                 [128, 8, 8, 256, 4, 4, 512]]


@pytest.mark.parametrize("dtype,geo,want", (
    [(torch.bfloat16, g, "tc") for g in FLAGSHIP_GEOS]
    + [(torch.float32, g, "ffma") for g in FLAGSHIP_GEOS]
    + [(torch.bfloat16, [8, 28, 28, 1, 14, 14, 64], "ffma"),
       (torch.float32, [8, 28, 28, 1, 14, 14, 64], "ffma"),
       (torch.bfloat16, [8, 14, 14, 64, 7, 7, 128], "tc"),
       (torch.bfloat16, [7, 16, 16, 24, 8, 8, 40], "tc"),
       (torch.bfloat16, [6, 28, 28, 3, 14, 14, 16], "ffma"),       # Cin 3
       (torch.bfloat16, [6, 28, 28, 16, 14, 14, 12], "ffma"),      # O 12
       (torch.bfloat16, [2 ** 15, 256, 256, 8, 128, 128, 8], "ffma")]))  # 2^34 elements
def test_kernel_variant_rule(dtype, geo, want):
    assert tpcg.kernel_variant(dtype, geo + [5, 5, 2, 2]) == want


def test_forced_variant_must_take_the_operands():
    """"ffma" takes everything; "tc" only what the rule gives it; anything
    else is refused (the wrappers raise before they reach a kernel)."""
    bf, fp = torch.zeros(1, dtype=torch.bfloat16), torch.zeros(1)
    geo = FLAGSHIP_GEOS[0] + [5, 5, 2, 2]
    assert tpcg._variant(bf, geo, None) == "tc" and tpcg._variant(fp, geo, None) == "ffma"
    assert tpcg._variant(bf, geo, "ffma") == "ffma" and tpcg._variant(bf, geo, "tc") == "tc"
    with pytest.raises(ValueError, match="variant"):
        tpcg._variant(fp, geo, "tc")
    with pytest.raises(ValueError, match="variant"):
        tpcg._variant(bf, geo, "mma")
    assert tpcg.ghost_sq_norms.launches_tc == 0 and tpcg.weighted_kernel_grad.launches_tc == 0


def _setup(tmp_path, aux_type, bs=8, seed=0):
    opt = options.parse(["MNIST", "--model", "DeepConvResNet", "-dpm", "gc",
                         "--conditional", "--aux_loss_type", aux_type,
                         "-o", str(tmp_path / "o"), "-bs", str(bs),
                         "--manual_seed", "17"])
    _, (D, Dv) = init_models(opt, init_G=False)
    b = TrainStepBuilder(opt, None, D) if False else None
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (bs, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, bs).astype(np.int32)
    return opt, D, Dv["params"], x, y, b


def _rel(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.mark.parametrize("aux_type", ["cross_entropy", "wasserstein"])
@pytest.mark.parametrize("bf16", [False, True])
def test_dcresnet_real_ghost_matches_jax(tmp_path, aux_type, bf16):
    opt, D, params, x, y, _ = _setup(tmp_path, aux_type)
    onehot = np.eye(10, dtype=np.float32)[y]
    counts = onehot.sum(0)
    row_w = (1.0 / np.maximum(onehot @ counts, 1.0)).astype(np.float32) \
        if aux_type == "wasserstein" else None
    clip = 0.05
    want, want_stats, (w_out, w_aux) = cg.dcresnet_real_ghost(
        params, jnp.asarray(x), jnp.asarray(y), n_classes=10, arch="ACGAN",
        aux_type=aux_type, aux_scalar=1.0,
        row_w=None if row_w is None else jnp.asarray(row_w), concat_planes=False,
        max_norm=clip, per_layer=False,
        compute_dtype=jnp.bfloat16 if bf16 else None)
    tparams = convert.params_from_jax(params, "D")
    got, got_stats, (g_out, g_aux) = tcg.dcresnet_real_ghost(
        tparams, torch.tensor(x), torch.tensor(y, dtype=torch.int64), n_classes=10,
        arch="ACGAN", aux_type=aux_type, aux_scalar=1.0,
        row_w=None if row_w is None else torch.tensor(row_w), max_norm=clip,
        compute_dtype=torch.bfloat16 if bf16 else None)
    assert float(np.mean(np.asarray(want_stats.frac_clipped))) > 0.5
    got_tree = convert.params_to_jax(got, "D")
    tol, gtol = (2e-2, 5e-2) if bf16 else (1e-4, 1e-4)
    for (path, a_), (_, g_) in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                   jax.tree_util.tree_flatten_with_path(got_tree)[0]):
        assert _rel(g_, a_) < gtol, (jax.tree_util.keystr(path), _rel(g_, a_))
    for name in ("norm_mean", "norm_std", "norm_max"):
        assert _rel(getattr(got_stats, name).numpy(),
                    np.asarray(getattr(want_stats, name))) < tol, name
    np.testing.assert_allclose(got_stats.frac_clipped.numpy(),
                               np.asarray(want_stats.frac_clipped), atol=1.0 / 8 + 1e-6)
    assert _rel(g_out.numpy(), np.asarray(w_out)) < tol
    assert _rel(g_aux.numpy(), np.asarray(w_aux)) < tol


def test_layer_orders_follow_the_jax_rule():
    """The flagship's ghost-order layers are conv2-conv4; conv1 is direct
    (ai = 240 kept from the JAX package)."""
    shapes = [(1024, 75, 64), (256, 1600, 128), (64, 3200, 256), (16, 6400, 512)]
    assert [tcg._ghost_order(*s) for s in shapes] == [cg._ghost_order(*s) for s in shapes] \
        == [False, True, True, True]
    assert tcg._BF16_NORM_MARGIN == cg._BF16_NORM_MARGIN


def test_wrappers_raise_on_other_devices():
    a = torch.zeros(2, 8, 8, 4, device="meta")
    c = torch.zeros(2, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tpcg.ghost_sq_norms(a, c, 5, 5, 2, 2)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tpcg.weighted_kernel_grad(a, c, torch.ones(2, device="meta"), (5, 5, 4, 8), 2, 2)
    for variant in ("ffma", "tc"):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            tpcg.ghost_sq_norms(a, c, 5, 5, 2, 2, variant=variant)
