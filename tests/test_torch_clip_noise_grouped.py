"""K6's grouped call (csl_gan_tpu_torch/ops/pallas_clip.py
``leaves_weighted_sum_noise``) on the CPU, at small shapes.

On CPU tensors the grouped call loops the plain version over the leaves, so
it is held bit for bit to ``weighted_sum_noise_plain`` leaf by leaf (seeds,
stds, counter bases and slots included) and, through
``grads.weighted_sum_fused_noise``, to the per-leaf route that called
``leaf_weighted_sum_noise`` once a large leaf. At std 0 its sums are held to
the JAX package's ``_weighted_sum`` on the same numpy inputs at rtol 1e-5
(the same fp32 products summed in another order). ``group_plan`` is checked
the way the kernel reads it: every (leaf, column) in exactly one work item
and one CTA's reduction slice, every row of B in exactly one CTA of a
cluster of at most 8. The CUDA launch itself runs only on the card
(``chip_smoke.py --clip``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from csl_gan_tpu.ops import grads as jgops
from csl_gan_tpu_torch.ops import grads as gops
from csl_gan_tpu_torch.ops import pallas_clip as pc

# The shapes K6's paths give it on the card (PERF.md): path 1's leaf, path
# 2's four leaves, a rank's rows, a --tp 2 slice, batch 50, the -pupd false
# slices at --tp 2 and the gate's P.
TABLE = [
    (600, (101632,)), (128, (102400, 409600, 1638400, 3276800)), (300, (101632,)),
    (600, (50816,)), (50, (101632,)), (128, (102400, 409600, 1638400, 8192)),
    (128, (8192,)), (128, (16384,)), (128, (33300,)),
]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _group(rng, b, shapes):
    gs = [torch.from_numpy(rng.standard_normal((b,) + s).astype(np.float32)) for s in shapes]
    ws = [torch.from_numpy(rng.uniform(0.1, 1.0, b).astype(np.float32)) for _ in shapes]
    return gs, ws


@pytest.mark.parametrize("b,shapes,bases,slots", [
    (6, [(33,), (8, 4), (3, 5, 7)], None, None),
    (5, [(1,), (4097,), (16, 16)], [0, 24, 2 ** 32 - 8], [2, 0, 1]),
    (1, [(12,), (13,)], [7, 0], [1, 1]),
    (9, [(2, 3)] * 16, list(range(0, 96, 6)), list(range(15, -1, -1))),
])
def test_grouped_cpu_is_the_plain_version_leaf_by_leaf(b, shapes, bases, slots):
    """Mixed leaves (P odd, P a multiple of 4, one element), counter bases
    past 2^32 and slots out of order: each output bit for bit the plain
    version at its leaf's seed, std and base."""
    rng = np.random.default_rng(b)
    gs, ws = _group(rng, b, shapes)
    n = len(gs)
    seeds = torch.from_numpy(rng.integers(0, 2 ** 63 - 1, n + 1, dtype=np.int64))
    stds = torch.from_numpy(rng.uniform(0.5, 3.0, n + 1).astype(np.float32))
    got = pc.leaves_weighted_sum_noise(gs, ws, seeds, stds, bases, slots)
    assert len(got) == n
    for i, (g, w) in enumerate(zip(gs, ws)):
        s = i if slots is None else slots[i]
        base = 0 if bases is None else bases[i]
        want = pc.weighted_sum_noise_plain(g.reshape(b, -1), w, seeds[s], stds[s], base)
        assert tuple(got[i].shape) == tuple(g.shape[1:])
        assert torch.equal(got[i], want.reshape(g.shape[1:])), i
        assert torch.equal(got[i], pc.leaf_weighted_sum_noise(g, w, seeds[s], stds[s], base))


def test_grouped_std0_matches_jax_weighted_sum():
    """std 0: the grouped sums against the JAX package's ``_weighted_sum``
    of the same numpy leaves and per-leaf factors, rtol 1e-5 (one fp32
    product summed in another order)."""
    rng = np.random.default_rng(3)
    shapes = [(16, 100, 3), (8, 16384), (16, 7, 5)]
    gs = [rng.standard_normal((12,) + s[1:]).astype(np.float32) for s in shapes]
    factors = rng.uniform(0.1, 1.0, (len(gs), 12)).astype(np.float32)
    want = jgops._weighted_sum([jnp.asarray(g) for g in gs], jnp.asarray(factors))
    got = pc.leaves_weighted_sum_noise([torch.from_numpy(g) for g in gs],
                                       list(torch.from_numpy(factors)), torch.arange(3),
                                       torch.zeros(3))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def _per_leaf_route(grads_ps, factors, fused):
    """The fused sum as the port took it before the grouped call: one
    ``leaf_weighted_sum_noise`` a large leaf, in leaf order."""
    out = {}
    for i, (k, g) in enumerate(grads_ps.items()):
        if fused.eps[i] is None:
            out[k] = pc.leaf_weighted_sum_noise(
                g, factors[i], fused.seeds[i], fused.stds[i],
                base=0 if fused.bases is None else fused.bases[i])
        else:
            s = (factors[i] @ g.reshape(g.shape[0], -1)).reshape(g.shape[1:])
            out[k] = s + fused.stds[i] * fused.eps[i]
    return out


@pytest.mark.parametrize("flat", [True, False])
@pytest.mark.parametrize("with_bases", [False, True])
def test_fused_route_is_the_per_leaf_route_bit_for_bit(monkeypatch, flat, with_bases):
    """``weighted_sum_fused_noise`` through one grouped call against the
    per-leaf route on the same draws: the same keys in the same order, every
    output bit for bit, and the small leaves' normals the same draws (the
    generator's order is unchanged). Flat clipping passes one expanded
    factor row to every leaf."""
    monkeypatch.setattr(pc, "MIN_PALLAS_ELEMS", 64)
    rng = np.random.default_rng(5)
    shapes = {"a.weight": (8, 9), "a.bias": (8,), "b.weight": (4, 8, 3, 3), "b.bias": (4,),
              "c.weight": (1, 65), "d.weight": (33, 3)}
    b = 7
    grads_ps = {k: torch.from_numpy(rng.standard_normal((b,) + s).astype(np.float32))
                for k, s in shapes.items()}
    leaves = [torch.zeros(s) for s in shapes.values()]
    norms = torch.from_numpy(rng.uniform(0.1, 3.0, (len(leaves), b)).astype(np.float32))
    factors = gops.clip_factors(norms, 1.0 if flat else [1.0 + i for i in range(len(leaves))],
                                per_layer=not flat)
    stds = torch.linspace(0.5, 2.0, len(leaves))
    draws = [gops.draw_fused_noise(torch.Generator().manual_seed(9), leaves, stds)
             for _ in range(2)]
    if with_bases:
        draws = [f._replace(bases=[3 * i for i in range(len(leaves))]) for f in draws]
    assert [e is None for e in draws[0].eps] == [True, False, True, False, True, True]
    for e0, e1 in zip(draws[0].eps, draws[1].eps):
        assert (e0 is None and e1 is None) or torch.equal(e0, e1)
    launches = pc.leaves_weighted_sum_noise.launches
    got = gops.weighted_sum_fused_noise(grads_ps, factors, draws[0])
    want = _per_leaf_route(grads_ps, factors, draws[1])
    assert list(got) == list(want) == list(shapes)
    for k in shapes:
        assert torch.equal(got[k], want[k]), k
    assert pc.leaves_weighted_sum_noise.launches == launches   # the CPU launches nothing


def _check_plan(b, ps, aligned=None):
    """The plan as the kernel reads it: each work item's leaf by the prefix
    sum, its columns, the CTAs' rows and the reduction slices."""
    aligned = tuple(True for _ in ps) if aligned is None else aligned
    plan = pc.group_plan(b, tuple(ps), aligned, 132)
    assert plan.tile in (256, 512, 1024)
    assert 1 <= plan.cluster <= min(8, b)
    # Every row of B in exactly one CTA of a cluster, none empty.
    rows = np.zeros(b, np.int64)
    for r in range(plan.cluster):
        r0, r1 = r * plan.rows, min(b, (r + 1) * plan.rows)
        assert r1 > r0
        rows[r0:r1] += 1
    assert (rows == 1).all()
    # Every column of a tile in exactly one reduction slice.
    slices = np.zeros(plan.tile, np.int64)
    for r in range(plan.cluster):
        slices[r * plan.tile // plan.cluster:(r + 1) * plan.tile // plan.cluster] += 1
    assert (slices == 1).all()
    n_tiles = [-(-p // plan.tile) for p in ps]
    assert list(plan.tile0) == [sum(n_tiles[:i]) for i in range(len(ps))]
    assert plan.vec == tuple(4 if p % 4 == 0 and a else 1 for p, a in zip(ps, aligned))
    items = np.arange(sum(n_tiles))
    leaf = np.searchsorted(np.asarray(plan.tile0), items, side="right") - 1
    for l, p in enumerate(ps):
        # The leaf's items take its tiles 0, 1, ... in turn: its columns once.
        col0 = (items[leaf == l] - plan.tile0[l]) * plan.tile
        assert (col0 == np.arange(n_tiles[l]) * plan.tile).all()
        assert col0[-1] < p <= col0[-1] + plan.tile, (b, ps, l)
    assert sum(n_tiles) * plan.cluster < 2 ** 31
    return plan


@pytest.mark.parametrize("b,ps", TABLE)
def test_group_plan_covers_the_paths_shapes(b, ps):
    plan = _check_plan(b, ps)
    # Enough CTAs for 132 SMs at every shape of the paths.
    assert sum(-(-p // plan.tile) for p in ps) * plan.cluster >= 132


@settings(max_examples=60, deadline=None)
@given(b=st.one_of(st.sampled_from([50, 128, 300, 600]), st.integers(1, 700)),
       ps=st.lists(st.one_of(st.sampled_from([p for _, g in TABLE for p in g]),
                             st.integers(1, 300000)), min_size=1, max_size=16),
       data=st.data())
def test_group_plan_covers_every_column_and_row(b, ps, data):
    aligned = tuple(data.draw(st.lists(st.booleans(), min_size=len(ps), max_size=len(ps))))
    _check_plan(b, ps, aligned)


def test_group_plan_is_cached_by_its_arguments():
    a = pc.group_plan(600, (101632,), (True,), 132)
    assert pc.group_plan(600, (101632,), (True,), 132) is a
    assert pc.group_plan(600, (101632,), (False,), 132).vec == (1,)


def _bad(kind):
    g, w = torch.zeros(4, 6), torch.ones(4)
    if kind == "mixed B":
        return [g, torch.zeros(5, 6)], [w, torch.ones(5)], {}
    if kind == "fp64":
        return [g.double()], [w], {}
    if kind == "fp64 weights":
        return [g], [w.double()], {}
    if kind == "non-contiguous":
        return [torch.zeros(6, 4).t()], [w], {}
    if kind == "non-contiguous weights":
        return [g], [torch.ones(4, 2)[:, 0]], {}
    if kind == "too many leaves":
        return [g] * (pc.MAX_LEAVES + 1), [w] * (pc.MAX_LEAVES + 1), {}
    if kind == "no leaf":
        return [], [], {}
    if kind == "negative base":
        return [g, g], [w, w], {"bases": [0, -1]}
    if kind == "weights short":
        return [g, g], [w], {}
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["mixed B", "fp64", "fp64 weights", "non-contiguous",
                                  "non-contiguous weights", "too many leaves", "no leaf",
                                  "negative base", "weights short"])
def test_wrapper_rejects(kind):
    gs, ws, kw = _bad(kind)
    with pytest.raises(ValueError):
        pc.leaves_weighted_sum_noise(gs, ws, torch.zeros(20, dtype=torch.int64),
                                     torch.zeros(20), **kw)


def test_wrapper_rejects_other_devices():
    g, w = torch.zeros(2, 4, device="meta"), torch.ones(2, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        pc.leaves_weighted_sum_noise([g], [w], 0, 0.0)
    with pytest.raises(ValueError, match="every leaf"):
        pc.leaves_weighted_sum_noise([torch.zeros(2, 4), g], [torch.ones(2), w], [0, 1],
                                     [0.0, 0.0])
