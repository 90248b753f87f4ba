"""The port's MessagePack subset (csl_gan_tpu_torch/utils/msgpack.py) against
flax's serialization: the port's bytes restore in flax, flax's bytes decode
in the port, both to the same tree, and the bytes are equal where the key
order is (flax writes keys sorted); a save of the JAX package decodes to what
flax restores; what lies outside the subset raises."""

import struct

import numpy as np
import pytest
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from csl_gan_tpu_torch.utils import msgpack

DTYPES = ["float32", "float64", "int32", "int64", "uint8", "int8", "bool", "float16", "uint32"]


@st.composite
def arrays(draw):
    dtype = np.dtype(draw(st.sampled_from(DTYPES)))
    shape = tuple(draw(st.lists(st.integers(0, 4), max_size=3)))
    n = int(np.prod(shape))
    raw = draw(st.binary(min_size=n * dtype.itemsize, max_size=n * dtype.itemsize))
    a = np.frombuffer(raw, np.uint8).copy().view(dtype).reshape(shape)
    if dtype == np.bool_:
        a = a.view(np.uint8) % 2 == 1
    if draw(st.booleans()) and a.ndim == 0:
        return a[()]                # a numpy scalar: flax's ext 3
    return a


leaves = st.one_of(
    st.none(), st.booleans(), st.integers(-2 ** 63, 2 ** 64 - 1),
    st.floats(allow_nan=False), st.text(max_size=300), st.binary(max_size=300),
    arrays())
trees = st.recursive(
    leaves,
    lambda kids: st.one_of(st.lists(kids, max_size=20),
                           st.dictionaries(st.text(max_size=40), kids, max_size=20)),
    max_leaves=60)


def assert_same(a, b):
    assert type(a) is type(b), (a, b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert a.dtype == b.dtype and np.shape(a) == np.shape(b)
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    else:
        assert a == b


def sort_keys(t):
    if isinstance(t, dict):
        return {k: sort_keys(t[k]) for k in sorted(t)}
    if isinstance(t, list):
        return [sort_keys(v) for v in t]
    return t


def as_tree(t):
    """Top-level leaves go in a map: the payloads are maps, and jax's tree
    map (inside msgpack_serialize) would turn a bare None into a tree."""
    return {"t": t}


@settings(max_examples=60, deadline=None)
@given(trees)
def test_port_bytes_restore_in_flax(tree):
    tree = as_tree(tree)
    assert_same(sort_keys(serialization.msgpack_restore(msgpack.packb(tree))),
                sort_keys(tree))


@settings(max_examples=60, deadline=None)
@given(trees)
def test_flax_bytes_decode_in_the_port(tree):
    tree = as_tree(tree)
    assert_same(msgpack.unpackb(serialization.msgpack_serialize(tree)), sort_keys(tree))


@settings(max_examples=60, deadline=None)
@given(trees)
def test_same_bytes_for_the_same_key_order(tree):
    tree = sort_keys(as_tree(tree))
    assert msgpack.packb(tree) == serialization.msgpack_serialize(tree)


def test_decoded_arrays_are_views_of_the_buffer():
    a = np.arange(1 << 16, dtype=np.float32)
    assert not msgpack.unpackb(msgpack.packb({"a": a}))["a"].flags.writeable
    buf = bytearray(msgpack.packb({"a": a}))
    out = msgpack.unpackb(buf)["a"]
    assert not out.flags.owndata
    np.testing.assert_array_equal(out, a)
    buf[-4:] = struct.pack("<f", 7.0)      # the decoded array reads the buffer
    assert out[-1] == 7.0


def test_a_jax_save_decodes_as_flax_restores_it(tmp_path):
    """A D checkpoint of the JAX package (nested maps, int32 Adam count,
    fp32 0-d clipping, the accountant's ints and floats)."""
    from csl_gan_tpu import options
    from csl_gan_tpu.models.registry import init_models
    from csl_gan_tpu.privacy import RdpAccountant
    from csl_gan_tpu.training import checkpoint
    from csl_gan_tpu.training.steps import TrainStepBuilder

    opt = options.parse(["MNIST", "--conditional", "-dpm", "gc", "-bs", "16",
                         "--manual_seed", "5", "-o", str(tmp_path / "o")])
    (G, Gv), (D, Dv) = init_models(opt)
    state = TrainStepBuilder(opt, G, D).init_state(Gv, Dv)
    acc = RdpAccountant(16, 200, 5.0)
    acc.step(42)
    checkpoint.save_pair(opt.output_dir, 3, 2, state, acc.state_dict())
    for name in ("D-3", "G-3"):
        raw = (tmp_path / "o" / "saves" / name).read_bytes()
        assert_same(msgpack.unpackb(raw), serialization.msgpack_restore(raw))
        assert msgpack.packb(msgpack.unpackb(raw)) == raw


@pytest.mark.parametrize("obj,err", [
    ({"t": (1, 2)}, TypeError),                     # flax's strict types: no tuples
    ({1: 2}, TypeError),                            # map keys are str
    ({"t": 2 ** 64}, OverflowError),
    ({"t": np.zeros(2, dtype=[("a", "f4")])}, ValueError),
    ({"t": 1j}, TypeError),                         # ext 2 is outside the subset
])
def test_encoding_outside_the_subset_raises(obj, err):
    with pytest.raises(err):
        msgpack.packb(obj)


def test_a_leaf_flax_would_chunk_raises(monkeypatch):
    monkeypatch.setattr(msgpack, "MAX_LEAF_BYTES", 1000)
    msgpack.packb({"a": np.zeros(250, np.float32)})
    with pytest.raises(ValueError, match="chunk"):
        msgpack.packb({"a": np.zeros(251, np.float32)})


@pytest.mark.parametrize("data,match", [
    (serialization.msgpack_serialize({"a": np.zeros(3, np.float32)})[:-2], "truncated"),
    (serialization.msgpack_serialize({"a": 1}) + b"\x00", "trailing"),
    (b"\xd4\x02\x00", "ext type 2"),                # native complex
    (b"\xc1", "outside the subset"),                # the never-used type byte
])
def test_decoding_bad_data_raises(data, match):
    with pytest.raises(ValueError, match=match):
        msgpack.unpackb(data)


def test_bfloat16_leaf_raises():
    import jax.numpy as jnp

    raw = serialization.msgpack_serialize({"a": np.asarray(jnp.ones(3, jnp.bfloat16))})
    with pytest.raises(ValueError, match="bfloat16"):
        msgpack.unpackb(raw)
