"""The port's flax msgpack codec (utils/flax_msgpack.py) against
flax.serialization: the same bytes as the JAX package's export writes
(``to_bytes(jax.device_get(tree))``), and each reads the other's bytes back
to identical arrays (bf16 compared by its bits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from learnablepoolingmethods_torch.utils import flax_msgpack


def _tree():
    """Leaves of every kind an export holds, in unsorted dicts."""
    rng = np.random.default_rng(0)
    return {
        "params": {
            "z_last": rng.standard_normal((3, 4), dtype=np.float32),
            "NetVLAD_0": {
                "cluster_weights": rng.standard_normal((40, 5), dtype=np.float32),
                "steps": np.arange(7, dtype=np.int32),
                "frames": rng.integers(0, 256, (2, 300), dtype=np.uint8),
                "bf16": rng.standard_normal((40, 33)).astype(jnp.bfloat16),
                "scalar": np.asarray(2.5, np.float32),
                "np_scalar": np.float32(-1.25),
                "negative": np.asarray([-1, -40, -200, -70000], np.int64),
            },
            "empty": {},
            "big": rng.standard_normal((300, 70), dtype=np.float32),
        },
        "batch_stats": {},
    }


def _port_tree(tree):
    """The same tree as the port holds it: bf16 as BFloat16Bits."""
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    if getattr(tree, "dtype", None) is not None and tree.dtype.name == "bfloat16":
        return np.asarray(tree).view(np.uint16).view(flax_msgpack.BFloat16Bits)
    return tree


def _assert_same_leaves(got, want):
    assert isinstance(got, dict) == isinstance(want, dict)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _assert_same_leaves(got[key], want[key])
        return
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape
    if want.dtype.name == "bfloat16" or got.dtype.name == "bfloat16":
        np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.fixture
def small_chunks(monkeypatch):
    """Both codecs chunk every array over 1000 bytes (the hidden FC's case
    at full width, 2**30)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1000)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 1000)


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
def test_bytes_equal_flax_export_bytes(request, chunked):
    if chunked:
        request.getfixturevalue("small_chunks")
    tree = _tree()
    want = serialization.to_bytes(jax.device_get(tree))
    for port_tree in (tree, _port_tree(tree)):  # ml_dtypes bf16 and its bits
        assert flax_msgpack.to_bytes(port_tree) == want
    if chunked:
        restored = serialization.msgpack_restore(want)
        assert restored["params"]["big"].shape == (300, 70)


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
def test_each_reads_the_others_bytes(request, chunked):
    if chunked:
        request.getfixturevalue("small_chunks")
    tree = _tree()
    want = jax.device_get(tree)
    _assert_same_leaves(serialization.msgpack_restore(flax_msgpack.to_bytes(_port_tree(tree))), want)
    got = flax_msgpack.from_bytes(serialization.to_bytes(tree))
    _assert_same_leaves(got, want)
    assert isinstance(got["params"]["NetVLAD_0"]["bf16"], flax_msgpack.BFloat16Bits)
    # flax writes a NumPy scalar without device_get as extension type 3
    assert got["params"]["NetVLAD_0"]["np_scalar"] == np.float32(-1.25)


def test_file_round_trip_keeps_bf16_and_is_writable(tmp_path):
    tree = _port_tree(_tree())
    path = tmp_path / "params.msgpack"
    with open(path, "wb") as f:
        flax_msgpack.dump(tree, f)
    back = flax_msgpack.load(str(path))
    _assert_same_leaves(back, tree)
    bf = back["params"]["NetVLAD_0"]["bf16"]
    assert isinstance(bf, flax_msgpack.BFloat16Bits) and bf.flags.writeable
    assert flax_msgpack.to_bytes(back) == flax_msgpack.to_bytes(tree)


def test_smallest_encodings_at_their_edges():
    """Lengths and integers at each width's edge, as msgpack packs them."""
    import msgpack

    for obj in (0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -128, -129, -32769, -2 ** 31 - 1,
                "a" * 31, "a" * 32, "a" * 256, "a" * 65536, 1.5, True, False, None):
        assert flax_msgpack.to_bytes(obj) == msgpack.packb(obj, use_bin_type=True), obj
        assert flax_msgpack.from_bytes(msgpack.packb(obj, use_bin_type=True)) == obj
    for n in (15, 16, 65536):
        tree = {f"k{i:05d}": np.zeros((), np.int8) for i in range(n)}
        assert flax_msgpack.to_bytes(tree) == serialization.to_bytes(jax.device_get(tree))
    for size in (0, 1, 2, 4, 16, 200, 300, 70000):  # fixext, ext8/16/32 and bin8/16/32
        tree = {"a": np.arange(size, dtype=np.uint8)}
        assert flax_msgpack.to_bytes(tree) == serialization.to_bytes(tree), size


def test_truncated_or_trailing_bytes_raise():
    data = flax_msgpack.to_bytes({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.from_bytes(data[:-1])
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.from_bytes(data + b"\x00")
