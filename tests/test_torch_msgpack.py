"""The port's msgpack reader and writer (``mquant_tpu_torch.utils.msgpack``)
against flax's ``msgpack_serialize`` / ``msgpack_restore``.

The writer's bytes must equal flax's for the same tree, and the reader must
give exactly flax's arrays (same dtype, shape and bits; bf16 by its 16-bit
patterns). Chunked arrays are covered with ``MAX_CHUNK_SIZE`` patched small
in both modules, inside each test only.
"""


import jax.numpy as jnp
import msgpack as pymsgpack
import numpy as np
import pytest
import torch
from flax import serialization

from mquant_tpu_torch.utils import msgpack as M


def _tree(seed=0):
    """A tree of the leaves an artifact holds: f32, bf16, int8 and int32
    arrays, 0-d arrays, a None slot and a QuantParams dict, and key lengths
    and map sizes past msgpack's fix forms."""
    rng = np.random.default_rng(seed)
    bf16 = np.asarray(jnp.asarray(rng.normal(size=(3, 5, 4)), jnp.bfloat16))
    return {
        "llm": {"layers": {"q": {"w_q": rng.integers(-128, 128, (2, 8, 6)
                                                     ).astype(np.int8),
                                 "w_scale": rng.random((2, 6)).astype(
                                     np.float32),
                                 "b": {"__none__": np.zeros((0,), np.int8)}},
                           "ln1": {"w": bf16}},
                "embed": {"w": rng.normal(size=(40, 7)).astype(np.float32)}},
        "llm.q": {"act": {"__namedtuple__": "QuantParams",
                          "scale": np.asarray(0.05, np.float32),
                          "zero_point": {"__none__": np.zeros((0,),
                                                              np.int8)}}},
        "idx": rng.integers(-2**31, 2**31, (33,)).astype(np.int32),
        "zero_d": np.asarray(7, np.int32),
        "k" * 40: np.zeros((70000,), np.int8),  # str8 key, bin32 body
        "many": {f"s{i}": np.full((1,), i, np.int8) for i in range(20)},
    }


def _to_torch(tree):
    """The same tree with torch leaves (bf16 through its bits)."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        if tree.dtype.name == "bfloat16":
            return torch.from_numpy(tree.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(tree.copy())
    return tree


def _same(ours, flax_tree, where=""):
    """``ours`` (the port's reader) equals flax's restored tree: keys in
    the same order, leaves bit-equal with the same dtype and shape."""
    if isinstance(flax_tree, dict):
        assert list(ours) == list(flax_tree), where
        for k in flax_tree:
            _same(ours[k], flax_tree[k], f"{where}/{k}")
        return
    if isinstance(flax_tree, (str, bool, int, float, complex)):
        assert ours == flax_tree, where
        return
    ref = np.asarray(flax_tree)
    t = M.to_tensor(ours)
    assert tuple(t.shape) == ref.shape, where
    if ref.dtype.name == "bfloat16":
        assert t.dtype == torch.bfloat16, where
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      ref.view(np.int16), err_msg=where)
    else:
        assert t.numpy().dtype == ref.dtype, where
        np.testing.assert_array_equal(t.numpy(), ref, err_msg=where)


@pytest.fixture
def chunk(request, monkeypatch):
    """MAX_CHUNK_SIZE of both modules, patched inside the test only."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", request.param)
    monkeypatch.setattr(M, "MAX_CHUNK_SIZE", request.param)
    return request.param


@pytest.mark.parametrize("chunk", [2**30, 64, 7], indirect=True)
@pytest.mark.parametrize("leaves", ["numpy", "torch"])
def test_writer_bytes_equal_flax(tmp_path, chunk, leaves):
    tree = _tree()
    ref = serialization.msgpack_serialize(tree)
    path = str(tmp_path / "t.msgpack")
    n = M.dump(tree if leaves == "numpy" else _to_torch(tree), path)
    with open(path, "rb") as f:
        got = f.read()
    assert n == len(got) == len(ref)
    assert got == ref


@pytest.mark.parametrize("chunk", [2**30, 64, 7], indirect=True)
def test_reader_equals_flax(tmp_path, chunk):
    tree = _tree(1)
    path = str(tmp_path / "t.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.msgpack_serialize(tree))
    ours = M.load(path)
    _same(ours, serialization.msgpack_restore(
        serialization.msgpack_serialize(tree)))
    big = ours["llm"]["embed"]["w"]
    assert isinstance(big, M.Chunked) == (40 * 7 * 4 > chunk)


def test_reader_views_the_file(tmp_path):
    """Unchunked leaves are views of one mapping of the file: their data
    lie as far apart in memory as their bytes in the file, and
    ``to_tensor`` on the CPU keeps the view."""
    a = np.arange(1000, dtype=np.int32)
    b = np.arange(500, dtype=np.float32) * 0.5
    path = str(tmp_path / "t.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.msgpack_serialize({"a": a, "b": b}))
    with open(path, "rb") as f:
        raw = f.read()
    tree = M.load(path)
    gap = tree["b"].data_ptr() - tree["a"].data_ptr()
    assert gap == raw.find(b.tobytes()) - raw.find(a.tobytes())
    assert M.to_tensor(tree["a"], "cpu").data_ptr() == tree["a"].data_ptr()
    # a copy-on-write mapping: writing a leaf leaves the file unchanged
    tree["a"][0] = 99
    with open(path, "rb") as f:
        assert f.read() == raw


@pytest.mark.parametrize("value", [
    np.float32(0.5), np.int8(-3), np.float64(2.5), 1 + 2j, True, None, 3.25,
    "x" * 300, b"\x00\x01" * 200, [1, -40, 300, "s", [2.5]],
    np.zeros((0,), np.int8), np.asarray(True), np.ones((2, 3), np.float16),
    np.arange(6, dtype=np.int64).reshape(2, 3),
    np.asarray(jnp.asarray(1.5, jnp.bfloat16)),
])
def test_leaf_kinds_round_trip(tmp_path, value):
    """npscalars (ext 3, numpy float64 included), complex values (ext 2),
    msgpack's own types, 0-d and empty arrays: flax's bytes, and flax's
    values read back."""
    tree = {"v": value}
    ref = serialization.msgpack_serialize(tree)
    path = str(tmp_path / "t.msgpack")
    M.dump(tree, path)
    with open(path, "rb") as f:
        assert f.read() == ref
    ours = M.load(path)["v"]
    want = serialization.msgpack_restore(ref)["v"]
    if isinstance(want, (np.ndarray, np.generic)):
        _same(ours, want)
    elif isinstance(want, list):
        assert ours == want
    else:
        assert ours == want and type(ours) is type(want)


@pytest.mark.parametrize("v", [0, 1, 127, 128, 255, 256, 65535, 65536,
                               2**32 - 1, 2**32, 2**63, -1, -32, -33, -128,
                               -129, -32768, -32769, -2**31, -2**31 - 1,
                               -2**63])
def test_int_encoding_equals_msgpack(v):
    assert M._int(v) == pymsgpack.packb(v)


@pytest.mark.parametrize("n", [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_length_headers_equal_msgpack(n):
    s = "a" * n
    assert M._str(s) == pymsgpack.packb(s)
    b = b"a" * n
    assert M._bin_head(n) + b == pymsgpack.packb(b, use_bin_type=True)
    d = {f"{i:06d}": 0 for i in range(n)}
    assert pymsgpack.packb(d).startswith(M._map_head(n))
    assert pymsgpack.packb([0] * n).startswith(M._array_head(n))


def test_dump_refuses_what_flax_cannot_hold(tmp_path):
    path = str(tmp_path / "t.msgpack")
    with pytest.raises(TypeError):
        M.dump({"t": (1, 2)}, path)  # a tuple (flax's strict types)
    with pytest.raises(TypeError):
        M.dump({1: np.zeros(2)}, path)
    with pytest.raises(ValueError):
        M.dump({"o": np.asarray([object()])}, path)
