"""The port's safetensors codec (``utils/safetensors.py``) against the
``safetensors`` package, and its interop (``utils/checkpoint.py``'s
``export_safetensors`` / ``import_safetensors``) against the JAX package's.

* Codec: the port's file is byte-equal to ``safetensors.numpy.save_file``'s
  for every dtype the format names here (F64 … BOOL, empty and 0-d tensors,
  with and without metadata), and the port reads the package's files bit
  for bit (BF16 as torch.bfloat16, never widened).
* Interop: the port's ``export_safetensors`` of a params + state tree is
  byte-equal to JAX's on the same tree; each package imports the other's
  file leaf for leaf, QuantParams / ObserverStats and None slots included.

The package writes the metadata from a Rust HashMap, whose order changes
from one process to the next: with two or more metadata keys its own files
differ run to run in that order alone. The port sorts the keys. Such files
are held equal byte for byte outside the metadata object and equal as
parsed JSON inside it (:func:`_same_file`); with none or one key, byte for
byte.
"""

import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import load_file as np_load
from safetensors.numpy import save_file as np_save

from mquant_tpu.core.quant import QuantParams as JQP
from mquant_tpu.observe.observers import ObserverStats as JOS
from mquant_tpu.utils import checkpoint as JC
from mquant_tpu_torch import interop
from mquant_tpu_torch.core.quant import QuantParams as TQP
from mquant_tpu_torch.observe.observers import ObserverStats as TOS
from mquant_tpu_torch.utils import checkpoint as TC
from mquant_tpu_torch.utils import safetensors as ST

DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
          "BF16": ml_dtypes.bfloat16, "I64": np.int64, "I32": np.int32,
          "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def _arrays(seed):
    rng = np.random.default_rng(seed)
    out = {}
    for i, (name, dt) in enumerate(DTYPES.items()):
        shape = [(3, 5), (7,), (2, 3, 4), ()][i % 4]
        if dt is np.bool_:
            a = rng.random(shape) > 0.5
        elif np.issubdtype(dt, np.integer):
            info = np.iinfo(dt)
            a = rng.integers(info.min, info.max, shape, endpoint=True,
                             dtype=dt)
        else:
            a = (rng.normal(size=shape) * 100).astype(dt)
        # names that interleave the dtype order
        out[f"{chr(ord('z') - i)}.{name.lower()}"] = np.asarray(a)
    out["empty.f32"] = np.zeros((0, 4), np.float32)
    out["empty.i8"] = np.zeros((3, 0), np.int8)
    return out


def _to_t(a):
    return interop.array_to_torch(a, "cpu")


def _same_file(a: str, b: str):
    """Byte-equal, or (two or more metadata keys) byte-equal but for the
    metadata's key order: the same header length, the same parsed header,
    the same data."""
    ba, bb = open(a, "rb").read(), open(b, "rb").read()
    start, head = ST.read_header(a)
    if len(head.get("__metadata__") or {}) <= 1:
        assert ba == bb
        return
    assert len(ba) == len(bb) and ba[:8] == bb[:8]
    assert ST.read_header(b) == (start, head)
    assert ba[start:] == bb[start:]


@pytest.mark.parametrize("meta", [
    None, {"mquant_structure": '{"": "dict", "a/b": "none"}'},
    {"k": "v", "a": 'q"uo\\te', "mquant_structure": '{"": "dict"}',
     "z": "é\n"}], ids=["no-meta", "one-key", "meta"])
def test_bytes_equal_package(tmp_path, meta):
    arrs = _arrays(0)
    np_save(arrs, str(tmp_path / "pkg.st"), metadata=meta)
    n = ST.save_file({k: _to_t(v) for k, v in arrs.items()},
                     str(tmp_path / "port.st"), metadata=meta)
    _same_file(str(tmp_path / "pkg.st"), str(tmp_path / "port.st"))
    assert n == os.path.getsize(tmp_path / "pkg.st")


@pytest.mark.parametrize("name", list(DTYPES))
def test_one_dtype_bytes_equal(tmp_path, name):
    """One tensor of each dtype alone (the header's padding at each
    length)."""
    a = _arrays(1)
    key = next(k for k in a if k.endswith("." + name.lower()))
    np_save({key: a[key]}, str(tmp_path / "pkg.st"))
    ST.save_file({key: _to_t(a[key])}, str(tmp_path / "port.st"))
    assert (tmp_path / "port.st").read_bytes() == (
        tmp_path / "pkg.st").read_bytes()


def test_reads_package_files_bit_equal(tmp_path):
    arrs = _arrays(2)
    path = str(tmp_path / "pkg.st")
    np_save(arrs, path, metadata={"x": "1"})
    with ST.SafeOpen(path) as f:
        assert f.metadata() == {"x": "1"}
        assert sorted(f.keys()) == sorted(arrs)
        for k, a in arrs.items():
            t = f.get_tensor(k)
            view = f.get_tensor(k, copy=False)
            assert tuple(t.shape) == a.shape, k
            if a.dtype == ml_dtypes.bfloat16:
                assert t.dtype == torch.bfloat16
                bits = a.view(np.int16)
                np.testing.assert_array_equal(
                    t.view(torch.int16).numpy(), bits)
                np.testing.assert_array_equal(
                    view.view(torch.int16).numpy(), bits)
            else:
                np.testing.assert_array_equal(t.numpy(), a)
                np.testing.assert_array_equal(view.numpy(), a)
    assert set(ST.load_file(path)) == set(arrs)


def _tree(seed, dtype=jnp.bfloat16):
    rng = np.random.default_rng(seed)

    def f(*s):
        return np.asarray(jnp.asarray(rng.normal(size=s), dtype))

    params = {"llm": {"layers": {"q": {"w": f(2, 8, 8), "b": None},
                                 "down": {"w_q": rng.integers(
                                     -8, 8, (2, 8, 8), dtype=np.int8),
                                     "w_scale": np.abs(f(2, 1, 8)).astype(
                                         np.float32), "w_col0": None}},
                      "ln_f": {"w": f(8)}},
              "vit": {"patch_embed": {"w": f(12, 4), "b": f(4)}}}
    state = {"llm.q": {"act": (np.float32(0.5) * np.ones((2,), np.float32),
                               None)},
             "vis.o": {"act": (np.ones((), np.float32),
                               np.zeros((), np.int32))},
             "obs": {"st": (np.zeros((3,), np.float32),
                            np.ones((3,), np.float32),
                            np.asarray(4, np.int32))}}
    return params, state


def _jax(tree):
    """The JAX package's types: jnp leaves, its named tuples."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: (JOS(*(_jax(x) for x in v)) if k == "st"
                    else JQP(*(_jax(x) for x in v)) if k == "act"
                    else _jax(v)) for k, v in tree.items()}
    return jnp.asarray(tree)


def _port(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: (TOS(*(_port(x) for x in v)) if k == "st"
                    else TQP(*(_port(x) for x in v)) if k == "act"
                    else _port(v)) for k, v in tree.items()}
    return _to_t(tree)


def _same(a, b, path=""):
    """a (JAX tree) and b (port tree) equal leaf for leaf, types too."""
    if a is None:
        assert b is None, path
        return
    if isinstance(a, dict):
        # an imported dict is in the file's layout order, in both packages
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
        return
    if isinstance(a, tuple):
        assert type(a).__name__ == type(b).__name__, path
        assert type(b) in (TQP, TOS, JQP, JOS), path
        for x, y, f in zip(a, b, a._fields):
            _same(x, y, f"{path}.{f}")
        return
    a = np.asarray(a)
    bt = b if isinstance(b, torch.Tensor) else None
    if bt is not None:
        b = (bt.view(torch.int16).numpy() if bt.dtype == torch.bfloat16
             else bt.numpy())
        if a.dtype == ml_dtypes.bfloat16:
            a = a.view(np.int16)
    else:
        b = np.asarray(b)
        if b.dtype == ml_dtypes.bfloat16:
            a, b = a.view(np.int16), b.view(np.int16)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("which", ["params", "state"])
def test_export_bytes_equal_jax(tmp_path, which):
    params, state = _tree(3)
    tree = params if which == "params" else state
    extra = {"model": "Qwen2-VL-7B", "n": 3} if which == "params" else None
    JC.export_safetensors(_jax(tree), str(tmp_path / "j.st"),
                          extra_meta=extra)
    n = TC.export_safetensors(_port(tree), str(tmp_path / "t.st"),
                              extra_meta=extra)
    _same_file(str(tmp_path / "j.st"), str(tmp_path / "t.st"))
    assert n == os.path.getsize(tmp_path / "j.st")


@pytest.mark.parametrize("which", ["params", "state"])
def test_each_imports_the_other(tmp_path, which):
    params, state = _tree(4)
    tree = params if which == "params" else state
    jp, tp = str(tmp_path / "j.st"), str(tmp_path / "t.st")
    JC.export_safetensors(_jax(tree), jp, extra_meta={"model": "m"})
    TC.export_safetensors(_port(tree), tp, extra_meta={"model": "m"})
    got_t, md_t = TC.import_safetensors(jp, device="cpu")
    got_j, md_j = JC.import_safetensors(tp)
    assert md_t == md_j == {"model": "m"}
    _same(_jax(tree), got_t)
    _same(got_j, _port(tree))
    # the port reads its own file back to the same tree
    _same(_jax(tree), TC.import_safetensors(tp, device="cpu")[0])
    with safe_open(tp, framework="numpy") as f:
        assert "mquant_structure" in f.metadata()
    assert os.path.getsize(tp) == os.path.getsize(jp)
    assert set(np_load(tp)) == set(np_load(jp))
