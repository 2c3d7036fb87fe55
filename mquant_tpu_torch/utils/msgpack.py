"""Reader and writer of the msgpack tree format of
``flax.serialization.msgpack_serialize`` / ``msgpack_restore``, with no
flax, no ``msgpack`` package and no ``ml_dtypes``.

The format: a msgpack map tree with string keys (sorted at every level, as
flax's copy of the tree through ``jax.tree_util`` leaves them) whose array
leaves are msgpack ext type 1, each holding a packed triple (shape, dtype
name, C-order bytes). A numpy scalar is ext type 3 (the same triple, 0-d), a
Python complex ext type 2 (a packed (real, imag) pair). An array of more
than :data:`MAX_CHUNK_SIZE` bytes is stored as the map
``{"__msgpack_chunked_array__": True, "shape": {"0": d0, …}, "chunks":
{"0": a0, …}}`` of 1-D pieces of at most that size.

:func:`load` maps the file and returns CPU tensors that are views of the
mapping (no copy of the file; bf16 from its 16-bit patterns), chunked arrays
as :class:`Chunked` (their pieces copied once, into the tensor that
:func:`to_tensor` makes where it is asked; an unchunked leaf is copied only
to another device). :func:`dump` streams a tree of
tensors to a file leaf by leaf; its bytes equal flax's for the same tree.
"""

from __future__ import annotations

import mmap
import struct
from typing import Any, BinaryIO, List, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # bytes of the largest unchunked array (flax's)
CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3

_TORCH_DTYPES = {"bool": torch.bool, "uint8": torch.uint8,
                 "int8": torch.int8, "int16": torch.int16,
                 "int32": torch.int32, "int64": torch.int64,
                 "float16": torch.float16, "bfloat16": torch.bfloat16,
                 "float32": torch.float32, "float64": torch.float64,
                 "complex64": torch.complex64,
                 "complex128": torch.complex128}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


class Chunked:
    """A chunked array leaf: its shape, dtype and 1-D pieces (views)."""

    def __init__(self, shape: Tuple[int, ...], pieces: List[torch.Tensor]):
        self.shape = tuple(shape)
        self.pieces = pieces
        self.dtype = pieces[0].dtype

    def to_tensor(self, device="cpu") -> torch.Tensor:
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        flat, lo = out.view(-1), 0
        for p in self.pieces:
            flat[lo:lo + p.numel()].copy_(p)
            lo += p.numel()
        return out


def to_tensor(leaf, device="cpu") -> torch.Tensor:
    """A loaded array leaf as a tensor on ``device``: on the CPU the leaf
    itself (a view of the copy-on-write mapping, safe to write), elsewhere
    one copy to the device; a chunked leaf's pieces joined into a new
    tensor."""
    if isinstance(leaf, Chunked):
        return leaf.to_tensor(device)
    return leaf.to(device)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


class _Reader:
    """msgpack decoding at absolute offsets of one mapping."""

    def __init__(self, mm):
        self.mm, self.buf, self.pos = mm, memoryview(mm), 0

    def _take(self, fmt: str):
        v = struct.unpack_from(fmt, self.buf, self.pos)[0]
        self.pos += struct.calcsize(fmt)
        return v

    def _byte(self) -> int:
        self.pos += 1
        return self.buf[self.pos - 1]

    def obj(self):
        b = self._byte()
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._bytes(b & 0x1F).decode("utf-8")
        if b in _SIMPLE:
            return _SIMPLE[b]
        if b in _NUMS:
            return self._take(_NUMS[b])
        if b in _BIN:
            return self._bytes(self._take(_BIN[b]))
        if b in _STR:
            return self._bytes(self._take(_STR[b])).decode("utf-8")
        if b in _EXT:
            return self._ext(self._take(_EXT[b]))
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self._ext(1 << (b - 0xD4))
        if b in (0xDC, 0xDD):
            n = self._take(">H" if b == 0xDC else ">I")
            return [self.obj() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self._map(self._take(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: unknown type byte {b:#x} at "
                         f"{self.pos - 1}")

    def _bytes(self, n: int) -> bytes:
        self.pos += n
        return bytes(self.buf[self.pos - n:self.pos])

    def _map(self, n: int):
        d = {}
        for _ in range(n):
            k = self.obj()
            d[k] = self.obj()
        if d.get(CHUNKED) is True:
            shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
            pieces = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
            return Chunked(shape, pieces)
        return d

    def _ext(self, n: int):
        code = struct.unpack_from(">b", self.buf, self.pos)[0]
        end = self.pos + 1 + n
        self.pos += 1
        if code == _EXT_COMPLEX:
            re, im = self.obj()
            out = complex(re, im)
        elif code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            if self._byte() != 0x93:
                raise ValueError("msgpack: an array ext is not a triple")
            shape, name = self.obj(), self.obj()
            nbytes = self._take(_BIN[self._byte()])
            out = _array(self.mm, self.pos, nbytes, name, shape)
        else:
            raise ValueError(f"msgpack: ext type {code} is not flax's")
        self.pos = end
        return out


_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
         0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}


def _array(mm, offset: int, nbytes: int, name: str, shape) -> torch.Tensor:
    """A CPU tensor viewing ``nbytes`` of the mapping at ``offset``."""
    if name not in _TORCH_DTYPES:
        raise ValueError(f"msgpack: dtype {name!r} has no torch dtype")
    tdt = _TORCH_DTYPES[name]
    np_dt = np.dtype(np.int16 if tdt == torch.bfloat16 else name)
    a = np.frombuffer(mm, dtype=np_dt, count=nbytes // np_dt.itemsize,
                      offset=offset)
    t = torch.from_numpy(a)
    if tdt == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.reshape(tuple(shape))


def load(path: str) -> Any:
    """The tree in ``path``: dicts in the file's key order, array leaves as
    CPU tensors viewing a copy-on-write mapping of the file (writing to one
    leaves the file as it is) or :class:`Chunked`."""
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    return _Reader(mm).obj()


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


def _uint(n: int, fix, codes) -> bytes:
    """A length header: the fix form ``code | n`` where ``fix`` = (bits,
    code) is given and n < 2^bits, else the narrowest sized form of
    ``codes``."""
    if fix is not None and n < (1 << fix[0]):
        return bytes([fix[1] | n])
    for code, fmt in codes:
        if n < (1 << (8 * struct.calcsize(fmt))):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


def _map_head(n: int) -> bytes:
    return _uint(n, (4, 0x80), ((0xDE, ">H"), (0xDF, ">I")))


def _array_head(n: int) -> bytes:
    return _uint(n, (4, 0x90), ((0xDC, ">H"), (0xDD, ">I")))


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _uint(len(b), (5, 0xA0),
                 ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I"))) + b


def _bin_head(n: int) -> bytes:
    return _uint(n, None, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")))


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                return bytes([code]) + struct.pack(fmt, v)
    for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                           (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
        if v >= low:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"msgpack: integer {v} out of range")


def _ext_head(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _uint(n, None, ((0xC7, ">B"), (0xC8, ">H"),
                                    (0xC9, ">I")))
    return head + struct.pack(">b", code)


def _host_bytes(x) -> Tuple[Tuple[int, ...], str, int, np.ndarray]:
    """(shape, dtype name, item size, flat uint8 view of the C-order bytes)
    of a tensor or numpy array; bf16 through its 16-bit patterns."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        name = _DTYPE_NAMES[t.dtype]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.numpy()
    else:
        a = np.asarray(x)  # (np.ascontiguousarray makes 0-d arrays 1-d)
        a = a if a.flags.c_contiguous else a.copy()
        name = a.dtype.name
        if a.dtype.hasobject or a.dtype.isalignedstruct:
            raise ValueError("msgpack: object and structured dtypes are not "
                             "serializable")
    return tuple(a.shape), name, a.itemsize, a.reshape(-1).view(np.uint8)


def _write_array(f: BinaryIO, shape, name: str, data: np.ndarray,
                 code: int = _EXT_NDARRAY):
    inner = (bytes([0x93]) + _array_head(len(shape))
             + b"".join(_int(d) for d in shape) + _str(name)
             + _bin_head(data.size))
    f.write(_ext_head(code, len(inner) + data.size))
    f.write(inner)
    f.write(memoryview(data))


def _write(f: BinaryIO, x, chunkable: bool):
    """One value. As flax's packer (``strict_types``), a numpy scalar is an
    npscalar ext even where it subclasses float, and only arrays whose
    parent is a dict (or the root) are chunked."""
    if isinstance(x, np.generic):
        shape, name, _, data = _host_bytes(np.asarray(x))
        _write_array(f, shape, name, data, _EXT_NPSCALAR)
    elif isinstance(x, dict):
        f.write(_map_head(len(x)))
        for k in sorted(x):  # flax's copy of the tree sorts every dict
            if not isinstance(k, str):
                raise TypeError(f"msgpack: key {k!r} is not a str")
            f.write(_str(k))
            _write(f, x[k], True)
    elif x is None:
        f.write(b"\xc0")
    elif isinstance(x, bool):
        f.write(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        f.write(_int(x))
    elif isinstance(x, float):
        f.write(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        f.write(_str(x))
    elif isinstance(x, bytes):
        f.write(_bin_head(len(x)) + x)
    elif isinstance(x, list):
        f.write(_array_head(len(x)))
        for v in x:
            _write(f, v, False)
    elif isinstance(x, complex):
        pair = b"\x92\xcb" + struct.pack(">d", x.real) + b"\xcb" \
            + struct.pack(">d", x.imag)
        f.write(_ext_head(_EXT_COMPLEX, len(pair)) + pair)
    elif isinstance(x, (torch.Tensor, np.ndarray)):
        shape, name, item, data = _host_bytes(x)
        if not (chunkable and data.size > MAX_CHUNK_SIZE):
            _write_array(f, shape, name, data)
            return
        step = max(1, int(MAX_CHUNK_SIZE / item)) * item
        starts = range(0, data.size, step)
        f.write(_map_head(3) + _str(CHUNKED) + b"\xc3" + _str("shape")
                + _map_head(len(shape)))
        for i, d in enumerate(shape):
            f.write(_str(str(i)) + _int(d))
        f.write(_str("chunks") + _map_head(len(starts)))
        for i, s in enumerate(starts):
            piece = data[s:s + step]
            f.write(_str(str(i)))
            _write_array(f, (piece.size // item,), name, piece)
    else:
        raise TypeError(f"msgpack: cannot serialize {type(x).__name__}")


def dump(tree: Any, path: str) -> int:
    """Writes ``tree`` (dicts with str keys, lists, None, bool, int, float,
    str, bytes, complex, tensors on any device, numpy arrays and scalars)
    to ``path`` leaf by leaf; returns the bytes written."""
    with open(path, "wb") as f:
        _write(f, tree, True)
        return f.tell()
