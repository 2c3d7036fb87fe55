"""The safetensors format, read and written without the ``safetensors``
package (which the card's machine lacks).

A file is an 8-byte little-endian header length, then the header: compact
JSON with ``__metadata__`` (str → str, keys sorted) first, then each
tensor's ``dtype``, ``shape`` and ``data_offsets`` (begin, end) into the
data that follows, padded with spaces to a multiple of 8 bytes. The tensors
are laid out by dtype, the package's order (U64, I64, F64, F32, U32, I32,
BF16, F16, U16, I16, I8, U8, BOOL), then by name; this writer gives the
package's bytes for the same tensors and metadata.

:func:`save_file` streams: it writes the header, then one tensor at a time,
copying each to the host only as it is written (tensors may live on the
card). :class:`SafeOpen` maps the file and reads one tensor at a time from
the mapping, so a 4-5 GB shard is never read whole into memory; a tensor
can stay a view of the mapping (``copy=False``) until it is moved to the
card.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Iterable, Optional, Tuple

import torch

# the format's dtype names, in the package's layout order
_ORDER = ("U64", "I64", "F64", "F32", "U32", "I32", "BF16", "F16", "U16",
          "I16", "I8", "U8", "BOOL")
_TORCH = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
          "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
          "BOOL": torch.bool}
for _name, _attr in (("U16", "uint16"), ("U32", "uint32"),
                     ("U64", "uint64")):
    if hasattr(torch, _attr):
        _TORCH[_name] = getattr(torch, _attr)
_NAME = {v: k for k, v in _TORCH.items()}
_RANK = {n: i for i, n in enumerate(_ORDER)}


def _header(entries: Iterable[Tuple[str, str, tuple, int]],
            metadata: Optional[Dict[str, str]]) -> Tuple[bytes, list]:
    """(padded header bytes, [(name, begin, end)] in layout order) for
    (name, dtype name, shape, nbytes) entries."""
    entries = sorted(entries, key=lambda e: (_RANK[e[1]], e[0]))
    head: Dict[str, object] = {}
    if metadata:
        head["__metadata__"] = {str(k): str(v)
                                for k, v in sorted(metadata.items())}
    layout, off = [], 0
    for name, dt, shape, nbytes in entries:
        head[name] = {"dtype": dt, "shape": list(shape),
                      "data_offsets": [off, off + nbytes]}
        layout.append((name, off, off + nbytes))
        off += nbytes
    text = json.dumps(head, separators=(",", ":"),
                      ensure_ascii=False).encode()
    text += b" " * (-len(text) % 8)
    return text, layout


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` (any devices) as one safetensors file; returns its
    bytes."""
    entries = []
    for name, t in tensors.items():
        if t.dtype not in _NAME:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors "
                            "name")
        entries.append((name, _NAME[t.dtype], tuple(t.shape),
                        t.numel() * t.element_size()))
    head, layout = _header(entries, metadata)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name, begin, end in layout:
            if end > begin:
                t = tensors[name].detach().reshape(-1).contiguous().cpu()
                f.write(t.view(torch.uint8).numpy())
    return 8 + len(head) + (layout[-1][2] if layout else 0)


def read_header(path: str) -> Tuple[int, Dict]:
    """(data start offset, parsed header) of a safetensors file."""
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        return 8 + n, json.loads(f.read(n))


class SafeOpen:
    """Tensors of one safetensors file, read one at a time from a mapping
    of it (a context manager, like the package's ``safe_open``)."""

    def __init__(self, path: str):
        self.path = path
        self._start, head = read_header(path)
        self._meta = head.pop("__metadata__", None)
        self._entries = head
        size = os.path.getsize(path)
        self._map = None
        if size > self._start:
            with open(path, "rb") as f:
                # copy-on-write: tensors may be views of the mapping without
                # the file being writable through them
                self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self._map = None  # views made with copy=False keep it alive

    def keys(self):
        return list(self._entries)

    def metadata(self) -> Optional[Dict[str, str]]:
        return None if self._meta is None else dict(self._meta)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def get_tensor(self, name: str, device=None, copy: bool = True
                   ) -> torch.Tensor:
        """The tensor ``name`` in its stored dtype: a BF16 tensor is the
        stored 16-bit patterns viewed as torch.bfloat16, never widened. On
        ``device`` if given; else on the host, a copy unless ``copy`` is
        false (then a view of the mapping)."""
        e = self._entries[name]
        dt = _TORCH[e["dtype"]]
        shape = tuple(e["shape"])
        begin, end = e["data_offsets"]
        if end == begin:
            t = torch.empty(shape, dtype=dt)
            return t if device is None else t.to(device)
        off = self._start + begin
        item = torch.empty((), dtype=dt).element_size()
        if off % item:  # a writer that did not align: read the bytes
            raw = torch.frombuffer(self._map, dtype=torch.uint8,
                                   count=end - begin, offset=off).clone()
            t = raw.view(dt)
        elif dt == torch.bfloat16:
            t = torch.frombuffer(self._map, dtype=torch.int16,
                                 count=(end - begin) // 2,
                                 offset=off).view(torch.bfloat16)
        else:
            t = torch.frombuffer(self._map, dtype=dt,
                                 count=(end - begin) // item, offset=off)
        t = t.reshape(shape)
        if device is not None:
            return t.to(device)
        return t.clone() if copy else t


def load_file(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Every tensor of the file on ``device``, in the file's key order."""
    with SafeOpen(path) as f:
        return {k: f.get_tensor(k, device=device) for k in f.keys()}
