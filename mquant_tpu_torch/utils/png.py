"""A PNG reader and writer with ``zlib`` and numpy only (no PIL: the card's
machine has none). The reader takes 8-bit gray, gray + alpha, RGB and
RGBA images, non-interlaced, with any of the five scanline filters, and
returns RGB as PIL's ``Image.open(...).convert("RGB")`` does (gray
replicated, alpha dropped). Anything else raises ``ValueError`` naming the
format, as does an image above PIL's decompression-bomb limit or image
data that inflates past what its header says. The writer stores RGB with
one filter type for every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type → samples a pixel
_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray + alpha",
                6: "RGBA"}
# PIL's decompression-bomb limit (2 × ``Image.MAX_IMAGE_PIXELS``), checked
# on the header before any image data is inflated
MAX_PIXELS = 2 * 89478485
_MAGIC = ((b"\xff\xd8\xff", "JPEG"), (b"GIF8", "GIF"), (b"BM", "BMP"),
          (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"))


def _format_of(data: bytes) -> str:
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    for magic, name in _MAGIC:
        if data.startswith(magic):
            return name
    return "unknown format"


def _chunks(data: bytes):
    at = len(_SIG)
    while at + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[at:at + 8])
        body = data[at + 8:at + 8 + n]
        if len(body) != n or at + 12 + n > len(data):
            raise ValueError("PNG: truncated chunk")
        crc = struct.unpack(">I", data[at + 8 + n:at + 12 + n])[0]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG: bad CRC in chunk {kind!r}")
        yield kind, body
        at += 12 + n


def _predict(f, a, b, c, kinds=(1, 2, 3, 4)):
    """The predictor (int16) of filter types ``f`` (broadcast against the
    pixels) from the left (a), upper (b) and upper-left (c) neighbours;
    only the types in ``kinds`` are computed (others predict 0)."""
    a, b, c = (t.astype(np.int16) for t in (a, b, c))
    pred = np.zeros(np.broadcast_shapes(np.shape(f), a.shape), np.int16)
    if 4 in kinds:
        da, db = b - c, a - c  # p − a and p − b for p = a + b − c
        pa, pb, pc = np.abs(da), np.abs(db), np.abs(da + db)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        np.copyto(pred, paeth, where=f == 4)
    if 3 in kinds:
        np.copyto(pred, (a + b) >> 1, where=f == 3)
    if 2 in kinds:
        np.copyto(pred, b, where=f == 2)
    if 1 in kinds:
        np.copyto(pred, a, where=f == 1)
    return pred


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """The (h, w, bpp) samples of ``h`` filtered scanlines. A pixel depends
    on its left, upper and upper-left neighbours, so the pixels of one
    anti-diagonal x + y = d are independent: the loop runs over the
    h + w − 1 diagonals, each a few numpy operations on a contiguous
    slice of a skewed copy (no per-byte Python)."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8, count=h * (stride + 1)).reshape(
        h, stride + 1)
    ft = rows[:, 0].astype(np.int16)
    if (ft > 4).any():
        raise ValueError(f"PNG: unknown filter type {int(ft.max())}")
    line = rows[:, 1:].reshape(h, w, bpp)
    if not ft.any():  # every row unfiltered
        return line.copy()
    kinds = set(ft.tolist()) - {0}
    # skewed, diagonal-major: q[x + y + 2, y + 1] is pixel (x, y), filtered
    # until its diagonal is reached; row 0 and the diagonal before each
    # row's first pixel stay zero (the neighbours outside the image)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    q = np.zeros((w + h + 1, h + 1, bpp), np.uint8)
    q[xs + ys + 2, ys + 1] = line
    f = np.zeros((h + 1, 1), np.int16)
    f[1:, 0] = ft
    for d in range(h + w - 1):
        y0, y1 = max(0, d - w + 1) + 1, min(h - 1, d) + 2  # rows y + 1
        pred = _predict(f[y0:y1], q[d + 1, y0:y1], q[d + 1, y0 - 1:y1 - 1],
                        q[d, y0 - 1:y1 - 1], kinds)
        q[d + 2, y0:y1] += pred.astype(np.uint8)  # mod 256
    return q[xs + ys + 2, ys + 1]


def _inflate(data: bytes, size: int) -> bytes:
    """The first ``size`` bytes of a zlib stream, refusing a stream that
    holds more (nothing is inflated past ``size``)."""
    d = zlib.decompressobj()
    try:
        raw = d.decompress(data, size)
        more = d.decompress(d.unconsumed_tail, 1) if d.unconsumed_tail \
            else b""
    except zlib.error as e:
        raise ValueError(f"PNG: bad image data ({e})") from e
    if more:
        raise ValueError("PNG: more image data than its header says")
    if len(raw) < size:
        raise ValueError("PNG: image data shorter than its header says")
    return raw


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W, 3) uint8 RGB. Raises ``ValueError`` naming the
    format of anything it does not read."""
    if not data.startswith(_SIG):
        raise ValueError(f"not a PNG image ({_format_of(data)})")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG: no IHDR or IDAT chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS:
        raise ValueError(f"unsupported PNG: {depth}-bit "
                         f"{_COLOR_NAMES.get(color, f'color type {color}')}"
                         " (8-bit gray, gray + alpha, RGB, RGBA only)")
    if interlace:
        raise ValueError("unsupported PNG: interlaced (Adam7)")
    if w * h > MAX_PIXELS:
        raise ValueError(f"PNG: {w}x{h} pixels exceed the limit of "
                         f"{MAX_PIXELS}")
    ch = _CHANNELS[color]
    px = _unfilter(_inflate(b"".join(idat), h * (w * ch + 1)), h, w, ch)
    if ch <= 2:  # gray (+ alpha): replicate the gray sample
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def encode_png(rgb: np.ndarray, filter_type: int = 0) -> bytes:
    """(H, W, 3) uint8 → PNG bytes: RGB, 8-bit, every row with
    ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w, _ = rgb.shape

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    px = np.zeros((h + 1, w + 1, 3), np.int16)
    px[1:, 1:] = np.asarray(rgb, np.uint8)
    pred = _predict(np.int16(filter_type), px[1:, :-1], px[:-1, 1:],
                    px[:-1, :-1])
    rows = np.concatenate([np.full((h, 1), filter_type, np.uint8),
                           ((px[1:, 1:] - pred) & 0xFF).astype(
                               np.uint8).reshape(h, w * 3)], 1)
    return (_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))
