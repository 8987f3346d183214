"""PNG reading and 8-bit PNG writing with zlib and numpy (no cv2: the card
has none). Reads non-interlaced gray, gray + alpha, RGB, RGBA and palette
images with every scanline filter, as ``cv2.imread(path, IMREAD_COLOR)``
gives them (in RGB order): the alpha dropped, a palette expanded through
``PLTE`` (``tRNS`` ignored), 16-bit samples taken to 8 bits by their high
byte, gray of 1, 2 or 4 bits scaled to 0-255. Writes gray or RGB with
filter 0.

Unfiltering: rows of filters None, Sub and Up decode a row at a time.
Average and Paeth make each byte depend on the byte one pixel to its left
in its own row, so an image holding such rows is decoded along
anti-diagonals instead: pixel (y, x) needs only (y, x-1), (y-1, x) and
(y-1, x-1), so every pixel with y + x = t decodes in one vector step, each
by its own row's filter: h + w - 1 steps instead of h·w. An image
without such rows keeps the row path, some 20x quicker on it
(``tests/test_torch_cv_png.py`` holds it to 4x).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


# each filter's predictor from the left (a), upper (b) and upper-left (c)
# bytes of the same channel
_PREDICT = {0: lambda a, b, c: 0, 1: lambda a, b, c: a, 2: lambda a, b, c: b,
            3: lambda a, b, c: (a + b) >> 1, 4: _paeth}


def _unfilter_rows(lines: np.ndarray, filters: np.ndarray, bpp: int
                   ) -> np.ndarray:
    """Filters 0-2 only: one row at a time."""
    h, stride = lines.shape
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        line = lines[y].astype(np.int32)
        f = filters[y]
        if f == 0:
            cur = line
        elif f == 2:
            cur = (line + prev) & 255
        else:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
        out[y] = cur
        prev = cur
    return out


def _unfilter_diagonal(lines: np.ndarray, filters: np.ndarray, bpp: int
                       ) -> np.ndarray:
    """Every filter, one anti-diagonal of pixels (bpp bytes each) a step."""
    h, stride = lines.shape
    w = stride // bpp
    raw = lines.reshape(h * w, bpp).astype(np.int16)
    # decoded pixels with one zero row above and one zero pixel left of
    # each row, flat: pixel (y, x) at (y + 1)·(w + 1) + x + 1
    out = np.zeros(((h + 1) * (w + 1), bpp), np.int16)
    kinds = sorted(set(int(f) for f in filters))
    for t in range(h + w - 1):
        ys = np.arange(max(0, t - w + 1), min(h - 1, t) + 1)
        xs = t - ys
        at = (ys + 1) * (w + 1) + xs + 1
        a, b, c = out[at - 1], out[at - w - 1], out[at - w - 2]
        f = filters[ys][:, None]
        pred = 0
        for k in kinds:
            p = _PREDICT[k](a, b, c)
            pred = p if len(kinds) == 1 else np.where(f == k, p, pred)
        out[at] = (raw[ys * w + xs] + pred) & 255
    return out.reshape(h + 1, w + 1, bpp)[1:, 1:].reshape(h, stride).astype(
        np.uint8)


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """(h, stride) uint8 scanlines from the decompressed stream; ``bpp``
    the bytes a pixel (at least 1) that Sub, Average and Paeth step by."""
    rows = np.frombuffer(raw, np.uint8)[:h * (stride + 1)].reshape(
        h, stride + 1)
    filters, lines = rows[:, 0], rows[:, 1:]
    if filters.max(initial=0) > 4:
        raise ValueError(f"PNG filter type {int(filters.max())}")
    if (filters >= 3).any():
        return _unfilter_diagonal(lines, filters, bpp)
    return _unfilter_rows(lines, filters, bpp)


def _unpack_bits(rows: np.ndarray, w: int, depth: int) -> np.ndarray:
    """(h, w) samples of 1, 2 or 4 bits, most significant first."""
    bits = np.unpackbits(rows, axis=1)
    h = rows.shape[0]
    bits = bits[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """(H, W, C) uint8: C 1 for gray, 3 for RGB and palette images (alpha
    dropped, 16-bit samples by their high byte)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIG):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr, plte = 8, [], None, None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    if interlace or ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"{path}: PNG of depth {depth}, color type {ctype}, "
                         f"interlace {interlace} is not read here")
    ch = _CHANNELS[ctype]
    stride = (w * ch * depth + 7) // 8
    bpp = max(1, ch * depth // 8)
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, stride, bpp)
    if depth < 8:
        img = _unpack_bits(rows, w, depth)[..., None]
        if ctype == 0:
            img = (img.astype(np.uint16) * 255 // ((1 << depth) - 1)
                   ).astype(np.uint8)
    elif depth == 16:
        img = rows.reshape(h, w, ch, 2)[..., 0]        # the high byte
    else:
        img = rows.reshape(h, w, ch)
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{path}: palette image without PLTE")
        return plte[img[..., 0]]
    return img[..., :1] if ctype in (0, 4) else img[..., :3]


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W), (H, W, 1) or (H, W, 3) uint8."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 3: 2}[c]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)
    with open(path, "wb") as f:
        f.write(_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                                  0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
