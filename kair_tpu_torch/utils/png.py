"""8-bit PNG reading and writing with zlib and numpy (no cv2: the card has
none). Reads non-interlaced gray, gray + alpha, RGB and RGBA images of bit
depth 8 (the alpha dropped) with every scanline filter; writes gray or RGB
with filter 0.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter(raw: bytes, h: int, w: int, c: int) -> np.ndarray:
    stride = w * c
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        f, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 2:
            cur = (line + prev) & 255
        elif f == 1:
            cur = np.cumsum(line.reshape(w, c), axis=0).reshape(-1) & 255
        elif f in (3, 4):
            # sequential along the row: one pixel (c channels) at a time
            cur = np.zeros(stride, np.int32)
            zero = np.zeros(c, np.int32)
            for x in range(0, stride, c):
                a = cur[x - c:x] if x else zero
                b = prev[x:x + c]
                if f == 3:
                    pr = (a + b) >> 1
                else:
                    cc = prev[x - c:x] if x else zero
                    pa, pb, pc = np.abs(b - cc), np.abs(a - cc), np.abs(a + b - 2 * cc)
                    pr = np.where((pa <= pb) & (pa <= pc), a,
                                  np.where(pb <= pc, b, cc))
                cur[x:x + c] = (line[x:x + c] + pr) & 255
        else:
            raise ValueError(f"PNG filter type {f}")
        out[y] = cur
        prev = cur
    return out.reshape(h, w, c)


def read_png(path: str) -> np.ndarray:
    """(H, W, C) uint8: C 1 for gray, 3 for RGB (alpha dropped)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIG):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise ValueError(f"{path}: PNG of depth {depth}, color type {ctype}, "
                         f"interlace {interlace} is not read here")
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w, _CHANNELS[ctype])
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
