"""Standard-library PNG codec (zlib + struct) for 8-bit images.

Reads and writes non-interlaced PNGs with 8 bits per sample in the four
colour types the pipeline meets: gray, gray+alpha, RGB and RGBA. The reader
undoes all five row filters (None, Sub, Up, Average, Paeth); the writer
stores every row unfiltered. Other variants (palette, 16-bit, Adam7
interlacing) raise ValueError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → samples per pixel
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"PNG chunk {ctype!r}: CRC mismatch")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG: missing IEND chunk")


def _unfilter_rows(ftype, F):
    """Rows of filter types 0-2 only: each row is one vector operation."""
    h, w, bpp = F.shape
    out = np.empty_like(F)
    prev = np.zeros((w, bpp), np.uint8)
    for y in range(h):
        f, row = ftype[y], F[y]
        if f == 0:
            cur = row
        elif f == 1:
            cur = np.cumsum(row, axis=0, dtype=np.uint8)  # wraps mod 256
        else:
            cur = row + prev
        out[y] = cur
        prev = cur
    return out


def _predict(f, a, b, c):
    """Filter predictions from the left (a), upper (b) and upper-left (c)
    neighbours; f is one filter type or a column of per-row types."""
    if np.isscalar(f):
        if f == 1:
            return a
        if f == 2:
            return b
        if f == 3:
            return (a + b) >> 1
        if f == 0:
            return 0
    # Paeth: p = a + b - c, so |p - a| = |b - c| and |p - b| = |a - c|
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    if np.isscalar(f):
        return paeth
    return np.choose(f, (np.zeros_like(a), a, b, (a + b) >> 1, paeth))


def _unfilter_wavefront(ftype, F):
    """Any mix of filter types. A pixel depends on its left, upper and
    upper-left neighbours, so every anti-diagonal x + y = d depends only on
    the two before it. The image is skewed so that each anti-diagonal is a
    contiguous column K[d, y] = F[y, d - y]; the walk over d then reads the
    two previous columns by plain slices."""
    h, w, bpp = F.shape
    D = h + w - 1
    Z = np.zeros((h, w + h, bpp), np.uint8)
    Z[:, :w] = F
    s0, s1, s2 = Z.strides
    # Row y of this view starts y pixels later than row y of F, so it holds
    # F[y, d - y] at column d and zeros elsewhere.
    K = np.lib.stride_tricks.as_strided(
        Z, shape=(h, D, bpp), strides=(s0 - s1, s1, s2)).transpose(1, 0, 2)
    K = np.ascontiguousarray(K)
    # R[d + 2, y + 1] = pixel (y, d - y); the two leading columns and the
    # leading row are the zero border; pixels outside the image stay zero.
    R = np.zeros((D + 2, h + 1, bpp), np.int16)
    single = ftype.min() == ftype.max()
    fcol = ftype.astype(np.int16)[:, None]
    for d in range(D):
        lo, hi = max(0, d - w + 1), min(h - 1, d) + 1
        a = R[d + 1, lo + 1:hi + 1]  # left: column d - 1, row y
        b = R[d + 1, lo:hi]  # up: column d - 1, row y - 1
        c = R[d, lo:hi]  # up-left: column d - 2, row y - 1
        f = int(ftype[0]) if single else fcol[lo:hi]
        R[d + 2, lo + 1:hi + 1] = (K[d, lo:hi] + _predict(f, a, b, c)) & 0xFF
    T = np.empty((h, D, bpp), np.uint8)
    T[...] = R[2:, 1:].transpose(1, 0, 2)
    t0, t1, t2 = T.strides
    # Undo the skew: pixel (y, x) sits at T[y, x + y].
    return np.lib.stride_tricks.as_strided(
        T, shape=(h, w, bpp), strides=(t0 + t1, t1, t2)).copy()


def decode(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W) uint8 for gray, else (H, W, C) with C = 2, 3, 4."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    header, idat = None, []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG: missing IHDR chunk")
    w, h, depth, color, comp, filt, interlace = header
    if depth != 8 or color not in _CHANNELS or comp or filt or interlace:
        raise ValueError(
            f"unsupported PNG variant (bit depth {depth}, colour type {color},"
            f" interlace {interlace}): only 8-bit non-interlaced gray, "
            "gray+alpha, RGB and RGBA are read")
    bpp = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError("PNG: image data has the wrong size")
    rows = raw.reshape(h, w * bpp + 1)
    ftype = rows[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown row filter {int(ftype.max())}")
    F = rows[:, 1:].reshape(h, w, bpp)
    if ftype.max(initial=0) <= 2:
        img = _unfilter_rows(ftype, F)
    else:
        img = _unfilter_wavefront(ftype, F)
    return img[..., 0] if bpp == 1 else img


def encode(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W) or (H, W, C) uint8 array, C in 1-4 → PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG encode: need uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"PNG encode: bad image shape {img.shape}")
    h, w, c = img.shape
    rows = np.zeros((h, w * c + 1), np.uint8)  # filter byte 0 = None
    rows[:, 1:] = img.reshape(h, w * c)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def write_png(path: str, img: np.ndarray) -> None:
    data = encode(img)
    with open(path, "wb") as f:
        f.write(data)
