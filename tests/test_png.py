"""The standard-library PNG codec (io/png.py) and PNG loading in data/views.

Filtered inputs are built here by an independent pure-Python encoder (the
PNG specification's filter definitions, row by row), so the decoder's
vectorised unfiltering is checked against a plain reference of the format.
"""

import struct
import zlib

import numpy as np
import pytest

from orthosfm_tpu.data import views as views_mod
from orthosfm_tpu.io import png


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _filter_row(ftype, row, prev, bpp):
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype]
        out[i] = (x - pred) & 0xFF
    return bytes(out)


def _encode_with_filters(img, filters):
    """PNG bytes of `img` (H, W[, C]) uint8 with row y filtered by
    filters[y % len(filters)]."""
    a = img if img.ndim == 3 else img[..., None]
    h, w, c = a.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    raw, prev = bytearray(), bytes(w * c)
    for y in range(h):
        row = a[y].tobytes()
        f = filters[y % len(filters)]
        raw += bytes([f]) + _filter_row(f, row, prev, c)
        prev = row

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (png.SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


def _smooth_image(shape, seed=0):
    """Smooth gradients plus noise: every filter type has real work."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    y, x = np.mgrid[0:h, 0:w]
    base = (40 * np.sin(x / 5.0) + 30 * np.cos(y / 7.0) + 128)[..., None]
    c = shape[2] if len(shape) == 3 else 1
    img = base + 25 * rng.normal(size=(h, w, c))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img if len(shape) == 3 else img[..., 0]


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (9, 5, 2), (6, 11, 3),
                                   (5, 3, 4)])
def test_png_roundtrip(shape, tmp_path):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    png.write_png(path, img)
    out = png.read_png(path)
    assert out.dtype == np.uint8 and out.shape == img.shape
    np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_decodes_each_filter(ftype):
    img = _smooth_image((12, 17, 3), seed=ftype)
    out = png.decode(_encode_with_filters(img, [ftype]))
    np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("shape", [(15, 9), (10, 7, 2), (11, 6, 4)])
def test_png_decodes_mixed_filters(shape):
    """Every row a different filter, in every colour type."""
    img = _smooth_image(shape, seed=3)
    out = png.decode(_encode_with_filters(img, [4, 3, 1, 0, 2, 3, 4]))
    np.testing.assert_array_equal(out, img)


def test_png_rejects_unsupported():
    good = png.encode(np.zeros((2, 2), np.uint8))
    with pytest.raises(ValueError):
        png.decode(b"not a png")
    # 16-bit depth in IHDR (CRC recomputed so only the variant is wrong)
    body = struct.pack(">IIBBBBB", 2, 2, 16, 0, 0, 0, 0)
    bad = (png.SIGNATURE + struct.pack(">I", 13) + b"IHDR" + body
           + struct.pack(">I", zlib.crc32(b"IHDR" + body)) + good[33:])
    with pytest.raises(ValueError, match="unsupported"):
        png.decode(bad)
    corrupt = bytearray(good)
    corrupt[30] ^= 0xFF  # a byte of the IHDR CRC
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(corrupt))
    with pytest.raises(ValueError):
        png.encode(np.zeros((2, 2), np.float32))


def test_view_loads_png_like_pillow_convert(tmp_path):
    """Gray → RGB replicates, alpha is dropped, an RGB mask becomes luma with
    Pillow's integer ITU-R 601-2 weights — what convert("RGB"/"L") gives."""
    gray = _smooth_image((9, 8), seed=5)
    png.write_png(str(tmp_path / "a.png"), gray)
    rgba = _smooth_image((9, 8, 4), seed=6)
    png.write_png(str(tmp_path / "b.png"), rgba)
    mask_rgb = _smooth_image((9, 8, 3), seed=7)
    png.write_png(str(tmp_path / "b_mask.png"), mask_rgb)

    va = views_mod.View(0, str(tmp_path / "a.png"))
    va.load_pixel_data()
    np.testing.assert_array_equal(va.pixels, np.repeat(gray[..., None], 3, -1))
    assert (va.width, va.height) == (8, 9)

    vb = views_mod.View(1, str(tmp_path / "b.png"))
    vb.find_corresponding_mask(str(tmp_path))
    vb.load_pixel_data()
    np.testing.assert_array_equal(vb.pixels, rgba[..., :3])
    r, g, b = (mask_rgb[..., i].astype(np.int64) for i in range(3))
    luma = (r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16
    np.testing.assert_array_equal(vb.mask, luma.astype(np.uint8))
