"""SURF feature detection in JAX (64-d descriptors).

Replacement for MVE's SURF (src/mve/sfm/surf.{h,cc}), part of the reference's
FEATURE_ALL default (matching_mve.cpp:333). Algorithm follows MVE exactly:
integral-image box-filter Hessian responses with filter sizes 3·fs for
fs ∈ kernel_sizes[octave][sample] (surf.cc:28-34), det(H) = Dxx·Dyy − 0.912·Dxy²
(surf.cc:160-213), strict 3×3×3 non-maximum suppression on the two middle
samples (surf.cc:310-375), single-step 3×3×3 quadratic localization with
|offset| ≤ 0.5 and contrast ≥ 500 (surf.cc:356-475), sliding-window Haar
orientation (surf.cc:519-617) and the 4×4 × (Σdx, Σdy, Σ|dx|, Σ|dy|)
descriptor with σ = 3.3s weighting (surf.cc:663-733).

Array design notes: the summed-area table is int32 (exact for ≤8 MP byte
images — the reference caps at 6 MP); response maps are shifted-slice
differences of the SAT (no scatter/loops); keypoints are fixed-capacity
top-k; orientation/descriptor stages are vmapped SAT gathers.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

KERNEL_SIZES = np.array([
    [3, 5, 7, 9],
    [5, 9, 13, 17],
    [9, 17, 25, 33],
    [17, 33, 49, 65],
])
CONTRAST_THRESHOLD = 500.0
HESSIAN_WEIGHT = 0.912
N_OCTAVES = 4


class SurfFeatures(NamedTuple):
    """Metadata host numpy; desc device-resident (see sift.Features)."""

    xy: "np.ndarray"  # (K, 2) input-image pixels
    scale: "np.ndarray"  # (K,)
    orientation: "np.ndarray"  # (K,)
    desc: jnp.ndarray  # (K, 64) device
    valid: "np.ndarray"  # (K,)


def _cumsum_exact_last(x_i32, block: int, max_val: int):
    """Inclusive int32 cumsum along the last axis via blocked triangular
    matmuls.

    The blocked form does an in-block inclusive cumsum as one
    (..., nb, B)·(B, B) upper-triangular matmul (f32 exact: `block` is
    chosen so block·max_val < 2²⁴, so every partial sum is an
    exactly-representable integer) plus a tiny inter-block carry cumsum —
    bit-identical to jnp.cumsum. It replaces a sequential scan over the
    2048-wide axis; whether the scan or this form is faster on a given
    device is a measurement, not a given. The product is asked for at
    HIGHEST precision explicitly: exactness needs full float32 operands,
    and a TF32 pass (10-bit mantissa) would round the partial sums."""
    assert block * max_val < (1 << 24), "f32 matmul would round"
    n = x_i32.shape[-1]
    nb = -(-n // block)
    pad = nb * block - n
    xp = jnp.pad(x_i32, [(0, 0)] * (x_i32.ndim - 1) + [(0, pad)])
    xb = xp.reshape(*xp.shape[:-1], nb, block).astype(jnp.float32)
    U = jnp.asarray(np.triu(np.ones((block, block), np.float32)))
    inner = jax.lax.dot_general(
        xb, U, (((xb.ndim - 1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32).astype(jnp.int32)
    totals = inner[..., :, -1]
    carry = jnp.cumsum(totals, axis=-1) - totals  # exclusive, (..., nb)
    out = inner + carry[..., :, None]
    return out.reshape(*xp.shape)[..., :n]


def integral_image(gray01):
    """int32 SAT of the byte-scaled image: S[y, x] = Σ_{j≤y, i≤x} img255.

    Pass 1 sums raw bytes (≤255 → block 256 exact); pass 2 sums row
    prefixes (≤255·W → block 32 exact up to W=2048; wider images split
    fine because the bound only involves the BLOCK sum)."""
    img = jnp.round(gray01 * 255.0).astype(jnp.int32)
    s = _cumsum_exact_last(img, 256, 255)
    max2 = 255 * img.shape[-1]
    blk2 = 8
    while blk2 * 2 * max2 < (1 << 24):
        blk2 *= 2
    s = _cumsum_exact_last(jnp.swapaxes(s, -1, -2), blk2, max2)
    return jnp.swapaxes(s, -1, -2)


def _shift(S, dy, dx, step: int = 1):
    """S[y·step+dy, x·step+dx] over the strided output grid, zero-padded out of
    range (valid pixels are interior anyway thanks to the border handling).
    Computing directly on the stride-decimated grid avoids 4^octave wasted
    work in the higher octaves."""
    H, W = S.shape
    oh = (H + step - 1) // step
    ow = (W + step - 1) // step
    pad = jnp.pad(S, ((abs(dy), abs(dy) + step), (abs(dx), abs(dx) + step)))
    return jax.lax.slice(pad, (abs(dy) + dy, abs(dx) + dx),
                         (abs(dy) + dy + (oh - 1) * step + 1,
                          abs(dx) + dx + (ow - 1) * step + 1),
                         (step, step))


def _response_map(S, fs: int, step: int):
    """det(H) response map at one (octave, sample): exact transcription of
    filter_dxx/dyy/dxy (surf.cc:218-305) as shifted-slice arithmetic."""
    fs2 = fs // 2
    H, W = S.shape

    def at(dy, dx):
        return _shift(S, dy, dx, step)

    # filter_dxx: rows y−fs, y+fs−1; cols x−fs−fs2−1 + {0, fs, 2fs, 3fs}
    c0 = -fs - fs2 - 1
    v0 = at(-fs, c0); v1 = at(-fs, c0 + fs); v2 = at(-fs, c0 + 2 * fs); v3 = at(-fs, c0 + 3 * fs)
    r2 = fs - 1
    v4 = at(r2, c0); v5 = at(r2, c0 + fs); v6 = at(r2, c0 + 2 * fs); v7 = at(r2, c0 + 3 * fs)
    dxx = (v5 + v0 - v4 - v1) - 2 * (v6 + v1 - v5 - v2) + (v7 + v2 - v6 - v3)

    # filter_dyy (transposed pattern): rows y−fs−fs2−1 + {0, fs, 2fs, 3fs};
    # cols x−fs, x+fs−1
    r0 = -fs - fs2 - 1
    w0 = at(r0, -fs); w1 = at(r0 + fs, -fs); w2 = at(r0 + 2 * fs, -fs); w3 = at(r0 + 3 * fs, -fs)
    cc = fs - 1
    w4 = at(r0, cc); w5 = at(r0 + fs, cc); w6 = at(r0 + 2 * fs, cc); w7 = at(r0 + 3 * fs, cc)
    dyy = (w5 + w0 - w1 - w4) - 2 * (w6 + w1 - w2 - w5) + (w7 + w2 - w3 - w6)

    # filter_dxy: four signed fs×fs boxes around the center
    def box(y0, x0, y1, x1):
        return at(y1, x1) + at(y0, x0) - at(y0, x1) - at(y1, x0)

    a = -fs - 1
    dxy = (box(a, a, a + fs, a + fs)
           - box(a, 0, a + fs, fs)
           - box(0, a, fs, a + fs)
           + box(0, 0, fs, fs))

    inv_karea = 1.0 / (fs * (2 * fs - 1))
    dxx_t = dxx.astype(jnp.float32) * inv_karea
    dyy_t = dyy.astype(jnp.float32) * inv_karea
    dxy_t = dxy.astype(jnp.float32) * inv_karea
    resp = dxx_t * dyy_t - HESSIAN_WEIGHT * dxy_t * dxy_t

    # Zero the border (surf.cc:191-199); coordinates are full-res x = step·i
    border = fs + fs2 + 1
    yy = jnp.arange(resp.shape[0])[:, None] * step
    xx = jnp.arange(resp.shape[1])[None, :] * step
    ok = (xx >= border) & (xx + border < W) & (yy >= border) & (yy + border < H)
    return jnp.where(ok, resp, 0.0)


def _octave_responses(S, o: int):
    step = 2**o
    return jnp.stack([_response_map(S, int(KERNEL_SIZES[o][k]), step)
                      for k in range(4)])


def _detect_octave(resp, cap: int):
    """Strict NMS over the two middle samples (surf.cc:310-343). resp: (4, h, w)."""
    h, w = resp.shape[1:]
    results = []
    for s in (1, 2):
        center = resp[s]
        ok = jnp.ones((h, w), bool)
        for l in (s - 1, s, s + 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if l == s and dy == 0 and dx == 0:
                        continue
                    ok = ok & (jnp.roll(resp[l], (-dy, -dx), (0, 1)) < center)
        interior = jnp.zeros((h, w), bool).at[1:-1, 1:-1].set(True)
        results.append(ok & interior)
    mask = jnp.stack(results)  # (2, h, w)
    vals = jnp.stack([resp[1], resp[2]])
    score = jnp.where(mask, vals, -jnp.inf).reshape(-1)
    k = min(cap, score.shape[0])
    top, idx = jax.lax.top_k(score, k)
    if k < cap:
        top = jnp.pad(top, (0, cap - k), constant_values=-jnp.inf)
        idx = jnp.pad(idx, (0, cap - k))
    valid = jnp.isfinite(top) & (top > 0)
    s_idx = idx // (h * w) + 1
    rem = idx % (h * w)
    return s_idx, rem // w, rem % w, valid


def _localize_octave(resp, s, y, x, valid, o: int):
    """Single-iteration 3×3×3 quadratic localization (surf.cc:356-475),
    vectorized over keypoints: one gather per stencil tap + a closed-form
    closed-form cofactor solve (no per-keypoint LU)."""
    S4, h, w = resp.shape
    iy = jnp.clip(y, 1, h - 2)
    ix = jnp.clip(x, 1, w - 2)
    flat = resp.reshape(-1)

    def at(ds, dy, dx):
        return flat[((s + ds) * h + iy + dy) * w + ix + dx]

    gx = 0.5 * (at(0, 0, 1) - at(0, 0, -1))
    gy = 0.5 * (at(0, 1, 0) - at(0, -1, 0))
    gs = 0.5 * (at(1, 0, 0) - at(-1, 0, 0))
    c0 = at(0, 0, 0)
    a = at(0, 0, -1) - 2 * c0 + at(0, 0, 1)   # xx
    e = at(0, -1, 0) - 2 * c0 + at(0, 1, 0)   # yy
    i = at(-1, 0, 0) - 2 * c0 + at(1, 0, 0)   # ss
    b = 0.25 * (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1))  # xy
    c = 0.25 * (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1) + at(-1, 0, -1))  # xs
    f = 0.25 * (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0) + at(-1, -1, 0))  # ys

    A11, A12, A13 = e * i - f * f, -(b * i - f * c), b * f - e * c
    A22, A23 = a * i - c * c, -(a * f - b * c)
    A33 = a * e - b * b
    det = a * A11 + b * A12 + c * A13
    singular = jnp.abs(det) < 1e-5
    inv_det = jnp.where(singular, 0.0, 1.0 / jnp.where(singular, 1.0, det))
    # sol = A⁻¹·b_vec with b_vec = −g (reference vec_b, surf.cc:418-421)
    sx = -(A11 * gx + A12 * gy + A13 * gs) * inv_det
    sy = -(A12 * gx + A22 * gy + A23 * gs) * inv_det
    ss = -(A13 * gx + A23 * gy + A33 * gs) * inv_det
    off_ok = (jnp.maximum(jnp.maximum(jnp.abs(sx), jnp.abs(sy)),
                          jnp.abs(ss)) <= 0.5) & ~singular
    # MVE: dog_value = N9[1][4] - 0.5 * vec_b.dot(vec_x) with vec_b = -g
    value = c0 - 0.5 * (-(gx * sx + gy * sy + gs * ss))
    contrast_ok = value >= CONTRAST_THRESHOLD
    sampling = 2.0**o
    fx = (ix.astype(jnp.float32) + sx) * sampling
    fy = (iy.astype(jnp.float32) + sy) * sampling
    fsamp = s.astype(jnp.float32) + ss
    return fx, fy, fsamp, valid & off_ok & contrast_ok


# Precomputed circular offsets for the orientation window (surf.cc:558-576)
_ORI_OFFSETS = np.array([(rx, ry) for ry in range(-5, 6) for rx in range(-5, 6)
                         if rx * rx + ry * ry < 36])
_ORI_GAUSS = np.exp(-(_ORI_OFFSETS[:, 0] ** 2 + _ORI_OFFSETS[:, 1] ** 2)
                    / (2.0 * 2.5**2))


def _sat_at(S, y, x, vi=None):
    """SAT lookup with clamping; S is (H, W) or, with vi given, (V, H, W) —
    any index shapes broadcast into ONE gather."""
    H, W = S.shape[-2:]
    yc = jnp.clip(y, 0, H - 1)
    xc = jnp.clip(x, 0, W - 1)
    if vi is None:
        return S[yc, xc]
    return S[vi, yc, xc]


def _haar_dx_dy(S, x, y, fs, vi=None):
    """Haar wavelet responses (surf.cc:623-659); x, y, fs traced ints of any
    broadcastable shape (12 batched gathers total, not 12 per sample)."""
    x1 = _sat_at(S, y - fs - 1, x - fs - 1, vi)
    x2 = _sat_at(S, y - fs - 1, x - 1, vi)
    x3 = _sat_at(S, y - fs - 1, x, vi)
    x4 = _sat_at(S, y - fs - 1, x + fs, vi)
    x5 = _sat_at(S, y + fs, x - fs - 1, vi)
    x6 = _sat_at(S, y + fs, x - 1, vi)
    x7 = _sat_at(S, y + fs, x, vi)
    x8 = _sat_at(S, y + fs, x + fs, vi)
    y1 = _sat_at(S, y - 1, x - fs - 1, vi)
    y2 = _sat_at(S, y - 1, x + fs, vi)
    y3 = _sat_at(S, y, x - fs - 1, vi)
    y4 = _sat_at(S, y, x + fs, vi)
    norm = ((2 * fs + 1) * fs * (fs + 1)).astype(jnp.float32)
    dx = ((x8 + x2 - x4 - x6) - (x7 + x1 - x3 - x5)).astype(jnp.float32) / norm
    dy = ((x8 + y1 - x5 - y2) - (y4 + x1 - y3 - x4)).astype(jnp.float32) / norm
    return dx, dy


def _orientation_block(S, vi, kx, ky, scale):
    """Dominant orientation via π/3 sliding windows (surf.cc:519-617),
    vectorized over a flat (C,) keypoint block. S (V, H, W) SAT stack."""
    H, W = S.shape[-2:]
    ix = jnp.floor(kx + 0.5).astype(jnp.int32)[:, None]
    iy = jnp.floor(ky + 0.5).astype(jnp.int32)[:, None]
    s = scale.astype(jnp.int32)[:, None]
    spacing = (8 * s + 1)[:, 0]
    in_bounds = ((ix[:, 0] >= spacing) & (iy[:, 0] >= spacing)
                 & (ix[:, 0] + spacing < W) & (iy[:, 0] + spacing < H))

    offs = jnp.asarray(_ORI_OFFSETS, jnp.int32)  # (109, 2)
    gauss = jnp.asarray(_ORI_GAUSS, jnp.float32)
    px = ix + offs[None, :, 0] * s  # (C, 109)
    py = iy + offs[None, :, 1] * s
    dx, dy = _haar_dx_dy(S, px, py, 2 * s, vi=vi[:, None])
    dx = dx * gauss
    dy = dy * gauss
    ang = jnp.arctan2(dy, dx)  # (C, 109)

    centers = jnp.arange(-np.pi, np.pi, np.pi / 8.0)
    lo = centers - np.pi / 6.0  # (16,)
    hi = centers + np.pi / 6.0
    a = ang[:, :, None]
    inside = (((a > lo) & (a < hi))
              | ((a + 2 * np.pi > lo) & (a + 2 * np.pi < hi))
              | ((a - 2 * np.pi > lo) & (a - 2 * np.pi < hi)))  # (C, 109, 16)
    sx = jnp.sum(jnp.where(inside, dx[:, :, None], 0.0), axis=1)  # (C, 16)
    sy = jnp.sum(jnp.where(inside, dy[:, :, None], 0.0), axis=1)
    lengths = sx * sx + sy * sy
    best = jnp.argmax(lengths, axis=-1)  # (C,)
    bsx = jnp.take_along_axis(sx, best[:, None], 1)[:, 0]
    bsy = jnp.take_along_axis(sy, best[:, None], 1)[:, 0]
    return jnp.arctan2(bsy, bsx), in_bounds


def _descriptor_block(S, vi, kx, ky, scale, ori):
    """64-d SURF descriptor (surf.cc:663-733), vectorized over a flat (C,)
    keypoint block. S (V, H, W) SAT stack."""
    H, W = S.shape[-2:]
    C = kx.shape[0]
    s = scale.astype(jnp.int32)
    spacing = (15 * s + 1).astype(jnp.float32)
    in_bounds = ((kx >= spacing) & (ky >= spacing)
                 & (kx + spacing < W) & (ky + spacing <= H))
    sino, coso = jnp.sin(ori)[:, None, None], jnp.cos(ori)[:, None, None]

    grid = jnp.arange(-10, 10)
    gx, gy = jnp.meshgrid(grid, grid, indexing="xy")  # (20, 20)
    gxf = (gx.astype(jnp.float32) + 0.5)[None]
    gyf = (gy.astype(jnp.float32) + 0.5)[None]
    sf = s.astype(jnp.float32)[:, None, None]
    rot_x = jnp.floor(kx[:, None, None] + (coso * gxf - sino * gyf) * sf
                      + 0.5).astype(jnp.int32)  # (C, 20, 20)
    rot_y = jnp.floor(ky[:, None, None] + (sino * gxf + coso * gyf) * sf
                      + 0.5).astype(jnp.int32)

    dx, dy = _haar_dx_dy(S, rot_x, rot_y, s[:, None, None],
                         vi=vi[:, None, None])
    odx = coso * dx + sino * dy
    ody = -sino * dx + coso * dy
    weight = (jnp.exp(-(gx.astype(jnp.float32) ** 2
                        + gy.astype(jnp.float32) ** 2) / (2.0 * 3.3) ** 2))[None]
    stats = jnp.stack([weight * odx, weight * ody,
                       weight * jnp.abs(odx), weight * jnp.abs(ody)], -1)
    blocks = stats.reshape(C, 4, 5, 4, 5, 4).sum(axis=(2, 4))  # (C, yb, xb, 4)
    d = blocks.reshape(C, 64)
    norm2 = jnp.sum(d * d, axis=-1)
    nonzero = norm2 > 1e-8
    d = d / jnp.sqrt(jnp.maximum(norm2, 1e-12))[:, None]
    return d, in_bounds & nonzero


# ---------------------------------------------------------------------------
# Haar-response-map orientation/descriptor path. The block functions above
# gather 12 SAT corners per Haar sample (6 108 random gathers per keypoint
# across both stages), and random gathers are slow next to contiguous
# slices. Keypoint scales come from a
# STATIC table (KERNEL_SIZES → scale = 0.4·fs, truncated to int), so the
# pipeline buckets keypoints by integer scale and, per scale, precomputes
# full Haar dx/dy maps with shifted SAT slices (elementwise, no gathers) —
# sampling then costs 2 gathers per sample instead of 12. For every
# in-bounds keypoint the values are bit-identical to the gather path (the
# windows guarantee no corner clamping; out-of-bounds keypoints are
# invalidated in both paths).


def _sat_shift(S, dy: int, dx: int):
    """S[..., clip(y+dy, 0, H−1), clip(x+dx, 0, W−1)] via edge-replicate
    pad + slice (matches _sat_at's clamping semantics)."""
    nb = S.ndim - 2
    H, W = S.shape[-2:]
    p = jnp.pad(S, [(0, 0)] * nb + [(max(0, -dy), max(0, dy)),
                                    (max(0, -dx), max(0, dx))], mode="edge")
    p = jax.lax.slice_in_dim(p, max(0, dy), max(0, dy) + H, axis=-2)
    return jax.lax.slice_in_dim(p, max(0, dx), max(0, dx) + W, axis=-1)


def _haar_maps(S, fs: int):
    """Full-image Haar dx/dy response maps for a STATIC filter size fs —
    the map value at (v, y, x) equals _haar_dx_dy(S, x, y, fs) exactly
    (same corner arithmetic, same int32→f32 cast point)."""
    c = {}
    for (dy, dx) in {(-fs - 1, -fs - 1), (-fs - 1, -1), (-fs - 1, 0),
                     (-fs - 1, fs), (fs, -fs - 1), (fs, -1), (fs, 0),
                     (fs, fs), (-1, -fs - 1), (-1, fs), (0, -fs - 1),
                     (0, fs)}:
        c[(dy, dx)] = _sat_shift(S, dy, dx)
    x1, x2, x3, x4 = (c[(-fs - 1, -fs - 1)], c[(-fs - 1, -1)],
                      c[(-fs - 1, 0)], c[(-fs - 1, fs)])
    x5, x6, x7, x8 = (c[(fs, -fs - 1)], c[(fs, -1)], c[(fs, 0)], c[(fs, fs)])
    y1, y2, y3, y4 = (c[(-1, -fs - 1)], c[(-1, fs)], c[(0, -fs - 1)],
                      c[(0, fs)])
    norm = jnp.float32((2 * fs + 1) * fs * (fs + 1))
    dx_m = ((x8 + x2 - x4 - x6) - (x7 + x1 - x3 - x5)).astype(jnp.float32) / norm
    dy_m = ((x8 + y1 - x5 - y2) - (y4 + x1 - y3 - x4)).astype(jnp.float32) / norm
    return dx_m, dy_m


def _map_at(M, vi, y, x):
    H, W = M.shape[-2:]
    return M[vi, jnp.clip(y, 0, H - 1), jnp.clip(x, 0, W - 1)]


def _orientation_block_s(dxo, dyo, vi, kx, ky, s_val: int):
    """_orientation_block with a static integer scale and precomputed
    fs=2s Haar maps (2 gathers per sample instead of 12)."""
    H, W = dxo.shape[-2:]
    ix = jnp.floor(kx + 0.5).astype(jnp.int32)[:, None]
    iy = jnp.floor(ky + 0.5).astype(jnp.int32)[:, None]
    spacing = 8 * s_val + 1
    in_bounds = ((ix[:, 0] >= spacing) & (iy[:, 0] >= spacing)
                 & (ix[:, 0] + spacing < W) & (iy[:, 0] + spacing < H))

    offs = jnp.asarray(_ORI_OFFSETS * s_val, jnp.int32)  # (109, 2)
    gauss = jnp.asarray(_ORI_GAUSS, jnp.float32)
    px = ix + offs[None, :, 0]
    py = iy + offs[None, :, 1]
    vv = vi[:, None]
    dx = _map_at(dxo, vv, py, px) * gauss
    dy = _map_at(dyo, vv, py, px) * gauss
    ang = jnp.arctan2(dy, dx)  # (C, 109)

    centers = jnp.arange(-np.pi, np.pi, np.pi / 8.0)
    lo = centers - np.pi / 6.0
    hi = centers + np.pi / 6.0
    a = ang[:, :, None]
    inside = (((a > lo) & (a < hi))
              | ((a + 2 * np.pi > lo) & (a + 2 * np.pi < hi))
              | ((a - 2 * np.pi > lo) & (a - 2 * np.pi < hi)))
    sx = jnp.sum(jnp.where(inside, dx[:, :, None], 0.0), axis=1)
    sy = jnp.sum(jnp.where(inside, dy[:, :, None], 0.0), axis=1)
    lengths = sx * sx + sy * sy
    best = jnp.argmax(lengths, axis=-1)
    bsx = jnp.take_along_axis(sx, best[:, None], 1)[:, 0]
    bsy = jnp.take_along_axis(sy, best[:, None], 1)[:, 0]
    return jnp.arctan2(bsy, bsx), in_bounds


def _descriptor_block_s(dxd, dyd, vi, kx, ky, s_val: int, ori):
    """_descriptor_block with a static integer scale and precomputed fs=s
    Haar maps."""
    H, W = dxd.shape[-2:]
    C = kx.shape[0]
    spacing = float(15 * s_val + 1)
    in_bounds = ((kx >= spacing) & (ky >= spacing)
                 & (kx + spacing < W) & (ky + spacing <= H))
    sino, coso = jnp.sin(ori)[:, None, None], jnp.cos(ori)[:, None, None]

    grid = jnp.arange(-10, 10)
    gx, gy = jnp.meshgrid(grid, grid, indexing="xy")
    gxf = (gx.astype(jnp.float32) + 0.5)[None]
    gyf = (gy.astype(jnp.float32) + 0.5)[None]
    sf = jnp.float32(s_val)
    rot_x = jnp.floor(kx[:, None, None] + (coso * gxf - sino * gyf) * sf
                      + 0.5).astype(jnp.int32)
    rot_y = jnp.floor(ky[:, None, None] + (sino * gxf + coso * gyf) * sf
                      + 0.5).astype(jnp.int32)
    vv = vi[:, None, None]
    dx = _map_at(dxd, vv, rot_y, rot_x)
    dy = _map_at(dyd, vv, rot_y, rot_x)
    odx = coso * dx + sino * dy
    ody = -sino * dx + coso * dy
    weight = (jnp.exp(-(gx.astype(jnp.float32) ** 2
                        + gy.astype(jnp.float32) ** 2) / (2.0 * 3.3) ** 2))[None]
    stats = jnp.stack([weight * odx, weight * ody,
                       weight * jnp.abs(odx), weight * jnp.abs(ody)], -1)
    blocks = stats.reshape(C, 4, 5, 4, 5, 4).sum(axis=(2, 4))
    d = blocks.reshape(C, 64)
    norm2 = jnp.sum(d * d, axis=-1)
    nonzero = norm2 > 1e-8
    d = d / jnp.sqrt(jnp.maximum(norm2, 1e-12))[:, None]
    return d, in_bounds & nonzero


@functools.partial(jax.jit, static_argnames=("n_slots", "s_val"))
def _ori_desc_flat_s(S, kp, vi_slots, n_slots: int, s_val: int):
    """_ori_desc_flat for one integer-scale bucket: Haar maps for fs=2s
    (orientation) and fs=s (descriptor) are built once with shifted slices,
    then every keypoint samples them with 2 gathers per sample."""
    dxo, dyo = _haar_maps(S, 2 * s_val)
    dxd, dyd = _haar_maps(S, s_val)

    def body(kp_c):
        vi = kp_c[:, 0].astype(jnp.int32)
        kx, ky = kp_c[:, 1], kp_c[:, 2]
        ori, ok1 = _orientation_block_s(dxo, dyo, vi, kx, ky, s_val)
        d, ok2 = _descriptor_block_s(dxd, dyd, vi, kx, ky, s_val, ori)
        return ori, ok1 & ok2, d

    B = kp.shape[0]
    V = S.shape[0]
    chunk = min(_SURF_CHUNK, B)
    ori, ok, desc = jax.lax.map(body, kp.reshape(B // chunk, chunk, 4))
    ori = ori.reshape(B)
    ok = ok.reshape(B)
    desc = jnp.where(ok[:, None], desc.reshape(B, 64), 0.0)
    desc_slots = jnp.zeros((V, n_slots, 64), jnp.float32).at[
        vi_slots[:, 0], vi_slots[:, 1]].set(desc)
    return jnp.stack([ori, ok.astype(jnp.float32)], -1), desc_slots


def _orientation(S, kx, ky, scale, ok):
    """Single-keypoint wrapper around _orientation_block (kept for the unit
    tests; the pipeline uses the flat block path)."""
    ori, ib = _orientation_block(S[None], jnp.zeros((1,), jnp.int32),
                                 kx[None], ky[None], scale[None])
    return ori[0], ok & ib[0]


def _descriptor(S, kx, ky, scale, ori, ok):
    """Single-keypoint wrapper around _descriptor_block (kept for the unit
    tests; the pipeline uses the flat block path)."""
    d, ib = _descriptor_block(S[None], jnp.zeros((1,), jnp.int32),
                              kx[None], ky[None], scale[None], ori[None])
    return d[0], ok & ib[0]


def _octave_cap(per_octave_cap: int, h: int, w: int, o: int) -> int:
    """Static per-octave keypoint capacity, shrunk with the octave's response
    sample count (NMS maxima get sparser as the stride grows)."""
    return max(128, min(per_octave_cap, (h * w) >> (2 * o + 6)))


@functools.partial(jax.jit, static_argnames=("per_octave_cap",))
def _detect_surf_batch(grays, per_octave_cap: int):
    """SAT + responses + NMS + localization for all octaves over a (V, H, W)
    stack. Returns (S (V, H, W) SAT stack, kp (V, ΣcapO, 4) packed
    [x, y, scale, valid] — ONE host pull)."""
    H, W = grays.shape[1:]

    def one(gray01):
        S = integral_image(gray01)
        kps = []
        for o in range(N_OCTAVES):
            cap = _octave_cap(per_octave_cap, H, W, o)
            resp = _octave_responses(S, o)
            s_idx, yy, xx, valid = _detect_octave(resp, cap)
            fx, fy, fsamp, valid = _localize_octave(resp, s_idx, yy, xx,
                                                    valid, o)
            samp_round = jnp.clip(jnp.floor(fsamp + 0.5).astype(jnp.int32),
                                  0, 3)
            fs_tab = jnp.asarray(KERNEL_SIZES[o], jnp.float32)
            scale = 3.0 * fs_tab[samp_round] * 1.2 / 9.0
            kps.append(jnp.stack([fx, fy, scale,
                                  valid.astype(jnp.float32)], -1))
        return S, jnp.concatenate(kps)

    # lax.map (not vmap): the ~60 floats/pixel response/NMS transients then
    # exist for ONE view at a time, so the whole 16-view reference-scale
    # stack runs as a single program (vmap made transients scale with the
    # chunk, forcing 4-view chunks and 4x the dispatches).
    return jax.lax.map(one, grays)


_SURF_CHUNK = 1024


@functools.partial(jax.jit, static_argnames=("n_slots",))
def _ori_desc_flat(S, kp, vi_slots, n_slots: int):
    """Orientation + descriptor over a flat compacted keypoint array.

    S (V, H, W) SAT stack; kp (B, 4) packed [view, x, y, scale] rows (B a
    multiple of the chunk size); vi_slots (B, 2) scatter destinations.
    Returns (packed (B, 2) [orientation, valid] — one host pull — and desc
    scattered to (V, n_slots, 64), device-resident)."""

    def body(kp_c):
        vi = kp_c[:, 0].astype(jnp.int32)
        kx, ky, scale = kp_c[:, 1], kp_c[:, 2], kp_c[:, 3]
        ori, ok1 = _orientation_block(S, vi, kx, ky, scale)
        d, ok2 = _descriptor_block(S, vi, kx, ky, scale, ori)
        return ori, ok1 & ok2, d

    B = kp.shape[0]
    V = S.shape[0]
    chunk = min(_SURF_CHUNK, B)
    ori, ok, desc = jax.lax.map(body, kp.reshape(B // chunk, chunk, 4))
    ori = ori.reshape(B)
    ok = ok.reshape(B)
    desc = jnp.where(ok[:, None], desc.reshape(B, 64), 0.0)
    desc_slots = jnp.zeros((V, n_slots, 64), jnp.float32).at[
        vi_slots[:, 0], vi_slots[:, 1]].set(desc)
    return jnp.stack([ori, ok.astype(jnp.float32)], -1), desc_slots


#: View-chunking budget for extract_batch: bounds the HELD per-view state
#: (the SAT stack consumed by the orientation/descriptor gathers); detection
#: transients are per-view inside the lax.map body.
HBM_BUDGET_BYTES = 4_000_000_000


def extract_batch(grays, per_octave_cap: int = 1024) -> SurfFeatures:
    """Batched SURF over a (V, H, W) same-shape stack; metadata fields are
    host numpy with a leading V axis, desc is device-resident — same
    host-compacted design as sift.extract_batch: detection runs at capacity,
    the expensive per-keypoint orientation/descriptor stages only on actual
    detections, with two host syncs total.

    Views are chunked to an HBM budget like sift.extract_batch — at
    reference-scale inputs the all-view response stack over-allocates the
    chip."""
    V, H, W = grays.shape
    per_view_bytes = H * W * 4 * 3  # held SAT + packed keypoints + margin
    chunk = max(1, min(V, int(HBM_BUDGET_BYTES // max(per_view_bytes, 1))))
    if chunk < V:
        parts = [extract_batch(grays[i:i + chunk], per_octave_cap)
                 for i in range(0, V, chunk)]
        return SurfFeatures(
            xy=np.concatenate([p.xy for p in parts], axis=0),
            scale=np.concatenate([p.scale for p in parts], axis=0),
            orientation=np.concatenate([p.orientation for p in parts], axis=0),
            desc=jnp.concatenate([p.desc for p in parts], axis=0),
            valid=np.concatenate([p.valid for p in parts], axis=0),
        )
    S, kp_packed = _detect_surf_batch(grays, per_octave_cap)
    kp_np = np.asarray(kp_packed)  # sync 1
    n_slots = kp_np.shape[1]
    valid_np = kp_np[:, :, 3] > 0.5
    vi_np, ki_np = np.nonzero(valid_np)
    n = vi_np.shape[0]
    xy = np.zeros((V, n_slots, 2), np.float32)
    scale_out = np.zeros((V, n_slots), np.float32)
    ori_out = np.zeros((V, n_slots), np.float32)
    valid_out = np.zeros((V, n_slots), bool)
    if n == 0:
        return SurfFeatures(xy=xy, scale=scale_out, orientation=ori_out,
                            desc=jnp.zeros((V, n_slots, 64), jnp.float32),
                            valid=valid_out)

    # Bucket keypoints by integer scale (the value _descriptor_block's
    # scale.astype(int32) would produce — a small static set derived from
    # KERNEL_SIZES) and run the per-scale Haar-map program per bucket.
    kxyz = kp_np[vi_np, ki_np, :3]
    s_int = kxyz[:, 2].astype(np.int32)
    desc_slots = jnp.zeros((V, n_slots, 64), jnp.float32)
    launched = []
    for s_val in sorted(set(int(s) for s in np.unique(s_int))):
        sel = np.flatnonzero(s_int == s_val)
        ns = len(sel)
        B = _SURF_CHUNK
        while B < ns:
            B *= 2
        kp_flat = np.zeros((B, 4), np.float32)
        kp_flat[:ns, 0] = vi_np[sel]
        kp_flat[:ns, 1:] = kxyz[sel]
        vi_slots = np.zeros((B, 2), np.int32)
        vi_slots[:ns, 0] = vi_np[sel]
        vi_slots[:ns, 1] = ki_np[sel]
        vi_slots[ns:, 1] = n_slots  # out-of-bounds → dropped by the scatter
        packed, dslots = _ori_desc_flat_s(S, jnp.asarray(kp_flat),
                                          jnp.asarray(vi_slots), n_slots,
                                          s_val)
        desc_slots = desc_slots + dslots
        launched.append((sel, ns, packed))
    for sel, ns, packed in launched:  # pull after all buckets enqueue
        packed_np = np.asarray(packed[:ns])  # sync 2 (per bucket)
        ori_out[vi_np[sel], ki_np[sel]] = packed_np[:, 0]
        valid_out[vi_np[sel], ki_np[sel]] = packed_np[:, 1] > 0.5
    xy[vi_np, ki_np] = kxyz[:, :2]
    scale_out[vi_np, ki_np] = kxyz[:, 2]
    return SurfFeatures(xy=xy, scale=scale_out, orientation=ori_out,
                        desc=desc_slots, valid=valid_out)


def extract(gray01, per_octave_cap: int = 1024) -> SurfFeatures:
    """Single-image SURF — the V=1 case of extract_batch (bit-identical)."""
    fb = extract_batch(jnp.asarray(gray01)[None], per_octave_cap)
    return SurfFeatures(xy=fb.xy[0], scale=fb.scale[0],
                        orientation=fb.orientation[0], desc=fb.desc[0],
                        valid=fb.valid[0])
