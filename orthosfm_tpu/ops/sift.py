"""SIFT feature detection in JAX — array-program replacement for the reference's
CPU/GPU detectors (MVE: src/mve/sfm/sift.{h,cc}; CudaSift: src/cuda_sift/).

Algorithm and every threshold follow the MVE implementation (the reference's
de-facto matching engine, SURVEY.md §1): Gaussian scale space with S+3 images
per octave (sift.cc:212-261), strict 26-neighbour DoG extrema (sift.cc:284-331),
5-step Taylor localization with contrast/edge/offset filters (sift.cc:339-484),
36-bin orientation histograms smoothed 6× with 80%-peak multi-orientation
(sift.cc:598-667), and 4×4×8 trilinear descriptors with 0.2 clamping
(sift.cc:669-843).

Redesign as array programs: keypoints live in fixed-capacity arrays with validity masks;
per-pixel loops become convolutions/reductions. The per-keypoint
orientation/descriptor stages are the redesign's core: valid keypoints from
every view in the batch are compacted on the host into ONE flat bucketed
array (capacity-sized padding never reaches the expensive stages), patches
are gathered once per keypoint, orientation histograms accumulate by masked
bin reductions, and the trilinear descriptor accumulation — a scatter-add in
the reference (sift.cc:793-806, cudaSiftD.cu:392-477) — becomes an exactly
equivalent hat-weight factorization: weight(bin b) = relu(1 − |bin_coord−b|),
so desc[by,bx,bt] = Σ_px Wy·Wx·(Wt·contrib) is two elementwise outer products
and one (16, P²)·(P², 8) matmul per keypoint-orientation. No scatters, no
per-view recompiles; each (octave shape × keypoint bucket) compiles once.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# MVE defaults (sift.h:48-90, sift.cc:226-236)
SAMPLES = 3  # num_samples_per_octave
BASE_BLUR = 1.6
INHERENT_BLUR = 0.5
MAX_OCTAVE = 4
CONTRAST_THRESHOLD = 0.02 / SAMPLES
EDGE_RATIO = 10.0
N_ORI_BINS = 36
MAX_ORIENTATIONS = 4  # peaks kept per keypoint
ORI_PATCH = 37  # covers win = int(4.5 * sigma_max) = 18
DESC_PATCH = 85  # covers win = int(sqrt(2) * 3 * sigma_max * 2.5) = 42

K_FACTOR = 2.0 ** (1.0 / SAMPLES)


def _odd(n: int) -> int:
    return n if n % 2 == 1 else n - 1


class Features(NamedTuple):
    """Per-image features in input-image pixel coordinates. Metadata fields
    are host numpy; desc is a DEVICE array (gather rows on device — copying
    it to the host is the single most expensive thing a caller can do with
    it)."""

    xy: "np.ndarray"  # (K, 2)
    scale: "np.ndarray"  # (K,) absolute scale
    orientation: "np.ndarray"  # (K,)
    desc: jnp.ndarray  # (K, 128) device
    valid: "np.ndarray"  # (K,)


# ---------------------------------------------------------------------------
# Image pyramid


def grayscale(rgb):
    """uint8 RGB -> float gray via channel average (MVE DESATURATE_AVERAGE)."""
    return jnp.mean(rgb.astype(jnp.float32), axis=-1) / 255.0


def _gauss_kernel_np(sigma: float) -> np.ndarray:
    # MVE blur_gaussian kernel radius: ceil(sigma * 2.884) (image_tools.h)
    r = max(int(math.ceil(sigma * 2.884)), 1)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _slide(p, i, size, axis):
    """Length-`size` slice of padded array `p` starting at `i` along axis."""
    return jax.lax.slice_in_dim(p, i, i + size, axis=axis)


def gaussian_blur(img, sigma: float):
    """Separable Gaussian blur with edge-replicate padding over (..., H, W).

    Implemented as tap-weighted shifted adds (not lax.conv): the shifted-add
    form is elementwise work that fuses into one kernel per pass and is
    batch-polymorphic. Whether a 1-channel lax.conv would be faster on a
    given device is open (ROADMAP D3)."""
    k = _gauss_kernel_np(sigma)
    r = (len(k) - 1) // 2
    H, W = img.shape[-2], img.shape[-1]
    nb = img.ndim - 2
    p = jnp.pad(img, [(0, 0)] * nb + [(r, r), (0, 0)], mode="edge")
    img = sum(float(k[i]) * _slide(p, i, H, -2) for i in range(len(k)))
    p = jnp.pad(img, [(0, 0)] * nb + [(0, 0), (r, r)], mode="edge")
    return sum(float(k[i]) * _slide(p, i, W, -1) for i in range(len(k)))


def half_size_gaussian(img):
    """Gaussian-weighted 2× downsample, σ=0.866 over the 4×4 support
    (MVE rescale_half_size_gaussian, image_tools.h:619-693). Shift-add
    form for the same layout reason as gaussian_blur; supports (..., H, W).
    """
    sigma = 0.866025403784439
    w1 = math.exp(-0.5 / (2.0 * sigma**2))
    w2 = math.exp(-2.5 / (2.0 * sigma**2))
    w3 = math.exp(-4.5 / (2.0 * sigma**2))
    kernel = np.array(
        [[w3, w2, w2, w3], [w2, w1, w1, w2], [w2, w1, w1, w2], [w3, w2, w2, w3]],
        np.float64,
    )
    kernel /= kernel.sum()
    H, W = img.shape[-2], img.shape[-1]
    ho, wo = (H + 1) // 2, (W + 1) // 2
    nb = img.ndim - 2
    # Output (x,y) reads input rows/cols (2y-1 .. 2y+2) with edge clamping
    p = jnp.pad(img, [(0, 0)] * nb + [(1, 2), (1, 2)], mode="edge")
    out = None
    for i in range(4):
        row = jax.lax.slice_in_dim(p, i, i + 2 * ho - 1, axis=-2)
        row = row[..., ::2, :]
        for j in range(4):
            col = jax.lax.slice_in_dim(row, j, j + 2 * wo - 1, axis=-1)
            term = float(kernel[i, j]) * col[..., :, ::2]
            out = term if out is None else out + term
    return out


def build_octave(base, has_sigma: float):
    """(S+3) blurred images + (S+2) DoGs for one octave (sift.cc:212-261)."""
    target = BASE_BLUR
    if target > has_sigma:
        base = gaussian_blur(base, math.sqrt(target**2 - has_sigma**2))
    imgs = [base]
    sigma = target
    dogs = []
    for _ in range(1, SAMPLES + 3):
        sigmak = sigma * K_FACTOR
        blur = math.sqrt(sigmak**2 - sigma**2)
        nxt = gaussian_blur(imgs[-1], blur)
        imgs.append(nxt)
        dogs.append(nxt - imgs[-2])
        sigma = sigmak
    return jnp.stack(imgs), jnp.stack(dogs)


# ---------------------------------------------------------------------------
# Extrema detection + localization (per octave)


def _neighborhood_max_min(dogs):
    """For every DoG triplet (s, s+1, s+2): strict 26-neighbour extremum mask
    of the middle image (sift.cc:284-331). dogs: (S+2, H, W) →
    (S, H, W) bool extremum masks (borders excluded)."""
    S2, H, W = dogs.shape
    masks = []
    for s in range(S2 - 2):
        tri = dogs[s : s + 3]  # (3, H, W)
        center = tri[1]
        larger = jnp.ones_like(center, bool)
        smaller = jnp.ones_like(center, bool)
        for l in range(3):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if l == 1 and dy == 0 and dx == 0:
                        continue
                    n = jnp.roll(tri[l], (-dy, -dx), axis=(0, 1))
                    larger = larger & (n < center)
                    smaller = smaller & (n > center)
        m = larger | smaller
        border = jnp.zeros((H, W), bool).at[1:-1, 1:-1].set(True)
        masks.append(m & border)
    return jnp.stack(masks)


def detect_extrema(dogs, cap: int):
    """Top-`cap` extrema by |DoG| response. Returns (s, y, x, valid)."""
    masks = _neighborhood_max_min(dogs)  # (S, H, W)
    S, H, W = masks.shape
    vals = jnp.abs(dogs[1 : 1 + S])  # center image of each triplet
    score = jnp.where(masks, vals, -1.0).reshape(-1)
    k = min(cap, score.shape[0])
    top, idx = jax.lax.top_k(score, k)
    if k < cap:  # tiny octave: pad result slots up to the static capacity
        top = jnp.pad(top, (0, cap - k), constant_values=-1.0)
        idx = jnp.pad(idx, (0, cap - k))
    valid = top > 0.0
    s = idx // (H * W)
    rem = idx % (H * W)
    return s, rem // W, rem % W, valid


def localize_keypoints(dogs, s, y, x, valid):
    """Taylor localization with up to 5 re-centering iterations + stability
    filters (sift.cc:339-484). Returns refined (x, y, sample, valid).

    Array formulation: per re-centering iteration, each keypoint gathers its
    3×3×3 DoG neighbourhood (27 values) and the 10 Taylor derivatives are
    computed from the cube; the Taylor solve is a closed-form cofactor 3×3
    vectorized over all keypoints. The earlier full-image derivative maps
    (10 × (S+2) × H × W rolled-difference planes) did the same math but
    peaked at ~800 MB/view at 2048² — gathering first keeps the transient
    at O(K) and lets the per-octave detection program run 4× more views per
    chunk."""
    S2, H, W = dogs.shape
    K = s.shape[0]

    dflat = dogs.reshape(-1)
    # Flat offsets of the 27-cube around (s, y, x), ds/dy/dx-major
    offs = jnp.asarray([(ds * H + dy) * W + dx
                        for ds in (-1, 0, 1)
                        for dy in (-1, 0, 1)
                        for dx in (-1, 0, 1)], jnp.int32)

    def cube_idx(ds, dy, dx):
        return ((ds + 1) * 3 + (dy + 1)) * 3 + (dx + 1)

    def deriv_at(ix, iy, s0):
        """(10, K) Taylor derivatives from gathered 27-cubes. The keypoint
        coordinates are pre-clamped to [1, dim−2], so every cube entry is in
        bounds (the rolled-map formulation wrapped at borders; interior
        values are bit-identical)."""
        base = (s0 * H + iy) * W + ix  # (K,)
        C = dflat[base[:, None] + offs[None, :]].T  # (27, K)

        def at(ds, dy, dx):
            return C[cube_idx(ds, dy, dx)]

        D0 = at(0, 0, 0)
        return jnp.stack([
            D0,
            0.5 * (at(0, 0, 1) - at(0, 0, -1)),                   # Dx
            0.5 * (at(0, 1, 0) - at(0, -1, 0)),                   # Dy
            0.5 * (at(1, 0, 0) - at(-1, 0, 0)),                   # Ds
            at(0, 0, 1) + at(0, 0, -1) - 2 * D0,                  # Dxx
            at(0, 1, 0) + at(0, -1, 0) - 2 * D0,                  # Dyy
            at(1, 0, 0) + at(-1, 0, 0) - 2 * D0,                  # Dss
            0.25 * (at(0, 1, 1) + at(0, -1, -1)
                    - at(0, -1, 1) - at(0, 1, -1)),               # Dxy
            0.25 * (at(1, 0, 1) + at(-1, 0, -1)
                    - at(1, 0, -1) - at(-1, 0, 1)),               # Dxs
            0.25 * (at(1, 1, 0) + at(-1, -1, 0)
                    - at(1, -1, 0) - at(-1, 1, 0)),               # Dys
        ])

    def solve3(d):
        """Closed-form solve A·sol = −g from the stacked derivative rows."""
        gx, gy, gs = d[1], d[2], d[3]
        a, e, i = d[4], d[5], d[6]
        b, c, f = d[7], d[8], d[9]  # Dxy, Dxs, Dys
        A11, A12, A13 = e * i - f * f, -(b * i - f * c), b * f - e * c
        A22, A23 = a * i - c * c, -(a * f - b * c)
        A33 = a * e - b * b
        det = a * A11 + b * A12 + c * A13
        inv_det = jnp.where(jnp.abs(det) < 1e-15, 0.0, 1.0 / det)
        sx = -(A11 * gx + A12 * gy + A13 * gs) * inv_det
        sy = -(A12 * gx + A22 * gy + A23 * gs) * inv_det
        ss = -(A13 * gx + A23 * gy + A33 * gs) * inv_det
        return sx, sy, ss

    # Clamp starting points so gathers stay in range even for invalid slots
    s0 = jnp.clip(s, 0, S2 - 3) + 1  # center image of the DoG triplet
    iy = jnp.clip(y, 1, H - 2)
    ix = jnp.clip(x, 1, W - 2)

    def body(_, carry):
        ix, iy, fx, fy, fs = carry
        d = deriv_at(ix, iy, s0)
        fx, fy, fs = solve3(d)
        dx = (jnp.where((fx > 0.6) & (ix < W - 2), 1, 0)
              + jnp.where((fx < -0.6) & (ix > 1), -1, 0))
        dy = (jnp.where((fy > 0.6) & (iy < H - 2), 1, 0)
              + jnp.where((fy < -0.6) & (iy > 1), -1, 0))
        return (ix + dx, iy + dy, fx, fy, fs)

    zero = jnp.zeros((K,), dogs.dtype)
    ix, iy, fx, fy, fs = jax.lax.fori_loop(
        0, 5, body, (ix, iy, zero, zero, zero))
    d = deriv_at(ix, iy, s0)
    val = d[0] + 0.5 * (d[1] * fx + d[2] * fy + d[3] * fs)
    Dxx, Dyy, Dxy = d[4], d[5], d[7]
    h_trace = Dxx + Dyy
    h_det = Dxx * Dyy - Dxy * Dxy
    h_score = h_trace * h_trace / jnp.where(jnp.abs(h_det) < 1e-20, 1e-20, h_det)
    score_thres = (EDGE_RATIO + 1.0) ** 2 / EDGE_RATIO

    kx = ix.astype(jnp.float32) + fx
    ky = iy.astype(jnp.float32) + fy
    ks = (s0 - 1).astype(jnp.float32) + fs
    ok = (valid
          & (jnp.abs(val) >= CONTRAST_THRESHOLD)
          & (h_score >= 0.0) & (h_score <= score_thres)
          & (jnp.abs(fx) <= 1.5) & (jnp.abs(fy) <= 1.5) & (jnp.abs(fs) <= 1.0)
          & (ks >= -1.0) & (ks <= float(SAMPLES))
          & (kx >= 0.0) & (kx <= float(W - 1))
          & (ky >= 0.0) & (ky <= float(H - 1)))
    return kx, ky, ks, ok


# ---------------------------------------------------------------------------
# Gradients, orientations, descriptors (per octave)


def grad_ori_images(imgs):
    """Gradient magnitude + orientation ∈ [0, 2π) per sample image
    (sift.cc:556-594). Border pixels carry zeros like MVE's uninitialized=0."""
    dx = 0.5 * (jnp.roll(imgs, -1, axis=2) - jnp.roll(imgs, 1, axis=2))
    dy = 0.5 * (jnp.roll(imgs, -1, axis=1) - jnp.roll(imgs, 1, axis=1))
    mag = jnp.sqrt(dx * dx + dy * dy)
    ori = jnp.arctan2(dy, dx)
    ori = jnp.where(ori < 0.0, ori + 2.0 * jnp.pi, ori)
    border = jnp.zeros(imgs.shape[1:], bool).at[1:-1, 1:-1].set(True)
    return mag * border[None], ori * border[None]


def _rel_scale(sample):
    return BASE_BLUR * 2.0 ** ((sample + 1.0) / SAMPLES)


def _hat(u):
    """Linear interpolation hat max(0, 1−|u|) — weight a continuous bin
    coordinate gives integer bin b. Exactly the reference's trilinear
    corner weights (sift.cc:793-806): corner bin ⌊c⌋ gets 1−frac(c), corner
    ⌊c⌋+1 gets frac(c), out-of-range bins get 0."""
    return jnp.maximum(0.0, 1.0 - jnp.abs(u))


def _gather_patches_flat(stack, vi, is_, iy, ix, size: int):
    """(V, S3, H, W) stack → (B, size, size) patches centered at each flat
    keypoint (view vi, scale image is_, pixel (iy, ix)), clamped to bounds
    (validity handled by callers' window checks). Returns (patches, y0, x0)."""
    V, S3, H, W = stack.shape
    r = size // 2
    y0 = jnp.clip(iy - r, 0, max(H - size, 0))
    x0 = jnp.clip(ix - r, 0, max(W - size, 0))

    def one(v, s, y, x):
        return jax.lax.dynamic_slice(
            stack, (v, jnp.clip(s, 0, S3 - 1), y, x), (1, 1, size, size))[0, 0]

    return jax.vmap(one)(vi, is_, y0, x0), y0, x0


def _orientations_block(grads, oris, vi, kx, ky, ks, patch: int):
    """36-bin histogram orientation assignment for a flat keypoint block
    (sift.cc:598-667). grads/oris (V, S3, H, W); all keypoint arrays (C,).

    Returns (orientations (C, MAX_ORIENTATIONS), ori_valid (C, MAX_ORIENTATIONS)).
    """
    H, W = grads.shape[-2:]
    C = kx.shape[0]
    ix = jnp.floor(kx + 0.5).astype(jnp.int32)
    iy = jnp.floor(ky + 0.5).astype(jnp.int32)
    is_ = jnp.round(ks).astype(jnp.int32) + 1
    sigma = _rel_scale(ks)
    win = (sigma * 1.5 * 3.0).astype(jnp.int32)
    in_bounds = ((ix >= win) & (ix + win < W) & (iy >= win) & (iy + win < H)
                 & (win <= patch // 2))

    gpatch, y0, x0 = _gather_patches_flat(grads, vi, is_, iy, ix, patch)
    opatch, _, _ = _gather_patches_flat(oris, vi, is_, iy, ix, patch)
    ar = jnp.arange(patch, dtype=jnp.int32)
    dy = (ar[None, :, None] + (y0 - iy)[:, None, None]).astype(jnp.float32)
    dx = (ar[None, None, :] + (x0 - ix)[:, None, None]).astype(jnp.float32)
    dxf = (kx - ix.astype(jnp.float32))[:, None, None]
    dyf = (ky - iy.astype(jnp.float32))[:, None, None]
    dist = (dx - dxf) ** 2 + (dy - dyf) ** 2
    winf = win.astype(jnp.float32)[:, None, None]
    maxdist = winf * winf + 0.5
    inside = (dist <= maxdist) & (jnp.abs(dx) <= winf) & (jnp.abs(dy) <= winf)
    sig15 = (sigma * 1.5)[:, None, None]
    weight = jnp.exp(-dist / (2.0 * sig15 * sig15))
    contrib = jnp.where(inside, gpatch * weight, 0.0).reshape(C, -1)
    bins = jnp.clip((N_ORI_BINS * opatch / (2.0 * jnp.pi)).astype(jnp.int32),
                    0, N_ORI_BINS - 1).reshape(C, -1)
    # Histogram by masked bin reductions — scatter-free (each b is one fused
    # compare+select+sum over the patch axis)
    hist = jnp.stack(
        [jnp.sum(jnp.where(bins == b, contrib, 0.0), axis=-1)
         for b in range(N_ORI_BINS)], axis=-1)  # (C, 36)

    # Smooth 6× with a circular [1,1,1]/3 kernel (MVE's in-place update uses
    # the pre-update neighbour via 'prev' — equivalent; sift.cc:641-653)
    for _ in range(6):
        hist = (jnp.roll(hist, 1, -1) + hist + jnp.roll(hist, -1, -1)) / 3.0

    maxh = jnp.max(hist, axis=-1, keepdims=True)
    h0 = jnp.roll(hist, 1, -1)
    h2 = jnp.roll(hist, -1, -1)
    is_peak = (hist > 0.8 * maxh) & (hist > h0) & (hist > h2)
    denom = h0 - 2.0 * hist + h2
    xoff = -0.5 * (h2 - h0) / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
    angles = 2.0 * jnp.pi * (xoff + jnp.arange(N_ORI_BINS) + 0.5) / N_ORI_BINS

    peak_score = jnp.where(is_peak, hist, -1.0)
    top_vals, top_idx = jax.lax.top_k(peak_score, MAX_ORIENTATIONS)
    ori_out = jnp.take_along_axis(angles, top_idx, axis=-1)
    ori_ok = (top_vals > 0.0) & in_bounds[:, None]
    return ori_out, ori_ok


def _descriptors_block(grads, oris, vi, kx, ky, ks, ori4, patch: int):
    """4×4×8 trilinear SIFT descriptors for a flat keypoint block
    (sift.cc:669-843). ori4 (C, MAX_ORIENTATIONS) candidate orientations.

    The trilinear scatter-add becomes hat weights + one matmul contraction:
      desc[by, bx, bt] = Σ_px Wy[px,by]·Wx[px,bx]·Wt[px,bt]·contrib[px]
    with W·[px,b] = relu(1 − |bin_coord(px) − b|) (circular for bt) — bit-for-
    bit the reference's corner weights, no scatters. The patch is gathered
    ONCE per keypoint and shared by all MAX_ORIENTATIONS orientations.

    Returns (desc (C, MAX_ORIENTATIONS, 128), in_bounds (C,)).
    """
    H, W = grads.shape[-2:]
    C = kx.shape[0]
    PXB, OHB = 4, 8
    ix = jnp.floor(kx + 0.5).astype(jnp.int32)
    iy = jnp.floor(ky + 0.5).astype(jnp.int32)
    is_ = jnp.round(ks).astype(jnp.int32) + 1
    sigma = _rel_scale(ks)
    binsize = 3.0 * sigma  # (C,)
    win = (jnp.sqrt(2.0) * binsize * (PXB + 1) * 0.5).astype(jnp.int32)
    in_bounds = ((ix >= win) & (ix + win < W) & (iy >= win) & (iy + win < H)
                 & (win <= patch // 2))

    gpatch, y0, x0 = _gather_patches_flat(grads, vi, is_, iy, ix, patch)
    opatch, _, _ = _gather_patches_flat(oris, vi, is_, iy, ix, patch)
    ar = jnp.arange(patch, dtype=jnp.int32)
    dy = (ar[None, :, None] + (y0 - iy)[:, None, None]).astype(jnp.float32)
    dx = (ar[None, None, :] + (x0 - ix)[:, None, None]).astype(jnp.float32)
    winf = win.astype(jnp.float32)[:, None, None]
    window = (jnp.abs(dx) <= winf) & (jnp.abs(dy) <= winf)
    winx = dx - (kx - ix.astype(jnp.float32))[:, None, None]
    winy = dy - (ky - iy.astype(jnp.float32))[:, None, None]

    # Gaussian spatial weight is rotation-invariant ((binx−off)²+(biny−off)²
    # = (winx²+winy²)/binsize²), so contrib is shared by all orientations
    gsigma = 0.5 * PXB
    bs = binsize[:, None, None]
    gweight = jnp.exp(-(winx * winx + winy * winy)
                      / (bs * bs * 2.0 * gsigma * gsigma))
    P2 = patch * patch
    contrib = jnp.where(window, gpatch * gweight, 0.0).reshape(C, P2)

    binoff = (PXB - 1) / 2.0
    bins_x = jnp.arange(PXB, dtype=jnp.float32)
    bins_t = jnp.arange(OHB, dtype=jnp.float32)
    descs = []
    for m in range(MAX_ORIENTATIONS):
        ori = ori4[:, m]
        sino = jnp.sin(ori)[:, None, None]
        coso = jnp.cos(ori)[:, None, None]
        binx = ((coso * winx + sino * winy) / bs + binoff).reshape(C, P2)
        biny = ((-sino * winx + coso * winy) / bs + binoff).reshape(C, P2)
        theta = opatch - ori[:, None, None]
        theta = jnp.where(theta < 0.0, theta + 2.0 * jnp.pi, theta)
        bint = (theta * OHB / (2.0 * jnp.pi) - 0.5).reshape(C, P2)

        Wx = _hat(binx[:, :, None] - bins_x)  # (C, P², 4)
        Wy = _hat(biny[:, :, None] - bins_x)  # (C, P², 4)
        dt = bint[:, :, None] - bins_t
        dt = dt - OHB * jnp.round(dt / OHB)  # circular distance
        Ct = _hat(dt) * contrib[:, :, None]  # (C, P², 8)
        G = (Wy[:, :, :, None] * Wx[:, :, None, :]).reshape(C, P2, PXB * PXB)
        d = jax.lax.dot_general(
            G, Ct, dimension_numbers=(((1,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32).reshape(C, 128)
        d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
        d = jnp.minimum(d, 0.2)
        d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
        descs.append(d)
    return jnp.stack(descs, axis=1), in_bounds


_ORI_DESC_CHUNK = 512


@functools.partial(jax.jit, static_argnames=("n_slots", "ori_patch",
                                              "desc_patch"))
def _ori_desc_flat(grads, oris, kp, vi_slots, n_slots: int, ori_patch: int,
                   desc_patch: int):
    """Orientation + descriptor stages over a flat compacted keypoint array.

    grads/oris (V, S3, H, W); kp (B, 4) packed [view, x, y, sample] rows with
    B a multiple of the chunk size (the host pads — packing keeps the
    host→device round trips at one per octave);
    vi_slots (B·M, 2) destination (view, slot) indices for the scatter-back.
    Chunks stream through lax.map so peak memory stays bounded.

    Returns (packed (B, M, 2) [orientation, valid] — ONE small host pull —
    and desc scattered to (V, n_slots, 128), which stays on device)."""

    def body(kp_c):
        vi_c = kp_c[:, 0].astype(jnp.int32)
        kx_c, ky_c, ks_c = kp_c[:, 1], kp_c[:, 2], kp_c[:, 3]
        ori4, ori_ok = _orientations_block(grads, oris, vi_c, kx_c, ky_c,
                                           ks_c, ori_patch)
        desc, d_ok = _descriptors_block(grads, oris, vi_c, kx_c, ky_c, ks_c,
                                        ori4, desc_patch)
        return ori4, ori_ok & d_ok[:, None], desc

    B = kp.shape[0]
    V = grads.shape[0]
    M = MAX_ORIENTATIONS
    chunk = min(_ORI_DESC_CHUNK, B)
    ori4, ok, desc = jax.lax.map(body, kp.reshape(B // chunk, chunk, 4))
    ori4 = ori4.reshape(B, M)
    ok = ok.reshape(B, M)
    desc = jnp.where(ok.reshape(B * M, 1), desc.reshape(B * M, 128), 0.0)
    desc_slots = jnp.zeros((V, n_slots, 128), jnp.float32).at[
        vi_slots[:, 0], vi_slots[:, 1]].set(desc)
    packed = jnp.stack([ori4, ok.astype(jnp.float32)], axis=-1)
    return packed, desc_slots


@functools.partial(jax.jit, static_argnames=("has_sigma", "cap"))
def _detect_octave_batch(bases, has_sigma: float, cap: int):
    """Pyramid + extrema + localization + gradient images for one octave over
    a (V, H, W) view stack. Returns a packed (V, cap, 4) keypoint tensor
    [x, y, sample, valid] (one host pull) plus the (V, S3, H, W)
    gradient-magnitude/orientation stacks (device-resident)."""

    def one(base):
        imgs, dogs = build_octave(base, has_sigma)
        s, y, x, valid = detect_extrema(dogs, cap)
        kx, ky, ks, valid = localize_keypoints(dogs, s, y, x, valid)
        grads, oris = grad_ori_images(imgs)
        kp = jnp.stack([kx, ky, ks, valid.astype(jnp.float32)], axis=-1)
        return kp, grads, oris

    return jax.vmap(one)(bases)


def _octave_cap(per_octave_cap: int, h: int, w: int) -> int:
    """Static per-octave keypoint capacity: the configured cap, shrunk with
    the octave's pixel count (an extremum needs a 3×3×3 neighbourhood, so
    dense small octaves cannot fill the full-resolution capacity)."""
    return max(256, min(per_octave_cap, (h * w) // 64))


def _bucket_size(n: int, chunk: int = _ORI_DESC_CHUNK) -> int:
    """Flat-keypoint padding bucket: next power-of-two multiple of the chunk
    size, so the expensive stages compile for O(log) distinct shapes."""
    b = chunk
    while b < n:
        b *= 2
    return b


class _OctaveBatch(NamedTuple):
    """Per-octave results for a view batch: small metadata host-side (numpy,
    fixed capacity cap·MAX_ORIENTATIONS per view; invalid slots zeroed) and
    descriptors DEVICE-side ((V, cap·M, 128) jnp — the 10s-of-MB descriptor
    tensor never goes to the host; downstream matching gathers rows on
    device)."""

    x: "np.ndarray"  # (V, cap·M)
    y: "np.ndarray"
    sample: "np.ndarray"
    orientation: "np.ndarray"
    desc: jnp.ndarray  # (V, cap·M, 128) device
    valid: "np.ndarray"


def _empty_octave_batch(V: int, cap: int) -> _OctaveBatch:
    M = MAX_ORIENTATIONS
    return _OctaveBatch(
        x=np.zeros((V, cap * M), np.float32),
        y=np.zeros((V, cap * M), np.float32),
        sample=np.zeros((V, cap * M), np.float32),
        orientation=np.zeros((V, cap * M), np.float32),
        desc=jnp.zeros((V, cap * M, 128), jnp.float32),
        valid=np.zeros((V, cap * M), bool),
    )


def _launch_ori_desc(kp_np, grads, oris, cap: int):
    """Host compaction of valid keypoints into one flat bucketed array →
    ENQUEUE the device orientation/descriptor program. Returns a thunk that
    finalizes the octave (its single host pull is the sync point, so callers
    can launch every octave before finalizing any — the syncs then overlap
    device compute of later octaves).

    Compaction is the array-program answer to ragged per-view keypoint counts:
    the (V, cap) capacity grid is usually <20% populated and the expensive
    per-keypoint stages should pay for detections, not capacity."""
    V, H, W = grads.shape[0], grads.shape[2], grads.shape[3]
    M = MAX_ORIENTATIONS
    valid_np = kp_np[:, :, 3] > 0.5
    vi_np, ki_np = np.nonzero(valid_np)
    n = vi_np.shape[0]
    if n == 0:
        return lambda: _empty_octave_batch(V, cap)
    B = _bucket_size(n)
    kxyz = kp_np[vi_np, ki_np, :3]

    kp_flat = np.zeros((B, 4), np.float32)
    kp_flat[:n, 0] = vi_np
    kp_flat[:n, 1:] = kxyz
    slots = (ki_np[:, None] * M + np.arange(M)[None, :]).astype(np.int32)
    vrep = np.broadcast_to(vi_np[:, None], slots.shape).astype(np.int32)
    vi_slots = np.zeros((B * M, 2), np.int32)
    vi_slots[: n * M, 0] = vrep.reshape(-1)
    vi_slots[: n * M, 1] = slots.reshape(-1)
    # Padded rows target slot cap·M: out-of-bounds scatter indices are
    # dropped by jnp's .at[].set default mode
    vi_slots[n * M:, 1] = cap * M

    ori_patch = min(ORI_PATCH, _odd(H), _odd(W))
    desc_patch = min(DESC_PATCH, _odd(H), _odd(W))
    packed, desc_slots = _ori_desc_flat(
        grads, oris, jnp.asarray(kp_flat), jnp.asarray(vi_slots), cap * M,
        ori_patch, desc_patch)

    def finalize() -> _OctaveBatch:
        packed_np = np.asarray(packed[:n])  # the octave's second host pull
        ori4 = packed_np[..., 0]
        ok4 = packed_np[..., 1] > 0.5
        out = _empty_octave_batch(V, cap)
        out.x[vrep, slots] = kxyz[:, None, 0]
        out.y[vrep, slots] = kxyz[:, None, 1]
        out.sample[vrep, slots] = kxyz[:, None, 2]
        out.orientation[vrep, slots] = ori4
        out.valid[vrep, slots] = ok4
        return out._replace(desc=desc_slots)

    return finalize


def double_size_supersample(img):
    """2× upscale by 4-tap supersampling with edge clamping — bit-matches
    MVE's rescale_double_size_supersample (mve/mve/image_tools.h:790-826):
    out[y,x] averages in[y>>1, x>>1], in[y>>1,(x+1)>>1], in[(y+1)>>1, x>>1]
    and in[(y+1)>>1,(x+1)>>1]."""
    a = img
    right = jnp.concatenate([img[:, 1:], img[:, -1:]], axis=1)
    down = jnp.concatenate([img[1:], img[-1:]], axis=0)
    diag = jnp.concatenate([down[:, 1:], down[:, -1:]], axis=1)
    H, W = img.shape
    top = jnp.stack([a, 0.5 * (a + right)], -1).reshape(H, 2 * W)
    bot = jnp.stack([0.5 * (a + down), 0.25 * (a + right + down + diag)],
                    -1).reshape(H, 2 * W)
    return jnp.stack([top, bot], 1).reshape(2 * H, 2 * W)


def extract(image_gray, per_octave_cap: int = 2048, max_octave: int = MAX_OCTAVE,
            min_octave: int = 0):
    """Multi-octave SIFT on a grayscale float image → Features in input-image
    pixel coordinates (x_img = 2^o·(x+0.5)−0.5, sift.cc:545-547).

    min_octave = −1 prepends the 2× upscale octave: the doubled image carries
    inherent blur 2·0.5 = 1.0 (sift.cc:178-184; the CudaSift path always runs
    with this upscale, cudaSiftH.cu:114-129 / matching.cpp:47-52).

    Single-view extraction is the V=1 case of the batched path, so both
    produce bit-identical features."""
    fb = extract_batch(jnp.asarray(image_gray)[None], per_octave_cap,
                       max_octave, min_octave)
    return Features(xy=fb.xy[0], scale=fb.scale[0],
                    orientation=fb.orientation[0], desc=fb.desc[0],
                    valid=fb.valid[0])


#: View-chunking budget for extract_batch: bounds the HELD per-octave
#: gradient/orientation stacks (~64*up^2*H*W bytes/view across the octave
#: chain); the big detection transients (Taylor maps, top-k workspace) are
#: per-view inside the lax.map body and do not scale with the chunk.
HBM_BUDGET_BYTES = 8_000_000_000


def _octave_plan(H: int, W: int, per_octave_cap: int, max_octave: int,
                 min_octave: int):
    """Static (octave, cap, h, w) schedule for an input shape."""
    plan = []
    h, w = H, W
    for o in range(min_octave, max_octave + 1):
        if o == -1:
            h, w = 2 * H, 2 * W
        elif o == 0:
            h, w = H, W
        if min(h, w) < 16:
            break
        plan.append((o, _octave_cap(per_octave_cap, h, w), h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
    return plan


def _detect_all_octaves(images, per_octave_cap: int, max_octave: int,
                        min_octave: int):
    """Enqueue one vmapped detection program per octave over the whole view
    stack (the octave chain is device-only — half_size feeds the next
    octave's detect without a host sync). Returns [(kp, grads, oris), ...]
    per octave, all device-resident.

    NOT fused into a single lax.map-over-views program: batched elementwise
    ops across views fuse far better than a sequential per-view loop, and
    with cube-gathering localization the per-view transients are small
    enough to vmap 16 full-resolution views at once."""
    plan = _octave_plan(images.shape[1], images.shape[2], per_octave_cap,
                        max_octave, min_octave)
    img = images
    has_sigma = INHERENT_BLUR
    dets = []
    for o, cap, h, w in plan:
        if o == -1:
            img = jax.vmap(double_size_supersample)(images)
            has_sigma = INHERENT_BLUR * 2.0
        elif o == 0:
            # Octave 0 always starts from the original image (sift.cc:195-199)
            img = images
            has_sigma = INHERENT_BLUR
        dets.append(_detect_octave_batch(img, has_sigma, cap))
        if o >= 0:
            img = jax.vmap(half_size_gaussian)(img)
            has_sigma = BASE_BLUR
    return dets


def extract_batch(images, per_octave_cap: int = 2048,
                  max_octave: int = MAX_OCTAVE, min_octave: int = 0):
    """Batched multi-octave SIFT over a (V, H, W) stack of same-shape images.

    All returned Features fields are numpy with a leading V axis and a fixed
    per-view slot layout (sum_o cap_o*M slots; invalid slots zeroed). ONE
    compiled detection program serves every (view, octave) pair and ONE flat
    compacted orientation/descriptor program per octave serves every valid
    keypoint of every view - the batched replacement for MVE's per-view
    omp loop (bundler_features.cc:40). Host syncs per chunk: one combined
    keypoint pull + one packed orientation pull per octave.

    The view axis is chunked to a device-memory budget on the HELD gradient
    stacks (at 16 views x 2048^2 with the 2x upscale octave they are ~17 GB;
    un-upscaled they fit in one chunk). The budget is a fixed constant, not
    yet derived from the device's memory (ROADMAP D8)."""
    assert min_octave >= -1, "octaves below -1 are not defined"
    V, H, W = images.shape
    up = 2 if min_octave <= -1 else 1
    # Held grads/oris chain (~64·1.33 B/px) + vmapped octave-0 detection
    # transients (pyramid + extrema masks + top-k workspace, ~140 B/px)
    per_view_bytes = int(230 * (up * H) * (up * W))
    chunk = max(1, min(V, HBM_BUDGET_BYTES // max(per_view_bytes, 1)))
    if chunk < V:
        parts = [extract_batch(images[i:i + chunk], per_octave_cap,
                               max_octave, min_octave)
                 for i in range(0, V, chunk)]
        return Features(
            xy=np.concatenate([p.xy for p in parts], axis=0),
            scale=np.concatenate([p.scale for p in parts], axis=0),
            orientation=np.concatenate([p.orientation for p in parts], axis=0),
            desc=jnp.concatenate([p.desc for p in parts], axis=0),
            valid=np.concatenate([p.valid for p in parts], axis=0),
        )
    from orthosfm_tpu.utils.profiling import stage as _stage

    plan = _octave_plan(H, W, per_octave_cap, max_octave, min_octave)

    # Phase 1: one vmapped program per octave + ONE combined keypoint pull
    with _stage("sift/pyramid_detect"):
        dets = _detect_all_octaves(images, per_octave_cap, max_octave,
                                   min_octave)
        kp_all = np.asarray(jnp.concatenate([kp for kp, _, _ in dets],
                                            axis=1))  # (V, sum cap, 4)

    # Phase 2: compact each octave's keypoints on host, enqueue the
    # orientation/descriptor program (grads/oris stay device-resident)
    with _stage("sift/ori_desc"):
        finalizers = []
        off = 0
        for (o, cap, h, w), (_, grads, oris) in zip(plan, dets):
            kp_np = kp_all[:, off:off + cap]
            off += cap
            finalizers.append((o, cap,
                               _launch_ori_desc(kp_np, grads, oris, cap)))

    # Phase 3: finalize each octave (one small pull each)
    all_feats = []
    for o, cap, fin in finalizers:
        of = fin()
        sf = 2.0**o
        xy = np.stack([sf * (of.x + 0.5) - 0.5, sf * (of.y + 0.5) - 0.5], -1)
        scale = BASE_BLUR * 2.0 ** (o + (of.sample + 1.0) / SAMPLES)
        all_feats.append(Features(xy=xy, scale=scale,
                                  orientation=of.orientation,
                                  desc=of.desc, valid=of.valid))
    return Features(
        xy=np.concatenate([f.xy for f in all_feats], axis=1),
        scale=np.concatenate([f.scale for f in all_feats], axis=1),
        orientation=np.concatenate([f.orientation for f in all_feats], axis=1),
        desc=jnp.concatenate([f.desc for f in all_feats], axis=1),
        valid=np.concatenate([f.valid for f in all_feats], axis=1),
    )
