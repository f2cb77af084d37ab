"""Feature detection + matching stack tests on synthetic textured images."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from orthosfm_tpu.ops import matching as match_ops
from orthosfm_tpu.ops import ransac_f, sift
from orthosfm_tpu.pipeline import tracks_build


def _blob_image(centers, amps, sigmas, H=180, W=180):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = np.full((H, W), 0.4)
    for (cx, cy), a, s in zip(centers, amps, sigmas):
        img += a * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
    return np.clip(img, 0, 1).astype(np.float32)


def _scene(seed=0, n=50):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(25, 155, (n, 2))
    amps = rng.uniform(0.25, 0.55, n) * rng.choice([-1, 1], n)
    sigmas = rng.uniform(2.0, 5.0, n)
    return centers, amps, sigmas


@pytest.mark.slow
def test_sift_repeatability_under_shift():
    centers, amps, sigmas = _scene()
    img1 = _blob_image(centers, amps, sigmas)
    img2 = _blob_image(centers + np.array([7.0, 3.0]), amps, sigmas)
    f1 = sift.extract(jnp.asarray(img1), per_octave_cap=256)
    f2 = sift.extract(jnp.asarray(img2), per_octave_cap=256)
    n1, n2 = int(f1.valid.sum()), int(f2.valid.sum())
    assert n1 > 15 and n2 > 15, (n1, n2)

    m12 = match_ops.match_pair(f1.desc, f1.valid, f2.desc, f2.valid)
    idx1 = np.flatnonzero(np.asarray(m12) >= 0)
    idx2 = np.asarray(m12)[idx1]
    assert len(idx1) >= 10, len(idx1)
    # Matched keypoints must be offset by ≈ (7, 3)
    d = np.asarray(f2.xy)[idx2] - np.asarray(f1.xy)[idx1]
    med = np.median(d, axis=0)
    np.testing.assert_allclose(med, [7.0, 3.0], atol=0.5)
    inlier_frac = np.mean(np.linalg.norm(d - med, axis=1) < 1.5)
    assert inlier_frac > 0.8, inlier_frac


def test_match_pair_mutual_consistency():
    rng = np.random.default_rng(1)
    d = rng.normal(size=(32, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    perm = rng.permutation(32)
    m12 = match_ops.match_pair(jnp.asarray(d), jnp.ones(32, bool),
                               jnp.asarray(d[perm]), jnp.ones(32, bool))
    # identical descriptors under permutation: d_best=0 → ratio passes
    recovered = np.asarray(m12)
    assert (recovered >= 0).all()
    np.testing.assert_array_equal(perm[recovered], np.arange(32))


@pytest.mark.parametrize("n1,n2,valid1,valid2,seed", [
    (64, 80, 64, 80, 0),      # all rows valid
    (300, 257, 250, 200, 1),  # padded tails on both sides
    (128, 128, 100, 128, 2),  # invalid rows only in set 1
])
def test_match_pair_equals_batched_and_numpy_reference(n1, n2, valid1,
                                                       valid2, seed):
    """match_pair is match_pairs_batched at B=1, and both agree with the
    float64 NumPy reference that chip_smoke.py checks the card against."""
    import chip_smoke

    d1, v1, d2, v2 = chip_smoke.planted_descriptors(1, max(n1, n2), 128,
                                                    seed=seed)
    d1, d2 = d1[0, :n1], d2[0, :n2]
    v1 = np.arange(n1) < valid1
    v2 = np.arange(n2) < valid2
    args = tuple(jnp.asarray(a) for a in (d1, v1, d2, v2))
    single = np.asarray(match_ops.match_pair(*args, lowe_ratio=0.8))
    batched = np.asarray(match_ops.match_pairs_batched(
        *(a[None] for a in args), lowe_ratio=0.8))[0]
    ref = chip_smoke.reference_match(d1, v1, d2, v2, 0.8)
    np.testing.assert_array_equal(single, batched)
    np.testing.assert_array_equal(single, ref)
    assert (ref >= 0).sum() > min(valid1, valid2) // 4  # planted matches
    assert np.all(ref[~v1] == -1) and np.all(v2[ref[ref >= 0]])


def test_ransac_fundamental_rejects_outliers():
    rng = np.random.default_rng(2)
    n = 200
    # A rigid scene observed by two orthographic-ish cameras: generate 3D
    # points, project with two projection matrices → valid epipolar geometry
    X = rng.uniform(-1, 1, (n, 3))
    def proj(R, t):
        p = X @ R.T + t
        return p[:, :2] / 4.0
    from scipy.spatial.transform import Rotation as _R  # noqa — not available?
    pytest.importorskip("scipy")
    R2 = _R.from_euler("y", 20, degrees=True).as_matrix()
    p1 = proj(np.eye(3), np.zeros(3))
    p2 = proj(R2, np.array([0.1, 0.0, 0.0]))
    # corrupt 25%
    bad = rng.choice(n, n // 4, replace=False)
    p2c = p2.copy()
    p2c[bad] += rng.uniform(-0.3, 0.3, (len(bad), 2))
    res = ransac_f.ransac_fundamental(
        jnp.asarray(p1, jnp.float32), jnp.asarray(p2c, jnp.float32),
        jnp.ones(n, bool), jax.random.PRNGKey(0), iterations=500, threshold=0.002)
    inl = np.asarray(res.inliers)
    assert inl[~np.isin(np.arange(n), bad)].mean() > 0.9
    assert inl[bad].mean() < 0.2


def test_union_find_tracks():
    # 3 views, features: v0:{0,1}, v1:{0,1}, v2:{0,1}
    # match chain v0f0-v1f0, v1f0-v2f0 → one 3-view track
    # conflict: v0f1-v1f1 and v0f1-v2f1 and v1f1-... fine; make a conflict track
    pm = [
        (0, 1, np.array([0]), np.array([0])),
        (1, 2, np.array([0]), np.array([0])),
        (0, 1, np.array([1]), np.array([1])),
        (0, 2, np.array([1]), np.array([1])),
    ]
    tracks = tracks_build.build_tracks(pm, [2, 2, 2])
    lens = sorted(len(t) for t in tracks)
    assert lens == [3, 3]
    # Now force a conflict: v1f0 (track A) also matches v2f1 (track B) —
    # unify_tracks merges A and B into one track with two features per view,
    # which is invalid and removed (bundler_tracks.cc:151-176)
    pm.append((1, 2, np.array([0]), np.array([1])))
    tracks = tracks_build.build_tracks(pm, [2, 2, 2])
    assert tracks == []


def test_lowres_subset():
    import jax.numpy as jnp
    from orthosfm_tpu.ops import matching as mo

    scale = jnp.asarray(np.array([1.0, 5.0, 3.0, 9.0, 2.0], np.float32))
    valid = jnp.asarray(np.array([True, True, True, False, True]))
    idx = np.asarray(mo.lowres_subset(scale, valid, 2))
    assert set(idx.tolist()) == {1, 2}  # largest valid scales, 9.0 masked out


@pytest.mark.slow
def test_sift_upscale_octave():
    """Octave −1 (2× supersampled upscale, reference: mve sift.cc:178-184 and
    the always-on CudaSift upscale, cudaSiftH.cu:114-129) must produce MORE
    features than octave 0+, at consistent input-image coordinates."""
    centers, amps, sigmas = _scene(seed=3)
    img = _blob_image(centers, amps, sigmas)
    f0 = sift.extract(jnp.asarray(img), per_octave_cap=256)
    fm1 = sift.extract(jnp.asarray(img), per_octave_cap=256, min_octave=-1)
    n0, nm1 = int(f0.valid.sum()), int(fm1.valid.sum())
    assert nm1 > n0, (nm1, n0)

    # Keypoints found at octave ≥0 must still be found with the upscale on,
    # at (approximately) the same positions
    xy0 = np.asarray(f0.xy)[np.asarray(f0.valid)]
    xym1 = np.asarray(fm1.xy)[np.asarray(fm1.valid)]
    d = np.linalg.norm(xy0[:, None, :] - xym1[None, :, :], axis=-1).min(axis=1)
    assert np.median(d) < 1.0, np.median(d)

    # All upscale-octave coordinates must stay inside the input image
    assert xym1.min() > -1.5
    assert xym1.max() < img.shape[0] + 1.5


def test_double_size_supersample_values():
    img = jnp.asarray(np.arange(6, dtype=np.float32).reshape(2, 3))
    up = np.asarray(sift.double_size_supersample(img))
    assert up.shape == (4, 6)
    # out[2i,2j] = in[i,j]; out[2i,2j+1] = avg row-neighbours;
    # out[2i+1,2j] = avg col-neighbours; corners clamp
    np.testing.assert_allclose(up[0, :3], [0.0, 0.5, 1.0])
    np.testing.assert_allclose(up[1, 0], 1.5)   # (0+3)/2
    np.testing.assert_allclose(up[1, 1], 2.0)   # (0+1+3+4)/4
    np.testing.assert_allclose(up[3, 5], 5.0)   # clamped corner


@pytest.mark.slow
def test_batched_extraction_matches_single():
    """extract_all_view_features (one vmapped program per shape group) must
    produce exactly the same per-view features as the per-view path."""
    from orthosfm_tpu.config import ReconstructionConfig
    from orthosfm_tpu.data.views import View
    from orthosfm_tpu.pipeline import matching as pm

    cfg = ReconstructionConfig()
    views = []
    for seed in range(3):
        centers, amps, sigmas = _scene(seed=seed)
        img = (_blob_image(centers, amps, sigmas) * 255).astype(np.uint8)
        v = View(view_id=seed, image_path=f"mem_{seed}.png",
                 width=img.shape[1], height=img.shape[0],
                 pixels=np.stack([img] * 3, -1))
        views.append(v)

    batched = pm.extract_all_view_features(views, cfg)
    for v, fb in zip(views, batched):
        fs = pm.extract_view_features(v, cfg)
        np.testing.assert_array_equal(fb.xy, fs.xy)
        np.testing.assert_array_equal(fb.sift_desc, fs.sift_desc)
        np.testing.assert_array_equal(fb.surf_desc, fs.surf_desc)
        np.testing.assert_array_equal(fb.scale, fs.scale)


@pytest.mark.slow
def test_extract_batch_view_chunking_matches_unchunked(monkeypatch):
    """Reference-scale inputs force view-chunked extraction (sift.py HBM
    budget); the chunked path must produce identical features."""
    import numpy as np

    from orthosfm_tpu.ops import sift

    rng = np.random.default_rng(0)
    imgs = rng.uniform(0.0, 1.0, (3, 64, 64)).astype(np.float32)
    full = sift.extract_batch(imgs, per_octave_cap=128)
    monkeypatch.setattr(sift, "HBM_BUDGET_BYTES", 64 * 64 * 4 * 30 + 1)
    chunked = sift.extract_batch(imgs, per_octave_cap=128)
    np.testing.assert_allclose(np.asarray(chunked.desc), np.asarray(full.desc))
    np.testing.assert_array_equal(chunked.valid, full.valid)
    np.testing.assert_allclose(chunked.xy, full.xy)
