"""Feature matching orchestration: views → SIFT features → exhaustive pairwise
matching with geometric verification → tracks.

The array-program calculateTracksUsingMVE (reference: src/matching/
matching_mve.cpp:247-473): no on-disk MVE scene — images go straight through
the JAX SIFT, pairs run as batched device programs, track building is a host
union-find. Gates and thresholds follow the reference's bundler configuration
(matching_mve.cpp:393-417): lowres pre-gate (500 features, ≥5 matches) when
|f1|·|f2| > 1e6, Lowe ratio 0.8, ≥max(8, 50) consistent matches,
RANSAC-F 1000 iterations at 0.0015, ≥max(8, 30) inliers.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from orthosfm_tpu.config import ReconstructionConfig
from orthosfm_tpu.data import tracks as tracks_mod
from orthosfm_tpu.data.views import View
from orthosfm_tpu.ops import matching as match_ops
from orthosfm_tpu.ops import ransac_f, sift
from orthosfm_tpu.parallel import matching_sharded
from orthosfm_tpu.pipeline import tracks_build
from orthosfm_tpu.utils.profiling import stage as _stage


@dataclasses.dataclass
class ViewFeatures:
    """Combined per-view features, ordered [SIFT..., SURF...] like MVE's
    FeatureSet (feature_set.cc). Descriptors stay per-type (128-d / 64-d) and
    are matched separately, then combined with index offsets
    (mve/sfm/matching.cc combine_results).

    Coordinates/scales are host numpy (tiny, drive host-side gating);
    descriptors are DEVICE arrays — they are produced on device, matched on
    device, and never copied to the host."""

    xy: np.ndarray  # (N, 2) pixel coords in the view's (config-downscaled) image
    norm_xy: np.ndarray  # (N, 2) MVE-normalized coords
    scale: np.ndarray  # (N,)
    sift_desc: jnp.ndarray  # (Ns, 128) device
    surf_desc: jnp.ndarray  # (Nu, 64) device

    @property
    def count(self) -> int:
        return self.xy.shape[0]

    @property
    def n_sift(self) -> int:
        return self.sift_desc.shape[0]


def _bucket(n: int, step: int = 512) -> int:
    return max(step, ((n + step - 1) // step) * step)


@functools.partial(jax.jit, static_argnames=("halvings", "pad_h", "pad_w"))
def _prepare_gray_jit(sum_u16, halvings: int, pad_h: int, pad_w: int):
    """One program: grayscale from channel sums → `halvings` MVE half-size
    reductions → edge-pad to the (pad_h, pad_w) shape bucket, over a
    (V, H, W) uint16 channel-sum stack: one launch instead of ~80 tiny
    per-view ones (16 views × {gray, halve×k, pad}).

    The host pre-sums the RGB channels into uint16 (exact: ≤ 3·255) so only
    2 bytes/px go to the device instead of 3; the division below
    reproduces sift.grayscale's mean/255 value (MVE DESATURATE_AVERAGE)
    with one f32 rounding instead of three."""
    gray = sum_u16.astype(jnp.float32) / (3.0 * 255.0)
    for _ in range(halvings):
        gray = jax.vmap(sift.half_size_gaussian)(gray)
    H, W = gray.shape[1:]
    if (H, W) != (pad_h, pad_w):
        gray = jnp.pad(gray, ((0, 0), (0, pad_h - H), (0, pad_w - W)),
                       mode="edge")
    return gray


def _halving_plan(H: int, W: int, max_pixels: int):
    """(halvings, h, w) after MVE-style repeated half-size until ≤ max_pixels
    (reference: bundler_features.cc:66-68)."""
    halvings, h, w = 0, H, W
    while h * w > max_pixels:
        h, w = (h + 1) // 2, (w + 1) // 2
        halvings += 1
    return halvings, h, w


def _prepare_grays(views: List[View], config: ReconstructionConfig):
    """Per-view (gray_row, halvings, h_orig, w_orig) with one stacked
    transfer + one device program per distinct input shape. The gray images
    stay on device end-to-end."""
    by_shape = {}
    for i, v in enumerate(views):
        by_shape.setdefault(v.pixels.shape, []).append(i)
    prepared = [None] * len(views)
    for shape, idxs in by_shape.items():
        H, W = shape[:2]
        halvings, h, w = _halving_plan(H, W, config.matching.max_image_pixels)
        pad_h, pad_w = -(-h // 128) * 128, -(-w // 128) * 128
        # Host-stacked uint16 channel sums, ONE device_put instead of a
        # transfer per view. The u16 sum is the cheapest exact grayscale
        # precursor (2 B/px, value ≤ 3·255); it runs across a thread pool
        # because large ufuncs release the GIL, so threads scale.
        from concurrent.futures import ThreadPoolExecutor

        def _sum_u16(i):
            return np.sum(views[i].pixels, axis=-1, dtype=np.uint16)

        with ThreadPoolExecutor(max_workers=8) as pool:
            sums = np.stack(list(pool.map(_sum_u16, idxs)))
        stack_u16 = jax.device_put(sums)
        gray = _prepare_gray_jit(stack_u16, halvings, pad_h, pad_w)
        for bi, i in enumerate(idxs):
            prepared[i] = (gray[bi], halvings, h, w)
    return prepared


def _assemble_features(view: View, config: ReconstructionConfig,
                       sift_np, surf_np, halvings, h_orig, w_orig
                       ) -> ViewFeatures:
    """Filter/sort/scale one view's raw detector outputs into ViewFeatures.
    sift_np/surf_np: dict-like (xy, scale, valid) numpy + device "desc"
    fields for this view; surf_np may be None. Descriptor selection happens
    as device row gathers (host only computes the index lists)."""

    def in_bounds(xy):
        return (xy[:, 0] < w_orig - 0.5) & (xy[:, 1] < h_orig - 0.5)

    v = sift_np["valid"] & in_bounds(sift_np["xy"])
    rows_s = np.flatnonzero(v)
    xy_s = sift_np["xy"][rows_s]
    scale_s = sift_np["scale"][rows_s] * (2.0**halvings)

    if surf_np is not None:
        sv = surf_np["valid"] & in_bounds(surf_np["xy"])
        rows_u = np.flatnonzero(sv)
        xy_u = surf_np["xy"][rows_u]
        scale_u = surf_np["scale"][rows_u] * (2.0**halvings)
    else:
        rows_u = np.zeros((0,), np.int64)
        xy_u = np.zeros((0, 2), np.float32)
        scale_u = np.zeros((0,), np.float32)

    cap = config.matching.max_features_per_view
    if xy_s.shape[0] > cap:
        order = np.argsort(-scale_s)[:cap]
        xy_s, scale_s, rows_s = xy_s[order], scale_s[order], rows_s[order]
    if xy_u.shape[0] > cap:
        order = np.argsort(-scale_u)[:cap]
        xy_u, scale_u, rows_u = xy_u[order], scale_u[order], rows_u[order]

    sift_desc = sift_np["desc"][jnp.asarray(rows_s, jnp.int32)]
    surf_desc = (surf_np["desc"][jnp.asarray(rows_u, jnp.int32)]
                 if surf_np is not None else jnp.zeros((0, 64), jnp.float32))

    xy = np.concatenate([xy_s, xy_u])
    scale = np.concatenate([scale_s, scale_u])
    # Map detected coords back to the view image (pixel centers: x' = 2x+0.5)
    for _ in range(halvings):
        xy = 2.0 * xy + 0.5

    w, h = float(view.width), float(view.height)
    maxdim = max(w, h)
    norm_xy = np.stack([(xy[:, 0] + 0.5 - w / 2.0) / maxdim,
                        (xy[:, 1] + 0.5 - h / 2.0) / maxdim], -1)
    return ViewFeatures(xy=xy, norm_xy=norm_xy, scale=scale,
                        sift_desc=sift_desc, surf_desc=surf_desc)


def _features_host_dicts(feats):
    """Split a (batched) Features/SurfFeatures into host metadata numpy
    arrays + the device descriptor tensor."""
    d = {k: np.asarray(getattr(feats, k)) for k in ("xy", "scale", "valid")}
    d["desc"] = feats.desc  # device
    return d


def extract_view_features(view: View, config: ReconstructionConfig) -> ViewFeatures:
    """Single-view extraction (the batched path below is the pipeline's)."""
    return extract_all_view_features([view], config)[0]


def extract_all_view_features(views: List[View],
                              config: ReconstructionConfig) -> List[ViewFeatures]:
    """Batched extraction: views group by (bucketed shape, halvings) and each
    group's SIFT/SURF runs as ONE vmapped device program over the view stack —
    the batched replacement for MVE's per-view omp loop
    (bundler_features.cc:40)."""
    with _stage("extract/prepare_gray"):
        prepared = _prepare_grays(views, config)
    groups = {}
    for i, (gray, halvings, ho, wo) in enumerate(prepared):
        groups.setdefault((gray.shape, halvings), []).append(i)

    out: List[ViewFeatures] = [None] * len(views)  # type: ignore[list-item]
    for (_, halvings), idxs in groups.items():
        stack = jnp.stack([prepared[i][0] for i in idxs])
        with _stage("extract/sift"):
            fs = sift.extract_batch(stack,
                                    min_octave=config.matching.sift_min_octave)
            fs_np = _features_host_dicts(fs)
        fu_np = None
        if config.matching.use_surf:
            from orthosfm_tpu.ops import surf as surf_mod

            with _stage("extract/surf"):
                fu = surf_mod.extract_batch(stack)
                fu_np = _features_host_dicts(fu)
        with _stage("extract/assemble"):
            for bi, i in enumerate(idxs):
                s_i = {k: a[bi] for k, a in fs_np.items()}
                u_i = ({k: a[bi] for k, a in fu_np.items()}
                       if fu_np is not None else None)
                out[i] = _assemble_features(views[i], config, s_i, u_i,
                                            halvings,
                                            prepared[i][2], prepared[i][3])
    return out



def _stack_descriptors(descs, cap):
    """(V, cap, D) stacked+padded DEVICE descriptor tensor and (V,) host
    counts. Per-view descriptors are already on device; padding/stacking are
    device ops (no host traffic)."""
    counts = np.array([min(d.shape[0], cap) for d in descs], np.int32)
    padded = [jnp.pad(d[:cap], ((0, cap - min(d.shape[0], cap)), (0, 0)))
              for d in descs]
    return jnp.stack(padded), counts


def _batched_pair_matches(stack, counts, pairs, ratio, pair_valid_n=None,
                          mesh=None):
    """Run match_pairs_batched over `pairs` in chunks.

    stack: (V, N, D) device; counts: (V,) host; pairs: list of (i, j).
    pair_valid_n: optional (P, 2) per-pair valid-count override (lowres gate).
    mesh: optional device mesh — the pair axis of every chunk shards over it
    (parallel/matching_sharded.py), each device matching its pair shard.
    Returns (P, N) int matches array (np — the downstream gates are host
    logic; one small pull per chunk)."""
    P = len(pairs)
    N = stack.shape[1]
    if P == 0:
        return np.zeros((0, N), np.int64)
    pi = np.array([p[0] for p in pairs])
    pj = np.array([p[1] for p in pairs])
    ci = counts[pi] if pair_valid_n is None else pair_valid_n[:, 0]
    cj = counts[pj] if pair_valid_n is None else pair_valid_n[:, 1]
    iota = np.arange(N)

    def make_args(idx):
        return (stack[jnp.asarray(pi[idx])],
                jnp.asarray(iota[None, :] < ci[idx, None]),
                stack[jnp.asarray(pj[idx])],
                jnp.asarray(iota[None, :] < cj[idx, None]))

    # Cap the chunk so the (B, N, N) similarity block stays ≲1 GB per device
    return matching_sharded.run_pair_chunks(
        functools.partial(match_ops.match_pairs_batched,
                          lowe_ratio=float(ratio)),
        make_args, P, (1 << 28) // max(N * N, 1), mesh).astype(np.int64)


def match_all_pairs(features: List[ViewFeatures], config: ReconstructionConfig,
                    verbose: bool = True, mesh=None):
    """Exhaustive pairwise matching with gates; returns
    [(i, j, idx_i, idx_j), ...] inlier match lists.

    Batched orchestration: instead of the reference's omp-parallel per-pair
    loop (bundler_matching.cc:74-96), descriptors stack into (V, N, D)
    tensors once and the low-res gate + full SIFT/SURF matching run as
    BATCHED device programs over pair chunks — one compiled program for the
    whole stage, large similarity matmuls, no per-pair dispatch.
    With a mesh, every batched pair program (similarity matmuls AND the
    RANSAC verification) shards its pair axis over the devices
    (parallel/matching_sharded.py) with per-pair keys, reproducing the
    single-device results (bit-for-bit on the CPU backend; see
    matching_sharded for GPUs)."""
    m = config.matching
    if m.matcher not in ("cascade_hashing", "exhaustive"):
        raise ValueError(f"unknown matcher {m.matcher!r} "
                         "(expected 'cascade_hashing' or 'exhaustive')")
    # Both engines run the exact exhaustive matcher — see
    # MatchingConfig.matcher for why cascade hashing maps onto it.
    n_views = len(features)
    key = jax.random.PRNGKey(config.seed + 7919)
    all_pairs = [(i, j) for i in range(n_views) for j in range(i + 1, n_views)
                 if features[i].count and features[j].count]
    if not all_pairs:
        if verbose:
            print("Found a total of 0 matching image pairs.")
        return []

    # --- Low-res matchability gate, batched (two_view_matching,
    # bundler_matching.cc:146-158). Per the reference's pairwise_match_lowres
    # (exhaustive_matching.cc:147-176): gate on lowres SIFT when the FIRST
    # view has SIFT features, otherwise on lowres SURF; each view contributes
    # min(lowres_feature_count, its own count) features independently.
    gated = [(i, j) for (i, j) in all_pairs
             if features[i].count * features[j].count > 1_000_000]
    passed = {p: True for p in all_pairs}
    gated_by_type = {
        "sift": [p for p in gated if features[p[0]].n_sift],
        "surf": [p for p in gated
                 if not features[p[0]].n_sift
                 and features[p[0]].count - features[p[0]].n_sift],
    }
    for kind, gpairs in gated_by_type.items():
        if not gpairs:
            continue
        with _stage("match/lowres_gate"):
            if kind == "sift":
                per_view = [(f.scale[:f.n_sift], f.sift_desc)
                            for f in features]
                ratio = m.lowe_ratio
            else:
                per_view = [(f.scale[f.n_sift:], f.surf_desc)
                            for f in features]
                ratio = m.surf_lowe_ratio
            nlow_cap = min(m.lowres_feature_count,
                           max(max(s.shape[0] for s, _ in per_view), 1))
            low_descs = []
            for scale, desc in per_view:
                order = np.argsort(-scale)[:nlow_cap]
                low_descs.append(desc[jnp.asarray(order, jnp.int32)])
            low_stack, low_counts = _stack_descriptors(low_descs, nlow_cap)
            m_low = _batched_pair_matches(low_stack, low_counts, gpairs,
                                          ratio, mesh=mesh)
        for p, row in zip(gpairs, m_low):
            if int((row >= 0).sum()) < m.lowres_match_threshold:
                passed[p] = False
                if verbose:
                    print(f"Pair ({p[0]},{p[1]}) rejected, low-res matches "
                          f"below {m.lowres_match_threshold}.")
    pairs = [p for p in all_pairs if passed[p]]

    # --- Full SIFT + SURF matching, batched per descriptor type
    with _stage("match/full_sift"):
        ns_cap = _bucket(max(f.n_sift for f in features))
        sift_stack, sift_counts = _stack_descriptors(
            [f.sift_desc for f in features], ns_cap)
        m_sift = _batched_pair_matches(sift_stack, sift_counts, pairs,
                                       m.lowe_ratio, mesh=mesh)
    with _stage("match/full_surf"):
        nu_max = max(f.surf_desc.shape[0] for f in features)
        if nu_max > 0:
            nu_cap = _bucket(nu_max)
            surf_stack, surf_counts = _stack_descriptors(
                [f.surf_desc for f in features], nu_cap)
            m_surf = _batched_pair_matches(surf_stack, surf_counts, pairs,
                                           m.surf_lowe_ratio, mesh=mesh)
        else:
            m_surf = np.zeros((len(pairs), 0), np.int64)

    # --- Combine per-type match lists and apply the match-count gate
    candidates = []  # (i, j, idx_i, idx_j)
    for pi, (i, j) in enumerate(pairs):
        fi, fj = features[i], features[j]
        # Combine the per-type match lists with index offsets
        # (mve/sfm/matching.cc combine_results)
        m12 = np.full(fi.count, -1, np.int64)
        row = m_sift[pi, :fi.n_sift]
        hit = row >= 0
        m12[:fi.n_sift][hit] = row[hit]
        n_surf_i = fi.count - fi.n_sift
        if n_surf_i and m_surf.shape[1]:
            row = m_surf[pi, :n_surf_i]
            hit = row >= 0
            m12[fi.n_sift:][hit] = row[hit] + fj.n_sift

        n_match = int((m12 >= 0).sum())
        if n_match < max(8, m.min_feature_matches):
            if verbose:
                print(f"Pair ({i},{j}) rejected, {n_match} matches below "
                      f"threshold {max(8, m.min_feature_matches)}.")
            continue
        idx_i = np.flatnonzero(m12 >= 0)
        candidates.append((i, j, idx_i, m12[idx_i]))

    # --- Geometric verification: all candidate pairs verify in chunks of one
    # compiled program each (vs MVE's per-pair 1000-iteration loops)
    results = []
    homography = m.pair_verification == "homography"
    M = _bucket(max((len(c[2]) for c in candidates), default=1), 256)
    P = len(candidates)
    p1 = np.zeros((P, M, 2), np.float32)
    p2 = np.zeros((P, M, 2), np.float32)
    valid = np.zeros((P, M), bool)
    for pi, (i, j, idx_i, idx_j) in enumerate(candidates):
        # CudaSift-style homographies on pixel coordinates (alternate engine,
        # reference: matching.cpp:172-199); fundamental matrices on
        # MVE-normalized ones
        xy_i = features[i].xy if homography else features[i].norm_xy
        xy_j = features[j].xy if homography else features[j].norm_xy
        p1[pi, :len(idx_i)] = xy_i[idx_i]
        p2[pi, :len(idx_i)] = xy_j[idx_j]
        valid[pi, :len(idx_i)] = True
    if homography:
        from orthosfm_tpu.ops import ransac_h

        fn = functools.partial(
            ransac_h.find_homography_batched_keys,
            iterations=m.homography_iterations,
            threshold_px=m.homography_threshold_px,
            find_threshold_px=m.homography_find_threshold_px)
        iterations, min_required = (m.homography_iterations,
                                    m.homography_min_inliers)
    else:
        fn = functools.partial(ransac_f.ransac_fundamental_batched_keys,
                               iterations=m.ransac_f_iterations,
                               threshold=m.ransac_f_threshold)
        iterations = m.ransac_f_iterations
        min_required = max(m.min_pair_inliers_to_accept,
                           m.min_matching_inliers)
    if P:
        key, k = jax.random.split(key)
        # Per-pair keys split once over ALL candidates: the draws are then
        # independent of chunk size and of the device count
        all_keys = jax.random.split(k, P)
        with _stage("match/verify_ransac"):
            # Chunk so the (chunk, iterations, M) error blocks stay ≲0.5 GB
            # per device
            res = matching_sharded.run_pair_chunks(
                fn, lambda idx: (p1[idx], p2[idx], valid[idx],
                                 all_keys[jnp.asarray(idx)]),
                P, (1 << 27) // max(iterations * M, 1), mesh)
        for (i, j, idx_i, idx_j), n_inl, inl in zip(
                candidates, res.num_inliers, res.inliers):
            if n_inl < min_required:
                if verbose:
                    print(f"Pair ({i},{j}) rejected, {n_inl} inliers below "
                          f"threshold {min_required}.")
                continue
            inl = inl[: len(idx_i)]
            results.append((i, j, idx_i[inl], idx_j[inl]))
            if verbose:
                print(f"Pair ({i},{j}) matched, {n_inl} inliers.")
    if verbose:
        print(f"Found a total of {len(results)} matching image pairs.")
    return results


def build_tracks(views: List[View], config: ReconstructionConfig,
                 verbose: bool = True, mesh=None) -> tracks_mod.TrackSet:
    """Full matching stage: SIFT → pairwise matching → union-find tracks.

    mesh: optional device mesh — pairwise matching + RANSAC verification
    shard their pair axis over it (see match_all_pairs)."""
    features = extract_all_view_features(views, config)
    if verbose:
        for v, f in zip(views, features):
            print(f"{v.display_name} {f.count} features "
                  f"({f.n_sift} SIFT + {f.count - f.n_sift} SURF)")
    pair_matches = match_all_pairs(features, config, verbose=verbose,
                                   mesh=mesh)
    return tracks_from_matches(views, features, pair_matches)


def tracks_from_matches(views: List[View], features: List[ViewFeatures],
                        pair_matches) -> tracks_mod.TrackSet:
    """Union-find + TrackSet assembly from verified pairwise matches."""
    with _stage("tracks/union_find"):
        feature_counts = [f.count for f in features]
        raw_tracks = tracks_build.build_tracks(pair_matches, feature_counts)

    with _stage("tracks/assemble"):
        view_ids = np.asarray([v.view_id for v in views], np.int32)
        track_list = []
        for t_id, members in enumerate(raw_tracks):
            feats = []
            for (vi, fi) in members:
                x, y = features[vi].xy[fi]
                gid = vi * (1 << 20) + fi
                feats.append((int(view_ids[vi]), int(fi), int(gid),
                              float(x), float(y), 0, 0, 0))
            track_list.append(feats)
        return tracks_mod.from_feature_lists(track_list, view_ids,
                                             capacity=max(len(track_list), 1))


def filter_duplicate_tracks(tracks):
    """No-op duplicate-track filter.

    API parity with the reference's filterDuplicateTracks, whose hnswlib-based
    body is fully commented out and which returns its input unchanged
    (src/matching/matching.cpp:370-436).
    """
    return tracks
