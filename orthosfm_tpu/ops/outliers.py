"""Outlier filtering on track tensors.

Array-program equivalents of src/triangulation/outlier_filtering.cpp: the
O(N²) nearest-neighbour scan becomes one pairwise-distance matrix reduction,
and the per-feature reprojection filter becomes masked updates on the
observation mask instead of list surgery.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from orthosfm_tpu.config import FilterConfig
from orthosfm_tpu.core import cameras as cam_mod
from orthosfm_tpu.data import tracks as tracks_mod
from orthosfm_tpu.ops import triangulate


_NN_CHUNK = 2048  # rows per tile of the pairwise-distance sweep


def nearest_neighbor_distances(pts, has_pt):
    """Min distance from each pointed track to any other pointed track.

    The reference's O(N²) scan (outlier_filtering.cpp:14-38) becomes a
    row-chunked matmul sweep: each (chunk × T) distance tile is one
    matmul + reduction, and only O(chunk·T) memory is live — so the filter
    scales to ≥100k tracks instead of materializing a T×T matrix."""
    T = pts.shape[0]
    big = jnp.asarray(1e12, pts.dtype)
    sq = jnp.sum(pts * pts, axis=-1)  # (T,)
    chunk = min(_NN_CHUNK, T)
    n_chunks = -(-T // chunk)
    T_pad = n_chunks * chunk
    pts_p = jnp.pad(pts, ((0, T_pad - T), (0, 0)))
    sq_p = jnp.pad(sq, (0, T_pad - T))
    valid_p = jnp.pad(has_pt, (0, T_pad - T))
    idx_p = jnp.arange(T_pad)

    def tile(args):
        p_c, sq_c, v_c, i_c = args  # (chunk, 4), (chunk,), (chunk,), (chunk,)
        d2 = sq_c[:, None] + sq[None, :] - 2.0 * (p_c @ pts.T)  # (chunk, T)
        d2 = jnp.maximum(d2, 0.0)
        pair_valid = v_c[:, None] & has_pt[None, :] & (i_c[:, None] != jnp.arange(T)[None, :])
        return jnp.min(jnp.where(pair_valid, d2, big), axis=1)

    d2min = jax.lax.map(tile, (pts_p.reshape(n_chunks, chunk, 4),
                               sq_p.reshape(n_chunks, chunk),
                               valid_p.reshape(n_chunks, chunk),
                               idx_p.reshape(n_chunks, chunk)))
    nn = jnp.sqrt(d2min.reshape(T_pad)[:T])
    return jnp.where(has_pt, nn, 0.0)


def filter_outlier_tracks(tracks: tracks_mod.TrackSet,
                          cfg: FilterConfig = FilterConfig()) -> tracks_mod.TrackSet:
    out = _filter_outlier_tracks_jit(tracks, cfg=cfg)
    return out.replace(view_ids=tracks.view_ids)  # keep host-cached buffer


@functools.partial(jax.jit, static_argnames=("cfg",))
def _filter_outlier_tracks_jit(tracks: tracks_mod.TrackSet,
                          cfg: FilterConfig = FilterConfig()) -> tracks_mod.TrackSet:
    """Drop triangulated tracks whose nearest-neighbour distance exceeds
    mean + 1.6·σ, or that lie outside the radius-10 bounding sphere; tracks
    without points are always kept (reference: outlier_filtering.cpp:40-125).

    Note: the reference's σ divides the squared sum by 2N (its counter keeps
    incrementing through the second loop, outlier_filtering.cpp:83-94); we
    reproduce that exactly for behavioral parity — the effective threshold is
    mean + 1.6·σ_true/√2.
    """
    has_pt = tracks.has_point & tracks.alive
    pts = tracks.points  # (T, 4) homogeneous; reference measures 4-D norms
    nn = nearest_neighbor_distances(pts, has_pt)

    n = jnp.maximum(jnp.sum(has_pt), 1)
    mean = jnp.sum(nn) / n
    sq_sum = jnp.sum(jnp.where(has_pt, (nn - mean) ** 2, 0.0))
    sigma = jnp.sqrt(sq_sum / (2 * n))  # reference's double-counted divisor
    sigma = jnp.maximum(sigma, cfg.nn_sigma_floor)

    p3 = tracks.points  # reference uses the homogeneous 4-vector norm (w=1)
    in_sphere = jnp.linalg.norm(p3, axis=-1) <= cfg.bounding_radius
    keep_pointed = (nn < mean + cfg.nn_sigma_threshold * sigma) & in_sphere
    keep = jnp.where(has_pt, keep_pointed, True) & tracks.alive
    return tracks.replace(alive=keep, has_point=tracks.has_point & keep)


def filter_tracks_reprojection_error(
    tracks: tracks_mod.TrackSet,
    cams: cam_mod.CameraSet,
    cam_cols,
    cfg: FilterConfig = FilterConfig(),
) -> tracks_mod.TrackSet:
    out = _filter_reproj_jit(tracks, cams, cam_cols, cfg=cfg)
    return out.replace(view_ids=tracks.view_ids)  # keep host-cached buffer


@functools.partial(jax.jit, static_argnames=("cfg",))
def _filter_reproj_jit(
    tracks: tracks_mod.TrackSet,
    cams: cam_mod.CameraSet,
    cam_cols,
    cfg: FilterConfig = FilterConfig(),
) -> tracks_mod.TrackSet:
    """Per-feature reprojection filter (reference: outlier_filtering.cpp:127-192).

    Full-size tracks (w.r.t. the given cameras) are triangulated; their features
    observed by those cameras are dropped when the reprojection error exceeds
    1.5 px; a filtered track survives only with ≥2 features. Non-full-size
    tracks pass through untouched. Features of cameras outside the set are
    always kept ("no judgement can be made").
    """
    cam_cols = jnp.asarray(cam_cols)
    full = tracks_mod.full_size_mask(tracks, cam_cols)

    # Triangulate the full-size tracks against these cameras (fresh points,
    # not the stored ones — mirrors the local triangulation at :131-134)
    tri = triangulate.triangulate_tracks(cams, tracks.replace(alive=full), cam_cols)
    pts = tri.points

    obs = tracks.obs[:, cam_cols, :]
    pix = cam_mod.project(cams, pts)  # (Vc, T, 2)
    err = jnp.linalg.norm(jnp.transpose(pix, (1, 0, 2)) - obs, axis=-1)  # (T, Vc)
    feat_ok = err < cfg.max_reprojection_error_px

    # Update the obs mask only for (full track, in-set camera) features
    col_sel = jnp.zeros((tracks.num_views,), bool).at[cam_cols].set(True)
    remove = jnp.zeros_like(tracks.obs_mask)
    remove = remove.at[:, cam_cols].set(~feat_ok)
    remove = remove & full[:, None] & col_sel[None, :]
    new_mask = tracks.obs_mask & ~remove

    counts = jnp.sum(new_mask, axis=1)
    keep = jnp.where(full, counts >= 2, True) & tracks.alive
    return tracks.replace(obs_mask=new_mask, alive=keep,
                          has_point=tracks.has_point & keep)
