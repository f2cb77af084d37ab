"""Batched orthographic ray triangulation.

Batched equivalent of the reference's per-track OpenMP loop
(src/triangulation/triangulation.cpp:11-93): every track's least-squares
nearest-point-to-N-lines system Σ(I − d dᵀ)p = Σ(I − d dᵀ)o is assembled with
masked reductions and solved as a batch of 3×3 systems — one fused XLA program
instead of a parallel-for with per-track Eigen SVDs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from orthosfm_tpu.core import cameras as cam_mod
from orthosfm_tpu.data import tracks as tracks_mod


def intersect_rays(origins, directions, mask):
    """Least-squares intersection point of masked ray bundles.

    origins, directions: (..., N, 3); mask: (..., N) → points (..., 3), valid (...,).
    (reference: triangulation.cpp:11-42)
    """
    d = directions / jnp.maximum(jnp.linalg.norm(directions, axis=-1, keepdims=True), 1e-12)
    eye = jnp.eye(3, dtype=d.dtype)
    proj = eye - d[..., :, None] * d[..., None, :]  # (..., N, 3, 3)
    m = mask[..., None, None].astype(d.dtype)
    R = jnp.sum(proj * m, axis=-3)
    q = jnp.sum(jnp.einsum("...nij,...nj->...ni", proj, origins) * mask[..., None], axis=-2)
    n_rays = jnp.sum(mask, axis=-1)
    valid = n_rays >= 2
    # Small ridge keeps the solve defined for degenerate (parallel/too-few ray)
    # bundles; those results are masked out by `valid` anyway.
    R = R + 1e-8 * eye
    from orthosfm_tpu.solvers.ba import solve3x3

    pts = solve3x3(R, q)
    return pts, valid


def triangulate_tracks(
    cams: cam_mod.CameraSet,
    tracks: tracks_mod.TrackSet,
    cam_cols,
    reset_existing: bool = True,
) -> tracks_mod.TrackSet:
    out = _triangulate_tracks_jit(cams, tracks, cam_cols,
                                  reset_existing=reset_existing)
    # keep the input's view_ids buffer: host-side helpers cache the numpy
    # mirror per device buffer (tracks_mod.host_view_ids), and a jit output
    # would be a fresh buffer -> one ~25 ms readback per downstream call
    return out.replace(view_ids=tracks.view_ids)


@functools.partial(jax.jit, static_argnames=("reset_existing",))
def _triangulate_tracks_jit(
    cams: cam_mod.CameraSet,
    tracks: tracks_mod.TrackSet,
    cam_cols,
    reset_existing: bool = True,
) -> tracks_mod.TrackSet:
    """Triangulate all alive tracks against the cameras sitting at columns
    ``cam_cols`` of the track tensor (reference: triangulation.cpp:44-93).

    cam_cols: (V_c,) int column indices such that cams[i] observes column
    cam_cols[i]. Tracks with <2 rays get has_point=False when reset_existing.
    """
    cam_cols = jnp.asarray(cam_cols)
    pixels = tracks.obs[:, cam_cols, :]  # (T, Vc, 2)
    mask = tracks.obs_mask[:, cam_cols] & tracks.alive[:, None]  # (T, Vc)

    plane_pts = cam_mod.pixel_to_plane_point(cams, jnp.transpose(pixels, (1, 0, 2)))
    origins = jnp.transpose(plane_pts, (1, 0, 2))  # (T, Vc, 3)
    dirs = jnp.broadcast_to(cam_mod.look_directions(cams)[None, :, :], origins.shape)

    pts, valid = intersect_rays(origins, dirs, mask)
    new_points4 = jnp.concatenate([pts, jnp.ones_like(pts[..., :1])], axis=-1)

    if reset_existing:
        points = jnp.where(valid[:, None], new_points4, tracks.points)
        has_point = valid
    else:
        update = valid & ~tracks.has_point
        points = jnp.where(update[:, None], new_points4, tracks.points)
        has_point = tracks.has_point | update
    return tracks.replace(points=points, has_point=has_point & tracks.alive)
