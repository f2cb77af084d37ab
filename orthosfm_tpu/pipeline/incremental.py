"""Incremental group-wise pose estimation — the pipeline's algorithmic core.

Reproduces runPoseEstimation (reference: src/sfm/reconstruct.cpp:174-295):
greedy group schedule → per group RANSAC'd Tomasi-Kanade init → reprojection
filter → local BA (with retriangulation) → first group seeds the global scene,
later groups align/merge → every 3rd group a global BA + outlier filters →
scene normalization → final global BA.

Array design: the global camera set is a fixed-capacity CameraSet covering ALL
views from the start (absent cameras are flagged fixed and carry no
observations), so the global-BA XLA program compiles once; only the host-side
`present` mask grows. Group control flow stays in Python (inherently
sequential, data-dependent); each numeric stage is a jitted program.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from orthosfm_tpu.config import ReconstructionConfig, SolverType
from orthosfm_tpu.core import cameras as cam_mod
from orthosfm_tpu.core import quaternions as quat
from orthosfm_tpu.core import umeyama
from orthosfm_tpu.data import tracks as tracks_mod
from orthosfm_tpu.ops import outliers, triangulate
from orthosfm_tpu.pipeline import grouping
from orthosfm_tpu.solvers import ba
from orthosfm_tpu.solvers import tomasi_kanade as tk


class TooFewTracksError(RuntimeError):
    """Raised when a group has <10 full-size tracks
    (reference: tomasi_kanade.cpp:202-205)."""


class MeshRunners:
    """Distributed solver dispatch for run_pose_estimation.

    When a jax.sharding.Mesh with >1 device is supplied, every bundle
    adjustment routes through parallel.ba_sharded (tracks/observations/point
    blocks sharded over the mesh, psum-reduced camera system) and every
    Tomasi-Kanade initialization through parallel.tk_sharded (hypotheses
    sharded, scores all-gathered). Single-device meshes fall back to the plain
    jit paths. Solver functions are cached per (optimize_points, config)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.n_devices = int(mesh.devices.size) if mesh is not None else 1
        self.active = mesh is not None and self.n_devices > 1
        self._ba_cache = {}
        self._tk_cache = {}

    def ba_run(self, cams, points4, obs, mask, optimize_points, config):
        if not self.active:
            return ba.run(cams, points4, obs, mask,
                          optimize_points=optimize_points, config=config)
        from orthosfm_tpu.parallel import ba_sharded

        key = (bool(optimize_points), config)
        if key not in self._ba_cache:
            self._ba_cache[key] = ba_sharded.make_sharded_ba(
                self.mesh, optimize_points=optimize_points, config=config)
        (points_p, obs_p, mask_p), T = ba_sharded.pad_tracks(
            [points4, obs, mask], self.n_devices)
        points_p, obs_p, mask_p = ba_sharded.shard_track_arrays(
            self.mesh, [points_p, obs_p, mask_p])
        res = self._ba_cache[key](cams, points_p, obs_p, mask_p)
        return ba.BAResult(cams=res.cams, points=res.points[:T],
                           cost=res.cost, initial_cost=res.initial_cost,
                           iterations=res.iterations)

    def tk_run(self, obs, valid, widths, heights, key, cfg):
        if not self.active:
            return tk.robust_factorization(obs, valid, widths, heights, key,
                                           cfg=cfg)
        from orthosfm_tpu.parallel import tk_sharded

        if cfg not in self._tk_cache:
            self._tk_cache[cfg] = tk_sharded.make_sharded_tk(self.mesh, cfg=cfg)
        return self._tk_cache[cfg](obs, valid, widths, heights, key)


@dataclasses.dataclass
class PoseEstimationResult:
    cameras: cam_mod.CameraSet  # V_total rows, only `present` valid
    present: np.ndarray  # (V_total,) bool
    insertion_order: List[int]  # view ids in reconstruction order
    tracks: tracks_mod.TrackSet  # filtered + triangulated global tracks


def _cols_for(tracks: tracks_mod.TrackSet, ids):
    return tracks_mod.columns_for_view_ids(tracks, ids)


# Jitted wrappers for the per-group glue: outside jit every jnp op dispatches
# its own device program; at ~14 groups x dozens of ops the eager chains
# dominated pose-estimation wall time (round-4 stage profile).
_normalize_to_cam_jit = jax.jit(cam_mod.normalize_scene_to_camera)
_take_jit = jax.jit(cam_mod.take)
_resolve_ambiguity_jit = jax.jit(tk.resolve_ambiguity)


@functools.partial(jax.jit, static_argnames=("solver",))
def _from_basis_jit(model, ids, widths, heights, solver):
    return cam_mod.from_basis(model, ids, widths, heights, solver)


def _make_group_cameras(model, ids, widths, heights, solver) -> cam_mod.CameraSet:
    return _from_basis_jit(model, np.asarray(ids, np.int32),
                           np.asarray(widths, np.float32),
                           np.asarray(heights, np.float32), solver)


@jax.jit
def _global_direction(global_cams: cam_mod.CameraSet, i0, i1):
    """normalize(origin₁) − normalize(origin₀) after rotating the scene so
    camera i0 has identity basis (reference: tomasi_kanade.cpp:411-419)."""
    R = cam_mod.basis(global_cams)
    o = R @ jnp.array([0.0, 0.0, -cam_mod.CAMERA_DISTANCE])
    R0 = R[i0]
    o_rot = jnp.einsum("ij,vi->vj", R0, o)  # R0ᵀ · o
    on = o_rot / jnp.maximum(jnp.linalg.norm(o_rot, axis=-1, keepdims=True), 1e-12)
    return on[i1] - on[i0]


@functools.partial(jax.jit,
                   static_argnames=("overlap_local_idx", "overlap_global_idx"))
def align_to_global(local: cam_mod.CameraSet, global_cams: cam_mod.CameraSet,
                    overlap_local_idx, overlap_global_idx) -> cam_mod.CameraSet:
    """Transform the local group into the global frame.

    Quaternion path: slerp(0.5) of the two local→global relative rotations,
    falling back to the second when the first is ≈ identity (reference:
    OrthoQuaternionRecoAlgorithm.cpp:72-118). Euler path: Umeyama over
    origin+axes correspondences of every overlapping camera (reference:
    OrthographicReconstructionAlgorithm.cpp:101-142).
    """
    if local.kind == "quat":
        q_l = quat.normalize(local.rot[jnp.asarray(overlap_local_idx)])
        q_g = quat.normalize(global_cams.rot[jnp.asarray(overlap_global_idx)])
        trans = quat.from_to_rotation(q_l, q_g)  # (2, 4)
        smoothed = quat.slerp(trans[0], trans[1], 0.5)
        t0 = trans[0]
        dist_identity = jnp.sqrt((1.0 - t0[0]) ** 2 + jnp.sum(t0[1:] ** 2))
        smoothed = jnp.where(dist_identity < 0.05, trans[1], smoothed)
        return cam_mod.apply_rotation(local, smoothed)

    R_l = cam_mod.basis(local)[jnp.asarray(overlap_local_idx)]  # (K, 3, 3)
    R_g = cam_mod.basis(global_cams)[jnp.asarray(overlap_global_idx)]
    d = jnp.asarray(cam_mod.CAMERA_DISTANCE)
    o_l = R_l @ jnp.array([0.0, 0.0, -d])
    o_g = R_g @ jnp.array([0.0, 0.0, -d])
    # correspondences: origins + the three axis columns per camera
    src = jnp.concatenate([o_l, R_l[..., :, 0], R_l[..., :, 1], R_l[..., :, 2]], axis=0)
    dst = jnp.concatenate([o_g, R_g[..., :, 0], R_g[..., :, 1], R_g[..., :, 2]], axis=0)
    R = umeyama.rotation_align(src, dst)
    return cam_mod.apply_rotation(local, R)


def group_full_size_counts(tracks: tracks_mod.TrackSet, groups, col_of):
    """Per-group count of full-size tracks, fetched in ONE host readback.

    The incremental loop needs these counts to gate the too-few-tracks error
    and the pristine-init fallback; fetching them per group costs one
    host sync each. They only change
    when the global filters mutate obs_mask/alive, so the driver refreshes
    this vector after each filter event instead."""
    cols = np.asarray([[col_of[v] for v in ids] for ids in groups])  # (G, S)
    m = tracks.alive[:, None] & jnp.all(
        tracks.obs_mask[:, jnp.asarray(cols)], axis=2)  # (T, G)
    return np.asarray(jnp.sum(m, axis=0))


def initial_alignment(tracks: tracks_mod.TrackSet, ids, widths, heights,
                      solver: SolverType, key,
                      global_cams: Optional[cam_mod.CameraSet],
                      global_idx_pair,
                      config: ReconstructionConfig,
                      fallback_tracks: Optional[tracks_mod.TrackSet] = None,
                      verbose: bool = False,
                      runners: Optional[MeshRunners] = None,
                      n_valid: Optional[int] = None,
                      n_valid_fb: Optional[int] = None) -> cam_mod.CameraSet:
    """calculateInitialAlignment analog (reference:
    OrthoQuaternionRecoAlgorithm.cpp:23-50 / Orthographic...cpp:36-63).

    ``fallback_tracks`` (normally the pristine pre-filter track set) is used
    when the filtered set has too few full-size tracks for the group. Under
    heavy observation noise the global 1.5 px reprojection filter
    (reference: outlier_filtering.cpp:140) strips every feature of the
    already-placed cameras, which would starve all later groups — the
    reference hard-throws there (tomasi_kanade.cpp:202-205). Falling back to
    the unfiltered observations is safe for INITIALIZATION only, because the
    RANSAC around Tomasi-Kanade provides its own outlier robustness; BA and
    triangulation keep using the filtered set. With
    config.strict_reference_behavior the fallback is disabled and the group
    hard-fails exactly like the reference."""
    cols = _cols_for(tracks, ids)
    obs = tracks.obs[:, cols, :]
    valid = tracks_mod.full_size_mask(tracks, cols)
    if n_valid is None:  # not precomputed by the caller → one host readback
        n_valid = int(jnp.sum(valid))
    min_tracks = max(10, config.ransac.sample_size)
    if config.strict_reference_behavior:
        fallback_tracks = None
    if n_valid < min_tracks and fallback_tracks is not None:
        cols_fb = _cols_for(fallback_tracks, ids)
        valid_fb = tracks_mod.full_size_mask(fallback_tracks, cols_fb)
        if n_valid_fb is None:
            n_valid_fb = int(jnp.sum(valid_fb))
        if n_valid_fb > n_valid:
            if verbose:
                print(f"  group {list(ids)}: only {n_valid} filtered full-size "
                      "tracks; initializing from the unfiltered observations")
            obs = fallback_tracks.obs[:, cols_fb, :]
            valid = valid_fb
            n_valid = n_valid_fb
    if n_valid < min_tracks:
        raise TooFewTracksError(
            f"group {list(ids)}: only {n_valid} full-size tracks (<{min_tracks})")

    w = jnp.asarray(np.asarray(widths, np.float32))
    h = jnp.asarray(np.asarray(heights, np.float32))
    if runners is None:
        runners = MeshRunners(None)
    res = runners.tk_run(obs, valid, w, h, key, config.ransac)
    if global_cams is None:
        model = res.model1
    else:
        gdir = _global_direction(global_cams, *global_idx_pair)
        model = _resolve_ambiguity_jit(res.model1, res.model2, gdir)
    # model stays on device — from_basis consumes it lazily (no host sync)
    return _make_group_cameras(model, ids, widths, heights, solver)


def _local_ba(local_cams, tracks, cols, config, runners):
    """Local bundle adjustment with retriangulation; only cameras persist
    (reference: reconstruct.cpp:219 + bundle_adjustment.cpp:74-83)."""
    shared = tracks_mod.shared_mask(tracks, cols)
    local = tracks.replace(alive=shared)
    local = triangulate.triangulate_tracks(local_cams, local, cols)
    mask = local.obs_mask[:, cols] & local.alive[:, None] & local.has_point[:, None]
    res = runners.ba_run(local_cams, local.points, local.obs[:, jnp.asarray(cols)],
                         mask, optimize_points=True, config=config.ba)
    return res.cams, res


def _global_ba(global_cams, present, tracks, config, runners, view_ids_np):
    """Global bundle adjustment over all present cameras; optimizes and writes
    back point positions (reference: reconstruct.cpp:261, 281)."""
    cols = _cols_for(tracks, view_ids_np[present])
    present_cols = jnp.zeros((tracks.num_views,), bool).at[jnp.asarray(cols)].set(True)
    # Absent cameras are frozen so the full-capacity camera set is solvable
    cams = global_cams.replace(fixed=global_cams.fixed | ~jnp.asarray(present))
    all_cols = _cols_for(tracks, view_ids_np)
    mask = (tracks.obs_mask[:, all_cols] & present_cols[None, all_cols]
            & tracks.alive[:, None] & tracks.has_point[:, None])
    res = runners.ba_run(cams, tracks.points, tracks.obs[:, jnp.asarray(all_cols)],
                         mask, optimize_points=True, config=config.ba)
    new_cams = res.cams.replace(fixed=global_cams.fixed)
    # Rescale optimized (unit-norm) points back to w=1 form for export/filters
    pts = res.points
    w_comp = pts[..., 3:4]
    safe = jnp.where(jnp.abs(w_comp) < 1e-8, jnp.where(w_comp < 0, -1e-8, 1e-8), w_comp)
    pts = jnp.where(tracks.has_point[:, None], pts / safe, tracks.points)
    return new_cams, tracks.replace(points=pts), res


def run_pose_estimation(tracks: tracks_mod.TrackSet, widths, heights,
                        config: ReconstructionConfig,
                        verbose: bool = True,
                        mesh=None) -> PoseEstimationResult:
    """Full incremental alignment (reference: reconstruct.cpp:174-295).

    ``mesh``: optional jax.sharding.Mesh. With >1 device, every bundle
    adjustment and Tomasi-Kanade initialization runs through the sharded
    solvers (parallel.ba_sharded / parallel.tk_sharded) — tracks and RANSAC
    hypotheses partitioned over the mesh, psum/all-gather collectives."""
    runners = MeshRunners(mesh)
    solver = config.solver
    view_ids = tracks_mod.host_view_ids(tracks.view_ids)
    V = len(view_ids)
    widths = np.broadcast_to(np.asarray(widths, np.float32), (V,))
    heights = np.broadcast_to(np.asarray(heights, np.float32), (V,))
    key = jax.random.PRNGKey(config.seed)

    # Pristine snapshot for initialization fallback under heavy noise (the
    # global filters below mutate obs_mask/alive; see initial_alignment)
    pristine_tracks = tracks

    inc = np.asarray(tracks_mod.incidence(tracks)).astype(bool)
    groups = grouping.build_groups(view_ids, inc, config.group_size)
    if verbose:
        print(f"Built {len(groups)} groups: {groups}")

    # Full-capacity global camera set (rows ordered like track columns)
    if solver.is_quaternion:
        global_cams = cam_mod.make_quaternion(view_ids, widths, heights)
    else:
        global_cams = cam_mod.make_euler(view_ids, widths, heights, solver=solver)
    present = np.zeros(V, bool)
    insertion_order: List[int] = []
    col_of = {int(v): i for i, v in enumerate(view_ids)}

    # Per-group full-size-track counts, one readback for ALL groups instead
    # of one host sync per group; refreshed after global filter events
    # (the only mutations of obs_mask/alive). The pristine set never mutates
    # so its counts are fetched lazily at most once.
    group_counts = group_full_size_counts(tracks, groups, col_of)
    pristine_counts = None

    for gi, ids in enumerate(groups):
        processed = gi + 1
        if verbose:
            print(f"===== Reconstructing group {ids} ({processed}/{len(groups)}) =====")
        cols = _cols_for(tracks, ids)
        key, k_init = jax.random.split(key)

        n_valid = int(group_counts[gi])
        min_tracks = max(10, config.ransac.sample_size)
        if n_valid < min_tracks and pristine_counts is None \
                and not config.strict_reference_behavior:
            pristine_counts = group_full_size_counts(pristine_tracks, groups,
                                                     col_of)
        n_valid_fb = (int(pristine_counts[gi])
                      if pristine_counts is not None else None)
        if present.any():
            pair = (col_of[ids[0]], col_of[ids[1]])
            local_cams = initial_alignment(tracks, ids, widths[cols], heights[cols],
                                           solver, k_init, global_cams, pair, config,
                                           fallback_tracks=pristine_tracks,
                                           verbose=verbose, runners=runners,
                                           n_valid=n_valid, n_valid_fb=n_valid_fb)
        else:
            local_cams = initial_alignment(tracks, ids, widths[cols], heights[cols],
                                           solver, k_init, None, None, config,
                                           fallback_tracks=pristine_tracks,
                                           verbose=verbose, runners=runners,
                                           n_valid=n_valid, n_valid_fb=n_valid_fb)

        # Reprojection outlier filter on the LOCAL track copy (reconstruct.cpp:212)
        local_tracks = outliers.filter_tracks_reprojection_error(
            tracks, local_cams, cols, config.filters)

        first_group = not present.any()
        if first_group:
            local_cams = local_cams.replace(fixed=local_cams.fixed.at[0].set(True))

        local_cams, ba_res = _local_ba(local_cams, local_tracks, cols, config,
                                       runners)
        if verbose:
            print(f"  local BA: cost {float(ba_res.initial_cost):.1f} -> "
                  f"{float(ba_res.cost):.1f} in {int(ba_res.iterations)} iters")
            print("Optimized local alignment:")
            print(cam_mod.format_cameras(local_cams))

        if first_group:
            local_cams = _normalize_to_cam_jit(local_cams, 0)
            for j, vid in enumerate(ids):
                c = col_of[vid]
                global_cams = _set_camera(global_cams, c, local_cams, j)
                present[c] = True
                insertion_order.append(vid)
            tracks = _triangulate_global(global_cams, present, tracks, view_ids)
        else:
            overlap_local = [j for j, vid in enumerate(ids) if present[col_of[vid]]]
            overlap_global = [col_of[ids[j]] for j in overlap_local]
            if len(overlap_local) != config.group_size - 1 and verbose:
                print(f"  warning: {len(overlap_local)} overlapping cameras "
                      f"(expected {config.group_size - 1})")
            local_cams = align_to_global(local_cams, global_cams,
                                         tuple(overlap_local),
                                         tuple(overlap_global))
            # mergeIntoGlobal: only cameras not yet present are added
            for j, vid in enumerate(ids):
                c = col_of[vid]
                if not present[c]:
                    global_cams = _set_camera(global_cams, c, local_cams, j)
                    present[c] = True
                    insertion_order.append(vid)
            tracks = _triangulate_global(global_cams, present, tracks, view_ids)

            if processed % config.global_ba_interval == 0:
                global_cams, tracks, res = _global_ba(global_cams, present,
                                                      tracks, config, runners,
                                                      view_ids)
                if verbose:
                    print(f"  global BA: cost {float(res.initial_cost):.1f} -> "
                          f"{float(res.cost):.1f} in {int(res.iterations)} iters")
                tracks = outliers.filter_outlier_tracks(tracks, config.filters)
                pres_ids = view_ids[present]
                pres_cams = _take_jit(global_cams, _cols_for(tracks, pres_ids))
                tracks = outliers.filter_tracks_reprojection_error(
                    tracks, pres_cams, _cols_for(tracks, pres_ids), config.filters)
                # obs_mask/alive changed → refresh the per-group counts
                group_counts = group_full_size_counts(tracks, groups, col_of)

            global_cams = _normalize_global(global_cams, col_of[insertion_order[0]])
            if verbose:
                print("Current Cameras:")
                print(cam_mod.format_cameras(global_cams, mask=present))

    # Final global BA + normalize (reconstruct.cpp:281-282)
    global_cams, tracks, res = _global_ba(global_cams, present, tracks, config,
                                          runners, view_ids)
    if verbose:
        print(f"final BA: cost {float(res.initial_cost):.1f} -> {float(res.cost):.1f} "
              f"in {int(res.iterations)} iters")
    global_cams = _normalize_global(global_cams, col_of[insertion_order[0]])
    if verbose:
        print("Final Alignment:")
        print(cam_mod.format_cameras(global_cams, mask=present))

    return PoseEstimationResult(cameras=global_cams, present=present,
                                insertion_order=insertion_order, tracks=tracks)


@jax.jit
def _set_camera(dst: cam_mod.CameraSet, dst_idx, src: cam_mod.CameraSet,
                src_idx) -> cam_mod.CameraSet:
    return dst.replace(
        rot=dst.rot.at[dst_idx].set(src.rot[src_idx]),
        offset=dst.offset.at[dst_idx].set(src.offset[src_idx]),
        scale=dst.scale.at[dst_idx].set(src.scale[src_idx]),
        fixed=dst.fixed.at[dst_idx].set(src.fixed[src_idx]),
    )


def _triangulate_global(global_cams, present, tracks, view_ids_np):
    ids = view_ids_np[present]
    cols = _cols_for(tracks, ids)
    pres_cams = _take_jit(global_cams, cols)
    return triangulate.triangulate_tracks(pres_cams, tracks, cols, reset_existing=True)


def _normalize_global(global_cams, target_col):
    return _normalize_to_cam_jit(global_cams, target_col)
