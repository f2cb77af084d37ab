"""Tomasi-Kanade factorization initialization with batched RANSAC.

Batched redesign of the reference's OpenMP RANSAC loop
(src/algorithms/tomasi_kanade.cpp:20-470): all hypotheses run as ONE vmapped
program — Gumbel top-k sampling replaces std::sample, the Ceres DENSE_QR
metric upgrade becomes a vmapped dense LM (solvers/lm.py), consensus scoring is
a masked reduction, and the best model is an argmax instead of an
omp-critical best-so-far race.

Terminology follows the paper/reference: D is the 2G×S measurement matrix of
mean-centered negated pixel coordinates, RStar the first three left singular
vectors, Q the 3×3 metric-upgrade matrix solved from orthonormality +
gauge constraints, and the two returned models are the depth-ambiguity mirror
pair (flip diag(1,1,−1)).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orthosfm_tpu.config import RansacConfig
from orthosfm_tpu.core import cameras as cam_mod
from orthosfm_tpu.solvers import lm

FLIP = jnp.diag(jnp.array([1.0, 1.0, -1.0]))


def _tk_residual(RStar, q9):
    """Metric-upgrade constraints (reference: tomasi_kanade.h:43-117):
    per camera iᵀQQᵀi=1, jᵀQQᵀj=1, iᵀQQᵀj=0, plus 6 gauge residuals pinning
    camera 0 to the world axes. RStar is (2G, 3)."""
    G = RStar.shape[0] // 2
    Q = q9.reshape(3, 3)
    QQ = Q @ Q.T
    i = RStar[:G]  # (G, 3)
    j = RStar[G:]  # (G, 3)
    r1 = jnp.einsum("gi,ij,gj->g", i, QQ, i) - 1.0
    r2 = jnp.einsum("gi,ij,gj->g", j, QQ, j) - 1.0
    r3 = jnp.einsum("gi,ij,gj->g", i, QQ, j)
    c1 = Q.T @ i[0] - jnp.array([1.0, 0.0, 0.0])
    c2 = Q.T @ j[0] - jnp.array([0.0, 1.0, 0.0])
    return jnp.concatenate([jnp.stack([r1, r2, r3], -1).reshape(-1), c1, c2])


def factorize(obs, mask, key):
    """One TK factorization on masked observations.

    obs: (S, G, 2) pixels; mask: (S,) valid columns. Returns the mirror pair
    (model1, model2), each (G, 3, 3) basis matrices normalized so camera 0 is
    the identity (reference: tomasi_kanade.cpp:20-151).
    """
    G = obs.shape[1]
    m = mask.astype(obs.dtype)
    D = -jnp.concatenate([obs[..., 0].T, obs[..., 1].T], axis=0)  # (2G, S)
    count = jnp.maximum(jnp.sum(m), 1.0)
    mean = jnp.sum(D * m[None, :], axis=1, keepdims=True) / count
    D = (D - mean) * m[None, :]

    # Economy SVD: U is (2G, min(2G, S)) — identical leading columns, and it
    # avoids materializing the (S, S) right factor for large track sets
    U, _, _ = jnp.linalg.svd(D, full_matrices=False)
    RStar = U[:, :3]  # (2G, 3)

    q0 = jax.random.uniform(key, (9,), minval=-1.0, maxval=1.0, dtype=obs.dtype)
    q, _ = lm.solve(functools.partial(_tk_residual, RStar), q0, iters=40)
    Q = q.reshape(3, 3)
    RFinal = RStar @ Q  # (2G, 3)

    x = RFinal[:G]
    y = RFinal[G:]
    z = jnp.cross(x, y)

    def unit(v):
        return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-12)

    combined = jnp.stack([unit(x), unit(y), unit(z)], axis=-1)  # (G, 3, 3) cols=axes
    sol1 = jnp.einsum("ij,gjk->gik", combined[0].T, combined)

    combined2 = FLIP @ combined @ FLIP
    sol2 = jnp.einsum("ij,gjk->gik", combined2[0].T, combined2)
    return sol1, sol2


def is_result_usable(model, cfg: RansacConfig):
    """Validity heuristic: reject factorizations with near-duplicate cameras
    (reference: tomasi_kanade.cpp:446-470)."""
    angles = cam_mod.basis_to_phi_theta_roll(model)  # (G, 3)
    dphi = jnp.abs(angles[:, None, 0] - angles[None, :, 0])
    dtheta = jnp.abs(angles[:, None, 1] - angles[None, :, 1])
    too_close_ang = (dphi < cfg.min_angle_separation_rad) & (dtheta < cfg.min_angle_separation_rad)
    dbasis = jnp.linalg.norm((model[:, None] - model[None, :]).reshape(model.shape[0], model.shape[0], 9), axis=-1)
    too_close_basis = dbasis < cfg.min_basis_distance
    off_diag = ~jnp.eye(model.shape[0], dtype=bool)
    return ~jnp.any((too_close_ang | too_close_basis) & off_diag)


def _model_geometry(model):
    """Basis trio -> (R_l2w (G,3,3), origins, look dirs) through the reference's
    angle-projection path (convertFromAxis → spherical matrix)."""
    angles = cam_mod.basis_to_phi_theta_roll(model)
    S = cam_mod.spherical_matrix(angles)
    R = cam_mod.COORD_TRANSFORM.astype(S.dtype).T @ S  # (G, 3, 3)
    o = R @ jnp.array([0.0, 0.0, -cam_mod.CAMERA_DISTANCE])
    look = R[..., :, 2]
    return R, o, look


def _triangulate_and_errors(model, obs, valid, width, height):
    """Triangulate all tracks under a model and return per-(track, cam)
    reprojection errors in pixels. obs: (T, G, 2); valid: (T,);
    width/height: (G,) per-camera image sizes."""
    R, o, look = _model_geometry(model)
    G = obs.shape[1]
    wh = jnp.stack([jnp.broadcast_to(width, (G,)),
                    jnp.broadcast_to(height, (G,))], -1)  # (G, 2)
    norm = -2.0 * (obs / wh[None] - 0.5)  # (T, G, 2) offset=0, scale=1
    origins = o[None] + norm[..., 0:1] * R[None, ..., :, 0] + norm[..., 1:2] * R[None, ..., :, 1]
    dirs = jnp.broadcast_to(look[None], origins.shape)
    mask_rays = jnp.broadcast_to(valid[:, None], obs.shape[:2])

    d = dirs
    eye = jnp.eye(3, dtype=obs.dtype)
    proj = eye - d[..., :, None] * d[..., None, :]
    m = mask_rays[..., None, None].astype(obs.dtype)
    A = jnp.sum(proj * m, axis=1) + 1e-8 * eye
    b = jnp.sum(jnp.einsum("tgij,tgj->tgi", proj, origins) * mask_rays[..., None], axis=1)
    from orthosfm_tpu.solvers.ba import solve3x3

    pts = solve3x3(A, b)  # (T, 3) — closed-form, no batched LU

    local = jnp.einsum("gij,ti->tgj", R, pts)  # Rᵀ·p
    xy = local[..., :2] / (-2.0) + 0.5
    pix = wh[None] * xy
    err = jnp.linalg.norm(pix - obs, axis=-1)  # (T, G)
    return pts, err


class TKResult(NamedTuple):
    model1: jnp.ndarray  # (G, 3, 3)
    model2: jnp.ndarray  # mirror solution
    num_inliers: jnp.ndarray
    found: jnp.ndarray  # bool — consensus model found (else fallback used)


def score_hypothesis(hkey, obs, valid, width, height, cfg: RansacConfig):
    """One RANSAC hypothesis: sample → factorize → validity heuristic →
    triangulate → consensus score (reference: tomasi_kanade.cpp:225-343).

    Shared by the single-device vmap driver (robust_factorization) and the
    hypothesis-sharded shard_map driver (parallel.tk_sharded) so the selection
    statistic can never diverge between them. Returns
    (samp_idx (S,), score scalar, n_consensus scalar)."""
    T = obs.shape[0]
    S = cfg.sample_size
    k_samp, k_q = jax.random.split(hkey)
    # Gumbel top-k = uniform sample of S valid tracks without replacement
    gumbel = jax.random.gumbel(k_samp, (T,))
    scores = jnp.where(valid, gumbel, -jnp.inf)
    _, samp_idx = jax.lax.top_k(scores, S)
    samp_obs = obs[samp_idx]  # (S, G, 2)

    sol1, _ = factorize(samp_obs, jnp.ones((S,), bool), k_q)
    usable = is_result_usable(sol1, cfg)

    pts, err = _triangulate_and_errors(sol1, obs, valid, width, height)
    in_sample = jnp.zeros((T,), bool).at[samp_idx].set(True)
    track_ok = jnp.all(err <= cfg.max_inlier_reprojection_error_px, axis=1)
    consensus = valid & ~in_sample & track_ok
    n_consensus = jnp.sum(consensus)

    # Model error over the inlier set (sample + consensus), matching the
    # reference's selection statistic (tomasi_kanade.cpp:318-343)
    inlier = consensus | (in_sample & valid)
    err_sum = jnp.sum(jnp.where(inlier[:, None], err, 0.0))
    mean_err = err_sum / jnp.maximum(jnp.sum(inlier) * obs.shape[1], 1)

    ok = usable & (n_consensus >= cfg.min_consensus_size)
    # Primary: consensus size; secondary: small mean error
    score = jnp.where(
        ok,
        n_consensus.astype(obs.dtype)
        + (cfg.max_inlier_reprojection_error_px - jnp.clip(mean_err, 0.0, cfg.max_inlier_reprojection_error_px))
        / (10.0 * cfg.max_inlier_reprojection_error_px),
        -jnp.inf,
    )
    return samp_idx, score, n_consensus


@functools.partial(jax.jit, static_argnames=("cfg",))
def robust_factorization(obs, valid, width, height, key,
                         cfg: RansacConfig = RansacConfig()) -> TKResult:
    """RANSAC'd TK factorization (reference: tomasi_kanade.cpp:193-370).

    obs: (T, G, 2) pixel observations of full-group tracks; valid: (T,) mask.
    All `maxIterations` hypotheses evaluate in parallel via vmap; the fallback
    (factorize on all tracks) is always computed and selected when no
    hypothesis reaches the consensus threshold.
    """
    H = cfg.max_iterations
    S = cfg.sample_size
    keys = jax.random.split(key, H + 1)
    width = jnp.asarray(width, obs.dtype)
    height = jnp.asarray(height, obs.dtype)

    samp_idx_all, scores, n_con = jax.vmap(
        lambda k: score_hypothesis(k, obs, valid, width, height, cfg))(keys[:H])
    best = jnp.argmax(scores)
    found = scores[best] > -jnp.inf

    def winner(_):
        # Recompute the winning factorization (both mirror solutions) with the
        # SAME metric-upgrade init key the scored hypothesis used, so the
        # returned model is exactly the one that passed validation
        k_q = jax.random.split(keys[best])[1]
        return factorize(obs[samp_idx_all[best]], jnp.ones((S,), bool), k_q)

    def fallback(_):
        # Factorize over all valid tracks (tomasi_kanade.cpp:361-365)
        return factorize(obs, valid, keys[H])

    model1, model2 = jax.lax.cond(found, winner, fallback, None)
    return TKResult(model1=model1, model2=model2,
                    num_inliers=jnp.where(found, n_con[best] + S, jnp.sum(valid)),
                    found=found)


def resolve_ambiguity(model1, model2, global_dir):
    """Pick the mirror solution whose cam0→cam1 origin direction best matches
    the already-aligned global cameras (reference: tomasi_kanade.cpp:372-444).

    global_dir: (3,) = normalize(origin₁) − normalize(origin₀) of the two
    overlapping global cameras after normalizing the global scene to the first
    (computed host-side by the pipeline); or None for the first group.
    """
    if global_dir is None:
        return model1

    def local_vec(model):
        _, o, _ = _model_geometry(model)
        on = o / jnp.maximum(jnp.linalg.norm(o, axis=-1, keepdims=True), 1e-12)
        return on[1] - on[0]

    s1 = jnp.dot(global_dir, local_vec(model1))
    s2 = jnp.dot(global_dir, local_vec(model2))
    return jnp.where(s1 > s2, model1, model2)
