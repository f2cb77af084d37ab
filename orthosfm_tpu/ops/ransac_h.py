"""Batched RANSAC homography estimation + IRLS refinement.

Batched equivalent of the reference's CudaSift geometric-verification path
(src/cuda_sift/matching.cu FindHomography — 10000 random 4-point hypotheses
scored on GPU — and src/cuda_sift/geomFuncs.cpp:6-60 ImproveHomography — 50
iteratively-reweighted 8×8 DLT solves on the inlier set). Selected via the
matching engine config (the reference's useMveForMatching=false branch,
src/sfm/reconstruct.cpp:91-108).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


def _dlt_rows(p1, p2):
    """DLT constraint rows for h (8-vector, h22=1): two rows per point."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    z = jnp.zeros_like(x)
    o = jnp.ones_like(x)
    r1 = jnp.stack([x, y, o, z, z, z, -u * x, -u * y], -1)
    r2 = jnp.stack([z, z, z, x, y, o, -v * x, -v * y], -1)
    rhs = jnp.stack([u, v], -1)
    return jnp.stack([r1, r2], -2), rhs


def homography_from_4(p1, p2):
    """Exact homography from 4 correspondences (each (4, 2))."""
    rows, rhs = _dlt_rows(p1, p2)  # (4, 2, 8), (4, 2)
    A = rows.reshape(8, 8)
    b = rhs.reshape(8)
    h = jnp.linalg.solve(A + 1e-10 * jnp.eye(8), b)
    return jnp.concatenate([h, jnp.ones((1,), h.dtype)]).reshape(3, 3)


def transfer_errors(H, p1, p2):
    """Squared one-way transfer error ‖H·p1 − p2‖² (CudaSift TestHomography)."""
    x1 = jnp.concatenate([p1, jnp.ones_like(p1[..., :1])], -1)
    q = x1 @ H.T
    wz = jnp.where(jnp.abs(q[..., 2:3]) < 1e-12, 1e-12, q[..., 2:3])
    proj = q[..., :2] / wz
    return jnp.sum((proj - p2) ** 2, axis=-1)


class RansacHResult(NamedTuple):
    inliers: jnp.ndarray  # (M,) bool
    num_inliers: jnp.ndarray
    homography: jnp.ndarray  # (3, 3)


@functools.partial(jax.jit, static_argnames=("iterations", "refine_loops"))
def find_homography(p1, p2, valid, key, iterations: int = 10000,
                    threshold_px: float = 30.0,
                    find_threshold_px: float = 60.0,
                    refine_loops: int = 50) -> RansacHResult:
    """RANSAC + IRLS homography (reference parameters: 10000 hypotheses at
    thresh 60, 50 refinement loops at thresh 30, matching.cpp:183-187)."""
    M = p1.shape[0]
    keys = jax.random.split(key, iterations)
    find_t2 = find_threshold_px * find_threshold_px
    limit = threshold_px * threshold_px

    def hypothesis(k):
        gumbel = jax.random.gumbel(k, (M,))
        _, idx = jax.lax.top_k(jnp.where(valid, gumbel, -jnp.inf), 4)
        H = homography_from_4(p1[idx], p2[idx])
        err = transfer_errors(H, p1, p2)
        return jnp.sum((err < find_t2) & valid), H

    counts, Hs = jax.vmap(hypothesis)(keys)
    H = Hs[jnp.argmax(counts)]

    # IRLS refinement: weighted 8×8 DLT over current inliers (geomFuncs.cpp:15-58)
    def refine(H, _):
        err = transfer_errors(H, p1, p2)
        w = ((err < limit) & valid).astype(p1.dtype)
        rows, rhs = jax.vmap(lambda a, b: _dlt_rows(a, b))(p1, p2)  # (M,2,8),(M,2)
        A = jnp.einsum("mki,mkj,m->ij", rows, rows, w)
        b = jnp.einsum("mki,mk,m->i", rows, rhs, w)
        h = jnp.linalg.solve(A + 1e-6 * jnp.eye(8), b)
        H_new = jnp.concatenate([h, jnp.ones((1,), h.dtype)]).reshape(3, 3)
        ok = jnp.sum(w) >= 4
        return jnp.where(ok, H_new, H), None

    H, _ = jax.lax.scan(refine, H, None, length=refine_loops)
    err = transfer_errors(H, p1, p2)
    inliers = (err < limit) & valid
    return RansacHResult(inliers=inliers, num_inliers=jnp.sum(inliers),
                         homography=H)


@functools.partial(jax.jit, static_argnames=("iterations", "refine_loops"))
def find_homography_batched_keys(p1, p2, valid, keys,
                                 iterations: int = 10000,
                                 threshold_px: float = 30.0,
                                 find_threshold_px: float = 60.0,
                                 refine_loops: int = 50) -> RansacHResult:
    """Pair-batched find_homography with explicit per-pair keys (P, 2) —
    chunking/sharding-invariant randomness (see
    ransac_f.ransac_fundamental_batched_keys)."""
    return jax.vmap(
        lambda a, b, v, k: find_homography(
            a, b, v, k, iterations=iterations, threshold_px=threshold_px,
            find_threshold_px=find_threshold_px, refine_loops=refine_loops)
    )(p1, p2, valid, keys)


@functools.partial(jax.jit, static_argnames=("iterations", "refine_loops"))
def find_homography_batched(p1, p2, valid, key, iterations: int = 10000,
                            threshold_px: float = 30.0,
                            find_threshold_px: float = 60.0,
                            refine_loops: int = 50) -> RansacHResult:
    """Pair-batched find_homography: p1/p2 (P, M, 2), valid (P, M). All P
    pairs verify inside one device program (the per-pair host loop costs a
    dispatch + sync round trip per pair otherwise) — the same batching the
    fundamental-matrix path has."""
    P = p1.shape[0]
    keys = jax.random.split(key, P)
    return find_homography_batched_keys(
        p1, p2, valid, keys, iterations=iterations,
        threshold_px=threshold_px, find_threshold_px=find_threshold_px,
        refine_loops=refine_loops)
