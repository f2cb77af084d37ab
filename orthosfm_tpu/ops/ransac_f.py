"""Batched RANSAC fundamental-matrix estimation (geometric verification).

Replaces MVE's sequential 1000-iteration loop (src/mve/sfm/
ransac_fundamental.cc:26-105) with one vmapped program: Gumbel top-8 sampling,
batched 8-point solves (SVD null vector + rank-2 enforcement,
mve/sfm/fundamental.cc), Sampson-distance inlier scoring, argmax selection.
Coordinates are expected in MVE-normalized form ((x + 0.5 − w/2)/max(w, h),
feature_set.cc:43-56), matching the 0.0015 threshold convention.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


def eight_point(p1, p2):
    """Fundamental matrix from 8 correspondences (each (8, 2)) via the linear
    8-point algorithm + rank-2 enforcement."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    ones = jnp.ones_like(x1)
    A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], -1)
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    F = vt[-1].reshape(3, 3)
    u, s, vt2 = jnp.linalg.svd(F)
    s = s.at[2].set(0.0)
    return (u * s[None, :]) @ vt2


def sampson_distance(F, p1, p2):
    """Squared Sampson distance (mve/sfm/fundamental.cc:225)."""
    x1 = jnp.concatenate([p1, jnp.ones_like(p1[..., :1])], -1)
    x2 = jnp.concatenate([p2, jnp.ones_like(p2[..., :1])], -1)
    Fx1 = x1 @ F.T  # (M, 3)
    Ftx2 = x2 @ F
    num = jnp.sum(x2 * Fx1, axis=-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return num / jnp.maximum(den, 1e-20)


class RansacFResult(NamedTuple):
    inliers: jnp.ndarray  # (M,) bool
    num_inliers: jnp.ndarray
    fundamental: jnp.ndarray  # (3, 3)


def _epipolar_rows(p1, p2):
    """(8, 9) linear-system rows of the 8-point algorithm."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    ones = jnp.ones_like(x1)
    return jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2,
                      x1, y1, ones], -1)


def _nullspace9(A):
    """Unit null vector of an (8, 9) system via unrolled Householder QR of
    Aᵀ: Aᵀ = QR ⇒ null(A) = Q·e₉ = H₁(H₂(…H₈(e₉))). Eight reflections of
    9-vectors — branch-free, fully unrolled, vmappable — replace a batched
    (8, 9) SVD, whose iterative solver is costly at 120k hypotheses per
    stage. Householder QR is backward stable, so —
    unlike a normal-equations/inverse-iteration formulation, which squares
    the conditioning and loses the null direction in f32 — the result
    matches the SVD null vector to ~cond(A)·ε_f32."""
    B = A.T  # (9, 8)
    rows = jnp.arange(9)
    reflectors = []
    for k in range(8):
        col = jnp.where(rows >= k, B[:, k], 0.0)
        nrm = jnp.linalg.norm(col)
        sign = jnp.where(col[k] >= 0.0, 1.0, -1.0)
        w = col + sign * nrm * (rows == k).astype(B.dtype)
        beta = 2.0 / jnp.maximum(jnp.sum(w * w), 1e-30)
        B = B - beta * jnp.outer(w, w @ B)
        reflectors.append((w, beta))
    v = (rows == 8).astype(B.dtype)
    for w, beta in reversed(reflectors):
        v = v - beta * w * jnp.dot(w, v)
    return v / jnp.maximum(jnp.linalg.norm(v), 1e-30)


@functools.partial(jax.jit, static_argnames=("iterations",))
def ransac_fundamental(p1, p2, valid, key, iterations: int = 1000,
                       threshold: float = 0.0015) -> RansacFResult:
    """p1, p2: (M, 2) normalized correspondence coords; valid: (M,) mask.

    Batched hypothesis loop: the null vector comes from the unrolled
    Householder QR (_nullspace9) instead of an (8, 9) SVD; the rank-2
    enforcement stays per hypothesis, exactly like the reference
    (mve/sfm/fundamental.cc enforce_fundamental_constraints) — scoring the
    un-enforced F measured ~30% fewer inliers on real matched pairs, which
    pushed borderline pairs under the accept threshold."""
    M = p1.shape[0]
    keys = jax.random.split(key, iterations)
    thresh2 = threshold * threshold

    def hypothesis(k):
        gumbel = jax.random.gumbel(k, (M,))
        _, idx = jax.lax.top_k(jnp.where(valid, gumbel, -jnp.inf), 8)
        F = _nullspace9(_epipolar_rows(p1[idx], p2[idx])).reshape(3, 3)
        u, s, vt2 = jnp.linalg.svd(F)
        F = (u * s.at[2].set(0.0)[None, :]) @ vt2
        d = sampson_distance(F, p1, p2)
        inl = (d < thresh2) & valid
        return jnp.sum(inl), F

    counts, Fs = jax.vmap(hypothesis)(keys)
    best = jnp.argmax(counts)
    F = Fs[best]
    inliers = (sampson_distance(F, p1, p2) < thresh2) & valid
    return RansacFResult(inliers=inliers, num_inliers=jnp.sum(inliers),
                         fundamental=F)


@functools.partial(jax.jit, static_argnames=("iterations",))
def ransac_fundamental_batched_keys(p1, p2, valid, keys,
                                    iterations: int = 1000,
                                    threshold: float = 0.0015
                                    ) -> RansacFResult:
    """Pair-batched RANSAC-F with explicit per-pair PRNG keys (P, 2).

    The keyed form makes the per-pair randomness independent of how the
    batch is chunked or sharded: the pair-sharded multi-device path
    (parallel/matching_sharded.py) passes each device its key shard and
    reproduces the single-device matches bit-for-bit."""
    return jax.vmap(
        lambda a, b, v, k: ransac_fundamental(a, b, v, k,
                                              iterations=iterations,
                                              threshold=threshold)
    )(p1, p2, valid, keys)


@functools.partial(jax.jit, static_argnames=("iterations",))
def ransac_fundamental_batched(p1, p2, valid, key, iterations: int = 1000,
                               threshold: float = 0.0015) -> RansacFResult:
    """Pair-batched RANSAC-F: p1, p2 (P, M, 2); valid (P, M).

    One compiled program verifies a whole batch of candidate pairs (the
    per-pair dispatch of the host loop disappears); semantics per pair are
    identical to ransac_fundamental. Returns stacked RansacFResult fields."""
    keys = jax.random.split(key, p1.shape[0])
    return ransac_fundamental_batched_keys(p1, p2, valid, keys,
                                           iterations=iterations,
                                           threshold=threshold)
