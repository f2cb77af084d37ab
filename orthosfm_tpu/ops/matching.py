"""Pairwise descriptor matching.

Array-program replacement for the reference's matchers (MVE
exhaustive/cascade hashing: src/mve/sfm/{matching,exhaustive_matching,
cascade_hashing}.*; CudaSift: src/cuda_sift/matching.cu). The brute-force
descriptor product is one batched (N1, 128)×(128, N2) matmul that replaces
the LSH machinery entirely; top-2 selection, Lowe ratio on squared distances
(MVE matching.h:126-142) and the mutual cross-check (matching.cc:18-36) are
reductions over it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def match_pair(desc1, valid1, desc2, valid2, lowe_ratio: float = 0.8):
    """Two-way matching with Lowe ratio + consistency check for one pair.

    desc: (N, 128) L2-normalized descriptors; valid: (N,) masks.
    Returns matches_12: (N1,) int32 index into set 2, −1 for unmatched —
    only mutually-consistent matches survive (MVE twoway_match +
    remove_inconsistent_matches). The single-pair case of
    match_pairs_batched.
    """
    return match_pairs_batched(desc1[None], valid1[None], desc2[None],
                               valid2[None], lowe_ratio=lowe_ratio)[0]


def count_matches(m12):
    return jnp.sum(m12 >= 0)


def lowres_subset(scale, valid, n: int):
    """Indices of the n largest-scale (lowest-resolution) valid features —
    the low-res matchability gate subset (MVE matching_base.h:46-52,
    exhaustive_matching sorts FeatureSet by scale)."""
    score = jnp.where(valid, scale, -jnp.inf)
    _, idx = jax.lax.top_k(score, n)
    return idx

# ---------------------------------------------------------------------------
# Batched pair matching: one compiled program processes a whole batch of view
# pairs at once. This replaces the reference's omp-parallel per-pair loop
# (mve/sfm/bundler_matching.cc:74-96) with batched similarity matmuls — the
# per-pair dispatch overhead of the host loop disappears and every
# (B, N1, N2) similarity block is one large matmul.


@functools.partial(jax.jit, static_argnames=("lowe_ratio",))
def match_pairs_batched(desc1, valid1, desc2, valid2, lowe_ratio: float = 0.8):
    """Two-way Lowe-ratio + mutual-consistency matching for a BATCH of pairs.

    desc1: (B, N1, D), valid1: (B, N1); desc2: (B, N2, D), valid2: (B, N2).
    Returns (B, N1) int32 index into each pair's set 2, −1 for unmatched.
    """
    big = jnp.asarray(4.0, desc1.dtype)

    def oneway(dA, vA, dB, vB):
        sim = jnp.einsum("bnd,bmd->bnm", dA, dB,
                         preferred_element_type=jnp.float32)
        d2 = jnp.maximum(2.0 - 2.0 * sim, 0.0)
        d2 = jnp.where(vB[:, None, :], d2, big)
        neg_top2, idx2 = jax.lax.top_k(-d2, 2)
        d_best, d_second = -neg_top2[..., 0], -neg_top2[..., 1]
        ok = (d_best <= lowe_ratio * lowe_ratio * d_second) & vA & (d_best < big)
        return jnp.where(ok, idx2[..., 0], -1)

    m12 = oneway(desc1, valid1, desc2, valid2)  # (B, N1)
    m21 = oneway(desc2, valid2, desc1, valid1)  # (B, N2)
    back = jnp.take_along_axis(m21, jnp.clip(m12, 0, m21.shape[1] - 1), axis=1)
    consistent = (m12 >= 0) & (back == jnp.arange(m12.shape[1])[None, :])
    return jnp.where(consistent, m12, -1)
