"""Distributed Tomasi-Kanade RANSAC: hypotheses sharded over the mesh.

The reference parallelizes RANSAC iterations with OpenMP threads
(tomasi_kanade.cpp:225); here each device evaluates its shard of the
hypothesis batch (sampling → factorization → metric upgrade → triangulation →
consensus scoring) and only the per-hypothesis scores are all-gathered for
the argmax — a few hundred floats per group initialization.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from orthosfm_tpu.config import RansacConfig
from orthosfm_tpu.parallel.mesh import TRACK_AXIS, pad_to_multiple
from orthosfm_tpu.solvers import tomasi_kanade as tk


def make_sharded_tk(mesh, cfg: RansacConfig = RansacConfig()):
    """Build a jitted distributed robust_factorization over the given mesh.

    Returns run(obs, valid, width, height, key) -> TKResult with the same
    semantics as solvers.tomasi_kanade.robust_factorization.
    """
    n_dev = mesh.devices.size
    H = pad_to_multiple(cfg.max_iterations, n_dev)
    S = cfg.sample_size

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(TRACK_AXIS)),
        out_specs=(P(TRACK_AXIS), P(TRACK_AXIS), P(TRACK_AXIS)),
        check_vma=False,
    )
    def _hypotheses(obs, valid, width, height, keys):
        # Same per-hypothesis body as the single-device driver — only the
        # hypothesis batch is sharded here (scores all-gather for the argmax)
        return jax.vmap(
            lambda k: tk.score_hypothesis(k, obs, valid, width, height, cfg)
        )(keys)

    @jax.jit
    def run(obs, valid, width, height, key) -> tk.TKResult:
        width = jnp.asarray(width, obs.dtype)
        height = jnp.asarray(height, obs.dtype)
        # Same key derivation as the single-device driver (split into
        # max_iterations+1); the hypothesis axis is then PADDED to the mesh
        # multiple with dummy keys whose scores are masked to −inf, so the
        # sharded argmax selects from exactly the same hypothesis set and
        # sharded/single-device results bit-match (tests/test_parallel.py).
        keys = jax.random.split(key, cfg.max_iterations + 1)
        hkeys = jnp.concatenate(
            [keys[:cfg.max_iterations],
             jnp.broadcast_to(keys[:1], (H - cfg.max_iterations, 2))])
        samp_idx, scores, n_con = _hypotheses(obs, valid, width, height, hkeys)
        scores = jnp.where(jnp.arange(H) < cfg.max_iterations, scores, -jnp.inf)
        best = jnp.argmax(scores)
        found = scores[best] > -jnp.inf

        def winner(_):
            k_q = jax.random.split(hkeys[best])[1]
            return tk.factorize(obs[samp_idx[best]], jnp.ones((S,), bool), k_q)

        def fallback(_):
            return tk.factorize(obs, valid, keys[cfg.max_iterations])

        model1, model2 = jax.lax.cond(found, winner, fallback, None)
        return tk.TKResult(
            model1=model1, model2=model2,
            num_inliers=jnp.where(found, n_con[best] + S, jnp.sum(valid)),
            found=found)

    return run
