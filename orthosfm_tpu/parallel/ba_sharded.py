"""Distributed bundle adjustment over a device mesh.

Tracks (and their observations + point blocks) shard across the mesh's
"tracks" axis; cameras are replicated. Each device assembles its shard's
contribution to the camera blocks U, the Schur-reduced system S and the
reduced RHS; `psum` (an NCCL all-reduce on GPUs) produces the global
(tiny) camera system, which every device solves redundantly — point
back-substitution never leaves the shard. The LM control flow (damping,
accept/reject) is replicated and deterministic, so no divergence between
devices.

Reference mapping: this is the distributed analog of Ceres SPARSE_SCHUR
(bundle_adjustment.cpp:126-145) — point blocks are the eliminated group,
cameras the reduced camera system (SURVEY.md §2.3, §5.7).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from orthosfm_tpu.config import BundleAdjustConfig
from orthosfm_tpu.core import cameras as cam_mod
from orthosfm_tpu.parallel.mesh import TRACK_AXIS, pad_to_multiple
from orthosfm_tpu.solvers import ba


def make_sharded_ba(mesh, optimize_points: bool = True,
                    config: BundleAdjustConfig = BundleAdjustConfig()):
    """Build a jitted distributed BA function over the given mesh.

    Returns run(cams, points4, obs, mask) -> BAResult with identical semantics
    to solvers.ba.run. Track-dimension inputs must be divisible by the mesh
    size (use pad_tracks)."""
    psum = functools.partial(jax.lax.psum, axis_name=TRACK_AXIS)
    replicated = P()
    sharded0 = P(TRACK_AXIS)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(replicated, sharded0, sharded0, sharded0),
        out_specs=(replicated, sharded0, replicated, replicated, replicated),
        check_vma=False,
    )
    def _run(cams, points4, obs, mask):
        dtype = obs.dtype
        free_c = cam_mod.free_mask(cams)
        p_hat = points4 / jnp.maximum(
            jnp.linalg.norm(points4, axis=-1, keepdims=True), 1e-20)
        track_valid = jnp.any(mask, axis=1)
        mask_ = mask & track_valid[:, None]
        safe = jnp.array([0.0, 0.0, 0.0, 1.0], dtype)
        p0 = jnp.where(track_valid[:, None], p_hat, safe)

        # Shard-local transpose to the solver's T-minor layout (no comms);
        # the LM control flow is replicated, partial reductions are psum'd.
        obsT = jnp.transpose(obs, (1, 2, 0))
        maskT = mask_.T
        pT = p0.T
        cams_f, p_f, cost_f, init_cost, iters = ba._lm_loop(
            cams, pT, obsT, maskT, free_c, optimize_points, config,
            reduce_fn=psum, cost_reduce_fn=psum)
        return cams_f, p_f.T, cost_f, init_cost, iters

    @jax.jit
    def run(cams, points4, obs, mask):
        cams_f, p_f, cost, init_cost, iters = _run(cams, points4, obs, mask)
        return ba.BAResult(cams=cams_f, points=p_f, cost=cost,
                           initial_cost=init_cost, iterations=iters)

    return run


def pad_tracks(arrs, n_devices: int):
    """Pad the leading (track) dimension of each array to a multiple of
    n_devices. Returns (padded_arrays, original_length)."""
    t = arrs[0].shape[0]
    t_pad = pad_to_multiple(t, n_devices)
    out = []
    for a in arrs:
        pad = [(0, t_pad - t)] + [(0, 0)] * (a.ndim - 1)
        out.append(jnp.pad(a, pad))
    return out, t


def shard_track_arrays(mesh, arrs):
    """Place track-major arrays with NamedSharding over the mesh."""
    sh = NamedSharding(mesh, P(TRACK_AXIS))
    return [jax.device_put(a, sh) for a in arrs]
