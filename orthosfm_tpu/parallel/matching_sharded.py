"""Pair-axis chunking and sharding for the matching stage.

The reference's biggest parallel surface is the omp-parallel per-pair loop
(src/mve/sfm/bundler_matching.cc:74-96). Its batched analog runs the pair
programs (descriptor-similarity matmuls in ops/matching.match_pairs_batched,
RANSAC-F/H verification in ops/ransac_f.py / ops/ransac_h.py) over chunks of
pairs; with a mesh, shard_map hands each device whole chunks — each device
runs the identical compiled program, no collectives needed (pairs are
independent; results come back to the host for the gate logic exactly as in
the single-device path).

The chunk size depends only on the pair count and a per-device memory cap,
never on the device count, so every device runs the program shape the
single-device path runs. That matters on GPUs: the compiled float32
arithmetic of RANSAC-F depends on the batch size, and a smaller per-device
batch flipped borderline inliers (PERF.md). With
per-pair PRNG keys pre-split on the host, sharded and single-device runs
then give the same matches.
"""

from __future__ import annotations

import jax
import numpy as np
from jax import shard_map
from jax.sharding import PartitionSpec

from orthosfm_tpu.parallel.mesh import TRACK_AXIS


def pair_chunk(n_pairs: int, cap: int) -> int:
    """Pairs per program call: n_pairs split into the fewest equal chunks of
    at most `cap` pairs."""
    n_chunks = -(-n_pairs // max(cap, 1))
    return -(-n_pairs // max(n_chunks, 1))


def run_pair_chunks(fn, make_args, n_pairs: int, cap: int, mesh=None):
    """fn over all pairs, in calls of pair_chunk(n_pairs, cap) pairs.

    make_args(idx) builds fn's operands for the pair indices `idx` (a host
    int array; every operand has idx's length as its leading axis). With a
    mesh, each call gives every device one whole chunk. The last call is
    filled up with copies of the last pair, whose results are dropped. All
    calls are enqueued before the first result is pulled. Returns fn's output
    pytree as host arrays with n_pairs along the leading axis."""
    chunk = pair_chunk(n_pairs, cap)
    step = chunk * (1 if mesh is None else mesh.devices.size)
    if mesh is not None:
        spec = PartitionSpec(TRACK_AXIS)
        fn = shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec,
                       check_vma=False)
    outs = [fn(*make_args(np.minimum(np.arange(s, s + step), n_pairs - 1)))
            for s in range(0, n_pairs, step)]
    return jax.tree_util.tree_map(
        lambda *xs: np.concatenate([np.asarray(x) for x in xs])[:n_pairs],
        *outs)
