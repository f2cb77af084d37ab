"""Device mesh helpers for multi-chip execution.

The pipeline's scaling axes are #tracks, #observations and #RANSAC hypotheses
(SURVEY.md §2.3): all shard over a single 1-D mesh axis ("tracks"), with
cameras replicated — psum collectives assemble the BA normal equations
(parallel/ba_sharded.py). The cards of one host are joined all to all, so a
1-D mesh is all the algorithm needs.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

TRACK_AXIS = "tracks"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (all when None). Raises
    when fewer devices exist than asked for."""
    devices = jax.devices()
    n = n_devices or len(devices)
    if n > len(devices):
        raise RuntimeError(
            f"make_mesh: {n} devices requested, {len(devices)} available "
            f"({devices[0].platform})")
    return Mesh(np.asarray(devices[:n]), (TRACK_AXIS,))


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> Mesh:
    """Initialize multi-host execution and return the global mesh.

    Pass the coordinator's address (``host:port``), the number of processes
    and this process's id; collectives across processes then run through
    JAX's distributed runtime (the reference has no distributed story at
    all; SURVEY.md §2.3).
    """
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return make_mesh()


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple
