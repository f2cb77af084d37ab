"""Benchmark: robust Schur-LM bundle adjustment throughput on one GPU.

Prints ONE JSON line: BA iterations/s on the standard synthetic problem
(16 cameras, 8192 tracks, ~131k observations with 0.5 px pixel noise) under
quaternion and Euler cameras, with the device it ran on (JAX platform,
device kind and count) and the card's name and power limit from nvidia-smi.
vs_baseline is the speedup over the same solver on the host CPU backend
(the reference implementation runs on the CPU: Ceres SPARSE_SCHUR + OpenMP).
Each timed solve runs to completion (block_until_ready); compilation is
excluded by a warm-up call. Fails when JAX's first device is not a GPU.

    python bench.py
"""

import json
import time

import numpy as np


NOISE_PX = 0.5  # SIFT-like localisation noise: the optimum's cost is not ~0


def make_problem(num_views=16, n_points=8192, width=2048.0):
    """Cameras (quaternion, view 0 fixed) perturbed by up to 1° from ground
    truth, triangulated points, and (T, V, 2) observations with Gaussian
    pixel noise of NOISE_PX, so the optimum has a well-defined cost."""
    import jax
    import jax.numpy as jnp

    from orthosfm_tpu.core import cameras as cam_mod, quaternions as quat
    from orthosfm_tpu.data import synthetic
    from orthosfm_tpu.ops import triangulate

    ds = synthetic.generate_dataset(synthetic.sphere_cloud(n_points),
                                    num_views=num_views, seed=0,
                                    width=int(width), height=int(width))
    tracks = synthetic.add_observation_noise(ds.tracks, NOISE_PX,
                                             jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    pert = np.asarray(ds.gt_cameras.rot[:, :3]) + np.deg2rad(
        rng.uniform(-1.0, 1.0, (num_views, 3))).astype(np.float32)
    e = cam_mod.make_euler(np.arange(num_views), width, width, angles=pert)
    cams = cam_mod.make_quaternion(np.arange(num_views), width, width,
                                   q=quat.from_matrix(cam_mod.basis(e)))
    cams = cams.replace(fixed=jnp.zeros(num_views, bool).at[0].set(True))
    ts = triangulate.triangulate_tracks(cams, tracks, np.arange(num_views))
    mask = ts.obs_mask & ts.alive[:, None] & ts.has_point[:, None]
    return cams, ts.points, ts.obs, mask


def to_euler(cams):
    """The same poses as Euler (all-dof) cameras, fixed flags kept."""
    from orthosfm_tpu.core import cameras as cam_mod

    e = cam_mod.make_euler(
        np.arange(len(cams.scale)), cams.width[0], cams.height[0],
        angles=np.asarray(cam_mod.basis_to_phi_theta_roll(
            cam_mod.basis(cams))))
    return e.replace(fixed=cams.fixed)


def ba_config(iters=30):
    from orthosfm_tpu.config import BundleAdjustConfig

    # function_tolerance 0: no stop on a small decrease; a solve ends after
    # `iters` iterations, or earlier once rejected steps drive the damping
    # to max_lambda
    return BundleAdjustConfig(max_iterations=iters, function_tolerance=0.0,
                              min_lambda=1e-12)


def time_ba(device, cams, points, obs, mask, iters=30, repeats=5):
    """Solve on `device`: (best iterations/s over `repeats` timed solves,
    each counted at its own iteration count; the first solve's result; its
    seconds, compilation included)."""
    import jax

    from orthosfm_tpu.solvers import ba

    cfg = ba_config(iters)
    args = jax.device_put((cams, points, obs, mask), device)

    t0 = time.perf_counter()
    res = ba.run(*args, optimize_points=True, config=cfg)
    jax.block_until_ready(res.cost)
    first_s = time.perf_counter() - t0

    ips = 0.0
    for _ in range(repeats):
        t0 = time.perf_counter()
        r = ba.run(*args, optimize_points=True, config=cfg)
        jax.block_until_ready(r.cost)
        ips = max(ips, int(r.iterations) / (time.perf_counter() - t0))
    return ips, res, first_s


def main():
    import jax

    from orthosfm_tpu.utils import compile_cache, device

    compile_cache.enable()
    info = device.require_gpu()
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]

    cams, points, obs, mask = make_problem()
    quat_ips, res, compile_s = time_ba(gpu, cams, points, obs, mask)
    euler_ips, _, _ = time_ba(gpu, to_euler(cams), points, obs, mask)
    cpu_ips, _, _ = time_ba(cpu, cams, points, obs, mask, repeats=1)

    print(json.dumps({
        "metric": "ba_iterations_per_s_16cam_8192trk",
        "value": quat_ips,
        "unit": "iter/s",
        "vs_baseline": quat_ips / cpu_ips,
        "euler_iter_per_s": euler_ips,
        "iterations_per_solve": int(res.iterations),
        "quat_compile_s": compile_s,
        "device": info,
        "nvidia_smi": device.nvidia_smi(),
    }))


if __name__ == "__main__":
    main()
