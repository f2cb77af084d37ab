"""Sharded BA on a virtual 8-device CPU mesh must match single-device BA."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from orthosfm_tpu.core import cameras as cam_mod
from orthosfm_tpu.core import quaternions as quat
from orthosfm_tpu.data import synthetic
from orthosfm_tpu.ops import triangulate
from orthosfm_tpu.parallel import ba_sharded, mesh as mesh_mod
from orthosfm_tpu.solvers import ba


def _problem():
    ds = synthetic.generate_dataset(synthetic.sphere_cloud(256), num_views=6, seed=0)
    rng = np.random.default_rng(1)
    pert = np.asarray(ds.gt_cameras.rot[:, :3]) + np.deg2rad(
        rng.uniform(-1, 1, (6, 3))).astype(np.float32)
    e = cam_mod.make_euler(np.arange(6), 2048, 2048, angles=pert)
    cams = cam_mod.make_quaternion(np.arange(6), 2048, 2048,
                                   q=quat.from_matrix(cam_mod.basis(e)))
    cams = cams.replace(fixed=jnp.zeros(6, bool).at[0].set(True))
    ts = triangulate.triangulate_tracks(cams, ds.tracks, np.arange(6))
    mask = ts.obs_mask & ts.alive[:, None] & ts.has_point[:, None]
    return cams, ts.points, ts.obs, mask


def test_sharded_matches_single_device():
    assert jax.device_count() >= 8, "conftest should provide 8 virtual devices"
    cams, pts, obs, mask = _problem()
    m = mesh_mod.make_mesh(8)
    run = ba_sharded.make_sharded_ba(m)
    (pts_p, obs_p, mask_p), t = ba_sharded.pad_tracks([pts, obs, mask], 8)

    res_s = run(cams, pts_p, obs_p, mask_p)
    res_1 = ba.run(cams, pts, obs, mask)

    assert float(res_s.cost) < float(res_s.initial_cost) * 1e-3
    # Same optimization result (identical replicated control flow)
    q_s = np.asarray(quat.normalize(res_s.cams.rot))
    q_1 = np.asarray(quat.normalize(res_1.cams.rot))
    dots = np.abs(np.sum(q_s * q_1, axis=-1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-4)


def test_sharded_tk_matches_expectation():
    from orthosfm_tpu.config import RansacConfig
    from orthosfm_tpu.core import cameras as cam_mod
    from orthosfm_tpu.core import quaternions as quat
    from orthosfm_tpu.data import synthetic
    from orthosfm_tpu.parallel import tk_sharded
    from orthosfm_tpu.solvers import tomasi_kanade as tk

    ds = synthetic.generate_dataset(synthetic.sphere_cloud(200), num_views=6, seed=3)
    cols = np.array([0, 1, 2])
    obs = ds.tracks.obs[:, cols, :]
    valid = ds.tracks.alive & jnp.all(ds.tracks.obs_mask[:, cols], axis=1)

    m = mesh_mod.make_mesh(8)
    run = tk_sharded.make_sharded_tk(m)
    res = run(obs, valid, 2048.0, 2048.0, jax.random.PRNGKey(0))
    assert bool(res.found)

    # model quality vs ground truth (one of the mirror pair must match)
    R = np.asarray(cam_mod.basis(ds.gt_cameras))[cols]
    gt = np.einsum("ij,gjk->gik", R[0].T, R)

    def err(model):
        ang = cam_mod.basis_to_phi_theta_roll(jnp.asarray(model))
        S = cam_mod.spherical_matrix(ang)
        R_rec = jnp.asarray(cam_mod.COORD_TRANSFORM.T @ S)
        ang_gt = cam_mod.basis_to_phi_theta_roll(jnp.asarray(gt))
        R_gt = cam_mod.COORD_TRANSFORM.T @ cam_mod.spherical_matrix(ang_gt)
        d = quat.angular_distance(quat.from_matrix(R_rec), quat.from_matrix(R_gt))
        return float(np.rad2deg(np.asarray(d)).max())

    assert min(err(res.model1), err(res.model2)) < 1.5


@pytest.mark.parametrize("n_pairs,cap,chunk", [
    (16, 524, 16),   # everything in one call
    (66, 256, 66),
    (120, 113, 60),  # two equal calls instead of 113 + 7
    (7, 1, 1),
    (1, 4, 1),
])
def test_pair_chunk_is_balanced_and_capped(n_pairs, cap, chunk):
    from orthosfm_tpu.parallel import matching_sharded

    assert matching_sharded.pair_chunk(n_pairs, cap) == chunk
    n_calls = -(-n_pairs // chunk)
    assert chunk <= cap and n_calls == -(-n_pairs // cap)
    assert chunk * n_calls - n_pairs < n_calls  # padding under one per call


@pytest.mark.parametrize("n_dev,n_pairs,cap", [(2, 10, 4), (4, 16, 524),
                                               (8, 5, 2)])
def test_run_pair_chunks_gives_devices_the_one_device_shape(n_dev, n_pairs,
                                                            cap):
    """Every device traces the program at the shape the single-device path
    uses, and the results are the single-device ones."""
    from orthosfm_tpu.parallel import matching_sharded

    rng = np.random.default_rng(0)
    x = rng.normal(size=(n_pairs, 3, 2)).astype(np.float32)
    y = rng.normal(size=(n_pairs, 3)).astype(np.float32)
    shapes = {"one": set(), "mesh": set()}

    def program(where):
        def fn(a, b):
            shapes[where].add((a.shape, b.shape))
            return {"s": jnp.sum(a, axis=(1, 2)) * b[:, 0], "b": b > 0}
        return fn

    make_args = lambda idx: (x[idx], jnp.asarray(y[idx]))
    out_1 = matching_sharded.run_pair_chunks(program("one"), make_args,
                                             n_pairs, cap)
    out_n = matching_sharded.run_pair_chunks(
        program("mesh"), make_args, n_pairs, cap, mesh_mod.make_mesh(n_dev))
    assert shapes["mesh"] == shapes["one"]
    assert len(shapes["one"]) == 1
    for k in ("s", "b"):
        assert isinstance(out_n[k], np.ndarray) and len(out_n[k]) == n_pairs
        np.testing.assert_array_equal(out_n[k], out_1[k])
    np.testing.assert_allclose(out_1["s"], x.sum(axis=(1, 2)) * y[:, 0],
                               rtol=1e-6)


def test_ransac_batch_shape_script_on_the_cpu_mesh():
    """scripts/ransac_batch_shape.py: on the CPU backend neither the batch
    split nor the mesh changes an inlier flag."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "ransac_batch_shape.py")
    spec = importlib.util.spec_from_file_location("ransac_batch_shape", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = script.compare(n_pairs=8, split=2, iterations=50)
    assert out["devices"] == jax.device_count()
    for k in ("one_batch_vs_split", "one_device_vs_mesh"):
        assert out[k]["inlier_flags_differing"] == 0, out
        assert out[k]["pairs_with_other_counts"] == 0, out
        assert out[k]["inlier_flags"] > 0


@pytest.mark.slow
def test_sharded_matching_bitmatches_single_device(tmp_path):
    """Pair-sharded matching + RANSAC verification over the 8-device mesh
    must reproduce the single-device track set exactly (per-pair keys are
    pre-split, so the draws are device-count-invariant) on the CPU backend.
    This is the multi-device coverage of the image/matching stage; reference
    parallel surface: the omp per-pair loop bundler_matching.cc:74-96."""
    from orthosfm_tpu.config import ReconstructionConfig
    from orthosfm_tpu.data import views as views_mod
    from orthosfm_tpu.pipeline import matching
    from orthosfm_tpu.testbench import render

    imgs = str(tmp_path / "imgs")
    render.make_image_dataset(imgs, num_views=6, width=224, height=224,
                              seed=3, ring_degrees=140.0)
    cfg = ReconstructionConfig(seed=0)
    views = views_mod.load_views(imgs)
    feats = matching.extract_all_view_features(views, cfg)

    pm1 = matching.match_all_pairs(feats, cfg, verbose=False)
    m = mesh_mod.make_mesh(8)
    pm8 = matching.match_all_pairs(feats, cfg, verbose=False, mesh=m)

    assert len(pm1) == len(pm8) > 0
    for (i1, j1, a1, b1), (i8, j8, a8, b8) in zip(pm1, pm8):
        assert (i1, j1) == (i8, j8)
        np.testing.assert_array_equal(a1, a8)
        np.testing.assert_array_equal(b1, b8)

    ts1 = matching.tracks_from_matches(views, feats, pm1)
    ts8 = matching.tracks_from_matches(views, feats, pm8)
    np.testing.assert_array_equal(np.asarray(ts1.alive), np.asarray(ts8.alive))
    np.testing.assert_array_equal(np.asarray(ts1.obs_mask),
                                  np.asarray(ts8.obs_mask))
    np.testing.assert_allclose(np.asarray(ts1.obs), np.asarray(ts8.obs))


def test_sharded_tk_bitmatches_single_device():
    """Hypothesis padding to the mesh multiple must not change RANSAC
    semantics: padded hypotheses are key-duplicates masked to −inf, so the
    sharded solver selects exactly the single-device model (reference
    iteration count formula: tomasi_kanade.cpp:208-212)."""
    from orthosfm_tpu.data import synthetic
    from orthosfm_tpu.parallel import tk_sharded
    from orthosfm_tpu.solvers import tomasi_kanade as tk

    ds = synthetic.generate_dataset(synthetic.sphere_cloud(200), num_views=6,
                                    seed=5)
    cols = np.array([0, 1, 2])
    obs = ds.tracks.obs[:, cols, :]
    valid = ds.tracks.alive & jnp.all(ds.tracks.obs_mask[:, cols], axis=1)

    m = mesh_mod.make_mesh(8)
    run = tk_sharded.make_sharded_tk(m)
    key = jax.random.PRNGKey(7)
    res_s = run(obs, valid, 2048.0, 2048.0, key)
    res_1 = tk.robust_factorization(obs, valid, 2048.0, 2048.0, key)
    assert bool(res_s.found) == bool(res_1.found)
    assert int(res_s.num_inliers) == int(res_1.num_inliers)
    np.testing.assert_allclose(np.asarray(res_s.model1),
                               np.asarray(res_1.model1), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(res_s.model2),
                               np.asarray(res_1.model2), rtol=0, atol=1e-6)


_MULTIHOST_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np, jax.numpy as jnp

pid = int(sys.argv[1]); port = sys.argv[2]
from orthosfm_tpu.parallel import mesh as mesh_mod
mesh = mesh_mod.init_distributed(f"localhost:{port}", 2, pid)
assert jax.device_count() == 8 and jax.local_device_count() == 4

from tests.test_parallel import _problem
from orthosfm_tpu.parallel import ba_sharded

cams, pts, obs, mask = _problem()
run = ba_sharded.make_sharded_ba(mesh)
(pts_p, obs_p, mask_p), t = ba_sharded.pad_tracks(
    [np.asarray(pts), np.asarray(obs), np.asarray(mask)], jax.device_count())
res = run(cams, pts_p, obs_p, mask_p)
ratio = float(res.cost) / float(res.initial_cost)
assert ratio < 1e-3, ratio
print(f"MULTIHOST_OK_{pid}", flush=True)
"""


@pytest.mark.slow
def test_multihost_two_process_cluster(tmp_path):
    """init_distributed across a real 2-process localhost cluster (Gloo CPU
    collectives, 4 virtual devices per process = 8 global): the full sharded
    BA must run and converge identically on both processes. This validates
    the multi-HOST path (jax.distributed, SURVEY §2.3 DCN story), not just
    the single-process virtual mesh the other tests use."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = tmp_path / "worker.py"
    worker.write_text(_MULTIHOST_WORKER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = root
    procs = [subprocess.Popen([sys.executable, str(worker), str(i), str(port)],
                              env=env, cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        outs.append(out)
        assert p.returncode == 0, f"worker {i}:\n{out}"
    for i in range(2):
        assert f"MULTIHOST_OK_{i}" in outs[i]
