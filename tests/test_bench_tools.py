"""The measurement helpers: the benchmark's BA problem, the trace reduction
and its interval union."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
from orthosfm_tpu.core import cameras as cam_mod
from orthosfm_tpu.solvers import ba
from orthosfm_tpu.utils import profiling


def test_bench_problem_solves_under_both_parameterisations():
    cams, points, obs, mask = bench.make_problem(num_views=6, n_points=256)
    assert obs.shape == (points.shape[0], 6, 2) and mask.shape == obs.shape[:2]
    euler = bench.to_euler(cams)
    assert euler.kind == "euler" and bool(euler.fixed[0])
    np.testing.assert_allclose(np.asarray(cam_mod.basis(euler)),
                               np.asarray(cam_mod.basis(cams)), atol=1e-5)
    cfg = bench.ba_config(iters=8)
    for c in (cams, euler):
        res = ba.run(c, points, obs, mask, optimize_points=True, config=cfg)
        # 0.5 px noise: the optimum costs about 0.25 per observation
        n_obs = int(jnp.sum(mask))
        assert float(res.cost) < 0.1 * float(res.initial_cost)
        assert 0.1 * n_obs < float(res.cost) < 0.5 * n_obs
        assert 1 <= int(res.iterations) <= 8


def test_time_ba_counts_each_solve_at_its_own_iterations():
    cams, points, obs, mask = bench.make_problem(num_views=4, n_points=128)
    cpu = jax.devices("cpu")[0]
    ips, res, first_s = bench.time_ba(cpu, cams, points, obs, mask, iters=5,
                                      repeats=2)
    assert 1 <= int(res.iterations) <= 5
    assert ips > 0.0 and first_s > 0.0
    assert float(res.cost) < float(res.initial_cost)
    ips0, _, _ = bench.time_ba(cpu, cams, points, obs, mask, iters=5,
                               repeats=0)
    assert ips0 == 0.0  # nothing timed


@pytest.mark.parametrize("spans,expect", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 20), (30, 35)], 25.0),   # overlap, then a gap
    ([(30, 35), (0, 10), (2, 3), (10, 12)], 17.0),  # unsorted, nested, touching
])
def test_busy_ns_is_the_interval_union(spans, expect):
    assert profiling.busy_ns(spans) == expect


def test_device_op_summary_reads_a_recorded_trace(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.device_op_summary(str(tmp_path / "none"))
    logdir = str(tmp_path / "trace")
    with jax.profiler.trace(logdir):
        x = jnp.ones((64, 64))
        jax.block_until_ready(jax.jit(lambda a: jnp.sin(a @ a))(x))
    assert any(f.endswith(".xplane.pb") for _, _, fs in os.walk(logdir)
               for f in fs)
    # The CPU backend records host threads only: no device plane to reduce.
    summary = profiling.device_op_summary(logdir)
    assert summary == []
    assert profiling.format_device_ops(summary) == ""
