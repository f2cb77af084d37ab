"""Smoke test: the reconstruction pipeline end to end on NVIDIA GPUs.

    python chip_smoke.py             # one card, all phases below
    python chip_smoke.py --cards 4   # four cards: the sharded path only

One card, in order; each phase prints one line with what it measured and
compared, and the limit beside each number:

1. device   — JAX version and devices, the card's name and power limit
              (nvidia-smi); exits NO_GPU (42) without printing a result
              unless JAX's first device is a GPU.
2. matching — ops.matching.match_pairs_batched on B=4 pairs × N=8192 × D=128
              seeded unit descriptors with planted correspondences, against
              the float64 NumPy reference `reference_match` below.
3. ba       — 16 cameras × 8192 tracks (bench.make_problem), 30 LM
              iterations, quaternion and Euler cameras, on the GPU and on the
              host CPU backend of the same process.
4. e2e      — 16 rendered views at 2048² through `orthosfm_tpu.app.main`
              (SIFT+SURF, batched matching, RANSAC-F, tracks, Tomasi-Kanade,
              BA, export), a cold and a warm run, poses against the
              rendered ground truth, then one more warm run under the
              profiler: device busy time, idle share, busiest operations.

`--cards 4` runs 12 views at 2048² through `app.main([..., "--devices=4"])`
and the same set on one card in the same process (cold runs only), and
compares the two.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
No phase catches its own failure: any failure exits non-zero before it.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np

NO_GPU = 42  # exit code: JAX found no GPU

# Angular-error bounds against the rendered ground truth: the reference
# testbench's <3° target (also tests/test_full_pipeline.py) on the worst
# camera, and 1° on the mean.
MAX_ANG_DEG = 3.0
MEAN_ANG_DEG = 1.0


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(ok, what) -> None:
    """Fail the run (an exception, so the exit code is non-zero)."""
    if not ok:
        raise AssertionError(f"check failed: {what}")


# ---------------------------------------------------------------------------
# 1. Device


def phase_device(cards: int) -> dict:
    import jax

    from orthosfm_tpu.utils import compile_cache, device

    cache = compile_cache.enable()
    log("device", f"jax {jax.__version__}; devices {jax.devices()}")
    try:
        info = device.require_gpu()
    except RuntimeError as e:
        print(f"[device] {e}; limit: platform == gpu", file=sys.stderr)
        sys.exit(NO_GPU)
    smi = device.nvidia_smi()
    if smi is None:
        raise RuntimeError("JAX sees a GPU but nvidia-smi gave no name and "
                           "power limit")
    if info["count"] < cards:
        raise RuntimeError(f"{cards} cards asked for, JAX sees "
                           f"{info['count']}")
    for line in smi.splitlines():
        print(line.strip(), flush=True)  # "name, power.limit" per card
    log("device", f"platform {info['platform']} (limit: gpu), kind "
                  f"{info['kind']}, count {info['count']}; compile cache "
                  f"{cache}; matmul precision "
                  f"{jax.config.jax_default_matmul_precision}")
    return info


# ---------------------------------------------------------------------------
# 2. Matching


def reference_match(d1, v1, d2, v2, lowe_ratio: float = 0.8):
    """Plain float64 NumPy two-way matcher for one pair: squared distance
    between unit descriptors, the two nearest valid neighbours, Lowe's ratio
    on squared distances, and the mutual check. Returns (N1,) indices into
    set 2, −1 where unmatched."""
    d1 = np.asarray(d1, np.float64)
    d2 = np.asarray(d2, np.float64)
    v1 = np.asarray(v1, bool)
    v2 = np.asarray(v2, bool)

    def oneway(A, vA, B, vB):
        dist = np.maximum(2.0 - 2.0 * (A @ B.T), 0.0)
        dist[:, ~vB] = 4.0  # beyond any distance between unit vectors
        rows = np.arange(len(A))
        two = np.argpartition(dist, 1, axis=1)[:, :2]
        da, db = dist[rows, two[:, 0]], dist[rows, two[:, 1]]
        first = np.where(da <= db, two[:, 0], two[:, 1])
        best, second = np.minimum(da, db), np.maximum(da, db)
        ok = (best <= lowe_ratio * lowe_ratio * second) & vA & (best < 4.0)
        return np.where(ok, first, -1)

    m12 = oneway(d1, v1, d2, v2)
    m21 = oneway(d2, v2, d1, v1)
    back = np.where(m12 >= 0, m21[np.clip(m12, 0, len(m21) - 1)], -2)
    return np.where(back == np.arange(len(m12)), m12, -1)


def planted_descriptors(B: int, N: int, D: int, seed: int = 0):
    """(d1, v1, d2, v2) float32 unit descriptors for B pairs: half of each
    pair's set-2 rows are noisy copies of shuffled set-1 rows (true
    correspondences), the rest are independent; the last rows of each pair
    are marked invalid, a different number per pair."""
    rng = np.random.default_rng(seed)

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    d1 = unit(rng.normal(size=(B, N, D)))
    d2 = unit(rng.normal(size=(B, N, D)))
    half = N // 2
    for b in range(B):
        src = rng.permutation(N)[:half]
        dst = rng.permutation(N)[:half]
        d2[b, dst] = unit(d1[b, src] + 0.15 * rng.normal(size=(half, D))
                          / np.sqrt(D))
    n_valid = N - 97 * np.arange(B)
    iota = np.arange(N)
    v1 = iota[None, :] < n_valid[:, None]
    v2 = iota[None, :] < n_valid[::-1, None]
    return d1, v1, d2, v2


def phase_matching(B: int = 4, N: int = 8192, D: int = 128,
                   min_agree: float = 0.999) -> None:
    import jax

    from orthosfm_tpu.ops import matching

    d1, v1, d2, v2 = planted_descriptors(B, N, D)
    args = jax.device_put((d1, v1, d2, v2))
    t0 = time.perf_counter()
    out = np.asarray(matching.match_pairs_batched(*args, lowe_ratio=0.8))
    compile_s = time.perf_counter() - t0
    warm = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(matching.match_pairs_batched(*args,
                                                           lowe_ratio=0.8))
        warm = min(warm, time.perf_counter() - t0)

    ref = np.stack([reference_match(d1[b], v1[b], d2[b], v2[b], 0.8)
                    for b in range(B)])
    agree = float(np.mean(out == ref))
    n_out, n_ref = int(np.sum(out >= 0)), int(np.sum(ref >= 0))
    # Float32 on the card vs float64 here can order two near-equal
    # neighbours differently or move a pair across the ratio boundary;
    # TF32 is off (precision "highest"), so nothing else may differ.
    log("matching", f"B={B} N={N} D={D}: match indices identical to the "
                    f"float64 NumPy reference on {agree:.6f} of rows "
                    f"(limit >= {min_agree}); matches {n_out} vs reference "
                    f"{n_ref} (limit > {B * N // 4}); compile+first "
                    f"{compile_s:.3f} s, warm {warm * 1e3:.3f} ms")
    check(agree >= min_agree, agree)
    check(n_ref > B * N // 4, n_ref)  # the planted half is found


# ---------------------------------------------------------------------------
# 3. Bundle adjustment


def _rotation_gap_deg(cams_a, cams_b) -> float:
    from orthosfm_tpu.core import cameras as cam_mod

    Ra = np.asarray(cam_mod.basis(cams_a), np.float64)
    Rb = np.asarray(cam_mod.basis(cams_b), np.float64)
    # ‖Ra − Rb‖_F = 2√2·sin(θ/2) for rotations: well conditioned at θ ≈ 0,
    # where arccos of the trace is not.
    chord = np.linalg.norm(Ra - Rb, axis=(1, 2)) / (2.0 * np.sqrt(2.0))
    return float(np.rad2deg(2.0 * np.arcsin(np.clip(chord, 0.0, 1.0))).max())


def phase_ba(num_views: int = 16, n_points: int = 8192, iters: int = 30,
             repeats: int = 5) -> None:
    import jax

    import bench

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    cams, points, obs, mask = bench.make_problem(num_views, n_points)
    n_obs = int(np.sum(np.asarray(mask)))
    for kind, c in (("quat", cams), ("euler", bench.to_euler(cams))):
        ips, res_g, compile_s = bench.time_ba(gpu, c, points, obs, mask,
                                              iters, repeats)
        cpu_ips, res_c, _ = bench.time_ba(cpu, c, points, obs, mask, iters,
                                          repeats=1)
        cost_g, cost_c = float(res_g.cost), float(res_c.cost)
        init = float(res_g.initial_cost)
        rel = abs(cost_g - cost_c) / cost_c
        gap = _rotation_gap_deg(res_g.cams, res_c.cams)
        n_it = int(res_g.iterations)
        # Float32 on both backends, TF32 off: only the reduction order
        # differs, which moves the converged cost by far less than 1 % and
        # the rotations by far less than 0.01°. The problem's 0.5 px noise
        # (bench.NOISE_PX) keeps the optimum's cost away from 0, where a
        # relative comparison would mean nothing. A solve ends after `iters`
        # iterations or earlier, once rejected steps drive the damping to
        # max_lambda (bench.ba_config).
        log("ba", f"{kind} {num_views} cams × {n_points} tracks ({n_obs} "
                  f"obs), {n_it} iterations (limit: 1 to {iters}) on the "
                  f"card, {int(res_c.iterations)} on the CPU backend: cost "
                  f"{init:.6g} -> {cost_g:.6g}"
                  f" (limit: falls); vs CPU backend {cost_c:.6g}, rel diff "
                  f"{rel:.3e} (limit <= 1e-2); max rotation gap {gap:.3e}°"
                  f" (limit <= 1e-2°); {ips:.3f} iter/s on "
                  f"{gpu.device_kind} (compile+first {compile_s:.3f} s; CPU"
                  f" backend {cpu_ips:.3f} iter/s)")
        check(0 < n_it <= iters, n_it)
        check(cost_g < init, (cost_g, init))
        check(rel <= 1e-2, rel)
        check(gap <= 1e-2, gap)


# ---------------------------------------------------------------------------
# 4. End to end through the CLI entry point


def _render(folder: str, num_views: int, width: int):
    from orthosfm_tpu.testbench import render

    t0 = time.perf_counter()
    gt = render.make_image_dataset(folder, num_views=num_views, width=width,
                                   height=width, seed=7, ring_degrees=200.0)
    return gt, time.perf_counter() - t0


def _run_app(proj: str, images: str, *extra: str) -> float:
    """app.main on the project; its (verbose) output goes to
    `<project>.log` and is shown on stderr only if the run fails."""
    from orthosfm_tpu import app

    log_path = proj + ".log"
    t0 = time.perf_counter()
    try:
        with open(log_path, "w") as f, contextlib.redirect_stdout(f):
            rc = app.main([proj, images, "--solver", "0", "--overwrite",
                           *extra])
    except BaseException:
        with open(log_path) as f:
            sys.stderr.write("".join(f.readlines()[-60:]))
        raise
    if rc:
        raise RuntimeError(f"app.main returned {rc}; see {log_path}")
    return time.perf_counter() - t0


def _check_project(proj: str, gt, num_views: int, width: int) -> str:
    """Assert every view is placed, the four output files are non-empty and
    the poses are within the bounds; return a summary."""
    from orthosfm_tpu.config import SolverType
    from orthosfm_tpu.core import cameras as cam_mod
    from orthosfm_tpu.io import cameras_io, timing
    from orthosfm_tpu.testbench import metrics

    for name in ("cameras.txt", "sparse_cloud.ply", "tracks.txt",
                 "time_measurements.txt"):
        path = os.path.join(proj, name)
        check(os.path.getsize(path) > 0, f"{name} is empty")
    cams = {c.image_name: c.transform
            for c in cameras_io.import_cameras(os.path.join(proj,
                                                            "cameras.txt"))}
    names = [f"view_{i:02d}.png" for i in range(num_views)]
    missing = [n for n in names if n not in cams]
    check(not missing, f"views not placed: {missing}")
    basis = np.stack([cams[n][:3, :3] for n in names])
    est = cam_mod.from_basis(basis, np.arange(num_views), float(width),
                             float(width), SolverType.ORTHO_QUATERNION)
    ang, _ = metrics.pose_errors(est, gt)
    m = timing.load_runtimes(os.path.join(proj, "time_measurements.txt"))
    with open(os.path.join(proj, "tracks.txt")) as f:
        n_tracks = sum(1 for _ in f)
    summary = (f"{num_views}/{num_views} views placed, {n_tracks} tracks; "
               f"angular error max {ang.max():.4f}° (limit < {MAX_ANG_DEG}°)"
               f" mean {ang.mean():.4f}° (limit < {MEAN_ANG_DEG}°); phases "
               f"init {m.init_time:.3f} s, tracks {m.track_building_time:.3f}"
               f" s, poses {m.pose_estimation_time:.3f} s, total "
               f"{m.total_time:.3f} s")
    check(ang.max() < MAX_ANG_DEG, ang)
    check(ang.mean() < MEAN_ANG_DEG, ang)
    return summary


def phase_e2e(work: str, num_views: int = 16, width: int = 2048) -> None:
    import jax

    from orthosfm_tpu.utils import profiling

    images = os.path.join(work, "images")
    proj = os.path.join(work, "project")
    gt, render_s = _render(images, num_views, width)
    log("e2e", f"rendered {num_views} views at {width}² in {render_s:.3f} s"
               " (host)")
    cold = _run_app(proj, images)
    log("e2e", f"cold run (compile + run) {cold:.3f} s: "
               + _check_project(proj, gt, num_views, width))
    warm = _run_app(proj, images)
    log("e2e", f"warm run {warm:.3f} s, {num_views / warm:.3f} views/s: "
               + _check_project(proj, gt, num_views, width))
    # A third warm run under the profiler: the device's busy time, idle
    # share and busiest operations (the timed runs above are not traced).
    trace_dir = os.path.join(work, "trace")
    with jax.profiler.trace(trace_dir):
        traced = _run_app(proj, images)
    log("trace", f"traced warm run {traced:.3f} s")
    print(profiling.format_device_ops(
        profiling.device_op_summary(trace_dir)), flush=True)


# ---------------------------------------------------------------------------
# --cards 4: the sharded path against one card


def phase_sharded(work: str, cards: int, num_views: int = 12,
                  width: int = 2048) -> None:
    import jax

    from orthosfm_tpu.parallel import ba_sharded, mesh as mesh_mod

    meshes, device_sets = [], []
    make_mesh, shard = mesh_mod.make_mesh, ba_sharded.shard_track_arrays

    def recording_make_mesh(n=None):
        meshes.append(make_mesh(n))
        return meshes[-1]

    def recording_shard(mesh, arrs):
        out = shard(mesh, arrs)
        device_sets.extend(frozenset(a.sharding.device_set) for a in out)
        return out

    mesh_mod.make_mesh = recording_make_mesh
    ba_sharded.shard_track_arrays = recording_shard
    images = os.path.join(work, "images")
    proj_n = os.path.join(work, f"project_{cards}")
    proj_1 = os.path.join(work, "project_1")
    gt, render_s = _render(images, num_views, width)
    log("sharded", f"rendered {num_views} views at {width}² in "
                   f"{render_s:.3f} s (host); {jax.device_count()} devices")
    try:
        cold_n = _run_app(proj_n, images, f"--devices={cards}")
    finally:
        mesh_mod.make_mesh = make_mesh
        ba_sharded.shard_track_arrays = shard
    log("sharded", f"{cards} cards, cold (compile + run) {cold_n:.3f} s: "
                   + _check_project(proj_n, gt, num_views, width))

    check(len(meshes) == 1, meshes)
    mesh_devs = list(meshes[0].devices.flat)
    distinct = {d.id for d in mesh_devs}
    platforms = {d.platform for d in mesh_devs}
    platform = jax.devices()[0].platform  # "gpu": phase_device checked it
    log("sharded", f"mesh {dict(meshes[0].shape)} over devices "
                   f"{sorted(distinct)} ({platforms}) (limit: {cards} "
                   f"distinct {platform} devices)")
    check(len(distinct) == cards and platforms == {platform}, mesh_devs)
    sizes = sorted({len(d) for d in device_sets})
    log("sharded", f"{len(device_sets)} sharded BA inputs, device_set sizes "
                   f"{sizes} (limit: all {cards})")
    check(device_sets and sizes == [cards], sizes)

    cold_1 = _run_app(proj_1, images)
    log("sharded", f"1 card, cold (compile + run) {cold_1:.3f} s: "
                   + _check_project(proj_1, gt, num_views, width))

    # tracks.txt is written after track building and before pose
    # estimation: it holds what the sharded matching and RANSAC made.
    with open(os.path.join(proj_n, "tracks.txt")) as f:
        tracks_n = f.read().splitlines()
    with open(os.path.join(proj_1, "tracks.txt")) as f:
        tracks_1 = f.read().splitlines()
    obs_n = sum(int(t.split(";")[0]) for t in tracks_n)
    obs_1 = sum(int(t.split(";")[0]) for t in tracks_1)
    common = sum((collections.Counter(tracks_n)
                  & collections.Counter(tracks_1)).values())
    shared = common / max(len(tracks_n), len(tracks_1), 1)
    # Each device runs the one-card program on whole one-card chunks of
    # pairs, with the same per-pair keys, so the tracks are expected to be
    # identical. The bound leaves room for 1 % of the lines: RANSAC-F's
    # float32 result depends on the compiled program, and the sharded
    # program is compiled apart from the one-card one.
    log("sharded", f"tracks {len(tracks_n)} on {cards} cards vs "
                   f"{len(tracks_1)} on one (limit: within 1 %), "
                   f"observations {obs_n} vs {obs_1} (limit: within 1 %), "
                   f"identical track lines {shared:.6f} (limit >= 0.99), "
                   f"tracks.txt identical {tracks_n == tracks_1}")
    check(abs(len(tracks_n) - len(tracks_1)) <= 0.01 * len(tracks_1),
          (len(tracks_n), len(tracks_1)))
    check(abs(obs_n - obs_1) <= 0.01 * obs_1, (obs_n, obs_1))
    check(shared >= 0.99, shared)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cards", type=int, default=1, choices=(1, 4),
                   help="4: run only the sharded path and its one-card "
                        "comparison")
    args = p.parse_args(argv)

    info = phase_device(args.cards)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if args.cards > 1:
            phase_sharded(work, args.cards)
        else:
            phase_matching()
            phase_ba()
            phase_e2e(work)
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
