"""End-to-end pipeline throughput benchmark (frames/s).

Measures the full reconstruct() driver — image loading → SIFT/SURF →
batched pairwise matching → tracks → incremental pose estimation → export —
on a hermetic rendered 16-view dataset, reporting per-phase times and
frames/s. This is the pipeline-level counterpart to bench.py's BA
metric. The reference measures the same phases into
time_measurements.txt (src/sfm/reconstruct.cpp:163-168).

Usage:
    python -m orthosfm_tpu.testbench.bench_pipeline [--views 16] [--width 512]
        [--compare-cpu] [--json OUT.json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time


def _run_once(images: str, gt, solver):
    from orthosfm_tpu.config import ReconstructionConfig
    from orthosfm_tpu.io import timing
    from orthosfm_tpu.pipeline.reconstruct import reconstruct
    from orthosfm_tpu.testbench import metrics

    import numpy as np

    proj = tempfile.mkdtemp(prefix="osfm_bench_")
    try:
        cfg = ReconstructionConfig(project_folder=proj, image_folder=images,
                                   solver=solver)
        t0 = time.monotonic()
        res, views = reconstruct(cfg, verbose=False)
        total = time.monotonic() - t0
        m = timing.load_runtimes(os.path.join(proj, "time_measurements.txt"))
        ang, pos = metrics.pose_errors(res.cameras, gt)
        return {
            "initialization_s": round(m.init_time, 3),
            "track_building_s": round(m.track_building_time, 3),
            "pose_estimation_s": round(m.pose_estimation_time, 3),
            "total_s": round(total, 3),
            "frames_per_s": round(len(views) / total, 3),
            "mean_angular_error_deg": round(float(np.mean(ang)), 4),
            "mean_position_error": round(float(np.mean(pos)), 5),
        }
    finally:
        shutil.rmtree(proj, ignore_errors=True)


def run_benchmark(num_views: int = 16, width: int = 512, seed: int = 7,
                  compare_cpu: bool = False, warmup: bool = True):
    """Render once, run the pipeline (warmup compile + timed run) and return
    the metrics dict. With compare_cpu, also runs on the host CPU backend and
    reports the throughput ratio."""
    import jax

    from orthosfm_tpu.utils import compile_cache

    # The matching stage compiles one program per (octave shape × detector).
    compile_cache.enable()

    from orthosfm_tpu.config import SolverType
    from orthosfm_tpu.testbench import render

    images = tempfile.mkdtemp(prefix="osfm_bench_imgs_")
    try:
        gt = render.make_image_dataset(images, num_views=num_views,
                                       width=width, height=width, seed=seed,
                                       ring_degrees=200.0)
        solver = SolverType.ORTHO_QUATERNION
        if warmup:
            _run_once(images, gt, solver)  # compile cache warm
        out = _run_once(images, gt, solver)
        dev = jax.devices()[0]
        out.update(num_views=num_views, width=width, platform=dev.platform,
                   device_kind=dev.device_kind)

        if compare_cpu and jax.default_backend() != "cpu":
            cpu = jax.devices("cpu")[0]
            with jax.default_device(cpu):
                if warmup:
                    # Same treatment as the accelerator run: one warmup
                    # pass absorbs JAX compilation so the recorded ratio
                    # compares steady states, not warm vs cold.
                    _run_once(images, gt, solver)
                cpu_out = _run_once(images, gt, solver)
            out["cpu_total_s"] = cpu_out["total_s"]
            # NB: the baseline is THIS code on the host CPU backend (the
            # reference implementation is CPU-only, but this is not the
            # reference's C++ — see BASELINE.md).
            out["cpu_baseline"] = "same-code-on-jax-cpu-backend"
            out["vs_cpu_throughput"] = round(
                cpu_out["total_s"] / out["total_s"], 3)
        return out
    finally:
        shutil.rmtree(images, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="orthosfm-tpu-bench-pipeline")
    p.add_argument("--views", type=int, default=16)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--compare-cpu", action="store_true")
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--json", default="")
    args = p.parse_args(argv)

    out = run_benchmark(num_views=args.views, width=args.width,
                        compare_cpu=args.compare_cpu,
                        warmup=not args.no_warmup)
    line = json.dumps(out)
    print(line)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        # Keep one row per (views, width) config so e.g. the 512² and the
        # reference-scale 2048² records coexist in one file.
        rows = {}
        if os.path.exists(args.json):
            with open(args.json) as f:
                try:
                    prev = json.load(f)
                except ValueError:
                    prev = {}
            rows = prev if isinstance(prev, dict) and "runs" in prev else (
                {"runs": {f"{prev.get('num_views')}x{prev.get('width')}": prev}}
                if prev else {"runs": {}})
        rows.setdefault("runs", {})[f"{args.views}x{args.width}"] = out
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
