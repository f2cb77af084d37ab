"""Per-substage profile of the track-building stage (feature extraction →
pairwise matching → union-find).

Renders the hermetic benchmark dataset, warms the compile cache with one full
pass, then re-runs build_tracks under utils.profiling.collect_stages —
device barriers on stage exit attribute async device work to the stage that
enqueued it. The reference's analog is per-stage WallTimer prints inside MVE
(src/matching/matching_mve.cpp:337-341,411-417) and CudaSift's kernel timers
(src/cuda_sift/cudaSiftH.cu:170).

Usage:
    python -m orthosfm_tpu.testbench.profile_matching [--views 16]
        [--width 2048] [--json OUT.json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time


def profile_matching(num_views: int = 16, width: int = 2048, seed: int = 7,
                     warmup: bool = True):
    import jax

    from orthosfm_tpu.utils import compile_cache

    compile_cache.enable()

    from orthosfm_tpu.config import ReconstructionConfig
    from orthosfm_tpu.data import views as views_mod
    from orthosfm_tpu.pipeline import matching
    from orthosfm_tpu.testbench import render
    from orthosfm_tpu.utils import profiling

    images = tempfile.mkdtemp(prefix="osfm_prof_imgs_")
    try:
        render.make_image_dataset(images, num_views=num_views, width=width,
                                  height=width, seed=seed, ring_degrees=200.0)
        cfg = ReconstructionConfig(image_folder=images)
        views = views_mod.load_views(images, downscale_factor=1)
        if warmup:
            matching.build_tracks(views, cfg, verbose=False)

        stages: dict = {}
        with profiling.collect_stages(stages):
            t0 = time.monotonic()
            ts = matching.build_tracks(views, cfg, verbose=False)
            total = time.monotonic() - t0
        n_tracks = int(ts.alive.sum()) if hasattr(ts, "alive") else -1
        return {"num_views": num_views, "width": width,
                "platform": jax.devices()[0].platform,
                "device_kind": jax.devices()[0].device_kind,
                "total_s": round(total, 3), "num_tracks": n_tracks,
                "stages": {k: round(v, 3) for k, v in stages.items()}}
    finally:
        shutil.rmtree(images, ignore_errors=True)


def format_table(out: dict) -> str:
    # Top-level stage keys (extract/, match/, tracks/); sift/* rows are
    # nested inside extract/sift and indent below it.
    stages = out["stages"]
    lines = [f"track building profile — {out['num_views']} views × "
             f"{out['width']}² on {out['platform']} "
             f"(total {out['total_s']} s, {out['num_tracks']} tracks)"]
    order = [k for k in stages if not k.startswith("sift/")]
    for k in order:
        lines.append(f"  {k:<24s} {stages[k]:8.3f} s")
        if k == "extract/sift":
            for sk in (x for x in stages if x.startswith("sift/")):
                lines.append(f"    {sk:<22s} {stages[sk]:8.3f} s")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="orthosfm-tpu-profile-matching")
    p.add_argument("--views", type=int, default=16)
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--json", default="")
    args = p.parse_args(argv)

    out = profile_matching(num_views=args.views, width=args.width,
                           warmup=not args.no_warmup)
    print(format_table(out))
    print(json.dumps(out))
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        rows = {}
        if os.path.exists(args.json):
            with open(args.json) as f:
                try:
                    rows = json.load(f)
                except ValueError:
                    rows = {}
        rows[f"{args.views}x{args.width}"] = out
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
