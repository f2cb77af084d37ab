"""Many-view scale demonstration: a full incremental reconstruction at
views/tracks counts far beyond the reference's practical envelope.

The reference's group builder enumerates all (groupSize-1)-combinations of
used cameras per group (src/data_structures/group.cpp:13-88) and its Ceres
BA is CPU-bound; published runs stop at ~16 views. This demo runs the
complete incremental loop (grouping, RANSAC'd TK inits, local BAs,
align/merge, periodic + final global BA over ALL cameras, outlier filters)
at --views 64 / --tracks 50k+ on one device and reports wall time plus
angular error vs ground truth, with the device it ran on.

    python scripts/scale_demo.py [--views 64] [--tracks 50000] [--json out]
"""

import argparse
import json
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, default=64)
    ap.add_argument("--tracks", type=int, default=50000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--noise-px", type=float, default=1.0)
    ap.add_argument("--json", default="")
    ap.add_argument("--platform", default="")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from orthosfm_tpu.utils import compile_cache

    compile_cache.enable()

    import numpy as np

    from orthosfm_tpu.config import ReconstructionConfig, SolverType
    from orthosfm_tpu.data import synthetic
    from orthosfm_tpu.pipeline import incremental
    from orthosfm_tpu.testbench import metrics

    # Asymmetric blob: mirror disambiguation needs asymmetric geometry.
    cloud = synthetic.blob_cloud(args.tracks, seed=args.seed)
    ds = synthetic.generate_dataset(cloud, num_views=args.views,
                                    seed=args.seed)
    key = jax.random.PRNGKey(args.seed)
    noisy = synthetic.add_observation_noise(ds.tracks, args.noise_px, key)
    cfg = ReconstructionConfig(solver=SolverType.ORTHO_QUATERNION,
                               seed=args.seed)

    t0 = time.perf_counter()
    res = incremental.run_pose_estimation(
        noisy, 2048.0, 2048.0, cfg, verbose=False)
    jax.block_until_ready(res.cameras.rot)
    wall = time.perf_counter() - t0

    ang, pos = metrics.pose_errors(res.cameras, ds.gt_cameras)
    out = {
        "views": args.views,
        "tracks": args.tracks,
        "noise_px": args.noise_px,
        "wall_s": round(wall, 2),
        "views_placed": int(np.sum(res.present)),
        "mean_angular_error_deg": round(float(np.mean(ang)), 4),
        "max_angular_error_deg": round(float(np.max(ang)), 4),
        "mean_position_error": round(float(np.mean(pos)), 5),
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
    }
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    main()
