"""CLI entry point — mirror of the reference orthosfm-app
(src/app/main.cpp:21-131).

Usage:
    python -m orthosfm_tpu.app PROJECT_FOLDER IMAGE_FOLDER [options]
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="orthosfm-tpu",
        description="Structure from motion for orthographic images",
    )
    p.add_argument("project_folder", help="folder to store the project in")
    p.add_argument("image_folder", help="folder with input images")
    p.add_argument("--calculated-tracks", default="",
                   help="path to a txt file with pre-calculated tracks")
    p.add_argument("--export-pairwise-tracks", action="store_true",
                   help="export pairwise track files for interop with other tools")
    p.add_argument("--mask-folder", default="",
                   help="folder with masks named {imageName}_mask.png")
    p.add_argument("--downscale-factor", type=int, default=1,
                   help="downscale images by this factor before matching")
    p.add_argument("--overwrite", action="store_true",
                   help="overwrite an existing project in the project folder")
    p.add_argument("--solver", type=int, default=0, choices=[0, 1, 2, 3],
                   help="0=Quaternion 1=EulerHorizontal 2=EulerHorizontalVertical "
                        "3=EulerAllDof")
    p.add_argument("--platform", default="",
                   help="force a JAX platform (e.g. cpu) instead of the default")
    p.add_argument("--devices", type=int, default=1,
                   help="shard pose estimation over this many devices "
                        "(tracks + RANSAC hypotheses partition over a mesh; "
                        "requires that many JAX devices)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax

    from orthosfm_tpu.utils import compile_cache

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    compile_cache.enable()

    from orthosfm_tpu.config import ReconstructionConfig, SolverType
    from orthosfm_tpu.io import project as project_io
    from orthosfm_tpu.pipeline.reconstruct import reconstruct

    if not os.path.isdir(args.image_folder):
        print("Error: The specified image folder does not exist.")
        return 1
    if args.calculated_tracks and not os.path.isfile(args.calculated_tracks):
        print("Error: The specified track file does not exist.")
        return 1

    if not project_io.create_project(args.project_folder, overwrite=args.overwrite):
        return 1

    config = ReconstructionConfig(
        project_folder=args.project_folder,
        image_folder=args.image_folder,
        mask_folder=args.mask_folder,
        track_file=args.calculated_tracks,
        downscale_factor=args.downscale_factor,
        solver=SolverType(args.solver),
        export_pairwise_tracks=args.export_pairwise_tracks,
    )
    mesh = None
    if args.devices > 1:
        from orthosfm_tpu.parallel import mesh as mesh_mod

        mesh = mesh_mod.make_mesh(args.devices)
    dev = jax.devices()[0]
    print(f"Running on {dev.platform} ({dev.device_kind}), "
          f"{args.devices} of {jax.device_count()} device(s)")
    print(f"Using solver: {config.solver.describe()}")
    reconstruct(config, mesh=mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
