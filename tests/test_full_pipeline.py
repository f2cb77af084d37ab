"""Hermetic full-pipeline integration test: rendered images → SIFT →
matching → tracks → incremental poses → artifacts (the reference's
full-pipeline testbench analog, self-contained)."""

import os

import numpy as np
import pytest

from orthosfm_tpu.config import ReconstructionConfig, SolverType
from orthosfm_tpu.io import cameras_io, project as project_io, timing
from orthosfm_tpu.pipeline.reconstruct import reconstruct
from orthosfm_tpu.testbench import metrics, render


@pytest.mark.slow
def test_reconstruct_from_images(tmp_path):
    images = str(tmp_path / "images")
    proj = str(tmp_path / "project")
    gt = render.make_image_dataset(images, num_views=5, width=224, height=224,
                                   seed=3, ring_degrees=100)
    project_io.create_project(proj)
    cfg = ReconstructionConfig(project_folder=proj, image_folder=images,
                               solver=SolverType.ORTHO_QUATERNION)
    res, views = reconstruct(cfg, verbose=False)

    assert res.present.all()
    ang, pos = metrics.pose_errors(res.cameras, gt)
    assert ang.max() < 3.0, ang
    assert pos.max() < 0.06, pos

    # All reference artifacts must exist
    for name in ("cameras.txt", "sparse_cloud.ply", "tracks.txt",
                 "time_measurements.txt"):
        assert os.path.isfile(os.path.join(proj, name)), name
    cams = cameras_io.import_cameras(os.path.join(proj, "cameras.txt"))
    assert len(cams) == 5
    m = timing.load_runtimes(os.path.join(proj, "time_measurements.txt"))
    assert m.total_time > 0


@pytest.mark.slow
def test_reconstruct_with_masks_and_downscale(tmp_path):
    """Masks + downscale-factor ≠ 1 through the full reconstruct() driver
    (reference flags --mask-folder / --downscale-factor, main.cpp:28-38).
    Images render at 448² and reconstruct at downscale 2; masks blank a
    40 px border so every surviving track feature must be inside it."""
    from orthosfm_tpu.io import png

    images = str(tmp_path / "images")
    masks = str(tmp_path / "masks")
    proj = str(tmp_path / "project")
    W = 448
    gt = render.make_image_dataset(images, num_views=5, width=W, height=W,
                                   seed=3, ring_degrees=100)
    os.makedirs(masks)
    border = 40
    m = np.zeros((W, W), np.uint8)
    m[border:-border, border:-border] = 255
    for i in range(5):
        png.write_png(os.path.join(masks, f"view_{i:02d}_mask.png"), m)

    project_io.create_project(proj)
    cfg = ReconstructionConfig(project_folder=proj, image_folder=images,
                               mask_folder=masks, downscale_factor=2,
                               solver=SolverType.ORTHO_QUATERNION)
    res, views = reconstruct(cfg, verbose=False)

    assert res.present.all()
    ang, pos = metrics.pose_errors(res.cameras, gt)
    assert ang.max() < 3.0, ang

    # Every surviving observation must lie inside the unmasked area (the
    # mask filter runs at the downscaled resolution: border 40/2 = 20 px)
    tr = res.tracks
    alive = np.asarray(tr.alive)
    obs = np.asarray(tr.obs)[alive]
    om = np.asarray(tr.obs_mask)[alive]
    b = border / 2 - 1.0
    inside = (obs[..., 0] >= b) & (obs[..., 0] <= W / 2 - b) & \
             (obs[..., 1] >= b) & (obs[..., 1] <= W / 2 - b)
    assert np.all(inside[om]), "masked-out features survived"


@pytest.mark.slow
@pytest.mark.parametrize("scene,expect_deg", [("blob", 1.0),
                                              ("ornament_cube", 1.5)])
def test_reconstruct_hard_scenes(tmp_path, scene, expect_deg):
    """End-to-end on the harder rendered scenes: a self-occluding multi-sphere
    blob and a corner-on cube with face bumps (flat patches + sharp
    silhouettes). Counterpart of the reference's organic Suzanne/Dragon
    evaluation sets (full_pipeline_tests.cpp:404-412)."""
    images = str(tmp_path / "images")
    proj = str(tmp_path / "project")
    gt = render.make_image_dataset(images, num_views=5, width=224, height=224,
                                   seed=4, ring_degrees=100, scene=scene)
    project_io.create_project(proj)
    cfg = ReconstructionConfig(project_folder=proj, image_folder=images,
                               solver=SolverType.ORTHO_QUATERNION)
    res, views = reconstruct(cfg, verbose=False)
    assert res.present.all()
    ang, pos = metrics.pose_errors(res.cameras, gt)
    assert ang.max() < expect_deg, ang


@pytest.mark.slow
def test_reconstruct_homography_engine(tmp_path):
    """End-to-end with the CudaSift-style homography verification engine
    (pair_verification="homography", reference: matching.cpp:160-215) —
    the alternate engine must produce a full reconstruction too."""
    import dataclasses

    images = str(tmp_path / "images")
    proj = str(tmp_path / "project")
    gt = render.make_image_dataset(images, num_views=5, width=224, height=224,
                                   seed=3, ring_degrees=100)
    project_io.create_project(proj)
    cfg = ReconstructionConfig(project_folder=proj, image_folder=images,
                               solver=SolverType.ORTHO_QUATERNION)
    cfg = dataclasses.replace(
        cfg, matching=dataclasses.replace(
            cfg.matching, pair_verification="homography",
            # homographies only approximate non-planar scenes: keep the
            # reference's gates but fewer hypotheses for CPU test speed
            homography_iterations=2000))
    res, views = reconstruct(cfg, verbose=False)
    assert res.present.all()
    ang, pos = metrics.pose_errors(res.cameras, gt)
    assert ang.max() < 3.0, ang


@pytest.mark.slow
@pytest.mark.parametrize("solver", [SolverType.ORTHO_QUATERNION,
                                    SolverType.ORTHO_EULER_HORIZONTAL,
                                    SolverType.ORTHO_EULER_HORIZONTAL_VERTICAL,
                                    SolverType.ORTHO_EULER_ALL_DOF])
def test_reconstruct_solver_matrix(tmp_path, solver):
    """All four --solver parameterizations end-to-end on a rendered dataset
    (the reference's eval grid, full_pipeline_tests.cpp:404-412, 428-439).
    The scene is a pure horizontal ring so the restricted Euler solvers can
    represent it exactly."""
    images = str(tmp_path / "images")
    proj = str(tmp_path / "project")
    gt = render.make_image_dataset(images, num_views=5, width=224, height=224,
                                   seed=5, ring_degrees=100,
                                   theta_range=0.0, roll_range=0.0)
    project_io.create_project(proj)
    cfg = ReconstructionConfig(project_folder=proj, image_folder=images,
                               solver=solver)
    res, views = reconstruct(cfg, verbose=False)
    assert res.present.all()
    ang, pos = metrics.pose_errors(res.cameras, gt)
    assert ang.max() < 3.0, (solver.name, ang)
