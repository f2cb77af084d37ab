"""Synthetic dataset generation for solver development and robustness tests.

Analog of the reference testbench fixtures
(src/testbench/dataset_generation.cpp:14-93): 16 virtual 2048×2048 views on a
22.5°-spaced ring with random theta/roll ∈ ±30°, perfect tracks built by
projecting a point cloud through the ground-truth cameras.

The reference ships Cube/Sphere/Suzanne PLY vertex clouds as resources
(dataset_generation.cpp:95-137); when that resource directory is mounted the
named clouds load the ACTUAL reference vertices so sweep results are directly
comparable. Procedural stand-ins (cube surface grid, Fibonacci sphere, a
blobby union of spheres) are the fallback so no data files are required.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from orthosfm_tpu.config import SolverType
from orthosfm_tpu.core import cameras as cam_mod
from orthosfm_tpu.data import tracks as tracks_mod
from orthosfm_tpu.utils.pytree import pytree_dataclass, static_field


@pytree_dataclass
class SyntheticDataset:
    tracks: tracks_mod.TrackSet
    gt_cameras: cam_mod.CameraSet  # Euler ground truth
    name: str = static_field("")


def cube_cloud(n_per_edge: int = 21, extent: float = 1.0) -> np.ndarray:
    """Points on the surface of a cube (≈ the reference's Cube.ply, 2.7k pts)."""
    lin = np.linspace(-extent, extent, n_per_edge)
    g1, g2 = np.meshgrid(lin, lin, indexing="ij")
    faces = []
    for axis in range(3):
        for sign in (-extent, extent):
            pts = np.zeros((n_per_edge * n_per_edge, 3))
            other = [a for a in range(3) if a != axis]
            pts[:, other[0]] = g1.ravel()
            pts[:, other[1]] = g2.ravel()
            pts[:, axis] = sign
            faces.append(pts)
    pts = np.concatenate(faces, axis=0)
    return np.unique(np.round(pts, 9), axis=0)


def sphere_cloud(n: int = 3800, radius: float = 1.0) -> np.ndarray:
    """Fibonacci-spiral sphere (≈ the reference's Sphere.ply, 3.8k pts)."""
    i = np.arange(n, dtype=np.float64)
    phi = np.arccos(1.0 - 2.0 * (i + 0.5) / n)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    return radius * np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], axis=-1
    )


def blob_cloud(n: int = 7800, seed: int = 7) -> np.ndarray:
    """Asymmetric multi-sphere blob (stands in for Suzanne.ply, 7.8k pts) —
    asymmetric geometry matters for disambiguating mirror solutions."""
    rng = np.random.default_rng(seed)
    centers = np.array(
        [[0.0, 0.0, 0.0], [0.6, 0.45, 0.2], [-0.6, 0.45, 0.2], [0.0, -0.35, 0.55]]
    )
    radii = np.array([0.7, 0.28, 0.28, 0.35])
    weights = radii**2 / np.sum(radii**2)
    which = rng.choice(len(centers), size=n, p=weights)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return centers[which] + radii[which][:, None] * dirs


#: Directory with the reference's shipped PLY vertex clouds
#: (reference: src/testbench/dataset_generation.cpp:95-137 loads
#: resources/{Cube,Sphere,Suzanne}.ply as the sweep fixtures).
REFERENCE_RESOURCE_DIR = os.environ.get("ORTHOSFM_REFERENCE_RESOURCES",
                                        "/root/reference/resources")


def reference_cloud(name: str):
    """Vertex cloud loaded from the reference's PLY fixture, or None when the
    resource directory isn't mounted. Using the actual Cube/Sphere/Suzanne
    vertices makes the noise-sweep results directly comparable to the
    reference testbench's.

    Clouds are rescaled to max-norm 1 so their image-plane footprint matches
    the procedural fixtures: the raw PLYs are ~0.25-0.4 units in extent,
    which under the same px-noise sweep makes noise relatively ~3x stronger
    — an artifact of arbitrary model units, not of the solvers."""
    path = os.path.join(REFERENCE_RESOURCE_DIR, f"{name}.ply")
    if not os.path.exists(path):
        return None
    from orthosfm_tpu.io import ply

    pts = ply.load_vertices(path)
    if not len(pts):
        return None
    return pts / np.max(np.linalg.norm(pts, axis=1))


def _cloud_with_reference_fallback(name: str, procedural):
    def make():
        pts = reference_cloud(name)
        return pts if pts is not None else procedural()

    return make


CLOUDS = {
    "Cube": _cloud_with_reference_fallback("Cube", cube_cloud),
    "Sphere": _cloud_with_reference_fallback("Sphere", sphere_cloud),
    "Blob": blob_cloud,
    "Suzanne": _cloud_with_reference_fallback("Suzanne", blob_cloud),
}


def generate_gt_cameras(
    num_views: int = 16,
    width: int = 2048,
    height: int = 2048,
    theta_range: float = 30.0,
    roll_range: float = 30.0,
    seed: int = 0,
) -> cam_mod.CameraSet:
    """Ring of cameras: camera 0 identity, camera i at phi = 22.5°·i with random
    theta/roll (reference: dataset_generation.cpp:14-39)."""
    rng = np.random.default_rng(seed)
    phis = np.deg2rad(360.0 / num_views * np.arange(num_views))
    thetas = np.deg2rad(rng.uniform(-theta_range, theta_range, size=num_views))
    rolls = np.deg2rad(rng.uniform(-roll_range, roll_range, size=num_views))
    thetas[0] = 0.0
    rolls[0] = 0.0
    angles = np.stack([phis, thetas, rolls], axis=-1).astype(np.float32)
    return cam_mod.make_euler(
        np.arange(num_views), width, height, angles=angles,
        solver=SolverType.ORTHO_EULER_ALL_DOF,
    )


def generate_dataset(
    cloud: str | np.ndarray = "Cube",
    num_views: int = 16,
    width: int = 2048,
    height: int = 2048,
    seed: int = 0,
    capacity: int | None = None,
    scene_scale: float = 3.0,
) -> SyntheticDataset:
    """Project every cloud point through every GT camera into perfect full-length
    tracks (reference: dataset_generation.cpp:41-93).

    scene_scale shrinks the cloud into the unit view volume: the reference's PLY
    models are roughly unit-sized; the default camera has scale=1 so the visible
    world range on the image plane is [-1, 1].
    """
    name = cloud if isinstance(cloud, str) else "custom"
    pts = CLOUDS[cloud]() if isinstance(cloud, str) else np.asarray(cloud)
    pts = pts / scene_scale
    gt = generate_gt_cameras(num_views, width, height, seed=seed)
    points4 = jnp.concatenate(
        [jnp.asarray(pts, jnp.float32), jnp.ones((pts.shape[0], 1), jnp.float32)], axis=-1
    )
    pixels = cam_mod.project(gt, points4)  # (V, T, 2)
    pixels = jnp.transpose(pixels, (1, 0, 2))  # (T, V, 2)

    n = pts.shape[0]
    cap = capacity or n
    ts = tracks_mod.empty(cap, num_views)
    t_idx = jnp.arange(n)
    gids = (jnp.arange(n)[:, None] * num_views + jnp.arange(num_views)[None, :]).astype(jnp.int32)
    ts = ts.replace(
        obs=ts.obs.at[t_idx].set(pixels),
        obs_mask=ts.obs_mask.at[t_idx].set(True),
        local_ids=ts.local_ids.at[t_idx].set(jnp.arange(n, dtype=jnp.int32)[:, None]),
        global_ids=ts.global_ids.at[t_idx].set(gids),
        alive=ts.alive.at[t_idx].set(True),
    )
    return SyntheticDataset(tracks=ts, gt_cameras=gt, name=name)


def add_observation_noise(tracks: tracks_mod.TrackSet, sigma_px: float, key,
                          frequency: float = 1.0) -> tracks_mod.TrackSet:
    """Gaussian pixel noise with an application-frequency gate, reproducing the
    testbench's observation-noise fault injection
    (reference: synthethic_tests.cpp:41-108)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0) if key is None else key)
    noise = sigma_px * jax.random.normal(k1, tracks.obs.shape)
    gate = jax.random.uniform(k2, tracks.obs_mask.shape) < frequency
    applied = jnp.where((tracks.obs_mask & gate)[..., None], noise, 0.0)
    return tracks.replace(obs=tracks.obs + applied)
