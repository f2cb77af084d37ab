"""Synthetic image rendering for full-pipeline tests.

The reference's full-pipeline tests rely on external image datasets
(README.md:24-27, not in the repo; named sets Suzanne/Rings/Dragon ×
Circle/3Lat/3Lat_rotated, full_pipeline_tests.cpp:404-412). To exercise the
image→features→matching→tracks→poses path hermetically, we ray-trace
orthographic views of procedurally textured analytic scenes: each pixel's ray
(orthographic, along the camera look direction) is intersected with the scene
and the 3D hit point is shaded with a band-limited random-Fourier 3D texture.
Texture is rigid on the surface, so local appearance is repeatable across
moderate viewpoint changes — the same regime as the reference's real/synthetic
object datasets.

Scenes (in rough difficulty order):
  sphere — single textured sphere: no occlusion, stable silhouette;
  blob   — union of K random spheres: self-occlusion, concavities, and
           silhouettes that change per view (counterpart of the reference's
           organic Suzanne/Dragon sets);
  cube   — axis-aligned box: flat faces (locally planar → homography-
           degenerate pairs), sharp depth discontinuities, faces appearing /
           disappearing across the ring.
"""

from __future__ import annotations

from typing import List

import numpy as np

from orthosfm_tpu.core import cameras as cam_mod


class FourierTexture3D:
    """Smooth random 3D texture f(p) = Σ a_k cos(w_k·p + φ_k), values ≈ [0,1]."""

    def __init__(self, n_components: int = 80, max_freq: float = 40.0, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.w = rng.uniform(-max_freq, max_freq, (n_components, 3))
        self.phase = rng.uniform(0, 2 * np.pi, n_components)
        self.amp = rng.uniform(0.5, 1.0, n_components) / np.sqrt(n_components)

    def __call__(self, pts: np.ndarray) -> np.ndarray:
        chunk = 1 << 16  # rows per step: bounds the (N, n_components) temporary
        v = np.concatenate(
            [np.cos(pts[s:s + chunk] @ self.w.T + self.phase) @ self.amp
             for s in range(0, len(pts), chunk)] or [np.zeros(0)])
        return 0.5 + 0.35 * np.tanh(1.5 * v)


# ---------------------------------------------------------------------------
# Analytic scenes: intersect(origins (..., 3), d (3,)) →
# (hit (...,) bool, p_hit (..., 3), normal (..., 3))


class SphereScene:
    def __init__(self, radius: float = 0.75, center=(0.0, 0.0, 0.0)):
        self.radius = radius
        self.center = np.asarray(center, np.float64)

    def intersect(self, origins, d):
        o = origins - self.center
        b = o @ d
        c = np.sum(o * o, axis=-1) - self.radius * self.radius
        disc = b * b - c
        hit = disc > 0.0
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        p = origins + t[..., None] * d
        n = (p - self.center) / self.radius
        return hit, p, n


class BlobScene:
    """Union of K spheres — the analytic counterpart of
    data.synthetic.blob_cloud: self-occluding, concave, view-dependent
    silhouettes."""

    def __init__(self, n_spheres: int = 6, seed: int = 3, radius: float = 0.8):
        rng = np.random.default_rng(seed)
        self.centers = rng.uniform(-0.45, 0.45, (n_spheres, 3))
        self.centers[0] = 0.0  # keep one anchor sphere at the origin
        self.radii = rng.uniform(0.45, 0.75, n_spheres) * radius

    def intersect(self, origins, d):
        t_best = np.full(origins.shape[:-1], np.inf)
        idx_best = np.full(origins.shape[:-1], -1, np.int32)
        for i, (c0, r) in enumerate(zip(self.centers, self.radii)):
            o = origins - c0
            b = o @ d
            c = np.sum(o * o, axis=-1) - r * r
            disc = b * b - c
            hit_i = disc > 0.0
            t = -b - np.sqrt(np.maximum(disc, 0.0))
            closer = hit_i & (t < t_best)
            t_best = np.where(closer, t, t_best)
            idx_best = np.where(closer, i, idx_best)
        hit = idx_best >= 0
        t = np.where(hit, t_best, 0.0)
        p = origins + t[..., None] * d
        centers = np.where(hit[..., None],
                           self.centers[np.maximum(idx_best, 0)], 0.0)
        radii = np.where(hit, self.radii[np.maximum(idx_best, 0)], 1.0)
        n = (p - centers) / radii[..., None]
        return hit, p, n


class CubeScene:
    """Box via the slab method: flat faces, sharp silhouettes.

    The box is rotated corner-on (45° yaw + ~35.26° tilt) by default so every
    equatorial view sees 2-3 faces: a single face fills the frame otherwise
    and a one-plane view is DEGENERATE for orthographic SfM (any small
    rotation of a plane is absorbed by an affine change of the plane — the
    bas-relief ambiguity), which no solver can recover from.
    """

    def __init__(self, half_extent: float = 0.55, corner_on: bool = True):
        self.h = half_extent
        if corner_on:
            cy, sy = np.cos(np.pi / 4), np.sin(np.pi / 4)
            tilt = np.arctan(1.0 / np.sqrt(2.0))
            ct, st = np.cos(tilt), np.sin(tilt)
            yaw = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            pitch = np.array([[1, 0, 0], [0, ct, -st], [0, st, ct]])
            self.R = pitch @ yaw  # world → cube frame
        else:
            self.R = np.eye(3)

    def intersect(self, origins, d):
        h = self.h
        o = origins @ self.R.T  # into cube frame
        dc = self.R @ d
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = np.where(np.abs(dc) > 1e-12, 1.0 / dc, np.inf)
            t1 = np.where(np.abs(dc) > 1e-12, (-h - o) * inv, 0.0)
            t2 = np.where(np.abs(dc) > 1e-12, (h - o) * inv, 0.0)
        tmin_ax = np.minimum(t1, t2)
        tmax_ax = np.maximum(t1, t2)
        # Parallel rays: inside the slab → ±inf bounds, outside → miss
        inside = np.abs(o) <= h
        parallel = np.abs(dc) <= 1e-12
        tmin_ax = np.where(parallel, np.where(inside, -np.inf, np.inf), tmin_ax)
        tmax_ax = np.where(parallel, np.where(inside, np.inf, -np.inf), tmax_ax)
        t_near = np.max(tmin_ax, axis=-1)
        t_far = np.min(tmax_ax, axis=-1)
        hit = t_near <= t_far
        t = np.where(hit, t_near, 0.0)
        p = origins + t[..., None] * d
        # Normal: the axis achieving t_near, rotated back to world frame
        ax = np.argmax(tmin_ax, axis=-1)
        nc = np.zeros_like(p)
        rows = np.indices(ax.shape)
        nc[(*rows, ax)] = -np.sign(dc[ax])
        return hit, p, nc @ self.R


class CompositeScene:
    """Union of sub-scenes: nearest hit wins (t recovered as (p − o)·d)."""

    def __init__(self, *scenes):
        self.scenes = scenes

    def intersect(self, origins, d):
        t_best = np.full(origins.shape[:-1], np.inf)
        p_best = np.zeros_like(origins)
        n_best = np.zeros_like(origins)
        any_hit = np.zeros(origins.shape[:-1], bool)
        for sc in self.scenes:
            hit, p, n = sc.intersect(origins, d)
            t = np.sum((p - origins) * d, axis=-1)
            closer = hit & (t < t_best)
            t_best = np.where(closer, t, t_best)
            p_best = np.where(closer[..., None], p, p_best)
            n_best = np.where(closer[..., None], n, n_best)
            any_hit |= hit
        return any_hit, p_best, n_best


def ornament_cube_scene(half_extent: float = 0.55, bump_radius: float = 0.3):
    """Corner-on cube with a bump sphere poking out of each face: the flat
    faces keep the polyhedron's sharp silhouettes and locally-planar patches
    (homography-degenerate pairs), while the bumps give every view the 3-D
    relief orthographic SfM needs (a pure plane is bas-relief-ambiguous)."""
    cube = CubeScene(half_extent=half_extent)
    blob = BlobScene.__new__(BlobScene)
    face_centers = half_extent * np.concatenate([np.eye(3), -np.eye(3)], 0)
    blob.centers = face_centers @ cube.R  # cube frame → world (Rᵀ·c)
    blob.radii = np.full(6, bump_radius)
    return CompositeScene(cube, blob)


class RingsScene(BlobScene):
    """Two interlocking rings of small spheres — the hermetic counterpart of
    the reference's Rings dataset: strongly non-planar, self-occluding, with
    thin structures and holes."""

    def __init__(self, n_per_ring: int = 14, ring_radius: float = 0.62,
                 tube_radius: float = 0.21):
        ang = np.linspace(0, 2 * np.pi, n_per_ring, endpoint=False)
        ring_a = np.stack([ring_radius * np.cos(ang),
                           ring_radius * np.sin(ang),
                           np.zeros_like(ang)], -1)
        ring_b = np.stack([ring_radius * np.cos(ang) + ring_radius,
                           np.zeros_like(ang),
                           ring_radius * np.sin(ang)], -1)
        ring_b[:, 0] -= ring_radius * 0.5
        self.centers = np.concatenate([ring_a, ring_b], 0)
        self.radii = np.full(len(self.centers), tube_radius)


class PointCloudScene:
    """Surface rendered from a vertex cloud as a union of small spheres, with
    the per-pixel nearest-hit search run as chunked JAX programs (the o·c
    term of the |o − c|² expansion is an (N, 3)·(3, P) matmul, so the whole
    intersect is matmuls and elementwise work on the device; ~P·N ops would
    crawl as a Python loop).

    This is the hermetic counterpart of the reference's Suzanne image sets:
    the reference ships only `resources/Suzanne.ply` vertices (its image
    datasets are external Blender renders, README.md:24-27), so the surface
    here is the vertex cloud itself inflated by ~1.5× its nearest-neighbour
    spacing — closed enough for stable silhouettes, bumpy enough for texture.
    """

    def __init__(self, points: np.ndarray, radius: float | None = None,
                 chunk: int = 16384):
        self.points = np.asarray(points, np.float32)
        if radius is None:
            radius = 1.5 * _median_nn_spacing(self.points)
        self.radius = float(radius)
        self.chunk = chunk
        self._intersect_jit = None

    def _build(self):
        import jax
        import jax.numpy as jnp

        c = jnp.asarray(self.points)  # (P, 3)
        r2 = self.radius * self.radius
        c_sq = jnp.sum(c * c, axis=-1)  # (P,)

        @jax.jit
        def one_chunk(o, d):
            od = o @ d  # (N,)
            cd = c @ d  # (P,)
            b = od[:, None] - cd[None, :]  # (N, P)
            oc = o @ c.T  # (N, P)
            dist2 = jnp.sum(o * o, -1)[:, None] + c_sq[None, :] - 2.0 * oc
            disc = b * b - dist2 + r2
            hit = disc > 0.0
            t = -b - jnp.sqrt(jnp.maximum(disc, 0.0))
            t = jnp.where(hit, t, jnp.inf)
            idx = jnp.argmin(t, axis=-1)  # (N,)
            t_best = jnp.take_along_axis(t, idx[:, None], -1)[:, 0]
            ok = jnp.isfinite(t_best)
            p = o + jnp.where(ok, t_best, 0.0)[:, None] * d
            n = (p - c[idx]) / self.radius
            return ok, p, n

        self._intersect_jit = one_chunk

    def intersect(self, origins, d):
        import jax.numpy as jnp

        if self._intersect_jit is None:
            self._build()
        shape = origins.shape[:-1]
        o_flat = np.asarray(origins, np.float32).reshape(-1, 3)
        d32 = jnp.asarray(np.asarray(d, np.float32))
        N = o_flat.shape[0]
        hits, ps, ns = [], [], []
        for s in range(0, N, self.chunk):
            o = jnp.asarray(o_flat[s:s + self.chunk])
            ok, p, n = self._intersect_jit(o, d32)
            hits.append(np.asarray(ok))
            ps.append(np.asarray(p))
            ns.append(np.asarray(n))
        hit = np.concatenate(hits).reshape(shape)
        p = np.concatenate(ps).reshape(*shape, 3).astype(np.float64)
        n = np.concatenate(ns).reshape(*shape, 3).astype(np.float64)
        return hit, p, n


def _median_nn_spacing(pts: np.ndarray, sample: int = 2000,
                       seed: int = 0) -> float:
    """Median nearest-neighbour distance over a sample of the cloud.
    Exported PLYs often duplicate vertices per flat-shaded face (Blender's
    Suzanne does), which would put the NN spacing at exactly 0 — dedupe
    first and floor the result by the cloud extent."""
    pts = np.unique(np.asarray(pts, np.float32), axis=0)
    rng = np.random.default_rng(seed)
    idx = (rng.choice(len(pts), sample, replace=False)
           if len(pts) > sample else np.arange(len(pts)))
    sub = pts[idx]
    d2 = np.sum((sub[:, None] - pts[None]) ** 2, -1)
    d2[np.arange(len(sub)), idx] = np.inf
    spacing = float(np.median(np.sqrt(d2.min(axis=1))))
    extent = float(np.linalg.norm(pts.max(0) - pts.min(0)))
    return max(spacing, 1e-3 * extent)


def suzanne_scene(seed: int = 0):
    """Suzanne vertex cloud from the reference resources
    (src/testbench/dataset_generation.cpp:95-137 loads the same PLY for the
    synthetic track tests), rendered as a PointCloudScene; falls back to the
    blob scene when the resource directory isn't mounted."""
    from orthosfm_tpu.data import synthetic

    pts = synthetic.reference_cloud("Suzanne")
    if pts is None:
        return BlobScene(seed=seed + 31)
    return PointCloudScene(pts)


SCENES = {
    "sphere": lambda seed: SphereScene(),
    "blob": lambda seed: BlobScene(seed=seed + 31),
    "cube": lambda seed: CubeScene(),
    "ornament_cube": lambda seed: ornament_cube_scene(),
    "rings": lambda seed: RingsScene(),
    "suzanne": suzanne_scene,
}


def render_views(gt_cams: cam_mod.CameraSet, width: int, height: int,
                 scene, texture: FourierTexture3D | None = None,
                 return_masks: bool = False):
    """Ray-trace each camera's orthographic view of the scene.

    With return_masks, also returns per-view uint8 foreground masks (255
    where a scene surface is hit) in the reference's mask convention —
    brightness > 16 = foreground (src/data_structures/view.cpp:100-112).
    Views render in a thread pool: the work is large NumPy operations,
    which release the interpreter lock."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    texture = texture or FourierTexture3D()
    R_all = np.asarray(cam_mod.basis(gt_cams), np.float64)  # (V, 3, 3)
    o_all = np.einsum("vij,j->vi", R_all, [0.0, 0.0, -cam_mod.CAMERA_DISTANCE])
    scales = np.asarray(gt_cams.scale, np.float64)
    offsets = np.asarray(gt_cams.offset, np.float64)

    xs = np.arange(width, dtype=np.float64)
    ys = np.arange(height, dtype=np.float64)
    px, py = np.meshgrid(xs, ys)  # (H, W)

    def one(v):
        R = R_all[v]
        # Pixel → point on camera plane (reference: OrthographicCamera.cpp:187-193)
        xn = -2.0 * (px / width - 0.5) + offsets[v, 0]
        yn = -2.0 * (py / height - 0.5) + offsets[v, 1]
        origin = (o_all[v][None, None]
                  + scales[v] * (xn[..., None] * R[:, 0] + yn[..., None] * R[:, 1]))
        d = R[:, 2]  # look direction (unit)
        hit, p_hit, normal = scene.intersect(origin, d)
        shade = np.full((height, width), 0.55)
        # Slight lambert-style modulation for silhouette stability
        lam = 0.75 + 0.25 * np.clip(-(normal @ d), 0.0, 1.0)
        tex = texture(p_hit[hit])
        shade[hit] = tex * lam[hit]
        g = (np.clip(shade, 0, 1) * 255).astype(np.uint8)
        return np.stack([g, g, g], axis=-1), np.where(hit, 255, 0).astype(np.uint8)

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        rendered = list(pool.map(one, range(len(gt_cams))))
    images = [img for img, _ in rendered]
    masks = [mk for _, mk in rendered]
    if return_masks:
        return images, masks
    return images


def render_sphere_views(gt_cams: cam_mod.CameraSet, width: int, height: int,
                        radius: float = 0.75, texture: FourierTexture3D | None = None,
                        ) -> List[np.ndarray]:
    """Back-compat wrapper: single textured sphere."""
    return render_views(gt_cams, width, height, SphereScene(radius=radius),
                        texture=texture)


def trajectory_angles(trajectory: str, num_views: int, ring_degrees: float,
                      theta_range: float, roll_range: float,
                      rng: np.random.Generator) -> np.ndarray:
    """(V, 3) [phi, theta, roll] GT camera angles for a named trajectory
    family (the reference's eval sets come in Circle / 3Lat / 3Lat_rotated
    variants, full_pipeline_tests.cpp:404-412):

    circle        — one ring at the equator with small random theta/roll
                    jitter (view 0 pinned to identity);
    3lat          — three latitude bands (theta = +lat, 0, −lat), each a
                    phi ring, roll = 0 everywhere. Needs a solver with a
                    vertical dof (the reference accordingly drops
                    EULER_HORIZONTAL on its 3Lat sets, :428-439);
    3lat_rotated  — 3lat with per-view random roll ∈ ±roll_range — needs the
                    full-dof Euler or quaternion solver (the reference keeps
                    only those for *_rotated, :428-439).
    """
    if trajectory == "circle":
        phis = np.deg2rad(np.linspace(0.0, ring_degrees, num_views,
                                      endpoint=False))
        thetas = np.deg2rad(rng.uniform(-theta_range, theta_range, num_views))
        rolls = np.deg2rad(rng.uniform(-roll_range, roll_range, num_views))
        thetas[0] = rolls[0] = 0.0
        return np.stack([phis, thetas, rolls], -1).astype(np.float32)
    if trajectory in ("3lat", "3lat_rotated"):
        lat = np.deg2rad(max(theta_range, 20.0))
        # Equator band FIRST: the evaluation convention (reference
        # full_pipeline_tests.cpp:253-297, no global alignment — only flip
        # normalization) assumes view 0 ≈ identity, which is also what the
        # pipeline's normalize-to-camera-0 produces. View 0 therefore sits
        # at (phi 0, theta 0, roll 0).
        band_theta = [0.0, lat, -lat]
        counts = [num_views - 2 * (num_views // 3), num_views // 3,
                  num_views // 3]
        phis, thetas, rolls = [], [], []
        for b, (th, n) in enumerate(zip(band_theta, counts)):
            # Stagger bands by a fraction of a step so columns don't repeat
            ph = np.linspace(0.0, ring_degrees, n, endpoint=False)
            ph += b * ring_degrees / max(n, 1) / 3.0
            phis += list(np.deg2rad(ph))
            thetas += [th] * n
            if trajectory == "3lat_rotated":
                rolls += list(np.deg2rad(
                    rng.uniform(-max(roll_range, 15.0),
                                max(roll_range, 15.0), n)))
            else:
                rolls += [0.0] * n
        rolls[0] = 0.0
        return np.stack([phis, thetas, rolls], -1).astype(np.float32)
    raise ValueError(f"unknown trajectory {trajectory!r}")


def make_image_dataset(folder: str, num_views: int = 8, width: int = 256,
                       height: int = 256, seed: int = 0,
                       theta_range: float = 10.0, roll_range: float = 6.0,
                       ring_degrees: float = 360.0, radius: float = 0.75,
                       scene: str = "sphere", trajectory: str = "circle",
                       mask_folder: str = ""):
    """Write a synthetic rendered image dataset; returns GT cameras.

    scene: "sphere" (default), "blob", "cube", "ornament_cube", "rings" or
    "suzanne" — see module docstring. trajectory: "circle" | "3lat" |
    "3lat_rotated" (trajectory_angles). mask_folder: also write per-view
    foreground masks `{name}_mask.png` there (reference mask discovery:
    src/data_structures/view.cpp:84-98)."""
    import os

    from orthosfm_tpu.io import png

    rng = np.random.default_rng(seed)
    angles = trajectory_angles(trajectory, num_views, ring_degrees,
                               theta_range, roll_range, rng)
    gt = cam_mod.make_euler(np.arange(num_views), width, height, angles=angles)

    texture = FourierTexture3D(seed=seed + 17)
    if scene == "sphere":
        sc = SphereScene(radius=radius)
    else:
        sc = SCENES[scene](seed)
    images, masks = render_views(gt, width, height, sc, texture=texture,
                                 return_masks=True)
    os.makedirs(folder, exist_ok=True)
    for i, img in enumerate(images):
        png.write_png(os.path.join(folder, f"view_{i:02d}.png"), img)
    if mask_folder:
        os.makedirs(mask_folder, exist_ok=True)
        for i, mk in enumerate(masks):
            png.write_png(os.path.join(mask_folder, f"view_{i:02d}_mask.png"),
                          mk)
    return gt
