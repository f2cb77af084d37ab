"""Bundle adjustment against an independent reference: the same problem
solved by scipy.optimize.least_squares, for each of the four solver types.

The reference parameterises rotations its own way (a rotation vector applied
to the initial rotation for quaternion cameras, the free Euler angles for the
Euler solvers) and projects with NumPy, so it shares only the feasible set
with solvers.ba: the free camera slots of cameras.free_mask, camera 0 fixed,
free 3-D points. Pixel noise of 0.2 px keeps every residual of the optimum
inside Huber's quadratic zone (|r| < 1 px), where the solver's per-observation
Huber loss and scipy's per-component one coincide; both then minimise the
same least-squares cost.
"""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy.optimize import least_squares
from scipy.spatial.transform import Rotation

from orthosfm_tpu.config import BundleAdjustConfig, SolverType
from orthosfm_tpu.core import cameras as cam_mod
from orthosfm_tpu.core import quaternions as quat
from orthosfm_tpu.solvers import ba

W = 2048.0
C = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])


def _euler_basis(phi, theta, roll):
    """Cᵀ·Rz(φ)·Rx(θ+π/2)·Rz(ρ) (reference: OrthographicCamera.cpp:78-95)."""
    def rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])

    om = theta + np.pi / 2
    rx = np.array([[1.0, 0.0, 0.0], [0.0, np.cos(om), -np.sin(om)],
                   [0.0, np.sin(om), np.cos(om)]])
    return C.T @ rz(phi) @ rx @ rz(roll)


def _project(R, offset, scale, pts):
    """(T, 2) pixels of world points through one camera with basis R."""
    local = pts @ R  # row t = Rᵀ p_t
    xy = (local[:, :2] / scale - offset) / (-2.0) + 0.5
    return W * xy


def _problem(solver: SolverType, V=5, T=80, seed=0):
    rng = np.random.default_rng(seed)
    dof = solver.degrees_of_freedom
    phi = np.deg2rad(np.arange(V) * 20.0)
    theta = np.deg2rad(rng.uniform(-10, 10, V)) * (dof >= 2 or solver.is_quaternion)
    roll = np.deg2rad(rng.uniform(-8, 8, V)) * (dof >= 3 or solver.is_quaternion)
    theta[0] = roll[0] = 0.0
    gt_R = [_euler_basis(*a) for a in zip(phi, theta, roll)]
    pts = rng.uniform(-0.6, 0.6, (T, 3))
    obs = np.stack([_project(R, np.zeros(2), 1.0, pts) for R in gt_R], 1)
    obs = obs + rng.normal(0.0, 0.2, obs.shape)  # (T, V, 2)

    # Initial state: free angles perturbed by up to 0.5°, camera 0 exact
    d = np.deg2rad(rng.uniform(-0.5, 0.5, (V, 3)))
    d[0] = 0.0
    free_ang = np.array([True, dof >= 2, dof >= 3]) | solver.is_quaternion
    angles0 = np.stack([phi, theta, roll], -1) + d * free_ang
    pts0 = pts + rng.normal(0.0, 0.005, pts.shape)
    return angles0, pts0, obs


def _cams(solver, angles):
    V = len(angles)
    e = cam_mod.make_euler(np.arange(V), W, W, angles=angles.astype(np.float32),
                           solver=solver)
    if solver.is_quaternion:
        e = cam_mod.make_quaternion(np.arange(V), W, W,
                                    q=quat.from_matrix(cam_mod.basis(e)))
    return e.replace(fixed=jnp.zeros(V, bool).at[0].set(True))


def _scipy_reference(solver, cams, angles0, pts0, obs):
    """Returns (cost, (V, 3, 3) bases) at scipy's optimum."""
    V, T = obs.shape[1], obs.shape[0]
    free = np.asarray(cam_mod.free_mask(cams))  # (V, 6)
    R0 = [_euler_basis(*a) for a in angles0]
    n_cam = int(free.sum())

    def unpack(x):
        cam = np.zeros((V, 6))
        cam[free] = x[:n_cam]
        return cam, x[n_cam:].reshape(T, 3)

    def camera(v, c):
        if solver.is_quaternion:
            R = Rotation.from_rotvec(c[:3]).as_matrix() @ R0[v]
        else:
            R = _euler_basis(*(angles0[v] + c[:3]))
        return R, c[3:5], 1.0 + c[5]

    def residuals(x):
        cam, pts = unpack(x)
        return np.concatenate([
            (_project(*camera(v, cam[v]), pts) - obs[:, v]).ravel()
            for v in range(V)])

    x0 = np.concatenate([np.zeros(n_cam), pts0.ravel()])
    sol = least_squares(residuals, x0, loss="huber", f_scale=1.0,
                        x_scale="jac", ftol=1e-14, xtol=1e-14, gtol=1e-14,
                        max_nfev=2000)
    r = residuals(sol.x).reshape(V, T, 2)
    s = np.sum(r * r, -1)
    rho = np.where(s <= 1.0, s, 2.0 * np.sqrt(s) - 1.0)
    cam, _ = unpack(sol.x)
    return 0.5 * rho.sum(), np.stack([camera(v, cam[v])[0] for v in range(V)])


@pytest.mark.parametrize("solver", list(SolverType))
def test_ba_matches_scipy_least_squares(solver):
    angles0, pts0, obs = _problem(solver)
    cams = _cams(solver, angles0)
    cost_ref, R_ref = _scipy_reference(solver, cams, angles0, pts0, obs)

    T, V = obs.shape[:2]
    points4 = jnp.asarray(np.concatenate([pts0, np.ones((T, 1))], 1), jnp.float32)
    cfg = BundleAdjustConfig(max_iterations=60, function_tolerance=1e-9)
    res = ba.run(cams, points4, jnp.asarray(obs, jnp.float32),
                 jnp.ones((T, V), bool), optimize_points=True, config=cfg)

    # float32 solver vs float64 reference: the optimum's cost agrees to
    # well within 1e-3 relative (f32 sums of ~800 squared residuals).
    np.testing.assert_allclose(float(res.cost), cost_ref, rtol=1e-3)
    assert float(res.cost) < float(res.initial_cost)
    R = np.asarray(cam_mod.basis(res.cams), np.float64)
    chord = np.linalg.norm(R - R_ref, axis=(1, 2)) / (2 * np.sqrt(2))
    gap_deg = np.rad2deg(2 * np.arcsin(np.minimum(chord, 1.0)))
    assert gap_deg.max() < 1e-3, gap_deg


@pytest.mark.parametrize("solver", [SolverType.ORTHO_QUATERNION,
                                    SolverType.ORTHO_EULER_ALL_DOF])
def test_fixed_cameras_stay_fixed(solver):
    """A fully fixed camera comes back bit-identical, whatever its slot."""
    angles0, pts0, obs = _problem(solver, seed=1)
    cams = _cams(solver, angles0)
    cams = cams.replace(fixed=cams.fixed.at[3].set(True))
    T, V = obs.shape[:2]
    points4 = jnp.asarray(np.concatenate([pts0, np.ones((T, 1))], 1), jnp.float32)
    res = ba.run(cams, points4, jnp.asarray(obs, jnp.float32),
                 jnp.ones((T, V), bool),
                 config=BundleAdjustConfig(max_iterations=5,
                                           function_tolerance=0.0))
    assert int(res.iterations) >= 1
    assert float(res.cost) < float(res.initial_cost)
    for v in (0, 3):
        np.testing.assert_array_equal(np.asarray(res.cams.rot[v]),
                                      np.asarray(cams.rot[v]))
        np.testing.assert_array_equal(np.asarray(res.cams.offset[v]),
                                      np.asarray(cams.offset[v]))
        np.testing.assert_array_equal(np.asarray(res.cams.scale[v]),
                                      np.asarray(cams.scale[v]))
