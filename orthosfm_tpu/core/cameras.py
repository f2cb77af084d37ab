"""Orthographic camera models as struct-of-arrays pytrees.

Replaces the reference's `Camera` class hierarchy (src/data_structures/Camera.h,
src/algorithms/orthographic/OrthographicCamera.{h,cpp},
src/algorithms/orthographic_quaternion/OrthoQuaternionCamera.{h,cpp}) with a
single dataclass `CameraSet` covering all four solver parameterizations behind
pure functions — idiomatic for vmap/jit instead of virtual dispatch.

Conventions (matching the reference exactly):
- Euler spherical rotation  S(phi, theta, roll) = Rz(phi) · Rx(theta + π/2) · Rz'(roll)
  where Rz' is the z-rotation the reference calls "Ry"
  (reference: OrthographicCamera.cpp:78-95).
- Coordinate transform C = [[1,0,0],[0,0,-1],[0,1,0]] maps the world up-axis (y)
  to the spherical system's z (reference: OrthographicCamera.cpp:128-134).
- World→local: p_local = Sᵀ · C · p  (Euler, OrthographicCamera.cpp:141-144),
  or p_local = q⁻¹ · p (quaternion, OrthographicQuaternionReprojectorError.h:49).
  The local→world rotation for an Euler camera is therefore R = Cᵀ·S, and a
  quaternion camera built from the same pose stores q with R(q) = Cᵀ·S.
- Pixel projection with both axes mirrored
  (reference: OrthographicCamera.cpp:63-76):
      x_pix = W · ((p_local.x/scale − offX)/(−2) + 0.5)
      y_pix = H · ((p_local.y/scale − offY)/(−2) + 0.5)
- Camera origin sits at distance 10 behind the target on the view sphere:
  origin = R · (0,0,−10) (reference: OrthographicCamera.h:119, cpp:58-61).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from orthosfm_tpu.config import SolverType
from orthosfm_tpu.core import quaternions as quat
from orthosfm_tpu.utils.pytree import pytree_dataclass, static_field

CAMERA_DISTANCE = 10.0
# Tangent layout for BA (both parameterizations): [r0, r1, r2, offX, offY, scale]
CAMERA_TANGENT_DIM = 6

# The coordinate-system transform C (reference: OrthographicCamera.cpp:128-134)
COORD_TRANSFORM = jnp.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])


@pytree_dataclass
class CameraSet:
    """A batch of cameras for one solver type.

    ``rot`` is interpreted per ``kind``:
      - kind == 'euler': rot[..., :3] = (phi, theta, roll) radians (col 3 unused)
      - kind == 'quat' : rot[..., :4] = unit quaternion (w, x, y, z)
    Keeping a single (V, 4) array lets both kinds share one pytree structure.
    """

    rot: jnp.ndarray  # (V, 4)
    offset: jnp.ndarray  # (V, 2)
    scale: jnp.ndarray  # (V,)
    width: jnp.ndarray  # (V,) float
    height: jnp.ndarray  # (V,) float
    view_ids: jnp.ndarray  # (V,) int32
    fixed: jnp.ndarray  # (V,) bool — fully-fixed cameras (gauge anchoring)
    kind: str = static_field("quat")
    solver: int = static_field(int(SolverType.ORTHO_QUATERNION))

    def __len__(self):
        return self.rot.shape[0]


# ---------------------------------------------------------------------------
# Construction


def make_euler(view_ids, width, height, angles=None, offset=None, scale=None,
               solver: SolverType = SolverType.ORTHO_EULER_ALL_DOF) -> CameraSet:
    v = jnp.asarray(view_ids, jnp.int32)
    n = v.shape[0]
    ang = jnp.zeros((n, 3)) if angles is None else jnp.asarray(angles, jnp.float32)
    rot = jnp.concatenate([ang, jnp.zeros((n, 1), ang.dtype)], axis=-1)
    return CameraSet(
        rot=rot,
        offset=jnp.zeros((n, 2)) if offset is None else jnp.asarray(offset, jnp.float32),
        scale=jnp.ones((n,)) if scale is None else jnp.asarray(scale, jnp.float32),
        width=jnp.broadcast_to(jnp.asarray(width, jnp.float32), (n,)),
        height=jnp.broadcast_to(jnp.asarray(height, jnp.float32), (n,)),
        view_ids=v,
        fixed=jnp.zeros((n,), bool),
        kind="euler",
        solver=int(solver),
    )


def make_quaternion(view_ids, width, height, q=None, offset=None, scale=None) -> CameraSet:
    v = jnp.asarray(view_ids, jnp.int32)
    n = v.shape[0]
    if q is None:
        q = jnp.tile(jnp.array([[1.0, 0.0, 0.0, 0.0]]), (n, 1))
    return CameraSet(
        rot=jnp.asarray(q, jnp.float32),
        offset=jnp.zeros((n, 2)) if offset is None else jnp.asarray(offset, jnp.float32),
        scale=jnp.ones((n,)) if scale is None else jnp.asarray(scale, jnp.float32),
        width=jnp.broadcast_to(jnp.asarray(width, jnp.float32), (n,)),
        height=jnp.broadcast_to(jnp.asarray(height, jnp.float32), (n,)),
        view_ids=v,
        fixed=jnp.zeros((n,), bool),
        kind="quat",
        solver=int(SolverType.ORTHO_QUATERNION),
    )


def euler_free_angles(solver: SolverType):
    """(3,) bool: which of (phi, theta, roll) are free for an Euler solver.

    Mirrors setDegreesOfFreedom (reference: OrthographicCamera.cpp:195-207):
    convertFromAxis only writes free angles, so restricted-DoF solvers keep
    their fixed angles at 0 through every basis-derived update."""
    dof = solver.degrees_of_freedom
    return jnp.array([dof >= 1, dof >= 2, dof >= 3])


def from_basis(basis, view_ids, width, height, solver: SolverType) -> CameraSet:
    """Build cameras from local→world basis matrices (columns = x/y/z world axes),
    as the TK init produces (reference: tomasi_kanade.cpp:169-191 feeding
    OrthographicCamera::convertFromAxis / OrthoQuaternionCamera ctor)."""
    basis = jnp.asarray(basis, jnp.float32)
    if solver.is_quaternion:
        q = quat.from_matrix(basis)
        return make_quaternion(view_ids, width, height, q=q)
    angles = basis_to_phi_theta_roll(basis)
    angles = jnp.where(euler_free_angles(solver)[None, :], angles, 0.0)
    return make_euler(view_ids, width, height, angles=angles, solver=solver)


# ---------------------------------------------------------------------------
# Rotation representations


def spherical_matrix(angles):
    """S = Rz(phi) · Rx(theta+π/2) · Rz(roll) (reference: OrthographicCamera.cpp:78-95).

    angles: (..., 3) = (phi, theta, roll).
    """
    phi, theta, roll = angles[..., 0], angles[..., 1], angles[..., 2]
    omega = theta + 0.5 * jnp.pi
    cph, sph = jnp.cos(phi), jnp.sin(phi)
    com, som = jnp.cos(omega), jnp.sin(omega)
    crl, srl = jnp.cos(roll), jnp.sin(roll)
    z = jnp.zeros_like(phi)
    o = jnp.ones_like(phi)

    def mat(rows):
        return jnp.stack([jnp.stack(r, -1) for r in rows], -2)

    Rz = mat([[cph, -sph, z], [sph, cph, z], [z, z, o]])
    Rx = mat([[o, z, z], [z, com, -som], [z, som, com]])
    Rr = mat([[crl, -srl, z], [srl, crl, z], [z, z, o]])
    return Rz @ Rx @ Rr


def spherical_matrix_derivs(angles):
    """∂S/∂(phi, theta, roll) for S = Rz(φ)·Rx(θ+π/2)·Rz(ρ).

    angles: (..., 3) → (..., 3 param, 3, 3). Used by the analytic BA
    Jacobians (solvers/ba.py) in place of per-observation autodiff.
    """
    phi, theta, roll = angles[..., 0], angles[..., 1], angles[..., 2]
    omega = theta + 0.5 * jnp.pi
    cph, sph = jnp.cos(phi), jnp.sin(phi)
    com, som = jnp.cos(omega), jnp.sin(omega)
    crl, srl = jnp.cos(roll), jnp.sin(roll)
    z = jnp.zeros_like(phi)
    o = jnp.ones_like(phi)

    def mat(rows):
        return jnp.stack([jnp.stack(r, -1) for r in rows], -2)

    Rz = mat([[cph, -sph, z], [sph, cph, z], [z, z, o]])
    Rx = mat([[o, z, z], [z, com, -som], [z, som, com]])
    Rr = mat([[crl, -srl, z], [srl, crl, z], [z, z, o]])
    dRz = mat([[-sph, -cph, z], [cph, -sph, z], [z, z, z]])
    dRx = mat([[z, z, z], [z, -som, -com], [z, com, -som]])
    dRr = mat([[-srl, -crl, z], [crl, -srl, z], [z, z, z]])
    dS_phi = dRz @ Rx @ Rr
    dS_theta = Rz @ dRx @ Rr
    dS_roll = Rz @ Rx @ dRr
    return jnp.stack([dS_phi, dS_theta, dS_roll], axis=-3)


def basis_to_phi_theta_roll(basis, apply_coordinate_transform: bool = True):
    """World-axes basis (columns x,y,z) -> (phi, theta, roll)
    (reference: OrthographicCamera.cpp:151-181)."""
    b = jnp.asarray(basis)
    if apply_coordinate_transform:
        b = COORD_TRANSFORM.astype(b.dtype) @ b
    phi = jnp.arctan2(-b[..., 1, 2], -b[..., 0, 2]) - 0.5 * jnp.pi
    col2_norm = jnp.linalg.norm(b[..., :, 2], axis=-1)
    theta = jnp.arccos(jnp.clip(b[..., 2, 2] / col2_norm, -1.0, 1.0)) - 0.5 * jnp.pi
    omega = theta + 0.5 * jnp.pi
    cph, sph = jnp.cos(phi), jnp.sin(phi)
    com, som = jnp.cos(omega), jnp.sin(omega)
    z = jnp.zeros_like(phi)
    o = jnp.ones_like(phi)
    Rz = jnp.stack(
        [jnp.stack([cph, -sph, z], -1), jnp.stack([sph, cph, z], -1), jnp.stack([z, z, o], -1)], -2
    )
    Rx = jnp.stack(
        [jnp.stack([o, z, z], -1), jnp.stack([z, com, -som], -1), jnp.stack([z, som, com], -1)], -2
    )
    test_axis = jnp.swapaxes(Rz @ Rx, -1, -2) @ b[..., :, 0:1]
    roll = jnp.arctan2(test_axis[..., 1, 0], test_axis[..., 0, 0])
    return jnp.stack([phi, theta, roll], axis=-1)


def rotation_l2w(cams: CameraSet):
    """Local→world rotation matrices, (V, 3, 3).

    Euler: R = Cᵀ·S (axes = toCameraSpace(e_i), reference OrthographicCamera.cpp:136-139).
    Quaternion: R = R(q).
    """
    if cams.kind == "quat":
        return quat.to_matrix(quat.normalize(cams.rot))
    S = spherical_matrix(cams.rot[..., :3])
    C = COORD_TRANSFORM.astype(S.dtype)
    return jnp.swapaxes(C, 0, 1) @ S


def basis(cams: CameraSet):
    """World-space axes as matrix columns [x y z] — same as rotation_l2w."""
    return rotation_l2w(cams)


def origins(cams: CameraSet):
    """Camera centers R·(0,0,−d) (reference: OrthographicCamera.cpp:58-61,
    OrthoQuaternionCamera.cpp:69-71)."""
    R = rotation_l2w(cams)
    return R @ jnp.array([0.0, 0.0, -CAMERA_DISTANCE], R.dtype)


def look_directions(cams: CameraSet):
    """World-space viewing direction = z axis (reference: OrthographicCamera.cpp:183-185)."""
    return rotation_l2w(cams)[..., :, 2]


# ---------------------------------------------------------------------------
# Projection / unprojection


def dehomogenize(points4):
    w = points4[..., 3:4]
    safe_w = jnp.where(jnp.abs(w) < 1e-12, jnp.where(w < 0, -1e-12, 1e-12), w)
    return points4[..., :3] / safe_w


def project_from_params(R_l2w, offset, scale, width, height, points4):
    """Project homogeneous points with explicit rotation/intrinsics.

    R_l2w (..., 3, 3); offset (..., 2); scale, width, height (...,);
    points4 (..., 4) → pixels (..., 2).
    (reference: OrthographicCamera.cpp:63-76 and the two residual functors.)
    """
    p = dehomogenize(points4)
    local = jnp.einsum("...ij,...i->...j", R_l2w, p)  # Rᵀ·p via contraction over rows
    proj = local[..., :2] / scale[..., None]
    xy = (proj - offset) / (-2.0) + 0.5
    wh = jnp.stack([width, height], axis=-1)
    return wh * xy


def project(cams: CameraSet, points4):
    """Project points (T, 4) through every camera → pixels (V, T, 2)."""
    R = rotation_l2w(cams)  # (V, 3, 3)
    p = dehomogenize(points4)  # (T, 3)
    local = jnp.einsum("vij,ti->vtj", R, p)
    proj = local[..., :2] / cams.scale[:, None, None]
    xy = (proj - cams.offset[:, None, :]) / (-2.0) + 0.5
    wh = jnp.stack([cams.width, cams.height], axis=-1)
    return wh[:, None, :] * xy


def pixel_to_plane_point(cams: CameraSet, pixels):
    """Ray origins on the camera plane for pixel coords (V, T, 2) → (V, T, 3)
    (reference: OrthographicCamera.cpp:187-193, OrthoQuaternionCamera.cpp:49-59)."""
    wh = jnp.stack([cams.width, cams.height], axis=-1)[:, None, :]
    norm = -2.0 * (pixels / wh - 0.5) + cams.offset[:, None, :]
    R = rotation_l2w(cams)
    x_axis = R[..., :, 0][:, None, :]
    y_axis = R[..., :, 1][:, None, :]
    o = origins(cams)[:, None, :]
    s = cams.scale[:, None, None]
    return o + s * (norm[..., 0:1] * x_axis + norm[..., 1:2] * y_axis)


# ---------------------------------------------------------------------------
# BA manifold: free-parameter masks and retraction


def free_mask(cams: CameraSet):
    """Per-camera (V, 6) mask of free tangent coordinates.

    Mirrors Ceres SetParameterBlockConstant wiring:
      - quaternion solver: rotation + offset free, scale fixed
        (OrthoQuaternionCamera.h:89-91, OrthoQuaternionRecoAlgorithm.cpp:141-145)
      - Euler solvers by dof: 1→phi; 2→phi,theta; 4→phi,theta,roll,offset
        (OrthographicCamera.cpp:195-207); offset/scale default-fixed
        (OrthographicCamera.h:133-134).
      - a fully `fixed` camera freezes everything (gauge anchor,
        reconstruct.cpp:215).
    """
    n = len(cams)
    solver = SolverType(cams.solver)
    if cams.kind == "quat":
        base = jnp.array([True, True, True, True, True, False])
    else:
        dof = solver.degrees_of_freedom
        base = jnp.array(
            [dof >= 1, dof >= 2, dof >= 3, dof >= 4, dof >= 4, dof >= 5]
        )
    mask = jnp.broadcast_to(base, (n, CAMERA_TANGENT_DIM))
    return mask & ~cams.fixed[:, None]


def retract(cams: CameraSet, delta):
    """Apply a tangent step delta (V, 6) → new CameraSet.

    Quaternion rotation update follows Ceres EigenQuaternionParameterization:
    q ← exp(δ) ⊗ q. Euler angles update additively (IdentityParameterization).
    """
    if cams.kind == "quat":
        dq = quat.exp_map(delta[..., :3])
        new_rot = quat.normalize(quat.multiply(dq, cams.rot))
    else:
        new_rot = cams.rot.at[..., :3].add(delta[..., :3])
    return cams.replace(
        rot=new_rot,
        offset=cams.offset + delta[..., 3:5],
        scale=cams.scale + delta[..., 5],
    )


# ---------------------------------------------------------------------------
# Scene normalization / alignment (reference semantics)


def apply_rotation(cams: CameraSet, R_or_q):
    """Left-multiply a global rotation onto every camera.

    Euler path re-extracts angles from the transformed axes while respecting
    dof-fixed flags? The reference's convertFromAxis respects fixPhi/fixTheta/
    fixRoll, but during normalization all cameras go through it identically —
    we re-extract all three angles (the fixed ones were not changed by BA and
    normalization is a global gauge transform, matching reference behavior for
    every code path that calls applyTransformation).
    """
    if cams.kind == "quat":
        q = R_or_q if R_or_q.shape[-1] == 4 else quat.from_matrix(R_or_q)
        new_rot = quat.normalize(quat.multiply(q, quat.normalize(cams.rot)))
        return cams.replace(rot=new_rot)
    R = R_or_q if R_or_q.shape[-1] == 3 else quat.to_matrix(R_or_q)
    new_basis = R @ rotation_l2w(cams)
    angles = basis_to_phi_theta_roll(new_basis)
    # convertFromAxis only writes the solver's free angles
    free = euler_free_angles(SolverType(cams.solver))
    angles = jnp.where(free[None, :], angles, cams.rot[..., :3])
    return cams.replace(rot=jnp.concatenate([angles, cams.rot[..., 3:4]], axis=-1))


def normalize_scene_to_camera(cams: CameraSet, target_index):
    """Rotate all cameras so the target camera's basis becomes the identity.

    Quaternion path: apply fromTo(q_target, I) to all (reference:
    OrthoQuaternionRecoAlgorithm.cpp:56-70). Euler path: Umeyama of the target
    axes onto the world axes, applied to all (reference:
    OrthographicReconstructionAlgorithm.cpp:69-99). Both reduce to applying
    R_targetᵀ on the left.
    """
    R = rotation_l2w(cams)
    Rt = R[target_index]
    if cams.kind == "quat":
        q_t = quat.from_matrix(Rt)
        return apply_rotation(cams, quat.conjugate(q_t))
    return apply_rotation(cams, jnp.swapaxes(Rt, -1, -2))


def normalize_scene(cams: CameraSet):
    return normalize_scene_to_camera(cams, 0)


def concatenate(a: CameraSet, b: CameraSet) -> CameraSet:
    assert a.kind == b.kind and a.solver == b.solver
    return CameraSet(
        rot=jnp.concatenate([a.rot, b.rot]),
        offset=jnp.concatenate([a.offset, b.offset]),
        scale=jnp.concatenate([a.scale, b.scale]),
        width=jnp.concatenate([a.width, b.width]),
        height=jnp.concatenate([a.height, b.height]),
        view_ids=jnp.concatenate([a.view_ids, b.view_ids]),
        fixed=jnp.concatenate([a.fixed, b.fixed]),
        kind=a.kind,
        solver=a.solver,
    )


def take(cams: CameraSet, indices) -> CameraSet:
    indices = jnp.asarray(indices)
    return CameraSet(
        rot=cams.rot[indices],
        offset=cams.offset[indices],
        scale=cams.scale[indices],
        width=cams.width[indices],
        height=cams.height[indices],
        view_ids=cams.view_ids[indices],
        fixed=cams.fixed[indices],
        kind=cams.kind,
        solver=cams.solver,
    )


def format_cameras(cams: CameraSet, mask=None) -> str:
    """Human-readable camera dump in the reference's print format
    (OrthographicCamera.cpp:146-149 / OrthoQuaternionCamera.cpp:23-32):
    angles in degrees via basisToPhiThetaRho, plus offset and scale."""
    import numpy as np

    angles = np.rad2deg(np.asarray(basis_to_phi_theta_roll(basis(cams))))
    off = np.asarray(cams.offset)
    sc = np.asarray(cams.scale)
    ids = np.asarray(cams.view_ids)
    lines = []
    for i in range(len(cams)):
        if mask is not None and not mask[i]:
            continue
        prefix = "Quaternion Camera" if cams.kind == "quat" else "Camera"
        lines.append(
            f"{prefix} {int(ids[i])} [phi: {angles[i, 0]:.4g}; "
            f"theta: {angles[i, 1]:.4g}; roll: {angles[i, 2]:.4g}; "
            f"offset ({off[i, 0]:.4g}; {off[i, 1]:.4g}); scale: {sc[i]:.4g}]")
    return "\n".join(lines)


def export_matrices(cams: CameraSet):
    """4×4 [X Y Z origin; 0 0 0 1] export matrices
    (reference: src/data_structures/camera_io.cpp:24-36)."""
    R = rotation_l2w(cams)
    o = origins(cams)
    n = len(cams)
    top = jnp.concatenate([R, o[..., :, None]], axis=-1)  # (V, 3, 4)
    bottom = jnp.broadcast_to(jnp.array([[[0.0, 0.0, 0.0, 1.0]]]), (n, 1, 4))
    return jnp.concatenate([top, bottom], axis=-2)
