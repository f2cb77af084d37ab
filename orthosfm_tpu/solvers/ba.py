"""Bundle adjustment: Huber-robustified Levenberg–Marquardt with Schur
complement over point blocks — the array-program replacement for the reference's
Ceres SPARSE_SCHUR solve (src/bundle_adjustment/bundle_adjustment.cpp:49-161).

Design (SURVEY.md §7 step 4):
  - residual per observation r[t,v] = project(cam_v, point_t) − obs[t,v],
    Huber-weighted (δ=1.0, bundle_adjustment.cpp:64) via IRLS weights;
  - analytic manifold Jacobians (cross-checked against jacfwd of the
    retraction in tests): cameras use the 6-dim tangent of
    core.cameras.retract (EigenQuaternionParameterization /
    IdentityParameterization analogs), points the 3-dim tangent of the unit
    sphere in R⁴ (HomogeneousVectorParameterization analog,
    bundle_adjustment.cpp:90);
  - the point blocks are eliminated (Schur), the reduced (6V×6V) camera
    system solves densely with Jacobi preconditioning, point updates
    back-substitute in-shard;
  - fixed parameters (SetParameterBlockConstant analog) are zeroed Jacobian
    columns + identity rows in the reduced system;
  - the whole LM loop is one lax.while_loop → a single XLA program per
    (T, V) shape, reused across incremental groups.

Layout: every per-observation tensor keeps the (large) track dimension T
minor-most — r (V,2,T), Jc (V,2,6,T), Jp (V,2,3,T) — so elementwise work runs
over long contiguous rows and every contraction over tracks matricizes into
one large matrix product:
    U      = batched (6 × 2T)·(2T × 6)    per camera,
    S_red  = (6V × 3T)·(3T × 6V)          one flat matmul,
    rhs    = (6V × 3T)·(3T,)
instead of many tiny-trailing-dim einsums. The 3×3 point blocks invert in
closed form (no batched LU).

Multi-device: ba_sharded.py wraps the same iteration in shard_map over the
track axis; U/S/rhs contributions are psum-reduced while point blocks stay
device-local.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orthosfm_tpu.config import BundleAdjustConfig
from orthosfm_tpu.core import cameras as cam_mod
from orthosfm_tpu.core import quaternions as quat

TAN_C = cam_mod.CAMERA_TANGENT_DIM  # 6
TAN_P = 3


# ---------------------------------------------------------------------------
# Homogeneous point manifold (track-major (T, ...) convenience forms)


def point_tangent_basis(p_hat):
    """Orthonormal basis (..., 4, 3) of the tangent space at unit p_hat ∈ S³,
    via the Householder reflection mapping e₃ → ∓p_hat (Ceres
    HomogeneousVectorParameterization's construction)."""
    sign = jnp.where(p_hat[..., 3:4] >= 0, 1.0, -1.0)
    v = p_hat + sign * jnp.array([0.0, 0.0, 0.0, 1.0], p_hat.dtype)
    vn2 = jnp.sum(v * v, axis=-1, keepdims=True)
    H = jnp.eye(4, dtype=p_hat.dtype) - 2.0 * v[..., :, None] * v[..., None, :] / jnp.maximum(
        vn2[..., None], 1e-20
    )
    return H[..., :, :3]


def retract_point(p_hat, delta):
    """Unit-norm retraction p ← normalize(p + B δ)."""
    B = point_tangent_basis(p_hat)
    p_new = p_hat + jnp.einsum("...ij,...j->...i", B, delta)
    return p_new / jnp.maximum(jnp.linalg.norm(p_new, axis=-1, keepdims=True), 1e-20)


# ---------------------------------------------------------------------------
# Track-minor (..., T) variants — the hot-path layout


def point_tangent_basis_T(pT):
    """(4, T) unit points → (4, 3, T) tangent bases (same construction as
    point_tangent_basis, T-minor)."""
    sign = jnp.where(pT[3] >= 0, 1.0, -1.0)  # (T,)
    e3 = jnp.array([0.0, 0.0, 0.0, 1.0], pT.dtype)
    v = pT + sign[None, :] * e3[:, None]  # (4, T)
    vn2 = jnp.maximum(jnp.sum(v * v, axis=0), 1e-20)  # (T,)
    eye43 = jnp.eye(4, dtype=pT.dtype)[:, :3]
    return eye43[:, :, None] - 2.0 * v[:, None, :] * v[None, :3, :] / vn2[None, None, :]


def retract_point_T(pT, deltaT):
    """(4, T), (3, T) → (4, T) unit-norm retraction."""
    B = point_tangent_basis_T(pT)
    p_new = pT + jnp.einsum("ijt,jt->it", B, deltaT)
    return p_new / jnp.maximum(jnp.linalg.norm(p_new, axis=0, keepdims=True), 1e-20)


# ---------------------------------------------------------------------------
# Per-observation residual (raw parameters, retraction-composed) — kept as the
# autodiff reference implementation for the analytic Jacobians.


def _obs_residual(kind, rot, offset, scale, w, h, p_hat, obs, dc, dp):
    """Residual (2,) of one observation after camera step dc (6,) and point
    step dp (3,). Mirrors the reference residual functors
    (OrthographicReprojectionError.h:26-77,
    OrthographicQuaternionReprojectorError.h:24-67)."""
    if kind == "quat":
        q = quat.normalize(quat.multiply(quat.exp_map(dc[:3]), rot))
        R = quat.to_matrix(q)
    else:
        angles = rot[:3] + dc[:3]
        S = cam_mod.spherical_matrix(angles)
        R = cam_mod.COORD_TRANSFORM.astype(S.dtype).T @ S
    off = offset + dc[3:5]
    sc = scale + dc[5]
    p = retract_point(p_hat, dp)
    p3 = cam_mod.dehomogenize(p)
    local = R.T @ p3
    proj = local[:2] / sc
    xy = (proj - off) / (-2.0) + 0.5
    return jnp.stack([w, h]) * xy - obs


def inv3x3(M):
    """Closed-form batched 3×3 inverse for (..., 3, 3) stacks (adjugate/det).

    The cofactor form is pure elementwise arithmetic that fuses into one
    kernel, where jnp.linalg.inv would run a batched LU.
    """
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    adj = jnp.stack([
        jnp.stack([A, -(b * i - c * h), b * f - c * e], -1),
        jnp.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        jnp.stack([C, -(a * h - b * g), a * e - b * d], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def inv3x3_T(M):
    """Closed-form 3×3 inverse for a (3, 3, T) stack (T-minor layout)."""
    a, b, c = M[0, 0], M[0, 1], M[0, 2]
    d, e, f = M[1, 0], M[1, 1], M[1, 2]
    g, h, i = M[2, 0], M[2, 1], M[2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    row0 = jnp.stack([A, -(b * i - c * h), b * f - c * e], 0)
    row1 = jnp.stack([B, a * i - c * g, -(a * f - c * d)], 0)
    row2 = jnp.stack([C, -(a * h - b * g), a * e - b * d], 0)
    return jnp.stack([row0, row1, row2], 0) * inv_det[None, None, :]


def solve3x3(M, y):
    """Batched 3×3 solve via the closed-form inverse ((..., 3, 3) stacks)."""
    return jnp.einsum("...ij,...j->...i", inv3x3(M), y)


class _Blocks(NamedTuple):
    r: jnp.ndarray  # (V, 2, T) raw residuals
    Jc: jnp.ndarray  # (V, 2, 6, T)
    Jp: jnp.ndarray  # (V, 2, 3, T)
    weight: jnp.ndarray  # (V, T) IRLS robust weights (0 where masked)


def _safe_w(w_comp):
    return jnp.where(jnp.abs(w_comp) < 1e-12,
                     jnp.where(w_comp < 0, -1e-12, 1e-12), w_comp)


def _project_residuals_T(cams: cam_mod.CameraSet, pT, obsT):
    """(V, 2, T) raw reprojection residuals; pT is (4, T) homogeneous."""
    R = cam_mod.rotation_l2w(cams)  # (V, 3, 3)
    p3 = pT[:3] / _safe_w(pT[3])[None, :]  # (3, T)
    local = jnp.einsum("vij,it->vjt", R, p3)  # (V, 3, T) = Rᵀ p3
    s = cams.scale[:, None, None]
    wh = jnp.stack([cams.width, cams.height], -1)[:, :, None]  # (V, 2, 1)
    off = cams.offset[:, :, None]
    pix = wh * (-(local[:, :2] / s - off) * 0.5 + 0.5)
    return pix - obsT


def _residuals_and_jacobians(cams: cam_mod.CameraSet, pT, obsT, maskT,
                             huber_delta):
    """Closed-form batched residuals + manifold Jacobians, T-minor layout.

    pT (4, T) unit homogeneous points; obsT (V, 2, T); maskT (V, T).
    Derivation (pix = wh·(−(Rᵀp/s − off)/2 + 0.5), r = pix − obs):

      ∂pix/∂local_xy = diag(−wh/2s) =: a
      quaternion tangent (q ← exp(δ)⊗q): ∂local/∂δ = Rᵀ[p]ₓ
      Euler angles:                      ∂local/∂angleₖ = ∂Sₖᵀ·(C·p)
      ∂pix/∂off = diag(wh/2);   ∂pix/∂s = −a·local_xy/s
      point tangent: ∂local/∂ε = Rᵀ·J₃·B with J₃ = [I/w | −p₃/w] (dehomog)
      and B the S³ tangent basis.

    Verified against the jacfwd formulation in tests/test_ba.py.
    """
    dtype = obsT.dtype
    V = obsT.shape[0]
    T = obsT.shape[2]
    R = cam_mod.rotation_l2w(cams)  # (V, 3, 3)
    sw = _safe_w(pT[3])  # (T,)
    p3 = pT[:3] / sw[None, :]  # (3, T)

    local = jnp.einsum("vij,it->vjt", R, p3)  # (V, 3, T)
    s = cams.scale  # (V,)
    wh = jnp.stack([cams.width, cams.height], -1)  # (V, 2)
    off = cams.offset  # (V, 2)
    pix = wh[:, :, None] * (-(local[:, :2] / s[:, None, None] - off[:, :, None]) * 0.5 + 0.5)
    r = pix - obsT  # (V, 2, T)

    a = -wh / (2.0 * s[:, None])  # (V, 2) pix/local_xy scale

    if cams.kind == "quat":
        # ∂local/∂δₖ = (Rᵀ[p]ₓ)[:, k]; [p]ₓ columns: (0,z,−y), (−z,0,x), (y,−x,0)
        x, y, z = p3[0], p3[1], p3[2]
        zero = jnp.zeros_like(x)
        Pcols = jnp.stack([
            jnp.stack([zero, z, -y], 0),
            jnp.stack([-z, zero, x], 0),
            jnp.stack([y, -x, zero], 0),
        ], 1)  # (j=3, k=3, T)
        dl_rot = jnp.einsum("vja,jkt->vakt", R, Pcols)  # (V, 3, 3, T)
    else:
        dS = cam_mod.spherical_matrix_derivs(cams.rot[..., :3])  # (V, 3, 3, 3)
        Cp = jnp.einsum("ab,bt->at", cam_mod.COORD_TRANSFORM.astype(dtype), p3)
        # ∂localₐ/∂angleₖ = Σ_b dSₖ[b, a]·(Cp)_b
        dl_rot = jnp.einsum("vkba,bt->vakt", dS, Cp)  # (V, 3, 3, T)

    # Jc columns: [rotation (3) | offset (2) | scale (1)]
    Jc_rot = a[:, :, None, None] * dl_rot[:, :2]  # (V, 2, 3, T)
    eye2 = jnp.eye(2, dtype=dtype)
    Jc_off = jnp.broadcast_to((wh[:, :, None] * 0.5 * eye2[None])[:, :, :, None],
                              (V, 2, 2, T))
    Jc_s = (-a[:, :, None] * local[:, :2] / s[:, None, None])[:, :, None, :]  # (V, 2, 1, T)
    Jc = jnp.concatenate([Jc_rot, Jc_off, Jc_s], axis=2)  # (V, 2, 6, T)

    B = point_tangent_basis_T(pT)  # (4, 3, T)
    # J₃ = [I/w | −p₃/w] (3, 4, T); J3B = J₃·B (3, 3, T)
    J3B = (B[:3] - p3[:, None, :] * B[3][None]) / sw[None, None, :]
    dl_pt = jnp.einsum("vja,jkt->vakt", R, J3B)  # (V, 3, 3, T)
    Jp = a[:, :, None, None] * dl_pt[:, :2]  # (V, 2, 3, T)

    m2 = maskT[:, None, :]
    r = jnp.where(m2, r, 0.0)
    Jc = jnp.where(m2[:, :, None], Jc, 0.0)
    Jp = jnp.where(m2[:, :, None], Jp, 0.0)
    rnorm = jnp.sqrt(jnp.maximum(jnp.sum(r * r, axis=1), 1e-30))  # (V, T)
    wgt = jnp.where(rnorm <= huber_delta, 1.0, huber_delta / rnorm)
    wgt = jnp.where(maskT, wgt, 0.0)
    return _Blocks(r=r, Jc=Jc, Jp=Jp, weight=wgt)


def _residuals_and_jacobians_autodiff(cams: cam_mod.CameraSet, points_hat, obs,
                                      mask, huber_delta):
    """jacfwd reference implementation in track-major layout (kept for
    cross-checking the analytic T-minor Jacobians in tests)."""
    kind = cams.kind
    f = functools.partial(_obs_residual, kind)

    def per_obs(rot, offset, scale, w, h, p_hat, o):
        zero_c = jnp.zeros((TAN_C,), obs.dtype)
        zero_p = jnp.zeros((TAN_P,), obs.dtype)
        r = f(rot, offset, scale, w, h, p_hat, o, zero_c, zero_p)
        Jc, Jp = jax.jacfwd(f, argnums=(7, 8))(rot, offset, scale, w, h, p_hat, o, zero_c, zero_p)
        return r, Jc, Jp

    per_track = jax.vmap(per_obs, in_axes=(None, None, None, None, None, 0, 0))
    per_all = jax.vmap(per_track, in_axes=(0, 0, 0, 0, 0, None, 1), out_axes=1)
    r, Jc, Jp = per_all(cams.rot, cams.offset, cams.scale, cams.width, cams.height,
                        points_hat, obs)

    # Hard-zero masked entries: padded/dead observations can carry NaN/Inf
    # (e.g. degenerate points), and 0-weight × NaN would poison the reductions.
    r = jnp.where(mask[..., None], r, 0.0)
    Jc = jnp.where(mask[..., None, None], Jc, 0.0)
    Jp = jnp.where(mask[..., None, None], Jp, 0.0)

    rnorm = jnp.linalg.norm(r, axis=-1)
    wgt = jnp.where(rnorm <= huber_delta, 1.0, huber_delta / jnp.maximum(rnorm, 1e-20))
    wgt = jnp.where(mask, wgt, 0.0)
    return r, Jc, Jp, wgt


def robust_cost(r, mask, huber_delta, comp_axis=1):
    """½ Σ ρ(‖r‖²) with Huber ρ (Ceres convention). Default layout is T-minor:
    r (V, 2, T) with mask (V, T); pass comp_axis=-1 for track-major (T, V, 2)."""
    s = jnp.sum(r * r, axis=comp_axis)
    d2 = huber_delta * huber_delta
    rho = jnp.where(s <= d2, s, 2.0 * huber_delta * jnp.sqrt(jnp.maximum(s, 1e-20)) - d2)
    return 0.5 * jnp.sum(jnp.where(mask, rho, 0.0))


def normal_equations(blocks: _Blocks, free_c):
    """Assemble the Schur-ready blocks (T-minor layout).

    Returns (U, Wc, Vt, g_c, g_p):
      U (V, 6, 6) camera diag blocks; Wc (V, 6, 3, T) couplings;
      Vt (3, 3, T) point blocks; g_c (V, 6); g_p (3, T) — gradients are
      −Jᵀr (the RHS of the GN step). Fixed camera params are projected out.

    Every contraction over tracks is a large matmul (see module docstring).
    """
    V = blocks.Jc.shape[0]
    T = blocks.Jc.shape[3]
    Jc = blocks.Jc * free_c[:, None, :, None]  # zero fixed columns
    Jp = blocks.Jp
    w = blocks.weight[:, None, None, :]  # (V, 1, 1, T)
    Jcw = Jc * w
    Jpw = Jp * w

    # U[v] = Σ_{k,t} w·Jc[v,k,:,t]ᵀJc[v,k,:,t]: batched (6, 2T)·(2T, 6)
    A = jnp.transpose(Jc, (0, 2, 1, 3)).reshape(V, 6, 2 * T)
    Aw = jnp.transpose(Jcw, (0, 2, 1, 3)).reshape(V, 6, 2 * T)
    U = jax.lax.dot_general(Aw, A, (((2,), (2,)), ((0,), (0,))),
                            preferred_element_type=jnp.float32)

    # Couplings and point blocks: tiny-k fmas, elementwise over T
    Wc = (Jcw[:, 0, :, None, :] * Jp[:, 0, None, :, :] +
          Jcw[:, 1, :, None, :] * Jp[:, 1, None, :, :])  # (V, 6, 3, T)
    Vt = jnp.einsum("vkpt,vkqt->pqt", Jpw, Jp)  # (3, 3, T), K = 2V
    g_c = -jnp.einsum("vkit,vkt->vi", Jcw, blocks.r)
    g_p = -jnp.einsum("vkpt,vkt->pt", Jpw, blocks.r)
    return U, Wc, Vt, g_c, g_p


def schur_solve(U, Wc, Vt, g_c, g_p, free_c, lam, optimize_points: bool,
                reduce_fn=None):
    """LM step via Schur elimination of point blocks (T-minor layout).

    Takes the normal_equations outputs; returns (delta_c (V, 6),
    delta_p (3, T)).

    ``reduce_fn`` sums partial cross-track contributions across devices
    (jax.lax.psum inside shard_map); U and g_c must already be globally
    reduced by the caller in that case. Point blocks stay local to their
    track shard.
    """
    if reduce_fn is None:
        reduce_fn = lambda x: x  # noqa: E731 — single-device: identity
    V, T = Wc.shape[0], Wc.shape[3]
    dtype = U.dtype
    eye3 = jnp.eye(3, dtype=dtype)
    eye6 = jnp.eye(6, dtype=dtype)

    # LM damping on the diagonals (Marquardt scaling with floor)
    dU = jnp.maximum(jnp.einsum("vii->vi", U), 1e-8)
    U_d = U + lam * dU[..., None] * eye6
    dV = jnp.maximum(jnp.stack([Vt[0, 0], Vt[1, 1], Vt[2, 2]], 0), 1e-8)  # (3, T)
    V_d = Vt + eye3[:, :, None] * (lam * dV + 1e-10)[:, None, :]

    if optimize_points:
        V_inv = inv3x3_T(V_d)  # (3, 3, T) — closed-form
    else:
        V_inv = jnp.zeros_like(V_d)

    # WVi[v,a,q,t] = Σ_p Wc[v,a,p,t]·V⁻¹[p,q,t]
    WVi = (Wc[:, :, 0, None, :] * V_inv[None, None, 0] +
           Wc[:, :, 1, None, :] * V_inv[None, None, 1] +
           Wc[:, :, 2, None, :] * V_inv[None, None, 2])  # (V, 6, 3, T)

    # Reduced camera system S = blkdiag(U_d) − Σ_t W V⁻¹ Wᵀ: one flat matmul
    X = WVi.reshape(V * 6, 3 * T)
    Y = Wc.reshape(V * 6, 3 * T)
    S_red = reduce_fn(jnp.dot(X, Y.T, preferred_element_type=jnp.float32))
    S = (-S_red).reshape(V, 6, V, 6)
    S = S.at[jnp.arange(V), :, jnp.arange(V), :].add(U_d)
    rhs = g_c.reshape(V * 6) - reduce_fn(X @ g_p.reshape(3 * T))

    n = V * 6
    S_f = S.reshape(n, n)
    free_f = free_c.reshape(n)

    # Pin fixed params: identity rows/cols, zero rhs
    fm = free_f.astype(dtype)
    S_f = S_f * fm[:, None] * fm[None, :] + jnp.diag(1.0 - fm)
    rhs_f = rhs * fm

    # Jacobi preconditioning for f32 conditioning
    d = jnp.sqrt(jnp.maximum(jnp.abs(jnp.diag(S_f)), 1e-12))
    S_s = S_f / d[:, None] / d[None, :]
    delta_c = (jnp.linalg.solve(S_s, rhs_f / d) / d).reshape(V, 6)
    delta_c = delta_c * free_c.astype(dtype)

    # Back-substitute point updates: δp = V⁻¹(g_p − Wᵀ δc)
    tmp = g_p - (Y.T @ delta_c.reshape(V * 6)).reshape(3, T)  # (3, T)
    delta_p = (V_inv[:, 0] * tmp[None, 0] + V_inv[:, 1] * tmp[None, 1] +
               V_inv[:, 2] * tmp[None, 2])  # (3, T)
    return delta_c, delta_p


class BAResult(NamedTuple):
    cams: cam_mod.CameraSet
    points: jnp.ndarray  # (T, 4) homogeneous (unit-norm)
    cost: jnp.ndarray
    initial_cost: jnp.ndarray
    iterations: jnp.ndarray


def _lm_loop(cams, pT, obsT, maskT, free_c, optimize_points, config,
             reduce_fn=None, cost_reduce_fn=None):
    """The shared LM while_loop over T-minor tensors. ``reduce_fn`` /
    ``cost_reduce_fn`` psum partial results under shard_map (identity when
    single-device)."""
    dtype = obsT.dtype
    cost_red = cost_reduce_fn or (lambda x: x)

    def cost_of(cams_, p_):
        r = _project_residuals_T(cams_, p_, obsT)
        r = jnp.where(maskT[:, None, :], r, 0.0)
        return cost_red(robust_cost(r, maskT, config.huber_delta))

    init_cost = cost_of(cams, pT)

    def cond(state):
        cams_, p_, lam, cost, it, done = state
        return (~done) & (it < config.max_iterations)

    def step(cams_, p_, lam):
        blocks = _residuals_and_jacobians(cams_, p_, obsT, maskT, config.huber_delta)
        U, Wc, Vt, g_c, g_p = normal_equations(blocks, free_c)
        if reduce_fn is not None:
            U = reduce_fn(U)
            g_c = reduce_fn(g_c)
        delta_c, delta_p = schur_solve(U, Wc, Vt, g_c, g_p, free_c, lam,
                                       optimize_points, reduce_fn=reduce_fn)
        cams_new = cam_mod.retract(cams_, delta_c.astype(dtype))
        p_new = retract_point_T(p_, delta_p.astype(dtype)) if optimize_points else p_
        return cams_new, p_new, cost_of(cams_new, p_new)

    def body(state):
        cams_, p_, lam, cost, it, done = state
        cams_new, p_new, new_cost = step(cams_, p_, lam)
        accept = new_cost < cost
        cams_ = jax.tree.map(lambda a, b: jnp.where(accept, b, a), cams_, cams_new)
        p_ = jnp.where(accept, p_new, p_)
        rel_decrease = (cost - new_cost) / jnp.maximum(cost, 1e-20)
        done_new = accept & (rel_decrease < config.function_tolerance)
        cost = jnp.where(accept, new_cost, cost)
        lam = jnp.where(accept, jnp.maximum(lam * config.lambda_down, config.min_lambda),
                        jnp.minimum(lam * config.lambda_up, config.max_lambda))
        done_new = done_new | (~accept & (lam >= config.max_lambda))
        return (cams_, p_, lam, cost, it + 1, done_new)

    state = (cams, pT, jnp.asarray(config.initial_lambda, dtype), init_cost,
             jnp.asarray(0, jnp.int32), jnp.asarray(False))
    cams_f, p_f, _, cost_f, iters, _ = jax.lax.while_loop(cond, body, state)
    return cams_f, p_f, cost_f, init_cost, iters


@functools.partial(jax.jit, static_argnames=("optimize_points", "config"))
def run(cams: cam_mod.CameraSet, points4, obs, mask,
        optimize_points: bool = True,
        config: BundleAdjustConfig = BundleAdjustConfig()) -> BAResult:
    """Run robust LM bundle adjustment.

    Args:
      cams: V cameras (their ``fixed`` flags and solver type drive free masks).
      points4: (T, 4) homogeneous points (w≠0 for valid tracks).
      obs: (T, V, 2) pixel observations aligned to the camera order.
      mask: (T, V) which observations participate (obs_mask & alive & has_point).

    Equivalent call in the reference: runBundleAdjustment(cameras, tracks,
    algorithm, optimizePoints, retriangulate) — retriangulation is done by the
    caller (pipeline) before invoking this, as bundle_adjustment.cpp:74-83 does.
    """
    free_c = cam_mod.free_mask(cams)
    p_hat = points4 / jnp.maximum(jnp.linalg.norm(points4, axis=-1, keepdims=True), 1e-20)

    track_valid = jnp.any(mask, axis=1)
    mask = mask & track_valid[:, None]
    # Dead/padded tracks get a safe unit point so the point manifold never
    # sees an exactly-zero vector (NaN gradients).
    safe = jnp.array([0.0, 0.0, 0.0, 1.0], obs.dtype)
    p_hat = jnp.where(track_valid[:, None], p_hat, safe)

    obsT = jnp.transpose(obs, (1, 2, 0))  # (V, 2, T)
    maskT = mask.T  # (V, T)
    pT = p_hat.T  # (4, T)

    cams_f, p_f, cost_f, init_cost, iters = _lm_loop(
        cams, pT, obsT, maskT, free_c, optimize_points, config)
    return BAResult(cams=cams_f, points=p_f.T, cost=cost_f,
                    initial_cost=init_cost, iterations=iters)


def _project_residuals(cams: cam_mod.CameraSet, points4, obs):
    """(T, V, 2) raw reprojection residuals for all pairs (track-major)."""
    pix = cam_mod.project(cams, points4)  # (V, T, 2)
    return jnp.transpose(pix, (1, 0, 2)) - obs


def reprojection_errors(cams: cam_mod.CameraSet, points4, obs, mask):
    """Per-observation euclidean reprojection errors (T, V), 0 where masked —
    the evaluateReprojectionError analog
    (reference: OrthographicReconstructionAlgorithm.cpp:204-223)."""
    r = _project_residuals(cams, points4, obs)
    return jnp.where(mask, jnp.linalg.norm(r, axis=-1), 0.0)


def run_even_odd(cams: cam_mod.CameraSet, points4, obs, mask,
                 optimize_points: bool = True,
                 config: BundleAdjustConfig = BundleAdjustConfig(),
                 fix_first_two: bool = False) -> BAResult:
    """Alternating even/odd-camera bundle adjustment
    (reference: bundle_adjustment.cpp:163-198 runEvenOddBundleAdjustment —
    present in the reference API though its call sites are commented out).

    Fixes even cameras, solves; fixes odd cameras, solves; restores the
    original fixed flags (plus optionally the first two) and solves once more.
    """
    n = len(cams)
    idx = jnp.arange(n)
    first_two = fix_first_two & (idx < 2)
    orig_fixed = cams.fixed

    even = (idx % 2 == 0) | first_two
    r1 = run(cams.replace(fixed=even), points4, obs, mask,
             optimize_points=optimize_points, config=config)
    odd = (idx % 2 != 0) | first_two
    r2 = run(r1.cams.replace(fixed=odd), r1.points, obs, mask,
             optimize_points=optimize_points, config=config)
    final_fixed = orig_fixed | first_two
    r3 = run(r2.cams.replace(fixed=final_fixed), r2.points, obs, mask,
             optimize_points=optimize_points, config=config)
    return BAResult(cams=r3.cams, points=r3.points, cost=r3.cost,
                    initial_cost=r1.initial_cost,
                    iterations=r1.iterations + r2.iterations + r3.iterations)
