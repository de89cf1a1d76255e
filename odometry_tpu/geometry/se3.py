"""Pure-JAX SE(3)/SO(3) Lie-group math (float32, fully batched).

Batched replacement for the vendored Sophus library used by the reference
(``third_party/Sophus/sophus/se3.hpp``, ``so3.hpp``). Only the operations the
odometry stack needs are implemented, but all of them accept arbitrary leading
batch dimensions and are jit/vmap/grad-safe (Taylor fallbacks near the
singularities instead of branches).

Twist convention matches Sophus / the reference LM optimizer
(``lm_optimizer.cpp:232-234``): ``xi = [v, w]`` with the translational part
first, so ``se3_exp(delta) @ T`` reproduces ``SE3::exp(delta_vec) * T``
(``lm_optimizer.cpp:152-153``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Small-angle cutoff: below this, use Taylor expansions. float32-safe.
_EPS = 1e-6

# Default f32 matmuls may run in reduced precision (TF32 on a GPU);
# Lie-group algebra needs true f32.
_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


def hat(w: jax.Array) -> jax.Array:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zeros, -wz, wy], axis=-1),
            jnp.stack([wz, zeros, -wx], axis=-1),
            jnp.stack([-wy, wx, zeros], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jax.Array) -> jax.Array:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _sinc_terms(theta_sq: jax.Array):
    """Return (A, B, C) = (sin th/th, (1-cos th)/th^2, (th - sin th)/th^3).

    Uses 4th-order Taylor expansions below the float32 cutoff so the functions
    (and their gradients) are finite at theta = 0.
    """
    theta = jnp.sqrt(theta_sq + 1e-30)
    small = theta_sq < _EPS
    # Guarded values so the "large" branch never divides by ~0.
    safe_sq = jnp.where(small, 1.0, theta_sq)
    safe_th = jnp.where(small, 1.0, theta)
    sin_t = jnp.sin(safe_th)
    cos_t = jnp.cos(safe_th)
    A = jnp.where(small, 1.0 - theta_sq / 6.0, sin_t / safe_th)
    B = jnp.where(small, 0.5 - theta_sq / 24.0, (1.0 - cos_t) / safe_sq)
    C = jnp.where(small, 1.0 / 6.0 - theta_sq / 120.0, (safe_th - sin_t) / (safe_sq * safe_th))
    return A, B, C


def so3_exp(w: jax.Array) -> jax.Array:
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation.

    Mirrors ``Sophus::SO3::exp`` (so3.hpp) in closed form.
    """
    theta_sq = jnp.sum(w * w, axis=-1)
    A, B, _ = _sinc_terms(theta_sq)
    W = hat(w)
    WW = _mm(W, W)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * WW


def so3_log(R: jax.Array) -> jax.Array:
    """Rotation matrix -> axis-angle, (..., 3, 3) -> (..., 3).

    Robust for angles in [0, pi]; near pi the axis is recovered from the
    diagonal of R (symmetric part), matching ``Sophus::SO3::log``.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    # Antisymmetric part gives axis * sin(theta).
    v = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_theta = jnp.sin(theta)
    near_pi = cos_theta < -0.99999
    small = theta < 1e-4
    # Generic: w = theta / (2 sin theta) * v ; small: w = 0.5 * v (1 + th^2/6)
    scale_generic = theta / jnp.where(jnp.abs(sin_theta) < 1e-12, 1.0, 2.0 * sin_theta)
    scale_small = 0.5 + theta * theta / 12.0
    scale = jnp.where(small, scale_small, scale_generic)
    w_generic = scale[..., None] * v
    # Near pi: |w_i| from diagonal; sign from v (or positive when v ~ 0).
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis_abs = jnp.sqrt(jnp.clip((diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None] + 1e-12), 0.0, None))
    # Fix signs using the largest axis component and off-diagonal sums.
    # R + R^T = 2 cos I + 2 (1 - cos) a a^T  -> off-diagonals give sign products.
    s01 = R[..., 0, 1] + R[..., 1, 0]
    s02 = R[..., 0, 2] + R[..., 2, 0]
    s12 = R[..., 1, 2] + R[..., 2, 1]
    ax = axis_abs[..., 0]
    ay = axis_abs[..., 1] * jnp.where(s01 >= 0, 1.0, -1.0)
    az = axis_abs[..., 2] * jnp.where(s02 >= 0, 1.0, -1.0)
    axis_pi = jnp.stack([ax, ay, az], axis=-1)
    # Keep consistency between ay/az when ax ~ 0: use s12 to relate them.
    ax_small = ax < 1e-3
    ay2 = axis_abs[..., 1]
    az2 = axis_abs[..., 2] * jnp.where(s12 >= 0, 1.0, -1.0)
    axis_pi = jnp.where(
        ax_small[..., None],
        jnp.stack([ax, ay2, az2], axis=-1),
        axis_pi,
    )
    norm = jnp.linalg.norm(axis_pi, axis=-1, keepdims=True)
    axis_pi = axis_pi / jnp.where(norm < 1e-12, 1.0, norm)
    w_pi = axis_pi * theta[..., None]
    return jnp.where(near_pi[..., None], w_pi, w_generic)


def se3_exp(xi: jax.Array) -> jax.Array:
    """Twist (..., 6) [v, w] -> homogeneous transform (..., 4, 4).

    Equivalent to ``Sophus::SE3::exp`` (se3.hpp:765): R = exp(w),
    t = V(w) v with the left Jacobian V = I + B*W + C*W^2.
    """
    v, w = xi[..., :3], xi[..., 3:]
    theta_sq = jnp.sum(w * w, axis=-1)
    A, B, C = _sinc_terms(theta_sq)
    W = hat(w)
    WW = _mm(W, W)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    R = eye + A[..., None, None] * W + B[..., None, None] * WW
    V = eye + B[..., None, None] * W + C[..., None, None] * WW
    t = _einsum("...ij,...j->...i", V, v)
    return rt_to_mat(R, t)


def se3_log(T: jax.Array) -> jax.Array:
    """Homogeneous transform (..., 4, 4) -> twist (..., 6) [v, w]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta_sq = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta_sq + 1e-30)
    W = hat(w)
    WW = _mm(W, W)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), W.shape)
    # V^{-1} = I - 0.5 W + (1/th^2)(1 - A/(2B)) W^2
    small = theta_sq < _EPS
    safe_sq = jnp.where(small, 1.0, theta_sq)
    A, B, _ = _sinc_terms(theta_sq)
    coef_generic = (1.0 - A / (2.0 * B)) / safe_sq
    coef_small = 1.0 / 12.0 + theta_sq / 720.0
    coef = jnp.where(small, coef_small, coef_generic)
    Vinv = eye - 0.5 * W + coef[..., None, None] * WW
    v = _einsum("...ij,...j->...i", Vinv, t)
    return jnp.concatenate([v, w], axis=-1)


def rt_to_mat(R: jax.Array, t: jax.Array) -> jax.Array:
    """(R (...,3,3), t (...,3)) -> homogeneous (..., 4, 4)."""
    batch = R.shape[:-2]
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def mat_to_rt(T: jax.Array):
    return T[..., :3, :3], T[..., :3, 3]


def se3_inverse(T: jax.Array) -> jax.Array:
    """Inverse of a rigid transform without a general 4x4 solve."""
    R, t = mat_to_rt(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return rt_to_mat(Rt, -_einsum("...ij,...j->...i", Rt, t))


def se3_compose(A: jax.Array, B: jax.Array) -> jax.Array:
    return _mm(A, B)


def se3_identity(batch=(), dtype=jnp.float32) -> jax.Array:
    return jnp.broadcast_to(jnp.eye(4, dtype=dtype), tuple(batch) + (4, 4))


def se3_adjoint(T: jax.Array) -> jax.Array:
    """Adjoint of SE(3) for the [v, w] twist ordering: (..., 6, 6)."""
    R, t = mat_to_rt(T)
    tR = _mm(hat(t), R)
    zeros = jnp.zeros_like(R)
    top = jnp.concatenate([R, tR], axis=-1)
    bottom = jnp.concatenate([zeros, R], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def transform_points(T: jax.Array, pts: jax.Array) -> jax.Array:
    """Apply (..., 4, 4) to points (..., N, 3) -> (..., N, 3)."""
    R, t = mat_to_rt(T)
    return _einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def rotation_angles_xyz(R: jax.Array) -> jax.Array:
    """Per-axis rotation angles as used by the keyframe criterion.

    Reproduces ``Sophus::SO3::angleX/angleY/angleZ`` (so3.hpp:127-154, used at
    ``run_odometry_kitti_offline.cpp:254-255``): each extracts a 2x2 block of
    R, projects it to the nearest SO(2) rotation, and takes its log. The
    nearest rotation to a 2x2 matrix M has angle atan2(M10 - M01, M00 + M11),
    which gives the closed forms below.

    Returns (..., 3) = [angleX, angleY, angleZ].
    """
    ax = jnp.arctan2(R[..., 2, 1] - R[..., 1, 2], R[..., 1, 1] + R[..., 2, 2])
    ay = jnp.arctan2(R[..., 0, 2] - R[..., 2, 0], R[..., 0, 0] + R[..., 2, 2])
    az = jnp.arctan2(R[..., 1, 0] - R[..., 0, 1], R[..., 0, 0] + R[..., 1, 1])
    return jnp.stack([ax, ay, az], axis=-1)
