"""Dense photometric residual/Jacobian + normal equations (pose tracking).

This is hot kernel #1: the reference's scalar loop
``LevenbergMarquardtOptimizer::ComputeResidualJacobianNaive``
(``lm_optimizer.cpp:163-264``) touches every pixel of every pyramid level each
LM iteration. Here it is dense masked tensor math:

* every "skip this pixel" (invalid depth, behind camera, out of bounds)
  becomes a zero-weight mask lane instead of a `continue`;
* the per-pixel 2x6 warp-Jacobian chain becomes a fused elementwise map
  producing a (H, W, 6) field;
* `J^T W J` / `J^T W r` become (6, N) @ (N, 6) contractions.

Interp mode "floor" reproduces the reference's nearest-via-floor image lookup
and integer-coordinate gradients (``lm_optimizer.cpp:208-217`` — flagged
"BUG!!!" in its own source); "bilinear" is the improved default for
accuracy-oriented configs.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from odometry_tpu.camera.pinhole import Pinhole, backproject, warp_points
from odometry_tpu.image.sampling import clip_gather_2d, sample_bilinear

_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


class ResidualSystem(NamedTuple):
    """Per-pixel linearization of the photometric error at one pose."""

    r: jax.Array  # (H, W) residual I2(warp(x)) - I1(x), 0 where invalid
    J: jax.Array  # (H, W, 6) d r / d twist, 0 where invalid
    valid: jax.Array  # (H, W) bool


def residual_jacobian(
    img_kf: jax.Array,
    inv_depth_kf: jax.Array,
    img_cur: jax.Array,
    cam: Pinhole,
    T: jax.Array,
    *,
    boundary: int = 4,
    min_inv_depth: float = 0.01,
    interp: str = "floor",
    affine_ab: tuple | None = None,
) -> ResidualSystem:
    """Vectorized ``ComputeResidualJacobianNaive`` (lm_optimizer.cpp:190-237).

    Args:
      img_kf: keyframe image at this level (H, W) float32.
      inv_depth_kf: keyframe inverse depth (H, W); |d| < min_inv_depth invalid.
      img_cur: current image at this level (H, W).
      cam: intrinsics for THIS level.
      T: (4, 4) transform mapping keyframe-camera points to current camera.
    """
    H, W = img_kf.shape
    ys = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)

    d = inv_depth_kf
    depth_valid = jnp.abs(d) >= min_inv_depth
    border = (
        (ys >= boundary)
        & (ys < H - boundary)
        & (xs >= boundary)
        & (xs < W - boundary)
    )
    z = 1.0 / jnp.where(depth_valid, d, 1.0)

    X, Y, Z = backproject(cam, xs, ys, z)
    u, v, Zw, warp_valid = warp_points(cam, T, X, Y, Z, H, W)
    valid = depth_valid & border & warp_valid

    if interp == "floor":
        xi = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, W - 1)
        yi = jnp.clip(jnp.floor(v).astype(jnp.int32), 0, H - 1)
        I2w = clip_gather_2d(img_cur, yi, xi)
        # Gradient at the integer warped coordinate with clamped neighbours
        # (ComputePixelGradient, image_processing_global.h:62-69).
        gx = 0.5 * (
            clip_gather_2d(img_cur, yi, xi + 1) - clip_gather_2d(img_cur, yi, xi - 1)
        )
        gy = 0.5 * (
            clip_gather_2d(img_cur, yi + 1, xi) - clip_gather_2d(img_cur, yi - 1, xi)
        )
    elif interp in ("bilinear", "mm"):  # dense path: mm == bilinear semantics
        I2w = sample_bilinear(img_cur, u, v)
        gx = 0.5 * (sample_bilinear(img_cur, u + 1.0, v) - sample_bilinear(img_cur, u - 1.0, v))
        gy = 0.5 * (sample_bilinear(img_cur, u, v + 1.0) - sample_bilinear(img_cur, u, v - 1.0))
    else:
        raise ValueError(f"unknown interp mode {interp!r}")

    if affine_ab is not None:
        # Brightness-affine corrected residual with FROZEN (a, b) — see
        # kernels/points.fit_affine_ab for the rationale and the reason the
        # fit must not run inside the LM iteration.
        a_fit, b_fit = affine_ab
        r = I2w - (a_fit * img_kf + b_fit)
    else:
        r = I2w - img_kf

    # 2x6 pinhole warp Jacobian at the KEYFRAME 3D point (lm_optimizer.cpp:232-233),
    # twist order [v, w]; rows contracted with the image gradient on the fly.
    safe_Z = jnp.where(Z == 0, 1.0, Z)
    inv_Z = 1.0 / safe_Z
    fx_z = cam.fx * inv_Z
    fy_z = cam.fy * inv_Z
    xy = X * Y
    inv_Z2 = inv_Z * inv_Z
    a = gx * fx_z
    b = gy * fy_z
    J = jnp.stack(
        [
            a,
            b,
            -(a * X + b * Y) * inv_Z,
            -a * xy * inv_Z - gy * cam.fy * (1.0 + Y * Y * inv_Z2),
            gx * cam.fx * (1.0 + X * X * inv_Z2) + b * xy * inv_Z,
            -a * Y + b * X,
        ],
        axis=-1,
    )

    vf = valid.astype(r.dtype)
    return ResidualSystem(r * vf, J * vf[..., None], valid)


class NormalEqs(NamedTuple):
    JtWJ: jax.Array  # (6, 6)
    JtWr: jax.Array  # (6,)
    err: jax.Array  # scalar: (1/n) r^T W r  (lm_optimizer.cpp:129)
    num_valid: jax.Array  # scalar int


def normal_equations(sys: ResidualSystem, weights: jax.Array) -> NormalEqs:
    """Reduce the dense system to 6x6 normal equations.

    weights: (H, W) robust weights (0 where invalid is fine — invalid lanes
    of r/J are already zeroed).
    """
    w = weights * sys.valid.astype(weights.dtype)
    Jf = sys.J.reshape(-1, 6)
    rf = sys.r.reshape(-1)
    wf = w.reshape(-1)
    Jw = Jf * wf[:, None]
    JtWJ = _einsum("ni,nj->ij", Jw, Jf)
    JtWr = _einsum("ni,n->i", Jw, rf)
    num_valid = jnp.sum(sys.valid)
    err = jnp.sum(wf * rf * rf) / jnp.maximum(num_valid, 1).astype(rf.dtype)
    return NormalEqs(JtWJ, JtWr, err, num_valid)
