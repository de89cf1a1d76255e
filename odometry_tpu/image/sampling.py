"""Image sampling at scattered coordinates (gathers), jit-safe.

The reference samples the warped image at ``floor`` of the warped coordinate
with no interpolation (``lm_optimizer.cpp:208-217``, flagged "BUG!!!" in its
own source). We provide that exact mode for parity plus a bilinear mode as the
improved default for accuracy-oriented configs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def gather_2d(img: jax.Array, yi: jax.Array, xi: jax.Array) -> jax.Array:
    """img[yi, xi] for integer index arrays of any (matching) shape.

    Indices must already be in-bounds; use clip_gather_2d otherwise.
    """
    h, w = img.shape
    flat = img.reshape(-1)
    idx = yi * w + xi
    return jnp.take(flat, idx.reshape(-1), axis=0).reshape(yi.shape)


def clip_gather_2d(img: jax.Array, yi: jax.Array, xi: jax.Array) -> jax.Array:
    h, w = img.shape
    yi = jnp.clip(yi, 0, h - 1)
    xi = jnp.clip(xi, 0, w - 1)
    return gather_2d(img, yi, xi)


def sample_floor(img: jax.Array, u: jax.Array, v: jax.Array) -> jax.Array:
    """Sample at (floor(v), floor(u)), clipped to bounds.

    Reference parity mode: ``kImg2.at<float>(floor(v), floor(u))``.
    """
    yi = jnp.floor(v).astype(jnp.int32)
    xi = jnp.floor(u).astype(jnp.int32)
    return clip_gather_2d(img, yi, xi)


def sample_bilinear(img: jax.Array, u: jax.Array, v: jax.Array) -> jax.Array:
    """Bilinear sample at continuous (u, v), edges clamped."""
    h, w = img.shape
    u = jnp.clip(u, 0.0, w - 1.0)
    v = jnp.clip(v, 0.0, h - 1.0)
    x0 = jnp.floor(u)
    y0 = jnp.floor(v)
    fx = u - x0
    fy = v - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    x1i = jnp.minimum(x0i + 1, w - 1)
    y1i = jnp.minimum(y0i + 1, h - 1)
    v00 = gather_2d(img, y0i, x0i)
    v01 = gather_2d(img, y0i, x1i)
    v10 = gather_2d(img, y1i, x0i)
    v11 = gather_2d(img, y1i, x1i)
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return top * (1.0 - fy) + bot * fy


# Full-f32 matmul passes for the dtype=float32 mode of sample_channels_mm
# (defined before first use).
_MM_PRECISION = jax.lax.Precision.HIGHEST


def sample_channels_mm(
    imgs: jax.Array,
    u: jax.Array,
    v: jax.Array,
    dtype=jnp.bfloat16,
) -> jax.Array:
    """Gather-free bilinear sampling of C channels at N points via matmuls.

    ``sample(I, u, v) = e_v(v)^T @ I @ e_u(u)`` where e_u/e_v are the 2-tap
    bilinear interpolation one-hot vectors. Stage 1 contracts the width axis
    for all channels at once ((C*H, W) @ (W, N) matmul); stage 2 reduces the
    height axis with per-point weights (elementwise + sum).

    This formulation is dense regular math: ~2x C*H*W*N/row MACs plus
    bandwidth for the interpolation matrices, in place of random gathers.
    Whether it beats the gather path depends on the device's gather cost
    (tools/microbench.py `sample`).

    `dtype` controls matmul input precision: bfloat16 quantizes 0-255 images
    by up to ~1 intensity level (fine for robust tracking, validated on the
    accuracy harness); float32 uses HIGHEST-precision passes at ~2x cost.

    Args:
      imgs: (C, H, W) channel stack sampled at the same points.
      u, v: (N,) continuous pixel coordinates, clipped to the image.

    Returns:
      (C, N) sampled values, float32.
    """
    C, H, W = imgs.shape
    u = jnp.clip(u, 0.0, W - 1.0)
    v = jnp.clip(v, 0.0, H - 1.0)
    x0 = jnp.floor(u)
    y0 = jnp.floor(v)
    fx = (u - x0).astype(dtype)
    fy = (v - y0).astype(jnp.float32)
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    precision = _MM_PRECISION if dtype == jnp.float32 else None
    cols = jax.lax.broadcasted_iota(jnp.int32, (W,) + u.shape, 0)
    Eu = jnp.where(
        cols == x0i[None, :],
        (1 - fx)[None, :],
        jnp.where(cols == x0i[None, :] + 1, fx[None, :], jnp.asarray(0, dtype)),
    ).astype(dtype)
    M = jax.lax.dot_general(
        imgs.astype(dtype).reshape(C * H, W),
        Eu,
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=precision,
    ).reshape(C, H, -1)
    rows = jax.lax.broadcasted_iota(jnp.int32, (H,) + v.shape, 0)
    Ev = jnp.where(
        rows == y0i[None, :],
        (1 - fy)[None, :],
        jnp.where(rows == y0i[None, :] + 1, fy[None, :], 0.0),
    )
    return jnp.sum(M * Ev[None], axis=1)


def sample_bilinear_mm(img: jax.Array, u: jax.Array, v: jax.Array,
                       dtype=jnp.bfloat16) -> jax.Array:
    """Single-channel :func:`sample_channels_mm`."""
    return sample_channels_mm(img[None], u, v, dtype)[0]


def remap_bilinear(img: jax.Array, map_u: jax.Array, map_v: jax.Array) -> jax.Array:
    """cv::remap equivalent: dst[y, x] = img(map_v[y,x], map_u[y,x]) bilinear.

    Used to apply precomputed undistort/rectify grids (``camera.cpp:79``).
    """
    return sample_bilinear(img, map_u, map_v)
