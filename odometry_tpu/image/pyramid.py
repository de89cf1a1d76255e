"""Image/depth pyramid ops as dense tensor math (replaces OpenCV usage).

Semantics match the reference exactly where it matters for trajectory parity:

* Gaussian 3x3 blur == ``cv::GaussianBlur(img, 3x3, sigma=0)`` which OpenCV
  resolves to the fixed separable kernel [1/4, 1/2, 1/4] with REFLECT_101
  borders (used at ``image_processing_global.cpp:30`` and
  ``depth_estimate.cpp:256-257``).
* ``pyr_down`` == ``cv::pyrDown``: separable [1,4,6,4,1]/16 blur with
  REFLECT_101 borders, then even-index decimation, output floor(n/2) as the
  reference forces via ``cv::Size(cols/2, rows/2)``
  (``image_processing_global.cpp:38,46``).
* The image pyramid's level 1 is built from the UNsmoothed input — a quirk of
  the reference (``image_processing_global.cpp:34-38``) that we reproduce.
* Depth pyramids decimate at odd indices with no averaging, preserving sparse
  validity (``image_processing_global.cpp:85-103``).

All functions are jit-safe with static shapes.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

GAUSS3 = (0.25, 0.5, 0.25)
GAUSS5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _reflect101_pad(img: jax.Array, r: int) -> jax.Array:
    """Pad by r on each side of both axes with OpenCV BORDER_REFLECT_101."""
    return jnp.pad(img, ((r, r), (r, r)), mode="reflect")


def _sep_conv(img: jax.Array, taps) -> jax.Array:
    """Separable 2D convolution with REFLECT_101 borders via shifted sums.

    Small odd tap counts only; XLA fuses the shifts+adds into one kernel.
    """
    r = len(taps) // 2
    h, w = img.shape
    p = _reflect101_pad(img, r)
    # Horizontal pass over rows [r : r+h) of the padded image.
    horiz = jnp.zeros((h + 2 * r, w), dtype=img.dtype)
    for i, t in enumerate(taps):
        horiz = horiz + jnp.float32(t) * jax.lax.dynamic_slice(p, (0, i), (h + 2 * r, w))
    out = jnp.zeros((h, w), dtype=img.dtype)
    for i, t in enumerate(taps):
        out = out + jnp.float32(t) * jax.lax.dynamic_slice(horiz, (i, 0), (h, w))
    return out


def gaussian_blur3(img: jax.Array) -> jax.Array:
    """cv::GaussianBlur(img, Size(3,3), 0) equivalent."""
    return _sep_conv(img, GAUSS3)


def pyr_down(img: jax.Array) -> jax.Array:
    """cv::pyrDown with forced floor(n/2) output size: separable 5-tap blur,
    then even-index decimation by a strided slice."""
    h, w = img.shape
    oh, ow = h // 2, w // 2
    blurred = _sep_conv(img, GAUSS5)
    return blurred[: 2 * oh : 2, : 2 * ow : 2]


def median_blur3(img: jax.Array) -> jax.Array:
    """3x3 median with REPLICATE borders (cv::medianBlur semantics)."""
    p = jnp.pad(img, 1, mode="edge")
    h, w = img.shape
    stack = jnp.stack(
        [p[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)], axis=0
    )
    return jnp.median(stack, axis=0)


def gaussian_image_pyramid(
    img: jax.Array, num_levels: int, smooth: bool = True
) -> Tuple[jax.Array, ...]:
    """The reference's ``GaussianImagePyramidNaive``.

    level 0 = blur3(img) (or raw copy), level 1 = pyrDown(RAW img),
    level l>=2 = pyrDown(level l-1).
    """
    levels = [gaussian_blur3(img) if smooth else img]
    if num_levels > 1:
        levels.append(pyr_down(img))
    for _ in range(2, num_levels):
        levels.append(pyr_down(levels[-1]))
    return tuple(levels)


def depth_pyramid(
    dep: jax.Array, num_levels: int, smooth: bool = False, indexing: str = "odd"
) -> Tuple[jax.Array, ...]:
    """The reference's ``MedianDepthPyramidNaive``: decimation, no averaging.

    indexing="odd" reproduces the reference exactly (``out[l](y,x) =
    out[l-1](2y+1, 2x+1)``, image_processing_global.cpp:85-103). NOTE this is
    misaligned with the image pyramid, whose pyrDown samples EVEN indices: at
    level l the depth stored at pixel x belongs to image pixel x*2^l + 2^l - 1,
    a (2^l - 1)-pixel offset that degrades sparse-depth tracking at coarse
    levels. indexing="even" is the corrected aligned mode.
    """
    if indexing not in ("odd", "even"):
        raise ValueError(f"bad indexing mode {indexing!r}")
    off = 1 if indexing == "odd" else 0
    levels = [median_blur3(dep) if smooth else dep]
    for _ in range(1, num_levels):
        prev = levels[-1]
        oh, ow = prev.shape[0] // 2, prev.shape[1] // 2
        levels.append(prev[off : off + 2 * oh : 2, off : off + 2 * ow : 2])
    return tuple(levels)


def central_gradients(img: jax.Array):
    """Clamped central-difference gradients over the whole image.

    Matches ``ComputePixelGradient`` (``image_processing_global.h:62-69``):
    neighbours are clamped to the image, so border pixels use a one-sided
    half-difference.
    """
    right = jnp.concatenate([img[:, 1:], img[:, -1:]], axis=1)
    left = jnp.concatenate([img[:, :1], img[:, :-1]], axis=1)
    down = jnp.concatenate([img[1:, :], img[-1:, :]], axis=0)
    up = jnp.concatenate([img[:1, :], img[:-1, :]], axis=0)
    gx = 0.5 * (right - left)
    gy = 0.5 * (down - up)
    return gx, gy


def gradient_magnitude(img: jax.Array) -> jax.Array:
    gx, gy = central_gradients(img)
    return jnp.sqrt(gx * gx + gy * gy)
