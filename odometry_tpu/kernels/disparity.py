"""Epipolar 8-point-pattern SSD disparity search as dense tensor math.

The reference scans each selected pixel's full epipolar segment with an AVX
SSD kernel (``depth_estimate.cpp:345-398``, ``ComputeSsdPattern8Sse
:435-453``). Here the whole search is matrix math:

With the 8-point DSO residual pattern stacked into per-pixel pattern vectors
``P_L[:, x]`` and ``P_R[:, xr]`` (shape (8, W) per row), the SSD between left
pixel x and right candidate xr expands to

    SSD(x, xr) = ||P_L[:,x]||^2 + ||P_R[:,xr]||^2 - 2 P_L[:,x] . P_R[:,xr]

so one (W, 8) @ (8, W) matmul per row scores *every* (pixel, candidate) pair,
and the winner-take-all over candidates is a masked argmin reduction. Rows
are batched through `lax.map` so the per-chunk cost volume stays small. On
the GPU, :func:`disparity_winner_maps` runs the banded Pallas/Triton kernel
of :mod:`odometry_tpu.kernels.disparity_triton` instead, which scores only
the band and writes no cost volume.

Pattern offsets (dy, dx), identical to ``ComputeSsdPattern8``
(``depth_estimate.cpp:420-433``): (-2,0), (-1,-1), (-1,+1), (0,-2), (0,0),
(0,+2), (+1,-1), (+2,0).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)

PATTERN_OFFSETS = ((-2, 0), (-1, -1), (-1, 1), (0, -2), (0, 0), (0, 2), (1, -1), (2, 0))


def pattern_stack(img: jax.Array) -> jax.Array:
    """(H, W) -> (8, H, W): the 8-point pattern value at each pixel.

    Border lanes read zero-padded neighbours; callers only use pixels at least
    `boundary >= 2` away from the edge, where all offsets are in-bounds.
    """
    H, W = img.shape
    padded = jnp.pad(img, 2)
    return jnp.stack(
        [padded[2 + dy : 2 + dy + H, 2 + dx : 2 + dx + W] for dy, dx in PATTERN_OFFSETS]
    )


class DisparityResult(NamedTuple):
    disparity: jax.Array  # (H, W) float, 0 where no accepted match
    inv_depth: jax.Array  # (H, W) float = disparity / (fx * baseline)
    matched: jax.Array  # (H, W) bool: SSD winner passed the threshold
    best_ssd: jax.Array  # (H, W) float (1e10 where no candidates)


def disparity_search(
    left: jax.Array,
    right: jax.Array,
    select_mask: jax.Array,
    *,
    fx: float,
    baseline: float,
    boundary: int = 4,
    ssd_th: float = 900.0,
    max_disparity: int | None = None,
    min_disparity: int | None = None,
    row_chunk: int = 8,
    lr_check: bool = False,
    lr_tol: int = 1,
) -> DisparityResult:
    """Full-search stereo matching for selected pixels (dense-map API).

    Matches the reference scan ``for right_x in [boundary, x)`` with
    first-minimum tie-breaking (strict `<` update at ``depth_estimate.cpp:385``
    == argmin's first-occurrence rule). `left`/`right` should be the blurred
    images. A finite `max_disparity` additionally bounds the scan
    (throughput configs; None == exact reference behaviour). `row_chunk`
    sizes the cost-matrix search's per-chunk cost volume only.

    lr_check=True (beyond-reference) additionally requires left->right and
    right->left winners to agree within `lr_tol` pixels — in this cost-matrix
    formulation the reverse match is just an argmin over the other axis of the
    SAME per-row cost matrix, so the check is nearly free and kills the
    accidental-match outliers a lone SSD threshold lets through.

    NOTE the production frontend (depth/estimator.py) consumes
    :func:`disparity_winner_maps` + its own lane-level finalize instead: this
    dense path's lr-check gather (``take_along_axis`` over the full image)
    touches every pixel, where the frontend gathers only the <=16k
    extracted lanes.
    """
    best, match, rmatch, _ = disparity_winner_maps(
        left, right,
        boundary=boundary, max_disparity=max_disparity,
        min_disparity=min_disparity, row_chunk=row_chunk,
        lr_check=lr_check,
    )
    return _finalize(
        left, best, match, rmatch, select_mask,
        fx=fx, baseline=baseline, boundary=boundary, ssd_th=ssd_th,
        lr_check=lr_check, lr_tol=lr_tol,
    )


def disparity_winner_maps(
    left: jax.Array,
    right: jax.Array,
    *,
    boundary: int = 4,
    max_disparity: int | None = None,
    min_disparity: int | None = None,
    row_chunk: int = 8,
    lr_check: bool = False,
    second_best: bool = False,
    second_excl: int = 2,
):
    """(best, match, rmatch, second) dense winner maps.

    best[y, x] = best SSD for left pixel x; match[y, x] = its right-image
    column; rmatch[y, xr] = best left column for right pixel xr (zeros when
    lr_check=False); second[y, x] = best SSD outside a +-2 px exclusion
    window around the winner (1e10 fill when `second_best` is False or no
    other candidate exists) for the uniqueness/ratio test. Thresholding and
    assembly are left to the caller.

    Lowered for CUDA this runs the band kernel of
    :mod:`odometry_tpu.kernels.disparity_triton`; elsewhere the cost-matrix
    search below (`row_chunk` sizes its per-chunk cost volume).
    """
    kw = dict(boundary=boundary, max_disparity=max_disparity,
              min_disparity=min_disparity, lr_check=lr_check,
              second_best=second_best, second_excl=second_excl)

    def band_kernel(a, b):
        from odometry_tpu.kernels import disparity_triton

        return disparity_triton.band_winner_maps(a, b, **kw)

    return jax.lax.platform_dependent(
        left, right, cuda=band_kernel,
        default=lambda a, b: cost_matrix_winner_maps(a, b, row_chunk=row_chunk, **kw),
    )


def cost_matrix_winner_maps(
    left, right, *, boundary, max_disparity, min_disparity, row_chunk=8,
    lr_check, second_best, second_excl,
):
    """:func:`disparity_winner_maps` as (W, W) cost matrices per row chunk."""
    H, W = left.shape
    PL = pattern_stack(left)  # (8, H, W)
    PR = pattern_stack(right)
    ln = jnp.sum(PL * PL, axis=0)  # (H, W)
    rn = jnp.sum(PR * PR, axis=0)

    xs = jax.lax.broadcasted_iota(jnp.int32, (W, W), 0)  # left pixel x
    xr = jax.lax.broadcasted_iota(jnp.int32, (W, W), 1)  # right candidate
    cand_ok = (xr >= boundary) & (xr < xs)
    if max_disparity is not None:
        cand_ok = cand_ok & (xs - xr <= max_disparity)
    if min_disparity is not None:
        cand_ok = cand_ok & (xs - xr >= min_disparity)

    pad_rows = (-H) % row_chunk
    PLp = jnp.pad(PL, ((0, 0), (0, pad_rows), (0, 0)))
    PRp = jnp.pad(PR, ((0, 0), (0, pad_rows), (0, 0)))
    lnp = jnp.pad(ln, ((0, pad_rows), (0, 0)))
    rnp = jnp.pad(rn, ((0, pad_rows), (0, 0)))
    nchunks = (H + pad_rows) // row_chunk

    def score_chunk(args):
        pl, pr, lnc, rnc = args  # (8, RB, W), ..., (RB, W)
        cross = _einsum("kbx,kby->bxy", pl, pr)  # (RB, W, W)
        ssd = lnc[:, :, None] + rnc[:, None, :] - 2.0 * cross
        ssd = jnp.where(cand_ok[None], ssd, jnp.float32(1e10))
        best = jnp.min(ssd, axis=2)
        match = jnp.argmin(ssd, axis=2).astype(jnp.int32)
        if lr_check:
            # Reverse winner per right pixel over the same cost matrix.
            rmatch = jnp.argmin(ssd, axis=1).astype(jnp.int32)
        else:
            rmatch = jnp.zeros_like(match)
        if second_best:
            # Runner-up outside the +-second_excl exclusion window around
            # the winner (the ratio/uniqueness test numerator's rival).
            near = jnp.abs(xr[None] - match[:, :, None]) <= second_excl
            second = jnp.min(jnp.where(near, jnp.float32(1e10), ssd), axis=2)
        else:
            second = jnp.full_like(best, 1e10)
        return best, match, rmatch, second

    pl_c = PLp.reshape(8, nchunks, row_chunk, W).transpose(1, 0, 2, 3)
    pr_c = PRp.reshape(8, nchunks, row_chunk, W).transpose(1, 0, 2, 3)
    ln_c = lnp.reshape(nchunks, row_chunk, W)
    rn_c = rnp.reshape(nchunks, row_chunk, W)
    best, match, rmatch, second = jax.lax.map(
        score_chunk, (pl_c, pr_c, ln_c, rn_c)
    )
    best = best.reshape(-1, W)[:H]
    match = match.reshape(-1, W)[:H]
    rmatch = rmatch.reshape(-1, W)[:H]
    second = second.reshape(-1, W)[:H]
    return best, match, rmatch, second


def _finalize(
    left, best, match, rmatch, select_mask, *,
    fx, baseline, boundary, ssd_th, lr_check, lr_tol,
) -> DisparityResult:
    """Winner thresholding + optional LR consistency + map assembly."""
    H, W = left.shape
    ys_f = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xs_f = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    row_ok = (ys_f >= boundary) & (ys_f < H - boundary) & (xs_f < W - boundary)
    matched = select_mask & row_ok & (best <= ssd_th)
    if lr_check:
        # Cycle consistency: the winner's reverse winner must land back on x.
        back = jnp.take_along_axis(rmatch, jnp.clip(match, 0, W - 1), axis=1)
        matched = matched & (jnp.abs(back - xs_f) <= lr_tol)

    disp = (xs_f - match).astype(jnp.float32)
    disp = jnp.where(matched, disp, 0.0)
    inv_depth = disp / jnp.float32(fx * baseline)
    best = jnp.where(select_mask & row_ok, best, jnp.float32(1e10))
    return DisparityResult(disp, inv_depth, matched, best)


def disparity_search_reference(
    left: jax.Array,
    right: jax.Array,
    select_mask: jax.Array,
    *,
    fx: float,
    baseline: float,
    boundary: int = 4,
    ssd_th: float = 900.0,
):
    """Slow direct-SSD golden model (no matmul expansion) for parity tests."""
    import numpy as np

    left = np.asarray(left)
    right = np.asarray(right)
    mask = np.asarray(select_mask)
    H, W = left.shape
    disp = np.zeros((H, W), np.float32)
    inv_depth = np.zeros((H, W), np.float32)
    matched = np.zeros((H, W), bool)
    best_map = np.full((H, W), 1e10, np.float32)

    def pat(img, y, x):
        return np.array([img[y + dy, x + dx] for dy, dx in PATTERN_OFFSETS], np.float32)

    for y in range(boundary, H - boundary):
        for x in range(boundary, W - boundary):
            if not mask[y, x]:
                continue
            pl = pat(left, y, x)
            smallest = 1e10
            match = -1
            for rx in range(boundary, x):
                ssd = float(np.sum((pl - pat(right, y, rx)) ** 2))
                if ssd < smallest:
                    smallest = ssd
                    match = rx
            best_map[y, x] = smallest
            if smallest <= ssd_th:
                matched[y, x] = True
                disp[y, x] = abs(x - match)
                inv_depth[y, x] = disp[y, x] / (fx * baseline)
    return disp, inv_depth, matched, best_map
