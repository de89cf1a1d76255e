"""Banded epipolar SSD search as a Pallas kernel through Triton.

One program per (image row, 128-pixel column tile). The program loads its
tile's 8 pattern taps once and walks the disparity band in registers,
carrying the running best SSD and its column; the (H, W) images are read
straight from device memory (they stay resident in L2), so no per-pixel
pattern stack or (W, W) cost matrix is ever written. The reverse winners
(best left column for each right pixel, for the left-right check) come from
the mirrored pass: the program then owns right-image columns and walks the
band the other way.

SSD is summed directly, sum_k (l_k - r_k)^2, where the XLA path expands it
as |l|^2 + |r|^2 - 2 l.r; the two agree except at SSD near-ties.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from odometry_tpu.kernels.disparity import PATTERN_OFFSETS

_BLOCK = 128
_PAD = 2  # the pattern's reach; images are zero-padded by it on every side
_NO_MATCH = 1e10


def _taps(ref, y, cols, ok, stride):
    """The 8 pattern values at (y, cols) of a zero-padded, flattened image."""
    return [
        plgpu.load(ref.at[(y + _PAD + dy) * stride + cols + (_PAD + dx)],
                   mask=ok, other=0.0)
        for dy, dx in PATTERN_OFFSETS
    ]


def _ssd(a, b):
    s = (a[0] - b[0]) * (a[0] - b[0])
    for ak, bk in zip(a[1:], b[1:]):
        s = s + (ak - bk) * (ak - bk)
    return s


def _forward_kernel(l_ref, r_ref, best_ref, match_ref, *second_ref,
                    width, boundary, d_lo, d_hi, second_excl):
    stride = width + 2 * _PAD
    y = pl.program_id(0)
    x0 = pl.program_id(1) * _BLOCK
    x = x0 + jnp.arange(_BLOCK, dtype=jnp.int32)
    in_img = x < width
    lt = _taps(l_ref, y, x, in_img, stride)
    # Largest disparity any lane of this tile can use: its last column's
    # candidate must stay at or right of `boundary`.
    d_top = jnp.minimum(d_hi, jnp.minimum(x0 + _BLOCK, width) - 1 - boundary)
    n = jnp.maximum(d_top - d_lo + 1, 0)

    def score(i):
        # Descending disparity == ascending candidate column, so a strict `<`
        # keeps the first minimum along the row, as argmin does.
        xr = x - (d_top - i)
        ok = in_img & (xr >= boundary)
        return xr, ok, _ssd(lt, _taps(r_ref, y, xr, ok, stride))

    def body(i, carry):
        best, match = carry
        xr, ok, ssd = score(i)
        take = ok & (ssd < best)
        return jnp.where(take, ssd, best), jnp.where(take, xr, match)

    best, match = lax.fori_loop(
        0, n, body,
        (jnp.full((_BLOCK,), _NO_MATCH, jnp.float32),
         jnp.zeros((_BLOCK,), jnp.int32)))
    plgpu.store(best_ref.at[y * width + x], best, mask=in_img)
    plgpu.store(match_ref.at[y * width + x], match.astype(jnp.float32), mask=in_img)
    if second_ref:
        def body2(i, second):
            xr, ok, ssd = score(i)
            take = ok & (jnp.abs(xr - match) > second_excl) & (ssd < second)
            return jnp.where(take, ssd, second)

        second = lax.fori_loop(
            0, n, body2, jnp.full((_BLOCK,), _NO_MATCH, jnp.float32))
        plgpu.store(second_ref[0].at[y * width + x], second, mask=in_img)


def _reverse_kernel(l_ref, r_ref, rmatch_ref, *, width, boundary, d_lo, d_hi):
    stride = width + 2 * _PAD
    y = pl.program_id(0)
    x0 = pl.program_id(1) * _BLOCK
    xr = x0 + jnp.arange(_BLOCK, dtype=jnp.int32)
    in_img = xr < width
    col_ok = in_img & (xr >= boundary)
    rt = _taps(r_ref, y, xr, in_img, stride)
    d_top = jnp.minimum(d_hi, width - 1 - x0)
    n = jnp.maximum(d_top - d_lo + 1, 0)

    def body(i, carry):
        # Ascending disparity == ascending left column: first minimum.
        best, rmatch = carry
        x = xr + d_lo + i
        ok = col_ok & (x < width)
        ssd = _ssd(_taps(l_ref, y, x, ok, stride), rt)
        take = ok & (ssd < best)
        return jnp.where(take, ssd, best), jnp.where(take, x, rmatch)

    _, rmatch = lax.fori_loop(
        0, n, body,
        (jnp.full((_BLOCK,), _NO_MATCH, jnp.float32),
         jnp.zeros((_BLOCK,), jnp.int32)))
    plgpu.store(rmatch_ref.at[y * width + xr], rmatch.astype(jnp.float32), mask=in_img)


def band_winner_maps(
    left: jax.Array,
    right: jax.Array,
    *,
    boundary: int,
    max_disparity: int | None,
    min_disparity: int | None,
    lr_check: bool,
    second_best: bool,
    second_excl: int,
    interpret: bool = False,
):
    """The :func:`~odometry_tpu.kernels.disparity.disparity_winner_maps`
    contract on (H, W) blurred images: (best, match, rmatch, second)."""
    H, W = left.shape
    d_lo = max(1, min_disparity or 1)
    d_hi = W if max_disparity is None else min(max_disparity, W)
    lp = jnp.pad(left.astype(jnp.float32), _PAD).reshape(-1)
    rp = jnp.pad(right.astype(jnp.float32), _PAD).reshape(-1)
    grid = (H, pl.cdiv(W, _BLOCK))
    params = plgpu.CompilerParams(num_warps=4, num_stages=1)
    # Column indices leave the kernels as f32 (exact below 2^24) so that
    # every operand shares one dtype: pallas_call's checkify rule, which
    # utils/debug.py's checked step runs, needs that.
    flat_f32 = jax.ShapeDtypeStruct((H * W,), jnp.float32)
    fwd_out = [flat_f32] * (3 if second_best else 2)
    outs = pl.pallas_call(
        functools.partial(_forward_kernel, width=W, boundary=boundary,
                          d_lo=d_lo, d_hi=d_hi, second_excl=second_excl),
        out_shape=fwd_out, grid=grid, compiler_params=params,
        interpret=interpret, name="disparity_band_forward",
    )(lp, rp)
    best = outs[0].reshape(H, W)
    match = outs[1].astype(jnp.int32).reshape(H, W)
    second = (outs[2].reshape(H, W) if second_best
              else jnp.full((H, W), _NO_MATCH, jnp.float32))
    if lr_check:
        rmatch = pl.pallas_call(
            functools.partial(_reverse_kernel, width=W, boundary=boundary,
                              d_lo=d_lo, d_hi=d_hi),
            out_shape=flat_f32, grid=grid, compiler_params=params,
            interpret=interpret, name="disparity_band_reverse",
        )(lp, rp).astype(jnp.int32).reshape(H, W)
    else:
        rmatch = jnp.zeros((H, W), jnp.int32)
    return best, match, rmatch, second
