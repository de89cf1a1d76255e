"""Stereo semi-dense inverse-depth frontend: select -> match -> refine -> filter.

Batched-tensor equivalent of ``DepthEstimator`` (``src/depth_estimate.cpp``):

  1. 3x3 Gaussian blur of both rectified images (``:256-257``),
  2. blockwise adaptive gradient selection  (kernels/select.py),
  3. full epipolar SSD disparity search      (kernels/disparity.py),
  4. per-pixel scalar inverse-depth LM refinement — the reference's
     ``DepthOptimization`` (``:80-198``) where every pixel's depth is
     independent, so J^T W J is diagonal and the whole LM loop is dense
     element-wise math under a ``lax.while_loop``,
  5. photometric + depth-range filtering with a minimum-survivor guard
     (``:176-197``).

Everything is fixed-shape masked math: the reference's gathered point list
becomes the (H, W) selection mask itself.

Known deviation (guarded reference bug): the reference zeroes J and b for
points whose warp leaves the image but then computes delta = b / (A=0) -> NaN
which silently poisons those points (``depth_estimate.cpp:217-224,164-166``).
We define delta = 0 there instead; such points keep their depth and are still
culled by the -1000 sentinel at filter time, which is the evident intent.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from odometry_tpu.config import CameraConfig, DepthConfig
from odometry_tpu.image.pyramid import gaussian_blur3
from odometry_tpu.image.sampling import clip_gather_2d, sample_bilinear
from odometry_tpu.kernels.points import PointSet, extract_points
from odometry_tpu.kernels.select import select_points

_SENTINEL = -1000.0  # depth_estimate.cpp:221


class DepthResult(NamedTuple):
    valid: jax.Array  # (H, W) bool final validity mask
    disparity: jax.Array  # (H, W) raw search disparity (pixels)
    inv_depth: jax.Array  # (H, W) refined inverse depth (1/m), 0 where invalid
    ok: jax.Array  # bool: >= min_valid_points survivors (frame status)
    num_valid: jax.Array  # int survivors
    iters: jax.Array  # refinement LM iterations run
    cost: jax.Array  # final refinement cost


class _RefineCarry(NamedTuple):
    tmp: jax.Array  # attempted inverse-depth map
    current: jax.Array  # best-so-far
    pre: jax.Array  # previous best
    resid: jax.Array  # |r| map from the LAST evaluation (sentinel where OOB)
    err_last: jax.Array
    err_now: jax.Array
    lam: jax.Array
    it: jax.Array
    active: jax.Array


def _eval_system(
    d: jax.Array,
    left: jax.Array,
    right: jax.Array,
    mask: jax.Array,
    tx_fx: float,
    huber_delta: float,
    interp: str = "floor",
):
    """Reference ``ComputeResidualJacobian`` (depth_estimate.cpp:200-242), dense.

    interp="floor" is the reference's integer warp; "bilinear" samples the
    right image at the true sub-pixel warp (improved mode).
    """
    H, W = left.shape
    xs = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    warped_xf = xs - tx_fx * d
    warped_x = jnp.floor(warped_xf).astype(jnp.int32)
    in_bounds = (warped_x >= 2) & (warped_x <= W - 2) & mask

    wx = jnp.clip(warped_x, 1, W - 2)
    if interp == "floor":
        r = left - clip_gather_2d(right, ys, wx)
        g = tx_fx * 0.5 * (clip_gather_2d(right, ys, wx + 1) - clip_gather_2d(right, ys, wx - 1))
    elif interp in ("bilinear", "mm"):  # dense path: mm == bilinear semantics
        from odometry_tpu.image.sampling import sample_bilinear

        uw = jnp.clip(warped_xf, 1.0, jnp.float32(W - 2))
        yf = ys.astype(jnp.float32)
        r = left - sample_bilinear(right, uw, yf)
        g = tx_fx * 0.5 * (
            sample_bilinear(right, uw + 1.0, yf) - sample_bilinear(right, uw - 1.0, yf)
        )
    else:
        raise ValueError(f"unknown interp mode {interp!r}")
    w = jnp.where(jnp.abs(r) <= huber_delta, 1.0, huber_delta / jnp.maximum(jnp.abs(r), 1e-12))

    ibf = in_bounds.astype(jnp.float32)
    jtwj = g * g * w * ibf
    b = -g * w * r * ibf
    resid = jnp.where(in_bounds, jnp.abs(r), jnp.float32(_SENTINEL))
    n_act = jnp.sum(ibf)
    err = jnp.where(n_act > 0, jnp.sum(r * r * w * ibf) / jnp.maximum(n_act, 1.0), jnp.float32(jnp.inf))
    return jtwj, b, resid, err


def refine_depth(
    left: jax.Array,
    right: jax.Array,
    inv_depth0: jax.Array,
    mask: jax.Array,
    cam: CameraConfig,
    cfg: DepthConfig,
):
    """Diagonal per-pixel inverse-depth LM (``DepthOptimization``, :141-168)."""
    tx_fx = cam.baseline * cam.fx

    def cond(c: _RefineCarry):
        return c.active & (c.it < cfg.max_iters)

    def body(c: _RefineCarry):
        jtwj, b, resid, err_now = _eval_system(
            c.tmp, left, right, mask, tx_fx, cfg.huber_delta, cfg.interp
        )
        bad = err_now > c.err_last
        lam_up = c.lam * cfg.lambda_up
        lam_down = jnp.maximum(c.lam / cfg.lambda_down, cfg.lambda_min)
        lam_new = jnp.where(bad, lam_up, lam_down)
        break_bad = bad & (lam_up > cfg.lambda_max)
        current = jnp.where(bad, c.pre, c.tmp)
        pre = current
        break_good = (~bad) & (err_now / c.err_last > cfg.precision)
        err_last = jnp.where(bad, c.err_last, err_now)
        active = ~(break_bad | break_good)

        # A is diagonal: delta_i = b_i / (jtwj_i * (1 + lambda)); guarded where
        # jtwj == 0 (see module docstring).
        denom = jtwj * (1.0 + lam_new)
        delta = jnp.where(denom > 0, b / jnp.where(denom > 0, denom, 1.0), 0.0)
        tmp = current + delta
        return _RefineCarry(tmp, current, pre, resid, err_last, err_now, lam_new, c.it + 1, active)

    f32 = jnp.float32
    H, W = left.shape
    init = _RefineCarry(
        tmp=inv_depth0,
        current=inv_depth0,
        pre=inv_depth0,
        resid=jnp.zeros((H, W), f32),
        err_last=jnp.asarray(1e10, f32),
        err_now=jnp.asarray(0.0, f32),
        lam=jnp.asarray(cfg.lambda_init, f32),
        it=jnp.asarray(0, jnp.int32),
        active=jnp.asarray(True),
    )
    out = jax.lax.while_loop(cond, body, init)
    return out.current, out.resid, out.it, out.err_now


def _eval_system_points(
    d: jax.Array,
    left_I: jax.Array,
    right: jax.Array,
    ys_i: jax.Array,
    xs_f: jax.Array,
    pvalid: jax.Array,
    width: int,
    tx_fx: float,
    huber_delta: float,
    interp: str,
    gxr: jax.Array | None = None,
    chan: jax.Array | None = None,
):
    """Sparse ``ComputeResidualJacobian``: all arrays are (cap,) point lanes.

    `gxr` is the precomputed central x-gradient of `right`; sampling it at the
    warped column reproduces the reference's 0.5*(R[wx+1]-R[wx-1]) exactly
    while halving the per-iteration gather count.

    interp="mm" samples the (right, gxr) stack `chan` gather-free via
    one-hot matmuls (rows are exact: the stereo warp never leaves the
    epipolar line, so the vertical interpolation weight is a one-hot).
    """
    W = width
    warped_xf = xs_f - tx_fx * d
    warped_x = jnp.floor(warped_xf).astype(jnp.int32)
    in_bounds = (warped_x >= 2) & (warped_x <= W - 2) & pvalid
    wx = jnp.clip(warped_x, 1, W - 2)
    if interp == "mm":
        from odometry_tpu.image.sampling import sample_channels_mm

        uw = jnp.clip(warped_xf, 1.0, jnp.float32(W - 2))
        Rw, Gw = sample_channels_mm(chan, uw, ys_i.astype(jnp.float32))
        r = left_I - Rw
        g = tx_fx * Gw
    elif interp == "floor":
        r = left_I - clip_gather_2d(right, ys_i, wx)
        if gxr is not None:
            g = tx_fx * clip_gather_2d(gxr, ys_i, wx)
        else:
            g = tx_fx * 0.5 * (
                clip_gather_2d(right, ys_i, wx + 1) - clip_gather_2d(right, ys_i, wx - 1)
            )
    else:
        uw = jnp.clip(warped_xf, 1.0, jnp.float32(W - 2))
        yf = ys_i.astype(jnp.float32)
        r = left_I - sample_bilinear(right, uw, yf)
        if gxr is not None:
            g = tx_fx * clip_gather_2d(gxr, ys_i, jnp.round(uw).astype(jnp.int32))
        else:
            g = tx_fx * 0.5 * (
                sample_bilinear(right, uw + 1.0, yf) - sample_bilinear(right, uw - 1.0, yf)
            )
    w = jnp.where(jnp.abs(r) <= huber_delta, 1.0, huber_delta / jnp.maximum(jnp.abs(r), 1e-12))
    ibf = in_bounds.astype(jnp.float32)
    jtwj = g * g * w * ibf
    b = -g * w * r * ibf
    resid = jnp.where(in_bounds, jnp.abs(r), jnp.float32(_SENTINEL))
    n_act = jnp.sum(ibf)
    err = jnp.where(n_act > 0, jnp.sum(r * r * w * ibf) / jnp.maximum(n_act, 1.0), jnp.float32(jnp.inf))
    return jtwj, b, resid, err


def refine_depth_points(
    left: jax.Array,
    right: jax.Array,
    pts: PointSet,
    cam: CameraConfig,
    cfg: DepthConfig,
):
    """Point-lane version of :func:`refine_depth` (the production path).

    `pts.inv_depth` carries the search-initialized inverse depth. Returns
    (refined (cap,), resid (cap,), iters, cost).
    """
    tx_fx = cam.baseline * cam.fx
    W = left.shape[1]
    ys_i = pts.ys.astype(jnp.int32)
    xs_f = pts.xs
    left_I = clip_gather_2d(left, ys_i, pts.xs.astype(jnp.int32))
    # Central x-gradient of the right image, once per frame.
    from odometry_tpu.image.pyramid import central_gradients

    gxr, _ = central_gradients(right)
    chan = jnp.stack([right, gxr]) if cfg.interp == "mm" else None

    def cond(c: _RefineCarry):
        return c.active & (c.it < cfg.max_iters)

    def body(c: _RefineCarry):
        jtwj, b, resid, err_now = _eval_system_points(
            c.tmp, left_I, right, ys_i, xs_f, pts.valid, W, tx_fx,
            cfg.huber_delta, cfg.interp, gxr, chan,
        )
        bad = err_now > c.err_last
        lam_up = c.lam * cfg.lambda_up
        lam_down = jnp.maximum(c.lam / cfg.lambda_down, cfg.lambda_min)
        lam_new = jnp.where(bad, lam_up, lam_down)
        break_bad = bad & (lam_up > cfg.lambda_max)
        current = jnp.where(bad, c.pre, c.tmp)
        pre = current
        break_good = (~bad) & (err_now / c.err_last > cfg.precision)
        err_last = jnp.where(bad, c.err_last, err_now)
        active = ~(break_bad | break_good)
        denom = jtwj * (1.0 + lam_new)
        delta = jnp.where(denom > 0, b / jnp.where(denom > 0, denom, 1.0), 0.0)
        tmp = current + delta
        return _RefineCarry(tmp, current, pre, resid, err_last, err_now, lam_new, c.it + 1, active)

    f32 = jnp.float32
    cap = pts.xs.shape[0]
    init = _RefineCarry(
        tmp=pts.inv_depth,
        current=pts.inv_depth,
        pre=pts.inv_depth,
        resid=jnp.zeros((cap,), f32),
        err_last=jnp.asarray(1e10, f32),
        err_now=jnp.asarray(0.0, f32),
        lam=jnp.asarray(cfg.lambda_init, f32),
        it=jnp.asarray(0, jnp.int32),
        active=jnp.asarray(True),
    )
    out = jax.lax.while_loop(cond, body, init)
    return out.current, out.resid, out.it, out.err_now


def refine_depth_points_patch(
    left: jax.Array,
    right: jax.Array,
    pts: PointSet,
    cam: CameraConfig,
    cfg: DepthConfig,
    half_width: int = 7,
):
    """Window-patch inverse-depth refinement (the production path).

    The full-image path (:func:`refine_depth_points`) pays ~5 gathers of
    (cap,) <- (H, W) per LM iteration. With the drift
    cap (DepthConfig.refine_max_shift ~ 1.5 px) refinement is BY DESIGN a
    sub-pixel polish inside a few px of the integer search winner, so this
    path gathers one (cap, 2*half_width+1) window of the right image around
    each lane's winner ONCE, then every LM iteration is pure lane math over
    the resident patch (two tiny (cap, W_patch) take_along gathers). The
    attempted disparity is clamped to the window interior — a trust region
    consistent with the drift filter that culls larger wanderers anyway.

    Same LM schedule/filters as the reference ``DepthOptimization``
    (depth_estimate.cpp:141-168); bilinear sub-pixel sampling semantics.
    """
    tx_fx = cam.baseline * cam.fx
    W = left.shape[1]
    hw = half_width
    ys_i = pts.ys.astype(jnp.int32)
    left_I = clip_gather_2d(left, ys_i, pts.xs.astype(jnp.int32))

    # Patch of the right image around each lane's warp start (the search
    # winner): columns base-hw .. base+hw, one gather total.
    x0f = pts.xs - tx_fx * pts.inv_depth
    base = jnp.clip(jnp.round(x0f).astype(jnp.int32), hw, W - 1 - hw)
    offs = jnp.arange(-hw, hw + 1, dtype=jnp.int32)
    cols = base[:, None] + offs[None, :]
    patch = right[ys_i[:, None], cols]  # (cap, 2hw+1)
    # Central x-gradient of the patch (interior taps only).
    gpatch = 0.5 * (patch[:, 2:] - patch[:, :-2])  # (cap, 2hw-1)

    lo = (base - (hw - 2)).astype(jnp.float32)
    hi = (base + (hw - 2)).astype(jnp.float32)

    # Gather-free window interpolation: linear interp at position p over a
    # K-tap resident window is the hat-weighted sum sum_k w[k]*hat(p - k) —
    # pure (cap, K) lane math, with no gather inside the LM iteration.
    taps_p = jnp.arange(2 * hw + 1, dtype=jnp.float32)[None, :]
    taps_g = jnp.arange(1, 2 * hw, dtype=jnp.float32)[None, :]

    def sample(warped_xf):
        relp = jnp.clip(
            warped_xf - (base.astype(jnp.float32) - hw), 1.0, 2 * hw - 1.0
        )[:, None]
        val = jnp.sum(patch * jnp.maximum(0.0, 1.0 - jnp.abs(relp - taps_p)), axis=1)
        # Gradient at the NEAREST tap — the exact semantics of the full-image
        # bilinear path (gxr gathered at round(uw)); box weights instead of a
        # one-hot gather.
        grad = jnp.sum(gpatch * (jnp.abs(relp - taps_g) <= 0.5), axis=1)
        return val, grad

    def eval_system(d):
        warped_xf = pts.xs - tx_fx * d
        in_bounds = (warped_xf >= lo) & (warped_xf <= hi) & pts.valid
        val, grad = sample(warped_xf)
        r = left_I - val
        g = tx_fx * grad
        w = jnp.where(jnp.abs(r) <= cfg.huber_delta, 1.0,
                      cfg.huber_delta / jnp.maximum(jnp.abs(r), 1e-12))
        ibf = in_bounds.astype(jnp.float32)
        jtwj = g * g * w * ibf
        b = -g * w * r * ibf
        resid = jnp.where(in_bounds, jnp.abs(r), jnp.float32(_SENTINEL))
        n_act = jnp.sum(ibf)
        err = jnp.where(
            n_act > 0,
            jnp.sum(r * r * w * ibf) / jnp.maximum(n_act, 1.0),
            jnp.float32(jnp.inf),
        )
        return jtwj, b, resid, err

    def cond(carry):
        c, _esc = carry
        return c.active & (c.it < cfg.max_iters)

    def body(carry):
        c, esc = carry
        jtwj, b, resid, err_now = eval_system(c.tmp)
        bad = err_now > c.err_last
        lam_up = c.lam * cfg.lambda_up
        lam_down = jnp.maximum(c.lam / cfg.lambda_down, cfg.lambda_min)
        lam_new = jnp.where(bad, lam_up, lam_down)
        break_bad = bad & (lam_up > cfg.lambda_max)
        current = jnp.where(bad, c.pre, c.tmp)
        pre = current
        break_good = (~bad) & (err_now / c.err_last > cfg.precision)
        err_last = jnp.where(bad, c.err_last, err_now)
        active = ~(break_bad | break_good)
        denom = jtwj * (1.0 + lam_new)
        delta = jnp.where(denom > 0, b / jnp.where(denom > 0, denom, 1.0), 0.0)
        tmp_raw = current + delta
        # Trust region: clamp the attempted warp inside the resident window —
        # and PERMANENTLY mark lanes the clamp bites. An escape attempt means
        # the lane wants a different photometric basin, not a sub-pixel
        # polish; the full-image path lets such lanes wander and culls them
        # via the drift filter, and rescuing them by clamping was measured to
        # re-poison the depth map (sweep tails 0.10 -> 0.71 on one cell).
        tmp = jnp.clip(tmp_raw, (pts.xs - hi) / tx_fx, (pts.xs - lo) / tx_fx)
        esc = esc | (tmp != tmp_raw)
        return (
            _RefineCarry(tmp, current, pre, resid, err_last, err_now,
                         lam_new, c.it + 1, active),
            esc,
        )

    f32 = jnp.float32
    cap = pts.xs.shape[0]
    init = _RefineCarry(
        tmp=pts.inv_depth,
        current=pts.inv_depth,
        pre=pts.inv_depth,
        resid=jnp.zeros((cap,), f32),
        err_last=jnp.asarray(1e10, f32),
        err_now=jnp.asarray(0.0, f32),
        lam=jnp.asarray(cfg.lambda_init, f32),
        it=jnp.asarray(0, jnp.int32),
        active=jnp.asarray(True),
    )
    out, escaped = jax.lax.while_loop(cond, body, (init, jnp.zeros((cap,), bool)))
    return out.current, out.resid, out.it, out.err_now, escaped


def search_band(cam: CameraConfig, cfg: DepthConfig):
    """(max_disparity, min_disparity) of the stereo search; None = unbounded."""
    max_disp = cfg.max_disparity
    min_disp = None
    if cfg.range_limited_search:
        # Clamp to the image width: a 0.1 m min_depth implies a 3861 px
        # "band" at KITTI intrinsics, which is full search.
        band_max = min(int(cam.fx * cam.baseline / cfg.min_depth) + 1, cam.width)
        max_disp = band_max if max_disp is None else min(max_disp, band_max)
        min_disp = max(1, int(cam.fx * cam.baseline / cfg.max_depth))
    return max_disp, min_disp


def compute_depth(
    left: jax.Array,
    right: jax.Array,
    cam: CameraConfig,
    cfg: DepthConfig,
) -> DepthResult:
    """Full frontend — equivalent of ``DepthEstimator::ComputeDepth`` (:33-78)."""
    left_s = gaussian_blur3(left)
    right_s = gaussian_blur3(right)

    sel = select_points(
        left_s,
        boundary=cfg.boundary,
        block_rows=cfg.block_rows,
        block_cols=cfg.block_cols,
        grad_th=cfg.grad_th,
        max_points_per_block=cfg.max_points_per_block,
        min_points_per_block=cfg.min_points_per_block,
    )

    max_disp, min_disp = search_band(cam, cfg)
    from odometry_tpu.kernels.disparity import disparity_winner_maps

    best, match, rmatch, second = disparity_winner_maps(
        left_s,
        right_s,
        boundary=cfg.boundary,
        max_disparity=max_disp,
        min_disparity=min_disp,
        lr_check=cfg.lr_check,
        second_best=cfg.ratio_test > 0,
        second_excl=cfg.ratio_excl,
    )

    # Dense outlier gates (beyond-reference; see DepthConfig.ratio_test /
    # block_consistency_tol). Both feed the blocked extraction mask so no
    # lane capacity is wasted on matches the finalize would cull, and both
    # are re-applied at lane level for the row/spread orders.
    H, W = left.shape
    xs_g = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    extra_ok = jnp.ones((H, W), bool)
    if cfg.ratio_test > 0:
        extra_ok = best <= cfg.ratio_test * second
    med = None
    if cfg.block_consistency_tol > 0:
        from odometry_tpu.kernels.select import block_median_map

        cand = sel & (best <= cfg.ssd_th) & extra_ok
        disp_cand = (xs_g - match).astype(jnp.float32)
        med = block_median_map(
            disp_cand, cand, boundary=cfg.boundary,
            block_rows=cfg.block_rows, block_cols=cfg.block_cols,
        )
        near_med = jnp.abs(disp_cand - med) <= cfg.block_consistency_tol
        extra_ok = extra_ok & (~jnp.isfinite(med) | near_med)

    # The reference keeps val=1 for selected pixels whose SSD failed; they
    # enter refinement with inverse depth 0 (depth_estimate.cpp:388-395 with
    # left_dep initialised to zero by the driver). Refinement runs on the
    # extracted point lanes (row-major first max_residuals, mirroring the
    # reference's gather at depth_estimate.cpp:106-116).
    # Selection cannot exceed blocks * per-block cap, so bound the lane count
    # by that (the reference's max_residuals=80000 is looser than its own
    # selection maximum of 40960).
    cap = min(cfg.max_residuals, cfg.block_rows * cfg.block_cols * cfg.max_points_per_block)
    if cfg.point_order == "blocked":
        # The blocked cap must not re-rank the selection stage's
        # gradient-ordered points by scan order (round-3 regression: depth
        # mte 0.131 -> 0.189): rank each tile's slots by gradient magnitude,
        # and spend no slots on pixels the SSD threshold will cull anyway
        # (they enter refinement at inverse depth 0 and always die at filter
        # time — reference depth_estimate.cpp:176-197). XLA CSEs these
        # gradients with select_points' own under the same jit.
        from odometry_tpu.image.pyramid import central_gradients

        gx, gy = central_gradients(left_s)
        grad = jnp.sqrt(gx * gx + gy * gy)
        pts = extract_points(best, sel & (best <= cfg.ssd_th) & extra_ok, cap,
                             order="blocked", priority=grad)
    else:
        pts = extract_points(best, sel, cap, order=cfg.point_order)

    # Lane-level finalize (thresholding + LR cycle check + disparity->inverse
    # depth), the _finalize semantics applied to <=cap lanes instead of the
    # full image: gathers of <=cap lanes instead of a take_along_axis over
    # the dense (H, W) map.
    ys_l = pts.ys.astype(jnp.int32)
    xs_l = pts.xs.astype(jnp.int32)
    best_l = pts.inv_depth  # extract carried the best-SSD values
    m_l = jnp.clip(clip_gather_2d(match, ys_l, xs_l), 0, W - 1)
    # Border predicate: select_points already never selects outside the
    # boundary margin, but the dense _finalize checked it explicitly — and-in
    # the lane equivalent so a future select variant cannot silently break
    # the invariant (costs ~nothing at <=16k lanes).
    b = cfg.boundary
    in_border = (
        (ys_l >= b) & (ys_l < H - b) & (xs_l >= b) & (xs_l < W - b)
    )
    matched_l = pts.valid & in_border & (best_l <= cfg.ssd_th)
    if cfg.ratio_test > 0 or cfg.block_consistency_tol > 0:
        extra_l = clip_gather_2d(extra_ok.astype(jnp.float32), ys_l, xs_l)
        matched_l = matched_l & (extra_l > 0.5)
    if cfg.lr_check:
        back_l = clip_gather_2d(rmatch, ys_l, m_l)
        matched_l = matched_l & (jnp.abs(back_l - xs_l) <= cfg.lr_tol)
    disp_l = jnp.where(matched_l, (xs_l - m_l).astype(jnp.float32), 0.0)
    inv0_l = disp_l / jnp.float32(cam.fx * cam.baseline)
    pts = pts._replace(inv_depth=inv0_l)
    if not cfg.refine_unmatched:
        # Only search-confirmed lanes refine (see DepthConfig.refine_unmatched).
        pts = pts._replace(valid=pts.valid & matched_l)
    use_patch = cfg.refine_backend == "patch" or (
        cfg.refine_backend == "auto"
        and cfg.interp in ("bilinear", "mm")
        and not cfg.refine_unmatched
        and cfg.refine_max_shift > 0
    )
    if use_patch:
        refined, resid, iters, cost, escaped = refine_depth_points_patch(
            left, right, pts, cam, cfg
        )
    else:
        refined, resid, iters, cost = refine_depth_points(left, right, pts, cam, cfg)
        escaped = None

    # Writeback + filtering (depth_estimate.cpp:176-197), per point lane.
    photo_bad = (resid > cfg.photo_th) | (resid == _SENTINEL)
    safe = jnp.where(refined != 0, refined, jnp.inf)
    depth = 1.0 / safe
    range_bad = (depth > cfg.max_depth) | (depth < cfg.min_depth)
    valid_pt = pts.valid & ~photo_bad & ~range_bad
    if escaped is not None:
        valid_pt = valid_pt & ~escaped
    if cfg.refine_max_shift > 0:
        # Matched lanes must stay near their integer search winner; a larger
        # drift means refinement crossed into a different photometric basin.
        drift = jnp.abs(refined * jnp.float32(cam.fx * cam.baseline) - disp_l)
        valid_pt = valid_pt & (~matched_l | (drift <= cfg.refine_max_shift))
    vals = jnp.where(valid_pt, refined, 0.0)

    # Scatter back to dense maps. Padded lanes carry in-border or clipped
    # indices and write zeros/False (out-of-bounds scatter updates drop).
    ys_i = pts.ys.astype(jnp.int32)
    xs_i = pts.xs.astype(jnp.int32)
    valid = jnp.zeros((H, W), bool).at[ys_i, xs_i].max(valid_pt)
    inv_depth = jnp.zeros((H, W), jnp.float32).at[ys_i, xs_i].add(vals)
    disparity = jnp.zeros((H, W), jnp.float32).at[ys_i, xs_i].max(disp_l)

    num_valid = jnp.sum(valid_pt)
    ok = num_valid >= cfg.min_valid_points
    return DepthResult(valid, disparity, inv_depth, ok, num_valid, iters, cost)
