"""Fixed-capacity point lists: the sparse tracking representation.

The reference's hot loops iterate only pixels with valid depth (~5-8% of the
frame, ``lm_optimizer.cpp:193``) or selected points (``depth_estimate.cpp:
106-116``). A dense masked formulation pays a gather for 100% of pixels;
extracting the valid pixels ONCE per keyframe into static-capacity point
arrays makes every LM iteration's scattered reads scale with the points.

Capacity semantics mirror the reference's ``max_residuals`` cap
(``run_odometry_kitti_offline.cpp:60``): extraction keeps the first
`capacity` valid pixels in row-major order and reports the true count.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from odometry_tpu.camera.pinhole import Pinhole
from odometry_tpu.image.sampling import clip_gather_2d, sample_bilinear

_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


class PointSet(NamedTuple):
    """Sparse pixels with inverse depth; fixed capacity, mask-padded."""

    xs: jax.Array  # (cap,) float32 pixel x
    ys: jax.Array  # (cap,) float32 pixel y
    inv_depth: jax.Array  # (cap,) float32
    valid: jax.Array  # (cap,) bool
    num: jax.Array  # scalar int32 = number of valid entries


def extract_points(
    values: jax.Array,
    mask: jax.Array,
    capacity: int,
    order: str = "row",
    priority: jax.Array | None = None,
) -> PointSet:
    """Gather pixels where `mask` into a capacity-bounded PointSet.

    order="row": row-major, first `capacity` kept (jnp.nonzero(..., size=)
    semantics) — matches the reference's first-N gather
    (``depth_estimate.cpp:106-116``). Under truncation this biases selection
    to the top of the image, which skews the tracked geometry.

    order="spread": enumerate pixels by 8x8 phase class (all pixels at
    position (y%8, x%8) == (0,0) across the whole image first, then (0,1),
    ...), so the first `capacity` valid pixels form a spatially uniform
    subsample — safe to truncate aggressively. Implemented as a blocked
    transpose (dense relayout, no gathers).

    order="blocked": spatially-capped per-tile extraction — the image is cut
    into ~capacity/16 tiles and each tile keeps a fixed slot budget of valid
    pixels, via one batched ``lax.top_k``. Same spatial-uniformity intent as
    "spread" but WITHOUT the global stream-compaction (jnp.nonzero lowers to
    a full-image cumsum). Tiles with more
    valid pixels than slots truncate (a spatial cap); underfull tiles leave
    masked lanes.

    `priority` (blocked order only): per-pixel float quality score; each tile
    then keeps its top-`slots` HIGHEST-priority valid pixels instead of the
    first in scan order. This is required on the depth-frontend side, where
    the selection stage ranks pixels by gradient strength
    (``depth_estimate.cpp:300-342``) and refinement quality collapses if the
    capacity cap silently re-ranks them by scan order (measured round 3:
    mte 0.189 vs 0.131 on the bench scene). Ignored by "row"/"spread", whose
    truncation order is the documented semantic.
    """
    H, W = values.shape
    if order == "blocked":
        return _extract_points_blocked(values, mask, capacity, priority)
    if order == "spread":
        t = 8
        Hp, Wp = -(-H // t) * t, -(-W // t) * t
        padded_m = jnp.pad(mask, ((0, Hp - H), (0, Wp - W)))
        padded_v = jnp.pad(values, ((0, Hp - H), (0, Wp - W)))
        nby, nbx = Hp // t, Wp // t
        # (by, py, bx, px) -> (py, px, by, bx)
        perm_m = padded_m.reshape(nby, t, nbx, t).transpose(1, 3, 0, 2).reshape(-1)
        perm_v = padded_v.reshape(nby, t, nbx, t).transpose(1, 3, 0, 2).reshape(-1)
        (idx,) = jnp.nonzero(perm_m, size=capacity, fill_value=0)
        count = jnp.minimum(jnp.sum(perm_m), capacity).astype(jnp.int32)
        py = idx // (t * nby * nbx)
        r1 = idx % (t * nby * nbx)
        px = r1 // (nby * nbx)
        r2 = r1 % (nby * nbx)
        by = r2 // nbx
        bx = r2 % nbx
        ys = (by * t + py).astype(jnp.float32)
        xs = (bx * t + px).astype(jnp.float32)
        vals = jnp.take(perm_v, idx)
    elif order == "row":
        flat_mask = mask.reshape(-1)
        (idx,) = jnp.nonzero(flat_mask, size=capacity, fill_value=0)
        count = jnp.minimum(jnp.sum(flat_mask), capacity).astype(jnp.int32)
        ys = (idx // W).astype(jnp.float32)
        xs = (idx % W).astype(jnp.float32)
        vals = jnp.take(values.reshape(-1), idx)
    else:
        raise ValueError(f"unknown extraction order {order!r}")
    lane = jax.lax.broadcasted_iota(jnp.int32, (capacity, 1), 0).squeeze(-1)
    valid = lane < count
    return PointSet(xs, ys, vals, valid, count)


def _blocked_grid(H: int, W: int, capacity: int, slots: int = 16):
    """Pick (S, nby, nbx, th, tw): S slots per tile over an nby x nbx tile
    grid with nby*nbx*S == capacity and roughly square tiles. Returns None
    when the shape cannot support the blocked layout (tiny images)."""
    S = slots
    while S > 1 and capacity % S != 0:
        S >>= 1
    B = capacity // S
    if B < 1:
        return None
    # nby = power-of-two closest to sqrt(B*H/W), kept within [1, B].
    import math

    target = math.sqrt(max(B * H / max(W, 1), 1e-9))
    nby = 1
    while nby * 2 <= B and abs(math.log2(nby * 2) - math.log2(target)) <= abs(
        math.log2(nby) - math.log2(target)
    ):
        nby *= 2
    while B % nby != 0:
        nby >>= 1
    nbx = B // nby
    th = -(-H // nby)
    tw = -(-W // nbx)
    if th * tw < S or th < 1 or tw < 1:
        return None
    return S, nby, nbx, th, tw


def _extract_points_blocked(
    values: jax.Array,
    mask: jax.Array,
    capacity: int,
    priority: jax.Array | None = None,
) -> PointSet:
    """Per-tile top-k extraction via batched top_k (see extract_points)."""
    H, W = values.shape
    grid = _blocked_grid(H, W, capacity)
    if grid is None:
        # Degenerate shapes (tests with tiny pyramids): exact spread fallback.
        return extract_points(values, mask, capacity, order="spread")
    S, nby, nbx, th, tw = grid
    B = nby * nbx
    Hp, Wp = nby * th, nbx * tw
    mpad = jnp.pad(mask, ((0, Hp - H), (0, Wp - W)))
    vpad = jnp.pad(values, ((0, Hp - H), (0, Wp - W)))
    # (nby, th, nbx, tw) -> (B, th*tw)
    relayout = lambda a: a.reshape(nby, th, nbx, tw).transpose(0, 2, 1, 3).reshape(B, th * tw)
    mb = relayout(mpad)
    vb = relayout(vpad)
    if priority is None:
        # Priority: valid lanes by ascending within-tile row-major index.
        lane = jax.lax.broadcasted_iota(jnp.int32, (B, th * tw), 1)
        prio = jnp.where(mb, -lane, jnp.int32(-(2**30)))
        top, idx = jax.lax.top_k(prio, S)  # (B, S)
        valid = top > -(2**30)
    else:
        pb = relayout(jnp.pad(priority, ((0, Hp - H), (0, Wp - W))))
        neg = jnp.float32(-3e38)
        prio = jnp.where(mb, pb.astype(jnp.float32), neg)
        top, idx = jax.lax.top_k(prio, S)  # (B, S)
        valid = top > neg
    vals = jnp.take_along_axis(vb, idx, axis=1)
    dy = idx // tw
    dx = idx % tw
    t = jax.lax.broadcasted_iota(jnp.int32, (B, S), 0)
    ys = (t // nbx) * th + dy
    xs = (t % nbx) * tw + dx
    valid = valid & (ys < H) & (xs < W)
    flat = lambda a: a.reshape(-1)
    valid = flat(valid)
    return PointSet(
        flat(xs).astype(jnp.float32),
        flat(ys).astype(jnp.float32),
        jnp.where(valid, flat(vals), 0.0),
        valid,
        jnp.sum(valid).astype(jnp.int32),
    )


def depth_point_pyramid(
    dpyr,
    boundary: int,
    min_inv_depth: float,
    capacity: int,
    order: str = "row",
):
    """Per-level PointSets from an inverse-depth pyramid.

    Valid = |d| >= min_inv_depth inside the tracker's border margin
    (``lm_optimizer.cpp:190-193``). Capacity shrinks 4x per level.
    """
    out = []
    for l, dep in enumerate(dpyr):
        H, W = dep.shape
        ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
        xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
        border = (
            (ys >= boundary) & (ys < H - boundary) & (xs >= boundary) & (xs < W - boundary)
        )
        mask = border & (jnp.abs(dep) >= min_inv_depth)
        cap = max(min(capacity >> (2 * l), H * W), 8)
        out.append(extract_points(dep, mask, cap, order=order))
    return tuple(out)


class PointSystem(NamedTuple):
    r: jax.Array  # (cap,)
    J: jax.Array  # (cap, 6)
    valid: jax.Array  # (cap,) bool


def residual_jacobian_points(
    pts: PointSet,
    img_cur: jax.Array,
    cam: Pinhole,
    T: jax.Array,
    *,
    kf_intensity: jax.Array,
    interp: str = "floor",
    grads: tuple | None = None,
    chan: jax.Array | None = None,
    affine_ab: tuple | None = None,
) -> PointSystem:
    """Sparse equivalent of kernels.photometric.residual_jacobian.

    `kf_intensity` is the keyframe image value at each point (gathered once at
    keyframe creation, not per iteration).

    `grads`, when given, is (gx, gy) — precomputed central-difference gradient
    images of `img_cur`. Floor mode then samples them at the same integer
    coordinates it samples the image (bit-identical result, 3 gathers instead
    of 5); bilinear mode samples the gradients at the NEAREST pixel (the
    Jacobian tolerates first-order approximation; 6 gathers instead of 12).

    interp="mm" is gather-free bilinear sampling of
    (image, gx, gy) via one-hot matmuls (see
    :func:`odometry_tpu.image.sampling.sample_channels_mm`); gradients are
    bilinearly interpolated at the warp (higher quality than the nearest-pixel
    gather modes). `chan` must then be the precomputed (3, H, W) stack
    ``[img_cur, gx, gy]`` (built once per level, reused across LM iterations).
    """
    H, W = img_cur.shape
    d = pts.inv_depth
    safe_d = jnp.where(jnp.abs(d) < 1e-12, 1.0, d)
    Z0 = 1.0 / safe_d
    X = Z0 * (pts.xs - cam.cx) / cam.fx
    Y = Z0 * (pts.ys - cam.cy) / cam.fy

    R = T[:3, :3]
    t = T[:3, 3]
    Xw = R[0, 0] * X + R[0, 1] * Y + R[0, 2] * Z0 + t[0]
    Yw = R[1, 0] * X + R[1, 1] * Y + R[1, 2] * Z0 + t[1]
    Zw = R[2, 0] * X + R[2, 1] * Y + R[2, 2] * Z0 + t[2]
    safe_Zw = jnp.where(Zw == 0, 1.0, Zw)
    u = cam.fx * Xw / safe_Zw + cam.cx
    v = cam.fy * Yw / safe_Zw + cam.cy
    uf = jnp.floor(u)
    vf = jnp.floor(v)
    valid = (
        pts.valid
        & (Zw > 0.0)
        & (uf >= 0.0)
        & (vf >= 0.0)
        & (uf < jnp.float32(W))
        & (vf < jnp.float32(H))
    )

    if interp == "floor":
        xi = jnp.clip(uf.astype(jnp.int32), 0, W - 1)
        yi = jnp.clip(vf.astype(jnp.int32), 0, H - 1)
        I2w = clip_gather_2d(img_cur, yi, xi)
        if grads is not None:
            gx = clip_gather_2d(grads[0], yi, xi)
            gy = clip_gather_2d(grads[1], yi, xi)
        else:
            gx = 0.5 * (
                clip_gather_2d(img_cur, yi, xi + 1) - clip_gather_2d(img_cur, yi, xi - 1)
            )
            gy = 0.5 * (
                clip_gather_2d(img_cur, yi + 1, xi) - clip_gather_2d(img_cur, yi - 1, xi)
            )
    elif interp == "mm":
        if chan is None:
            from odometry_tpu.image.pyramid import central_gradients

            g = grads if grads is not None else central_gradients(img_cur)
            chan = jnp.stack([img_cur, g[0], g[1]])
        from odometry_tpu.image.sampling import sample_channels_mm

        I2w, gx, gy = sample_channels_mm(chan, u, v)
    elif interp == "bilinear":
        I2w = sample_bilinear(img_cur, u, v)
        if grads is not None:
            xi = jnp.clip(jnp.round(u).astype(jnp.int32), 0, W - 1)
            yi = jnp.clip(jnp.round(v).astype(jnp.int32), 0, H - 1)
            gx = clip_gather_2d(grads[0], yi, xi)
            gy = clip_gather_2d(grads[1], yi, xi)
        else:
            gx = 0.5 * (sample_bilinear(img_cur, u + 1.0, v) - sample_bilinear(img_cur, u - 1.0, v))
            gy = 0.5 * (sample_bilinear(img_cur, u, v + 1.0) - sample_bilinear(img_cur, u, v - 1.0))
    else:
        raise ValueError(f"unknown interp mode {interp!r}")

    if affine_ab is not None:
        # Brightness-affine corrected residual r = I2(warp) - (a*I1 + b)
        # with FROZEN (a, b) — see :func:`fit_affine_ab` for why the fit must
        # not run inside the LM iteration. The pose Jacobian is untouched
        # (a, b do not enter I2's dependence on T).
        a_fit, b_fit = affine_ab
        r = I2w - (a_fit * kf_intensity + b_fit)
    else:
        r = I2w - kf_intensity

    # 2x6 warp Jacobian at the keyframe point (lm_optimizer.cpp:232-234).
    inv_Z = 1.0 / jnp.where(Z0 == 0, 1.0, Z0)
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
    vf32 = valid.astype(r.dtype)
    return PointSystem(r * vf32, J * vf32[:, None], valid)


def fit_affine_ab(r0: jax.Array, kf_intensity: jax.Array, valid: jax.Array,
                  a_dead: float = 0.0, b_dead: float = 0.0):
    """Closed-form brightness-affine fit (a, b) minimizing
    ``sum_valid (I2w - a*I1 - b)^2``, from a raw-residual linearization
    (``r0 = I2w - I1``, masked).

    DSO-style illumination handling (beyond-reference; the reference's raw
    residual, ``lm_optimizer.cpp:217``, biases the pose under exposure drift /
    vignetting). Refit every LM iteration, this converges the joint
    (pose, illumination) problem by alternation — a tracker with
    ``affine_light=True`` recovers an 8%-gain / 9-gray-bias corrupted frame
    to sub-centimetre pose (tests/test_tracker.py).

    KNOWN TRADE-OFF, measured on the accuracy-sweep fixtures: on
    photometrically CLEAN but geometry-ambiguous scenes (a single textured
    plane near its homography ambiguity) the 2-DoF fit can absorb genuine
    pose signal and destabilize a marginal solve (plane-family seed 4:
    0.09 -> 1.9 mte). That is why `affine_light` is an opt-in config for
    photometrically unstable sensors, not a preset default. `a_dead`/`b_dead`
    optionally soft-threshold the correction toward (1, 0) (lasso-style;
    clean-scene fits sit inside |a-1| ~ 0.005, |b| < 1 gray) at the price of
    under-correcting real drift by the deadband.

    Returns scalar (a, b), clamped to a plausible photometric envelope so a
    degenerate frame (few lanes, heavy occlusion) cannot hallucinate a huge
    correction.
    """
    vf = valid.astype(r0.dtype)
    n = jnp.maximum(jnp.sum(vf), 1.0)
    i2 = r0 + vf * kf_intensity  # masked I2w (r0 is already masked)
    s1 = jnp.sum(vf * kf_intensity)
    s2 = jnp.sum(vf * kf_intensity * kf_intensity)
    t0 = jnp.sum(i2)
    t1 = jnp.sum(i2 * kf_intensity)
    det = s2 * n - s1 * s1
    ok_fit = det > 1e-6 * jnp.maximum(s2 * n, 1.0)
    a = jnp.where(ok_fit, (t1 * n - t0 * s1) / jnp.where(ok_fit, det, 1.0), 1.0)
    b = jnp.where(ok_fit, (t0 - a * s1) / n, 0.0)

    def soft(x, dead):
        return jnp.sign(x) * jnp.maximum(jnp.abs(x) - dead, 0.0)

    if a_dead:
        a = 1.0 + soft(a - 1.0, a_dead)
    if b_dead:
        b = soft(b, b_dead)
    return jnp.clip(a, 0.7, 1.4), jnp.clip(b, -40.0, 40.0)


class PointNormalEqs(NamedTuple):
    JtWJ: jax.Array
    JtWr: jax.Array
    err: jax.Array
    num_valid: jax.Array


def normal_equations_points(sys: PointSystem, weights: jax.Array) -> PointNormalEqs:
    w = weights * sys.valid.astype(weights.dtype)
    Jw = sys.J * w[:, None]
    JtWJ = _einsum("ni,nj->ij", Jw, sys.J)
    JtWr = _einsum("ni,n->i", Jw, sys.r)
    num_valid = jnp.sum(sys.valid)
    err = jnp.sum(w * sys.r * sys.r) / jnp.maximum(num_valid, 1).astype(sys.r.dtype)
    return PointNormalEqs(JtWJ, JtWr, err, num_valid)
