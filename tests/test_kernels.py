"""Golden parity tests: dense kernels vs scalar ports of the reference loops."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from odometry_tpu.camera import Pinhole, level_intrinsics
from odometry_tpu.geometry import se3_exp
from odometry_tpu.image import gaussian_blur3
from odometry_tpu.kernels.photometric import residual_jacobian, normal_equations
from odometry_tpu.kernels.select import select_points
from odometry_tpu.kernels.disparity import (
    disparity_search,
    disparity_search_reference,
    pattern_stack,
    PATTERN_OFFSETS,
)
from odometry_tpu.solvers.robust import huber_weights, tdist_weights, tdist_scale
from odometry_tpu.data.synthetic import make_scene, render_stereo, render


H, W = 96, 160
CAM = Pinhole.create(240.0, 240.0, W / 2.0, H / 2.0)


@pytest.fixture(scope="module")
def scene_frames():
    scene = make_scene(3, depth=10.0)
    left, right, z = render_stereo(scene, CAM, 0.537, jnp.eye(4), H, W)
    return scene, np.asarray(left), np.asarray(right), np.asarray(z)


# ---------------------------------------------------------------------------
# Photometric residual/Jacobian vs a scalar port of
# ComputeResidualJacobianNaive (lm_optimizer.cpp:163-264).
# ---------------------------------------------------------------------------


def _photometric_golden(img1, img2, dep1, T, cam, boundary=4):
    rows, cols = img1.shape
    fx, fy, cx, cy = (float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy))
    J_rows, r_rows, coords = [], [], []
    for y in range(boundary, rows - boundary):
        for x in range(boundary, cols - boundary):
            d = dep1[y, x]
            if abs(d) < 0.01:
                continue
            Z = 1.0 / d
            X = Z * (x - cx) / fx
            Y = Z * (y - cy) / fy
            p = T @ np.array([X, Y, Z, 1.0], np.float32)
            if p[2] <= 0:
                continue
            u = fx * p[0] / p[2] + cx
            v = fy * p[1] / p[2] + cy
            ui, vi = int(np.floor(u)), int(np.floor(v))
            if ui < 0 or vi < 0 or ui >= cols or vi >= rows:
                continue
            gx = 0.5 * (img2[vi, min(ui + 1, cols - 1)] - img2[vi, max(ui - 1, 0)])
            gy = 0.5 * (img2[min(vi + 1, rows - 1), ui] - img2[max(vi - 1, 0), ui])
            r = img2[vi, ui] - img1[y, x]
            fx_z, fy_z = fx / Z, fy / Z
            xy, xx, yy, zz = X * Y, X * X, Y * Y, Z * Z
            jw = np.array(
                [
                    [fx_z, 0, -fx_z * X / Z, -fx_z * xy / Z, fx * (1 + xx / zz), -fx_z * Y],
                    [0, fy_z, -fy_z * Y / Z, -fy * (1 + yy / zz), fy_z * xy / Z, fy_z * X],
                ],
                np.float32,
            )
            J_rows.append(np.array([gx, gy], np.float32) @ jw)
            r_rows.append(r)
            coords.append((y, x))
    return np.array(J_rows), np.array(r_rows), coords


def test_residual_jacobian_matches_scalar_reference(scene_frames):
    scene, left, right, z = scene_frames
    dep = (1.0 / z).astype(np.float32)
    # Knock out some depths to exercise the invalid-depth path.
    rng = np.random.default_rng(0)
    dep[rng.random(dep.shape) < 0.5] = 0.0
    T = np.asarray(se3_exp(jnp.asarray([0.05, -0.02, 0.1, 0.004, -0.006, 0.003])))
    img2, _ = render(scene, CAM, np.linalg.inv(T), H, W)
    img2 = np.asarray(img2)

    sys = residual_jacobian(
        jnp.asarray(left), jnp.asarray(dep), jnp.asarray(img2), CAM, jnp.asarray(T)
    )
    Jg, rg, coords = _photometric_golden(left, img2, dep, T, CAM)
    assert len(coords) > 200

    valid = np.asarray(sys.valid)
    ours_n = valid.sum()
    assert ours_n == len(coords)
    ys = [c[0] for c in coords]
    xs = [c[1] for c in coords]
    assert np.all(valid[ys, xs])
    assert np.allclose(np.asarray(sys.r)[ys, xs], rg, atol=1e-3)
    assert np.allclose(np.asarray(sys.J)[ys, xs], Jg, rtol=1e-4, atol=1e-2)


def test_normal_equations_match_direct(scene_frames):
    scene, left, right, z = scene_frames
    dep = (1.0 / z).astype(np.float32)
    T = jnp.eye(4)
    sys = residual_jacobian(jnp.asarray(left), jnp.asarray(dep), jnp.asarray(right), CAM, T)
    w = huber_weights(sys.r, 28.0, sys.valid)
    eqs = normal_equations(sys, w)
    Jf = np.asarray(sys.J).reshape(-1, 6)
    rf = np.asarray(sys.r).reshape(-1)
    wf = np.asarray(w).reshape(-1)
    ref_JtWJ = (Jf * wf[:, None]).T @ Jf
    ref_JtWr = (Jf * wf[:, None]).T @ rf
    nv = np.asarray(sys.valid).sum()
    assert np.allclose(np.asarray(eqs.JtWJ), ref_JtWJ, rtol=1e-4, atol=1e-2)
    assert np.allclose(np.asarray(eqs.JtWr), ref_JtWr, rtol=1e-4, atol=1e-2)
    assert int(eqs.num_valid) == nv
    assert np.isclose(float(eqs.err), (wf * rf * rf).sum() / nv, rtol=1e-4)


# ---------------------------------------------------------------------------
# Robust weights (lm_optimizer.cpp:249-261, 338-358).
# ---------------------------------------------------------------------------


def test_huber_weights():
    r = jnp.asarray([0.0, 10.0, -28.0, 56.0, -100.0])
    valid = jnp.ones(5, bool)
    w = np.asarray(huber_weights(r, 28.0, valid))
    assert np.allclose(w, [1.0, 1.0, 1.0, 0.5, 0.28])


def test_tdist_scale_matches_scalar_fixed_point(rng):
    r = rng.normal(scale=12.0, size=500).astype(np.float32)
    valid = np.ones(500, bool)
    sigma = float(tdist_scale(jnp.asarray(r), jnp.asarray(valid)))
    # Scalar do-while port of ComputeScaleNaive.
    cur, vee = 5.0, 200.0
    while True:
        init = cur
        s = np.sum(r**2 * (1 + vee) / (vee + r**2 / cur**2))
        cur = np.sqrt(s / len(r))
        if abs(cur - init) < 1e-3:
            break
    assert np.isclose(sigma, cur, atol=1e-2)


def test_tdist_weights_shape_and_range(rng):
    r = jnp.asarray(rng.normal(scale=12.0, size=(16, 16)).astype(np.float32))
    valid = jnp.ones((16, 16), bool)
    w = np.asarray(tdist_weights(r, valid))
    assert w.shape == (16, 16)
    assert np.all(w > 0) and np.all(w <= (200.0 + 1) / 200.0)


# ---------------------------------------------------------------------------
# Point selection (depth_estimate.cpp:300-342).
# ---------------------------------------------------------------------------


def _select_golden(img, boundary, n_br, n_bc, grad_th, cap):
    h, w = img.shape
    bh = (h - 2 * boundary) // n_br
    bw = (w - 2 * boundary) // n_bc
    gxm = np.zeros_like(img)
    gym = np.zeros_like(img)
    gxm[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    gym[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    grad = np.sqrt(gxm**2 + gym**2)
    mask = np.zeros((h, w), bool)
    for bid in range(n_br * n_bc):
        sy = boundary + (bid // n_bc) * bh
        sx = boundary + (bid % n_bc) * bw
        block = grad[sy : sy + bh, sx : sx + bw].ravel()
        th = np.partition(block, len(block) // 2)[len(block) // 2] + grad_th
        count = 0
        for y in range(sy, sy + bh):
            for x in range(sx, sx + bw):
                if count >= cap:
                    break
                if grad[y, x] > th:
                    mask[y, x] = True
                    count += 1
            if count >= cap:
                break
    return mask


def test_select_points_matches_scalar_reference(scene_frames):
    _, left, _, _ = scene_frames
    blurred = np.asarray(gaussian_blur3(jnp.asarray(left)))
    ours = np.asarray(
        select_points(jnp.asarray(blurred), boundary=4, block_rows=8, block_cols=16,
                      grad_th=8.0, max_points_per_block=80)
    )
    golden = _select_golden(blurred, 4, 8, 16, 8.0, 80)
    assert ours.sum() > 50
    assert np.array_equal(ours, golden)


def test_select_points_cap(rng):
    # A high-contrast noise image must cap at max_points_per_block per block.
    img = (rng.random((64, 64)) * 255).astype(np.float32)
    mask = np.asarray(
        select_points(jnp.asarray(img), boundary=4, block_rows=2, block_cols=2,
                      grad_th=0.0, max_points_per_block=10)
    )
    bh, bw = (64 - 8) // 2, (64 - 8) // 2
    for by in range(2):
        for bx in range(2):
            blk = mask[4 + by * bh : 4 + (by + 1) * bh, 4 + bx * bw : 4 + (bx + 1) * bw]
            assert blk.sum() <= 10


# ---------------------------------------------------------------------------
# Disparity search (depth_estimate.cpp:345-398).
# ---------------------------------------------------------------------------


def test_pattern_stack_offsets(rng):
    img = jnp.asarray(rng.random((32, 32)).astype(np.float32))
    pat = np.asarray(pattern_stack(img))
    for k, (dy, dx) in enumerate(PATTERN_OFFSETS):
        assert np.allclose(pat[k, 10, 12], np.asarray(img)[10 + dy, 12 + dx])


def test_disparity_matches_direct_ssd(scene_frames):
    _, left, right, z = scene_frames
    ls = np.asarray(gaussian_blur3(jnp.asarray(left)))
    rs = np.asarray(gaussian_blur3(jnp.asarray(right)))
    sel = np.asarray(
        select_points(jnp.asarray(ls), boundary=4, block_rows=8, block_cols=16,
                      grad_th=8.0, max_points_per_block=80)
    )
    res = disparity_search(
        jnp.asarray(ls), jnp.asarray(rs), jnp.asarray(sel),
        fx=float(CAM.fx), baseline=0.537, boundary=4, ssd_th=900.0,
    )
    gd, gi, gm, gb = disparity_search_reference(
        ls, rs, sel, fx=float(CAM.fx), baseline=0.537, boundary=4, ssd_th=900.0
    )
    ours_m = np.asarray(res.matched)
    # Matmul expansion has ~1e-1 absolute SSD noise; allow disagreement only
    # where the SSD landscape is genuinely flat between candidates.
    agree = ours_m == gm
    assert agree.mean() > 0.99
    both = ours_m & gm
    assert both.sum() > 20
    disp_diff = np.abs(np.asarray(res.disparity)[both] - gd[both])
    assert (disp_diff <= 1).mean() > 0.98
    assert np.allclose(np.asarray(res.best_ssd)[both], gb[both], atol=1.0, rtol=1e-3)


def test_disparity_recovers_ground_truth(scene_frames):
    _, left, right, z = scene_frames
    ls = gaussian_blur3(jnp.asarray(left))
    rs = gaussian_blur3(jnp.asarray(right))
    sel = select_points(ls, boundary=4, block_rows=8, block_cols=16,
                        grad_th=8.0, max_points_per_block=80)
    res = disparity_search(
        ls, rs, jnp.asarray(sel), fx=float(CAM.fx), baseline=0.537,
        boundary=4, ssd_th=900.0,
    )
    m = np.asarray(res.matched)
    assert m.sum() > 20
    gt_disp = float(CAM.fx) * 0.537 / z
    err = np.abs(np.asarray(res.disparity) - gt_disp)[m]
    # Integer-pixel search: within 1 px of GT for the vast majority.
    assert np.median(err) <= 1.0
    assert (err <= 2.0).mean() > 0.9


def test_mm_sampler_matches_gather_bilinear():
    """sample_channels_mm == sample_bilinear exactly at f32, ~1 level at bf16."""
    from odometry_tpu.image.sampling import sample_bilinear, sample_channels_mm

    key = jax.random.PRNGKey(3)
    H, W, N = 61, 143, 700
    img = jax.random.uniform(key, (H, W), jnp.float32) * 255.0
    gx = jax.random.normal(key, (H, W), jnp.float32) * 20.0
    ku, kv = jax.random.split(key)
    u = jax.random.uniform(ku, (N,), jnp.float32) * (W - 1)
    v = jax.random.uniform(kv, (N,), jnp.float32) * (H - 1)

    ref_i = np.asarray(sample_bilinear(img, u, v))
    ref_g = np.asarray(sample_bilinear(gx, u, v))
    got32 = np.asarray(sample_channels_mm(jnp.stack([img, gx]), u, v, dtype=jnp.float32))
    np.testing.assert_allclose(got32[0], ref_i, atol=1e-4)
    np.testing.assert_allclose(got32[1], ref_g, atol=1e-4)

    got16 = np.asarray(sample_channels_mm(jnp.stack([img, gx]), u, v))
    assert np.max(np.abs(got16[0] - ref_i)) < 2.0  # bf16 image quantization
    assert np.max(np.abs(got16[1] - ref_g)) < 0.5


def test_extract_points_spread_uniform_under_truncation():
    """Spread order keeps a truncated selection spatially uniform."""
    from odometry_tpu.kernels.points import extract_points

    H, W = 64, 100
    rng = np.random.default_rng(0)
    mask = jnp.asarray(rng.random((H, W)) < 0.5)
    values = jnp.asarray(rng.normal(size=(H, W)).astype(np.float32))

    cap = 256
    pts = extract_points(values, mask, cap, order="spread")
    ys = np.asarray(pts.ys).astype(int)
    xs = np.asarray(pts.xs).astype(int)
    val = np.asarray(pts.valid)
    assert val.sum() == cap  # far more than cap valid pixels exist
    # Every returned point is genuinely selected and carries its value.
    m = np.asarray(mask)
    v = np.asarray(values)
    assert m[ys[val], xs[val]].all()
    np.testing.assert_allclose(np.asarray(pts.inv_depth)[val], v[ys[val], xs[val]])
    # Spatial uniformity: both halves of the image get close to half the points.
    top = (ys[val] < H // 2).mean()
    left_frac = (xs[val] < W // 2).mean()
    assert 0.35 < top < 0.65
    assert 0.35 < left_frac < 0.65
    # Row order under the same truncation is heavily top-biased (sanity check
    # that spread actually changes behaviour).
    pts_row = extract_points(values, mask, cap, order="row")
    ys_row = np.asarray(pts_row.ys).astype(int)[np.asarray(pts_row.valid)]
    assert (ys_row < H // 2).mean() > 0.95
