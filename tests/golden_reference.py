"""TEST-ONLY golden model: NumPy transliteration of the reference frame loop.

This module re-implements, in NumPy + OpenCV (for bit-exact cv::GaussianBlur /
cv::pyrDown semantics), the composed behaviour of the reference executable:

  * driver frame loop .... run_odometry_kitti_offline.cpp:94-271
  * pose tracker LM ...... lm_optimizer.cpp:73-160 (+ kernel :163-264)
  * depth frontend ....... depth_estimate.cpp:33-242 (+ search :244-398)
  * pyramids ............. image_processing_global.cpp:12-113
  * Sophus SE3::exp ...... third_party/Sophus/sophus/se3.hpp:765

It exists ONLY to pin end-to-end parity of the pipeline's parity
configuration (floor warps, odd depth decimation, stale keyframe warm start,
level-1-from-unsmoothed pyramid, lambda schedules, selected-but-unmatched
points entering refinement at depth 0) — tests/test_reference_parity.py.
It is deliberately independent of odometry_tpu: only numpy/cv2.

Faithfulness notes:
  * All state is float32, like the C++ (Eigen f32 / CV_32F); only the 6x6
    solve runs in float64 (the C++ uses colPivHouseholderQr, whose pivoting
    is more accurate than a naive f32 solve; the difference is far below
    other f32 noise).
  * The reference reads UNINITIALISED cv::Mat memory for the depth of
    selected-but-unmatched pixels on frames >= 1 (cur_left_dep is allocated
    without init_val, run_odometry_kitti_offline.cpp:230, and
    DisparityDepthEstimate only writes matched pixels). We take the benign,
    deterministic frame-0 interpretation: those depths are 0.
  * Where the reference divides by a zero diagonal (depth refinement
    jtwj=0 -> delta = 0/0), we define delta = 0 (the evident intent; same
    choice as the JAX build, see odometry_tpu/depth/estimator.py docstring).
"""

from __future__ import annotations

import dataclasses

import numpy as np

F = np.float32


# ---------------------------------------------------------------------------
# Sophus (se3.hpp:765, so3.hpp) — closed forms with Taylor guards.
# ---------------------------------------------------------------------------


def _hat(w):
    return np.array(
        [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], np.float64
    )


def se3_exp_np(xi):
    """Sophus SE3<float>::exp — xi = [upsilon(3), omega(3)]."""
    xi = np.asarray(xi, np.float64)
    v, w = xi[:3], xi[3:]
    th2 = float(w @ w)
    th = np.sqrt(th2)
    W = _hat(w)
    W2 = W @ W
    if th < 1e-8:
        R = np.eye(3) + W + 0.5 * W2
        V = np.eye(3) + 0.5 * W + W2 / 6.0
    else:
        R = np.eye(3) + np.sin(th) / th * W + (1 - np.cos(th)) / th2 * W2
        V = (
            np.eye(3)
            + (1 - np.cos(th)) / th2 * W
            + (th - np.sin(th)) / (th2 * th) * W2
        )
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T.astype(F)


def angles_xyz_np(R):
    """SO3::angleX/angleY/angleZ (so3.hpp:127-154): log of the nearest SO(2)
    to the respective 2x2 block, atan2(M10 - M01, M00 + M11)."""
    R = np.asarray(R, np.float64)
    ax = np.arctan2(R[2, 1] - R[1, 2], R[1, 1] + R[2, 2])
    ay = np.arctan2(R[0, 2] - R[2, 0], R[0, 0] + R[2, 2])
    az = np.arctan2(R[1, 0] - R[0, 1], R[0, 0] + R[1, 1])
    return np.array([ax, ay, az], F)


# ---------------------------------------------------------------------------
# Pyramids (image_processing_global.cpp:12-113) — cv2 for exact cv semantics.
# ---------------------------------------------------------------------------


def image_pyramid_np(img, num_levels, smooth=True):
    import cv2

    img = np.ascontiguousarray(img, F)
    rows, cols = img.shape
    out = [cv2.GaussianBlur(img, (3, 3), 0) if smooth else img.copy()]
    rows //= 2
    cols //= 2
    if num_levels > 1:
        # Level 1 from the UNsmoothed input (:38), forced floor size.
        out.append(cv2.pyrDown(img, dstsize=(cols, rows)))
    for _ in range(2, num_levels):
        rows //= 2
        cols //= 2
        out.append(cv2.pyrDown(out[-1], dstsize=(cols, rows)))
    return out


def depth_pyramid_np(dep, num_levels):
    """MedianDepthPyramidNaive with smooth=false: odd-index decimation."""
    out = [np.ascontiguousarray(dep, F)]
    for _ in range(1, num_levels):
        prev = out[-1]
        rows, cols = prev.shape[0] // 2, prev.shape[1] // 2
        out.append(prev[1 : 1 + 2 * rows : 2, 1 : 1 + 2 * cols : 2].copy())
    return out


# ---------------------------------------------------------------------------
# Depth frontend (depth_estimate.cpp).
# ---------------------------------------------------------------------------

PATTERN = ((-2, 0), (-1, -1), (-1, 1), (0, -2), (0, 0), (0, 2), (1, -1), (2, 0))


@dataclasses.dataclass
class GoldenConfig:
    fx: float
    cx: float
    cy: float
    baseline: float
    num_levels: int = 4
    max_iterations: tuple = (10, 20, 30, 30)  # index = level (0 finest)
    huber_delta: float = 28.0
    precision: float = 0.995
    lambda_init: float = 0.01
    boundary: int = 4
    block_rows: int = 16
    block_cols: int = 32
    max_points_per_block: int = 80
    grad_th: float = 8.0
    ssd_th: float = 900.0
    photo_th: float = 15.0
    min_depth: float = 0.1
    max_depth: float = 30.0
    depth_max_iters: int = 50
    min_valid_points: int = 500
    kf_weights: tuple = (0.1 / 3.3, 1.0 / 3.3, 0.1 / 3.3, 1.0 / 3.3, 0.1 / 3.3, 1.0 / 3.3)
    kf_threshold: float = 1.1


def select_points_np(blurred, cfg: GoldenConfig):
    """Block-adaptive gradient threshold selection (:300-342)."""
    h, w = blurred.shape
    b = cfg.boundary
    bh = (h - 2 * b) // cfg.block_rows
    bw = (w - 2 * b) // cfg.block_cols
    # Gradients exactly as in the block loop: central difference, unclamped
    # (block interiors never touch the image border because b >= 1).
    gx = np.zeros_like(blurred)
    gy = np.zeros_like(blurred)
    gx[:, 1:-1] = F(0.5) * (blurred[:, 2:] - blurred[:, :-2])
    gy[1:-1, :] = F(0.5) * (blurred[2:, :] - blurred[:-2, :])
    grad = np.sqrt(gx * gx + gy * gy).astype(F)
    val = np.zeros((h, w), np.uint8)
    for bid in range(cfg.block_rows * cfg.block_cols):
        sy = b + (bid // cfg.block_cols) * bh
        sx = b + (bid % cfg.block_cols) * bw
        block = grad[sy : sy + bh, sx : sx + bw].ravel()
        th = np.partition(block, block.size // 2)[block.size // 2] + F(cfg.grad_th)
        count = 0
        done = False
        for y in range(sy, sy + bh):
            for x in range(sx, sx + bw):
                if count >= cfg.max_points_per_block:
                    done = True
                    break
                if grad[y, x] > th:
                    val[y, x] = 1
                    count += 1
            if done:
                break
    return val


def disparity_search_np(left_b, right_b, val, cfg: GoldenConfig):
    """Full epipolar SSD scan per selected pixel (:345-398). Returns
    (disp, dep) maps; dep = disp / (fx * baseline); unmatched stay 0 and KEEP
    val=1 (reference behaviour)."""
    h, w = left_b.shape
    b = cfg.boundary
    disp = np.zeros((h, w), F)
    dep = np.zeros((h, w), F)
    # Pattern stacks for vectorized per-row scoring.
    padL = np.pad(left_b, 2)
    padR = np.pad(right_b, 2)
    PL = np.stack([padL[2 + dy : 2 + dy + h, 2 + dx : 2 + dx + w] for dy, dx in PATTERN])
    PR = np.stack([padR[2 + dy : 2 + dy + h, 2 + dx : 2 + dx + w] for dy, dx in PATTERN])
    for y in range(b, h - b):
        xs = np.nonzero(val[y, b : w - b])[0] + b
        if xs.size == 0:
            continue
        row_r = PR[:, y, :]  # (8, w)
        for x in xs:
            if x <= b:
                continue
            cand = row_r[:, b:x]  # (8, x-b)
            d = cand - PL[:, y, x][:, None]
            ssd = np.sum(d * d, axis=0, dtype=F)
            k = int(np.argmin(ssd))  # first minimum == strict < update
            if ssd[k] <= cfg.ssd_th:
                disp[y, x] = F(abs(x - (b + k)))
                dep[y, x] = F(disp[y, x] / (cfg.fx * cfg.baseline))
    return disp, dep


def depth_optimization_np(left, right, dep, val, cfg: GoldenConfig):
    """Per-pixel inverse-depth LM + filtering (:80-197). Mutates dep/val
    (like the C++ writes through its output Mats); returns status ok."""
    h, w = left.shape
    ys, xs = np.nonzero(val == 1)  # row-major, like the gather loop :107-115
    n = xs.size
    if n == 0:
        return False
    cur = dep[ys, xs].astype(F)
    pre = cur.copy()
    tmp = cur.copy()
    resid = np.zeros(n, F)
    lam = F(cfg.lambda_init)
    err_last = F(1e10)
    txfx = F(cfg.baseline * cfg.fx)

    xs_f = xs.astype(F)

    def eval_system(d):
        wx = np.floor(xs_f - txfx * d).astype(np.int64)
        inb = (wx >= 2) & (wx <= w - 2)
        wxc = np.clip(wx, 1, w - 2)
        r = left[ys, xs] - right[ys, wxc]
        wgt = np.where(np.abs(r) <= cfg.huber_delta, F(1.0), F(cfg.huber_delta) / np.abs(r))
        g = txfx * F(0.5) * (right[ys, np.minimum(wxc + 1, w - 1)] - right[ys, wxc - 1])
        jtwj = np.where(inb, g * g * wgt, F(0.0))
        bb = np.where(inb, -g * wgt * r, F(0.0))
        res = np.where(inb, np.abs(r), F(-1000.0))
        n_act = int(inb.sum())
        err = F(np.sum(np.where(inb, r * r * wgt, F(0.0))) / max(n_act, 1))
        return jtwj, bb, res, err

    it = 0
    while it < cfg.depth_max_iters:
        jtwj, bb, resid, err_now = eval_system(tmp)
        if err_now > err_last:
            lam = lam * F(10.0)
            if lam > 1e5:
                break
            cur = pre.copy()
        else:
            cur = tmp.copy()
            pre = cur.copy()
            if err_now / err_last > cfg.precision:
                break
            err_last = err_now
            lam = max(lam / F(10.0), F(1e-7))
        denom = jtwj * (F(1.0) + lam)
        delta = np.where(denom > 0, bb / np.where(denom > 0, denom, F(1.0)), F(0.0))
        tmp = delta + cur
        it += 1

    # Writeback + filtering (:176-197) using the LAST evaluated residuals
    # (evaluated at tmp, not necessarily at cur — reference quirk).
    photo_bad = (resid > cfg.photo_th) | (resid == -1000)
    with np.errstate(divide="ignore"):
        depth_m = np.where(cur != 0, F(1.0) / np.where(cur != 0, cur, F(1.0)), np.inf)
    range_bad = (depth_m > cfg.max_depth) | (depth_m < cfg.min_depth)
    keep = ~(photo_bad | range_bad)
    val[ys, xs] = keep.astype(np.uint8)
    dep[ys, xs] = np.where(keep, cur, F(0.0))
    return int(keep.sum()) >= cfg.min_valid_points


def compute_depth_np(left, right, cfg: GoldenConfig):
    """ComputeDepth (:33-78): blur -> select -> search -> refine -> filter.

    Returns (val, disp, dep, ok)."""
    import cv2

    left = np.ascontiguousarray(left, F)
    right = np.ascontiguousarray(right, F)
    lb = cv2.GaussianBlur(left, (3, 3), 0)
    rb = cv2.GaussianBlur(right, (3, 3), 0)
    val = select_points_np(lb, cfg)
    disp, dep = disparity_search_np(lb, rb, val, cfg)
    ok = depth_optimization_np(left, right, dep, val, cfg)
    return val, disp, dep, ok


# ---------------------------------------------------------------------------
# Pose tracker (lm_optimizer.cpp:73-264), dense floor-warp formulation.
# ---------------------------------------------------------------------------


def _level_intrinsics(cfg: GoldenConfig, level):
    """fx/2^l and the GetCxLevel recursion (image_processing_global.h:22-28)."""
    cx, cy = F(cfg.cx), F(cfg.cy)
    for _ in range(level):
        cx = (cx + F(0.5)) / F(2.0) + F(0.5)
        cy = (cy + F(0.5)) / F(2.0) + F(0.5)
    return F(cfg.fx / 2.0**level), cx, cy


def _residual_jacobian_np(img1, img2, dep1, T, level, cfg: GoldenConfig):
    """ComputeResidualJacobianNaive (:163-264), vectorized over pixels.

    Returns (J (n,6), r (n,), w (n,)) for valid rows in row-major pixel
    order, or None when n == 0."""
    rows, cols = img1.shape
    fxl, cxl, cyl = _level_intrinsics(cfg, level)
    b = 4  # hard-coded in the kernel loop (:190-191)
    ys, xs = np.mgrid[b : rows - b, b : cols - b]
    ys = ys.ravel()
    xs = xs.ravel()
    d = dep1[ys, xs]
    vdep = np.abs(d - F(0.0)) >= F(0.01)
    Z = np.where(vdep, F(1.0) / np.where(vdep, d, F(1.0)), F(0.0))
    X = Z * (xs.astype(F) - cxl) / fxl
    Y = Z * (ys.astype(F) - cyl) / fxl  # reference uses fx for fy too
    P = np.stack([X, Y, Z, np.ones_like(Z)]).astype(F)
    Q = (T.astype(F) @ P).astype(F)
    zpos = Q[2] > F(0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = fxl * Q[0] / Q[2] + cxl
        v = fxl * Q[1] / Q[2] + cyl
    uf = np.floor(u)
    vf = np.floor(v)
    inb = (uf >= 0) & (vf >= 0) & (uf < cols) & (vf < rows)
    valid = vdep & zpos & inb
    if not valid.any():
        return None
    ys, xs = ys[valid], xs[valid]
    ui = uf[valid].astype(np.int64)
    vi = vf[valid].astype(np.int64)
    X, Y, Z = X[valid], Y[valid], Z[valid]
    # Clamped central gradient at the integer warp (the "BUG!!!" floor read).
    gx = F(0.5) * (img2[vi, np.minimum(ui + 1, cols - 1)] - img2[vi, np.maximum(ui - 1, 0)])
    gy = F(0.5) * (img2[np.minimum(vi + 1, rows - 1), ui] - img2[np.maximum(vi - 1, 0), ui])
    r = img2[vi, ui] - img1[ys, xs]
    fx_z = fxl / Z
    xy, xx, yy, zz = X * Y, X * X, Y * Y, Z * Z
    J = np.stack(
        [
            gx * fx_z,
            gy * fx_z,
            gx * (-fx_z * X / Z) + gy * (-fx_z * Y / Z),
            gx * (-fx_z * xy / Z) + gy * (-fxl * (1 + yy / zz)),
            gx * (fxl * (1 + xx / zz)) + gy * (fx_z * xy / Z),
            gx * (-fx_z * Y) + gy * (fx_z * X),
        ],
        axis=1,
    ).astype(F)
    wgt = np.where(np.abs(r) <= cfg.huber_delta, F(1.0), F(cfg.huber_delta) / np.abs(r))
    return J, r.astype(F), wgt.astype(F)


def solve_pose_np(img_pyr1, dep_pyr1, img_pyr2, T_init, cfg: GoldenConfig, stats=None):
    """LevenbergMarquardtOptimizer::Solve / OptimizeCameraPose (:54-160)."""
    current = T_init.astype(F)
    for l in range(cfg.num_levels - 1, -1, -1):
        img1, img2, dep1 = img_pyr1[l], img_pyr2[l], dep_pyr1[l]
        it = 0
        err_last = F(1e10)
        lam = F(cfg.lambda_init)
        inc = current.copy()
        last = current.copy()
        n_iters = 0
        while cfg.max_iterations[l] > it:
            sysm = _residual_jacobian_np(img1, img2, dep1, inc, l, cfg)
            if sysm is None:
                return np.eye(4, dtype=F), False  # Solve failed -> identity
            J, r, w = sysm
            n = r.size
            err_now = F(np.sum(r * r * w) / n)
            if err_now > err_last:
                lam = lam * F(5.0)
                if lam > 1e5:
                    it += 1
                    break
                current = last.copy()
            else:
                current = inc.copy()
                last = current.copy()
                if err_now / err_last > cfg.precision:
                    it += 1
                    break
                err_last = err_now
                lam = max(lam / F(5.0), F(1e-5))
            jtw = (J * w[:, None]).T  # (6, n)
            jtwj = (jtw @ J).astype(F)
            bvec = (-(jtw @ r)).astype(F)
            A = jtwj + lam * np.diag(np.diag(jtwj))
            delta = np.linalg.solve(A.astype(np.float64), bvec.astype(np.float64))
            inc = (se3_exp_np(delta) @ current).astype(F)
            it += 1
        if stats is not None:
            stats.append((l, it, float(err_last)))
    return current, True


# ---------------------------------------------------------------------------
# Driver frame loop (run_odometry_kitti_offline.cpp:94-271).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GoldenRun:
    poses: np.ndarray  # (N, 4, 4) predicted absolute poses
    keyframe_ids: list
    failed_at: int | None
    per_frame: list  # (pose_to_kf, motion_mag, promoted) tuples


def run_golden(frames, cfg: GoldenConfig, init_pose=None):
    """frames: list of (left, right) float32 arrays. Mirrors main()'s loop:
    depth every frame, frame-to-keyframe tracking, stale warm start in both
    branches, promotion on weighted motion magnitude."""
    left0, right0 = frames[0]
    cur_pose = (np.eye(4, dtype=F) if init_pose is None else init_pose.astype(F))
    val, disp, dep, ok = compute_depth_np(left0, right0, cfg)
    if not ok:
        raise RuntimeError("golden: frame-0 depth failed")
    kf_img_pyr = image_pyramid_np(left0, cfg.num_levels, smooth=True)
    kf_dep_pyr = depth_pyramid_np(dep, cfg.num_levels)
    kf_pose = cur_pose.copy()
    warm = np.eye(4, dtype=F)  # estimator's affine_init_, identity-constructed

    poses = [cur_pose.copy()]
    keyframe_ids = [0]
    per_frame = []
    failed_at = None
    for fid in range(1, len(frames)):
        left, right = frames[fid]
        cur_img_pyr = image_pyramid_np(left, cfg.num_levels, smooth=True)
        pose_to_kf, _ok = solve_pose_np(kf_img_pyr, kf_dep_pyr, cur_img_pyr, warm, cfg)
        cur_pose = (kf_pose @ np.linalg.inv(pose_to_kf.astype(np.float64))).astype(F)
        poses.append(cur_pose.copy())

        val, disp, dep, ok = compute_depth_np(left, right, cfg)
        if not ok:
            failed_at = fid
            per_frame.append((pose_to_kf, 0.0, False))
            break
        dep_pyr_cur = depth_pyramid_np(dep, cfg.num_levels)

        ang = np.abs(angles_xyz_np(pose_to_kf[:3, :3]))
        mot = np.concatenate([ang, np.abs(pose_to_kf[:3, 3])])
        motion_mag = float(mot @ np.asarray(cfg.kf_weights, F))
        promoted = motion_mag > cfg.kf_threshold
        if promoted:
            kf_img_pyr = cur_img_pyr
            kf_dep_pyr = dep_pyr_cur
            kf_pose = cur_pose.copy()
            keyframe_ids.append(fid)
        # Reset(pose_to_keyframe) in BOTH branches (:261, :268).
        warm = pose_to_kf.copy()
        per_frame.append((pose_to_kf, motion_mag, promoted))
    return GoldenRun(np.stack(poses), keyframe_ids, failed_at, per_frame)
