"""End-to-end parity: the pipeline's parity configuration must reproduce
the reference frame loop, frame for frame.

The golden model (tests/golden_reference.py) is a NumPy/cv2 transliteration of
the composed reference executable:

  * driver frame loop .... run_odometry_kitti_offline.cpp:94-271
  * pose tracker LM ...... lm_optimizer.cpp:73-160
  * depth frontend ....... depth_estimate.cpp:33-242
  * pyramids ............. image_processing_global.cpp:12-113

Structure of the parity argument (three layers, tightest first):

1. **Stage exactness** — point selection and the epipolar SSD search are
   integer-valued decisions and must match the golden model EXACTLY (zero
   tolerance), as must the depth pyramids' odd decimation.
2. **Teacher-forced frame parity** — for every frame of a 30-frame sequence,
   both implementations are fed the SAME keyframe state (golden's pyramids,
   golden's refined depth, golden's stale warm start) and must produce the
   same pose-to-keyframe (|dt| < 2e-3, measured agreement ~1e-5) and the same
   keyframe-promotion decision. This pins every quirk flag (floor warps, odd
   decimation, level-1-from-unsmoothed pyramid, stale warm start, row-major
   truncation) every frame, including frames right after promotions where the
   stale warm start sits far from the new keyframe's basin.
3. **Refinement closeness** — the depth refinement LM shares one lambda and
   one scalar cost across ~4000 pixels; its accept/reject path bifurcates on
   float32 summation-order ties (measured: identical inputs, inv_depth
   differs by <= ~5e-3 and ~0.03% of validity flips between golden and JAX —
   and the same would hold between golden and the actual C++, whose AVX hadd
   reduction order is a third ordering). Asserted within those bands.

Why not closed-loop trajectory equality: the composed loop is chaotic — one
flipped LM accept/reject (a genuine float tie) compounds through the keyframe
chain. Measured: two faithful implementations stay within ~0.1 m for ~7
frames and then bifurcate at a promotion; the C++ binary itself would do the
same against either under a different compiler's reduction order. Layer 2 is
the strongest parity statement that is well-posed: every frame's decision,
verified against identical state, over sequences with multiple promotions.

A quirk-flag drift fails loudly: flipping interp floor->bilinear or the depth
decimation odd->even moves teacher-forced poses 10-100x past the tolerance
(test_quirk_flags_break_frame_parity).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from odometry_tpu.camera import Pinhole
from odometry_tpu.config import (
    CameraConfig,
    DepthConfig,
    KeyframeConfig,
    PipelineConfig,
    TrackerConfig,
)
from odometry_tpu.data.synthetic import make_driving_scene, drive_trajectory, stereo_sequence
from odometry_tpu.depth.estimator import compute_depth
from odometry_tpu.image.pyramid import gaussian_image_pyramid, depth_pyramid
from odometry_tpu.kernels.disparity import disparity_search
from odometry_tpu.kernels.select import select_points
from odometry_tpu.image.pyramid import gaussian_blur3
from odometry_tpu.tracking.tracker import prepare_keyframe, solve_pose, solve_pose_points

from golden_reference import (
    GoldenConfig,
    angles_xyz_np,
    compute_depth_np,
    depth_pyramid_np,
    run_golden,
    select_points_np,
    disparity_search_np,
)

H, W = 144, 320
FX, CX, CY = 400.0, W / 2.0, H / 2.0
BASELINE = 386.1448 / 718.856
NUM_LEVELS = 3
MAX_ITERS = (10, 20, 30)
BLOCK_ROWS, BLOCK_COLS = 8, 16
MIN_VALID = 30
KF_THRESHOLD = 0.08  # step 0.12 / 3.3 per frame => promotion every ~2-3 frames

POSE_TOL = 2e-3  # teacher-forced |t| tolerance; measured noise ~1e-5..1e-4
# The tracker LM's break conditions (err_now/err_last > precision,
# lambda > lambda_max) are float32 ties: when a step lands within last-ulp of
# the 0.995 ratio, the golden model (f64 np.linalg.solve) and the JAX build
# (f32 Cholesky) — and equally the C++ (f32 pivoted QR) against either — can
# break at different iterations. Measured rate: ~1 frame in 30; bounded
# displacement (the extra iterations only descend further). Such frames get a
# loose band; their frequency is capped so systematic drift cannot hide in it.
BIFURCATION_TOL = 5e-2
MAX_BIFURCATION_FRACTION = 0.15
REFINE_TOL = 1e-2  # inv-depth band for the refinement LM (see layer 3 above)


def tracker_config(**overrides) -> TrackerConfig:
    kw = dict(
        num_levels=NUM_LEVELS,
        max_iterations=MAX_ITERS,
        interp="floor",
        depth_decimation="odd",
        engine="points",
        point_order="row",
    )
    kw.update(overrides)
    return TrackerConfig(**kw)


def depth_config(**overrides) -> DepthConfig:
    kw = dict(block_rows=BLOCK_ROWS, block_cols=BLOCK_COLS,
              min_valid_points=MIN_VALID, interp="floor", point_order="row")
    kw.update(overrides)
    return DepthConfig(**kw)


def camera_config() -> CameraConfig:
    return CameraConfig(fx=FX, fy=FX, cx=CX, cy=CY, baseline=BASELINE,
                        height=H, width=W)


def golden_config() -> GoldenConfig:
    return GoldenConfig(
        fx=FX, cx=CX, cy=CY, baseline=BASELINE, num_levels=NUM_LEVELS,
        max_iterations=MAX_ITERS, block_rows=BLOCK_ROWS, block_cols=BLOCK_COLS,
        min_valid_points=MIN_VALID, kf_threshold=KF_THRESHOLD,
    )


def _render_sequence(seed: int, num_frames: int):
    cam = Pinhole.create(FX, FX, CX, CY)
    scene = make_driving_scene(seed)
    poses = drive_trajectory(num_frames, step=0.12, seed=seed)
    return [
        (np.asarray(l, np.float32), np.asarray(r, np.float32))
        for l, r in stereo_sequence(scene, cam, BASELINE, poses, H, W)
    ]


def _golden_keyframe_state(frames, golden, fid, cache):
    """(kf image pyramid, kf depth pyramid as jnp, warm start) for frame fid,
    all from GOLDEN products — the teacher-forcing inputs."""
    kf_id = max(k for k in golden.keyframe_ids if k < fid)
    if kf_id not in cache:
        _, _, dep, _ = compute_depth_np(frames[kf_id][0], frames[kf_id][1], golden_config())
        cache[kf_id] = dep
    dep = cache[kf_id]
    pyr = gaussian_image_pyramid(jnp.asarray(frames[kf_id][0]), NUM_LEVELS, smooth=True)
    dpyr = depth_pyramid(jnp.asarray(dep), NUM_LEVELS, smooth=False, indexing="odd")
    # Reference quirk: warm start is the PREVIOUS frame's pose_to_keyframe in
    # both branches (run_odometry_kitti_offline.cpp:261,268), even right after
    # a promotion. per_frame[k] holds frame k+1's solve.
    warm = golden.per_frame[fid - 2][0] if fid >= 2 else np.eye(4, dtype=np.float32)
    return pyr, dpyr, jnp.asarray(warm)


def _motion_promoted(T: np.ndarray) -> tuple[float, bool]:
    ang = np.abs(angles_xyz_np(T[:3, :3]))
    mot = np.concatenate([ang, np.abs(T[:3, 3])])
    w = np.asarray(golden_config().kf_weights, np.float32)
    mag = float(mot @ w)
    return mag, mag > KF_THRESHOLD


@pytest.fixture(scope="module")
def seq3():
    frames = _render_sequence(seed=3, num_frames=30)
    golden = run_golden(frames, golden_config())
    assert golden.failed_at is None
    assert len(golden.keyframe_ids) >= 4, "sequence must exercise promotions"
    return frames, golden


def test_stage_parity_select_and_search_exact(seq3):
    """Layer 1: selection mask and SSD search are EXACT (integer decisions)."""
    import cv2

    frames, _ = seq3
    left, right = frames[0]
    lb = cv2.GaussianBlur(left, (3, 3), 0)
    rb = cv2.GaussianBlur(right, (3, 3), 0)
    val_g = select_points_np(lb, golden_config())
    lbj = gaussian_blur3(jnp.asarray(left))
    assert float(jnp.max(jnp.abs(lbj - lb))) < 1e-3  # blur itself (float op)
    sel = np.asarray(
        select_points(lbj, boundary=4, block_rows=BLOCK_ROWS, block_cols=BLOCK_COLS,
                      grad_th=8.0, max_points_per_block=80)
    )
    assert ((val_g == 1) != sel).sum() == 0

    disp_g, _dep_g = disparity_search_np(lb, rb, val_g, golden_config())
    d = disparity_search(jnp.asarray(lb), jnp.asarray(rb), jnp.asarray(val_g == 1),
                         fx=FX, baseline=BASELINE, boundary=4, ssd_th=900.0,
                         max_disparity=None)
    on = val_g == 1
    assert np.abs(disp_g - np.asarray(d.disparity))[on].max() == 0.0

    gd = depth_pyramid_np(_dep_g, NUM_LEVELS)
    pd = depth_pyramid(jnp.asarray(_dep_g), NUM_LEVELS, smooth=False, indexing="odd")
    for a, b in zip(gd, pd):
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("engine", ["points"])
def test_teacher_forced_frame_parity(seq3, engine):
    """Layer 2: same keyframe state in -> same pose and promotion out, for
    EVERY frame of a 30-frame sequence with multiple promotions."""
    frames, golden = seq3
    cam = Pinhole.create(FX, FX, CX, CY)
    tcfg = tracker_config(engine=engine)
    cache = {}
    diffs = []
    for fid in range(1, len(frames)):
        pyr_kf, dpyr_kf, warm = _golden_keyframe_state(frames, golden, fid, cache)
        pyr_cur = gaussian_image_pyramid(jnp.asarray(frames[fid][0]), NUM_LEVELS, smooth=True)
        if engine == "points":
            kfl = prepare_keyframe(pyr_kf, dpyr_kf, tcfg)
            res = solve_pose_points(kfl, pyr_cur, cam, tcfg, warm)
        else:
            res = solve_pose(pyr_kf, dpyr_kf, pyr_cur, cam, tcfg, warm)
        T_ours = np.asarray(res.T)
        T_gold, motion_gold, promoted_gold = golden.per_frame[fid - 1]
        dt = float(np.abs(T_ours[:3, 3] - T_gold[:3, 3]).max())
        dR = float(np.abs(T_ours[:3, :3] - T_gold[:3, :3]).max())
        d = max(dt, dR)
        diffs.append(d)
        assert d < BIFURCATION_TOL, (fid, dt, dR)
        if d < POSE_TOL:
            # Promotion decisions must agree wherever the solves agree (on a
            # bifurcated frame the motion can legitimately sit across the
            # threshold; teacher-forcing prevents any compounding).
            _, promoted_ours = _motion_promoted(T_ours)
            assert promoted_ours == promoted_gold, (fid, motion_gold)
    diffs = np.asarray(diffs)
    bifurcated = (diffs >= POSE_TOL).sum()
    assert bifurcated <= MAX_BIFURCATION_FRACTION * len(diffs), (
        bifurcated, len(diffs), np.sort(diffs)[-5:])
    # Off the bifurcated frames, agreement must be near exact — the tight
    # tolerance is what catches quirk drift.
    assert np.median(diffs) < 2e-4, float(np.median(diffs))


def test_teacher_forced_depth_parity(seq3):
    """Layer 3: the full depth frontend at every golden keyframe — selection
    and search exact via stage tests; the shared-lambda refinement LM agrees
    within its float32 bifurcation band."""
    frames, golden = seq3
    ccfg, dcfg = camera_config(), depth_config()
    bifurcated = 0
    for kf_id in golden.keyframe_ids:
        val_g, _, dep_g, ok_g = compute_depth_np(frames[kf_id][0], frames[kf_id][1],
                                                 golden_config())
        dres = compute_depth(jnp.asarray(frames[kf_id][0]), jnp.asarray(frames[kf_id][1]),
                             ccfg, dcfg)
        assert bool(dres.ok) == ok_g
        vg = val_g == 1
        vp = np.asarray(dres.valid)
        flips = (vg != vp).sum()
        both = vg & vp
        dmax = np.abs(dep_g - np.asarray(dres.inv_depth))[both].max()
        if flips > max(8, int(0.01 * vg.sum())) or dmax >= REFINE_TOL:
            # A bifurcated LM path (different shared-lambda trajectory) moves
            # every pixel a little and flips a few % of validity decisions;
            # bounded and rare (see module docstring layer 3).
            bifurcated += 1
            assert flips <= 0.05 * vg.sum(), (kf_id, flips, vg.sum())
            assert dmax < 0.2, (kf_id, dmax)
        else:
            assert flips <= max(8, int(0.01 * vg.sum())), (kf_id, flips, vg.sum())
            assert dmax < REFINE_TOL, (kf_id, dmax)
    # Budget from measurement: 3 of 12 keyframes on seed 3 take the bifurcated
    # band (np pairwise vs XLA reduction order flips a shared-lambda
    # accept/reject); every one stays inside the inner flip/dmax bounds. The
    # cap keeps >=3/4 of keyframes in the tight band so quirk drift (which
    # moves EVERY keyframe) cannot hide in it.
    assert bifurcated <= max(2, int(0.25 * len(golden.keyframe_ids))), bifurcated


def test_refine_interp_quirk_separates(seq3):
    """The refinement warp quirk (floor vs sub-pixel) must move depths by
    clearly more than the bifurcation noise floor: the parity config's
    agreement with golden is only meaningful if a drifted flag is visible."""
    frames, _ = seq3
    ccfg = camera_config()
    a = compute_depth(jnp.asarray(frames[0][0]), jnp.asarray(frames[0][1]),
                      ccfg, depth_config())
    b = compute_depth(jnp.asarray(frames[0][0]), jnp.asarray(frames[0][1]),
                      ccfg, depth_config(interp="bilinear"))
    both = np.asarray(a.valid) & np.asarray(b.valid)
    moved = np.abs(np.asarray(a.inv_depth) - np.asarray(b.inv_depth))[both]
    # Most pixels move by the sub-pixel correction (up to 0.5 px of
    # disparity); the golden-vs-parity median on a non-bifurcated frame is 0.
    assert np.median(moved) > 2e-4, float(np.median(moved))


def test_quirk_flags_break_frame_parity(seq3):
    """The teacher-forced tolerance catches drift: flipping the two biggest
    quirk flags (warp interpolation, depth decimation phase) moves the frame-1
    pose far beyond POSE_TOL."""
    frames, golden = seq3
    cam = Pinhole.create(FX, FX, CX, CY)
    cache = {}
    pyr_kf, dpyr_kf, warm = _golden_keyframe_state(frames, golden, 1, cache)
    T_gold = golden.per_frame[0][0]

    drifted = tracker_config(interp="bilinear", depth_decimation="even")
    kfl = prepare_keyframe(pyr_kf, dpyr_kf, drifted)
    res = solve_pose_points(kfl, pyr_cur=gaussian_image_pyramid(
        jnp.asarray(frames[1][0]), NUM_LEVELS, smooth=True), cam=cam, cfg=drifted,
        T_init=warm)
    dt = float(np.abs(np.asarray(res.T)[:3, 3] - T_gold[:3, 3]).max())
    assert dt > 10 * POSE_TOL, dt


@pytest.mark.slow
def test_teacher_forced_frame_parity_seed7_dense():
    """Second seed + the dense engine (the other parity execution path).

    Uses the same bifurcation-budget structure as the points variant above:
    the dense engine's reduction order differs from the points engine's, so
    its LM accept/reject float32 ties land on different frames (measured on
    this seed: frame 14 at 2.07e-3 — just past POSE_TOL, well inside the
    bifurcation band; everything else ~1e-5)."""
    frames = _render_sequence(seed=7, num_frames=30)
    golden = run_golden(frames, golden_config())
    assert golden.failed_at is None and len(golden.keyframe_ids) >= 3
    cam = Pinhole.create(FX, FX, CX, CY)
    tcfg = tracker_config(engine="dense")
    cache = {}
    diffs = []
    for fid in range(1, len(frames)):
        pyr_kf, dpyr_kf, warm = _golden_keyframe_state(frames, golden, fid, cache)
        pyr_cur = gaussian_image_pyramid(jnp.asarray(frames[fid][0]), NUM_LEVELS, smooth=True)
        res = solve_pose(pyr_kf, dpyr_kf, pyr_cur, cam, tcfg, warm)
        T_ours = np.asarray(res.T)
        T_gold = golden.per_frame[fid - 1][0]
        d = max(
            float(np.abs(T_ours[:3, 3] - T_gold[:3, 3]).max()),
            float(np.abs(T_ours[:3, :3] - T_gold[:3, :3]).max()),
        )
        diffs.append(d)
        assert d < BIFURCATION_TOL, (fid, d)
    diffs = np.asarray(diffs)
    bifurcated = (diffs >= POSE_TOL).sum()
    assert bifurcated <= MAX_BIFURCATION_FRACTION * len(diffs), (
        bifurcated, len(diffs), np.sort(diffs)[-5:])
    assert np.median(diffs) < 2e-4, float(np.median(diffs))
