"""The jittable odometry pipeline: init + per-frame step with keyframe policy.

Re-expression of the reference KITTI driver's frame loop
(``run_odometry_kitti_offline.cpp:94-271``) as pure functions over a
fixed-shape state pytree, so the entire per-frame computation is ONE jitted
call (host code does IO only):

  state = init(left0, right0, ...)
  state, out = step(state, left, right)   # jit, device-resident

Faithful reference semantics:
* pose is tracked frame-to-KEYFRAME and chained through the keyframe absolute
  pose: ``cur = kf_pose @ inverse(pose_to_kf)`` (``:215-218``),
* depth is recomputed every frame (``:229``) and the current frame's pyramids
  replace the "previous" ones every frame (``:249-252``),
* keyframe promotion when the weighted motion magnitude
  ``[|angX|,|angY|,|angZ|,|tx|,|ty|,|tz|] . w > 1.1`` (``:254-258``) — the
  promoted keyframe is the CURRENT frame (pyramids just built),
* the tracker is warm-started with the last pose_to_keyframe in BOTH branches
  (``Reset(pose_to_keyframe, 0.01)`` at ``:261`` and ``:268``) — including
  right after promotion, a reference quirk we reproduce,
* a failed depth frame (too few survivors) leaves the keyframe unchanged; the
  host runner decides whether to stop (the reference breaks the loop, ``:230``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from odometry_tpu.camera.pinhole import Pinhole
from odometry_tpu.config import PipelineConfig
from odometry_tpu.depth.estimator import compute_depth
from odometry_tpu.geometry import (
    rotation_angles_xyz,
    se3_compose,
    se3_identity,
    se3_inverse,
)
from odometry_tpu.image.pyramid import depth_pyramid, gaussian_image_pyramid
from odometry_tpu.tracking.tracker import (
    TrackResult,
    prepare_keyframe,
    solve_pose,
    solve_pose_points,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class OdometryState:
    """Everything carried frame to frame. Fixed shapes; jit-friendly."""

    kf_pyr: Tuple[jax.Array, ...]  # keyframe image pyramid (level 0 first)
    kf_dpyr: Tuple[jax.Array, ...]  # keyframe inverse-depth pyramid
    kf_track: tuple  # engine="points": per-level KeyframeLevel; else ()
    kf_valid: jax.Array  # (H, W) keyframe depth validity mask
    kf_pose: jax.Array  # (4, 4) keyframe absolute pose (cam-to-world)
    pose_init: jax.Array  # (4, 4) tracker warm start (reference affine_init_)
    cur_pose: jax.Array  # (4, 4) current absolute pose
    prev_rel: jax.Array  # (4, 4) last frame-to-frame motion (for the
    # constant-velocity warm start; identity until two frames exist)
    frame_id: jax.Array  # int32
    kf_count: jax.Array  # int32 number of keyframes so far
    healthy: jax.Array  # bool: last depth frame succeeded
    lost_streak: jax.Array  # int32 consecutive lost frames (relocalize)


class StepOutput(NamedTuple):
    cur_pose: jax.Array  # (4, 4) absolute pose of this frame
    pose_to_kf: jax.Array  # (4, 4) tracker output (kf-cam -> cur-cam)
    promoted: jax.Array  # bool: this frame became the new keyframe
    motion: jax.Array  # weighted motion magnitude
    track_ok: jax.Array  # bool
    depth_ok: jax.Array  # bool
    num_valid_depth: jax.Array  # int32
    track_stats: tuple  # per-level LevelStats (coarsest first)
    lost: jax.Array  # bool: tracking-lost criterion fired this frame
    # Frontend maps for keyframe visual dumps (save_to_vis,
    # run_odometry_kitti_offline.cpp:432-473). Zero-filled on frames where
    # the lazy frontend skipped depth; transfers stay on-device unless the
    # host actually fetches them.
    inv_depth: jax.Array  # (H, W) float32
    valid: jax.Array  # (H, W) bool
    # (39,) f32 packed host summary: everything the per-frame host loop
    # consumes, in ONE device->host transfer. Each np.asarray/bool() on a
    # separate output is its own round trip, which makes a sync-per-frame
    # driver latency-bound. Layout:
    # [0:16] cur_pose, [16:32] new keyframe pose, [32] promoted, [33] lost,
    # [34] depth_ok, [35] track_ok, [36] motion, [37] num_valid_depth,
    # [38] finest-level final cost.
    summary: jax.Array


def _cam(cfg: PipelineConfig) -> Pinhole:
    c = cfg.camera
    return Pinhole.create(c.fx, c.fy, c.cx, c.cy)


def init(
    left: jax.Array,
    right: jax.Array,
    cfg: PipelineConfig,
    init_pose: jax.Array | None = None,
) -> tuple[OdometryState, jax.Array]:
    """Initialize from frame 0 (``run_odometry_kitti_offline.cpp:94-147``).

    Returns (state, depth_ok). The reference exits if frame-0 depth fails.
    """
    n = cfg.tracker.num_levels
    dres = compute_depth(left, right, cfg.camera, cfg.depth)
    pyr = gaussian_image_pyramid(left, n, smooth=True)
    dpyr = depth_pyramid(dres.inv_depth, n, smooth=False,
                         indexing=cfg.tracker.depth_decimation)
    kf_track = (
        prepare_keyframe(pyr, dpyr, cfg.tracker)
        if cfg.tracker.engine == "points"
        else ()
    )
    pose0 = init_pose if init_pose is not None else se3_identity()
    state = OdometryState(
        kf_pyr=pyr,
        kf_dpyr=dpyr,
        kf_track=kf_track,
        kf_valid=dres.valid,
        kf_pose=pose0,
        pose_init=se3_identity(),
        cur_pose=pose0,
        prev_rel=se3_identity(),
        frame_id=jnp.asarray(0, jnp.int32),
        kf_count=jnp.asarray(1, jnp.int32),
        healthy=dres.ok,
        lost_streak=jnp.asarray(0, jnp.int32),
    )
    return state, dres.ok


def step(
    state: OdometryState,
    left: jax.Array,
    right: jax.Array,
    cfg: PipelineConfig,
) -> tuple[OdometryState, StepOutput]:
    """One full odometry frame (``run_odometry_kitti_offline.cpp:198-271``)."""
    n = cfg.tracker.num_levels
    cam = _cam(cfg)

    pyr_cur = gaussian_image_pyramid(left, n, smooth=True)
    if cfg.tracker.engine == "points":
        track: TrackResult = solve_pose_points(
            state.kf_track, pyr_cur, cam, cfg.tracker, state.pose_init
        )
    else:
        track = solve_pose(
            state.kf_pyr, state.kf_dpyr, pyr_cur, cam, cfg.tracker, state.pose_init
        )
    cur_pose = se3_compose(state.kf_pose, se3_inverse(track.T))

    # Keyframe criterion (``:254-258``): per-axis rotation angles of the
    # RELATIVE pose + absolute translation components, weighted.
    # Reference ordering: [angX, angY, angZ, tx, ty, tz].
    angles = jnp.abs(rotation_angles_xyz(track.T[:3, :3]))
    trans = jnp.abs(track.T[:3, 3])
    motion_vec = jnp.stack([angles[0], angles[1], angles[2], trans[0], trans[1], trans[2]])
    weights = jnp.asarray(cfg.keyframe.weights, jnp.float32)
    motion_mag = jnp.dot(motion_vec, weights, precision=jax.lax.Precision.HIGHEST)
    candidate = motion_mag > cfg.keyframe.motion_threshold

    # Tracking-lost criterion (beyond-reference recovery policy; see
    # KeyframeConfig). track_stats is coarsest-first, so [-1] is level 0.
    kcfg = cfg.keyframe
    lost = ~track.ok
    if kcfg.lost_cost_threshold > 0:
        lost = lost | (track.stats[-1].err_final > kcfg.lost_cost_threshold)
    if kcfg.lost_motion_threshold > 0:
        lost = lost | (motion_mag > kcfg.lost_motion_threshold)
    streak = jnp.where(lost, state.lost_streak + 1, 0)
    if kcfg.relocalize:
        # Hold the previous absolute pose instead of chaining a garbage
        # estimate. Re-seed the keyframe from this frame only after
        # `relocalize_patience` consecutive losses: a transient bad solve
        # gets retried against the OLD keyframe from the held-pose start
        # first (see KeyframeConfig.relocalize_patience).
        cur_pose = jnp.where(lost, state.cur_pose, cur_pose)
        candidate = candidate | (lost & (streak >= kcfg.relocalize_patience))

    def depth_products(_):
        dres = compute_depth(left, right, cfg.camera, cfg.depth)
        dpyr_cur = depth_pyramid(dres.inv_depth, n, smooth=False,
                                 indexing=cfg.tracker.depth_decimation)
        track_cur = (
            prepare_keyframe(pyr_cur, dpyr_cur, cfg.tracker)
            if cfg.tracker.engine == "points"
            else ()
        )
        return dres, dpyr_cur, track_cur

    if cfg.depth_every_frame:
        dres, dpyr_cur, track_cur = depth_products(None)
    else:
        # Lazy frontend: only keyframe candidates pay for depth.
        zeros = jax.eval_shape(depth_products, None)
        skip = lambda _: jax.tree_util.tree_map(
            lambda s: jnp.zeros(s.shape, s.dtype), zeros
        )
        dres, dpyr_cur, track_cur = jax.lax.cond(candidate, depth_products, skip, None)
        # A skipped frame reports a healthy frontend (nothing was observed).
        dres = dres._replace(ok=jnp.where(candidate, dres.ok, True))

    promote = candidate & dres.ok

    def sel(new, old):
        return jax.tree_util.tree_map(
            lambda a, b: jnp.where(promote, a, b), new, old
        )

    kf_pose_new = sel(cur_pose, state.kf_pose)

    # Frame-to-frame motion estimate for the constant-velocity model. On a
    # lost frame the held pose makes the measured motion identity, so keep
    # the previous velocity instead of freezing the prediction.
    rel = se3_compose(se3_inverse(state.cur_pose), cur_pose)
    prev_rel = jnp.where(lost, state.prev_rel, rel) if cfg.keyframe.relocalize else rel

    # Warm start for the NEXT frame. Parity: both branches warm-start with
    # pose_to_keyframe (:261, :268). With reset_on_promote, promotion
    # restarts the relative pose at identity (the reference's own TODO at
    # :253). A lost frame's estimate is garbage by definition, so relocalize
    # instead reconstructs the start consistent with the HELD pose:
    # cur = kf_pose @ inv(T)  =>  T_init = inv(cur_pose) @ kf_pose
    # (= identity when this frame re-seeded the keyframe).
    if cfg.tracker.warm_start == "constant_velocity":
        # T maps kf-cam -> cur-cam, so T = inv(cur) @ kf_pose; predicting
        # cur_next = cur @ prev_rel gives T_init = inv(prev_rel) @ inv(cur)
        # @ kf_pose_new — correct across promotions and holds by design.
        pose_init = se3_compose(
            se3_inverse(prev_rel), se3_compose(se3_inverse(cur_pose), kf_pose_new)
        )
    else:
        pose_init = track.T
        if cfg.keyframe.reset_on_promote:
            pose_init = jnp.where(promote, se3_identity(dtype=track.T.dtype), pose_init)
        if cfg.keyframe.relocalize:
            held_init = se3_compose(se3_inverse(cur_pose), kf_pose_new)
            pose_init = jnp.where(lost, held_init, pose_init)

    new_state = OdometryState(
        kf_pyr=sel(pyr_cur, state.kf_pyr),
        kf_dpyr=sel(dpyr_cur, state.kf_dpyr),
        kf_track=sel(track_cur, state.kf_track),
        kf_valid=sel(dres.valid, state.kf_valid),
        kf_pose=kf_pose_new,
        pose_init=pose_init,
        cur_pose=cur_pose,
        prev_rel=prev_rel,
        frame_id=state.frame_id + 1,
        kf_count=state.kf_count + promote.astype(jnp.int32),
        healthy=dres.ok,
        lost_streak=streak,
    )
    f32 = jnp.float32
    summary = jnp.concatenate([
        cur_pose.reshape(-1).astype(f32),
        kf_pose_new.reshape(-1).astype(f32),
        jnp.stack([
            promote.astype(f32),
            lost.astype(f32),
            dres.ok.astype(f32),
            track.ok.astype(f32),
            motion_mag.astype(f32),
            dres.num_valid.astype(f32),
            track.stats[-1].err_final.astype(f32),
        ]),
    ])
    out = StepOutput(
        cur_pose=cur_pose,
        pose_to_kf=track.T,
        promoted=promote,
        motion=motion_mag,
        track_ok=track.ok,
        depth_ok=dres.ok,
        num_valid_depth=dres.num_valid,
        track_stats=track.stats,
        lost=lost,
        inv_depth=dres.inv_depth,
        valid=dres.valid,
        summary=summary,
    )
    return new_state, out
