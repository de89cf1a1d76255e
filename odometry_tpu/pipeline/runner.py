"""Host-side sequence runner: IO + the jitted per-frame step.

Equivalent role to the reference's ``main()`` loop
(``run_odometry_kitti_offline.cpp:198-282``): feed frames, collect the
trajectory, stop on depth failure, export results. All compute lives in the
jitted :func:`odometry_tpu.pipeline.odometry.step`.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Callable, Iterable, Iterator, Optional

import jax
import jax.numpy as jnp
import numpy as np

from odometry_tpu.config import PipelineConfig
from odometry_tpu.pipeline.odometry import init, step, OdometryState, StepOutput
from odometry_tpu.utils.checkpoint import load_pytree, save_pytree


@functools.cache
def _compiled(cfg: PipelineConfig, with_pose0: bool):
    """Per-config jitted entry points, cached across runner invocations.

    PipelineConfig is a frozen dataclass of hashables, so it keys the cache;
    re-running a sequence (or another sequence with the same config) reuses
    the compiled executables instead of re-tracing.
    """
    if with_pose0:
        jit_init = jax.jit(lambda l, r, p0: init(l, r, cfg, p0))
    else:
        jit_init = jax.jit(lambda l, r: init(l, r, cfg, None))
    jit_step = jax.jit(lambda s, l, r: step(s, l, r, cfg))
    return jit_init, jit_step


class InitFailed(RuntimeError):
    """The depth frontend failed on the first frame: there is no map."""


@dataclasses.dataclass
class RunResult:
    poses: np.ndarray  # (N, 4, 4) absolute predicted poses
    keyframe_ids: list  # frame indices promoted to keyframe (0 included)
    num_frames: int
    failed_at: Optional[int]  # frame index where depth failed, or None
    fps: float
    per_frame_ms: list
    lost_ids: list = dataclasses.field(default_factory=list)  # tracking-lost frames
    stage_report: dict = dataclasses.field(default_factory=dict)  # StageTimer.report()
    # (image, inverse_depth, valid) per keyframe when collect_vis was set.
    vis: list = dataclasses.field(default_factory=list)


def run_sequence(
    frames: Iterable,
    cfg: PipelineConfig,
    init_pose: np.ndarray | None = None,
    stop_on_depth_failure: bool = True,
    progress: Callable[[int, StepOutput], None] | None = None,
    timer: "StageTimer | None" = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    collect_vis: bool = False,
    debug_checks: bool = False,
) -> RunResult:
    """Run odometry over an iterable of (left, right) float32 image pairs.

    The first pair initializes the system (frame 0 pose = `init_pose` or
    identity, like the reference seeding with gt_poses[0], ``:96-98``).

    Operability features (SURVEY §5):
      * `timer`: a utils.profiling.StageTimer accumulating io / step / sync
        spans; the report lands in RunResult.stage_report.
      * `checkpoint_path` + `checkpoint_every=N`: persist the full odometry
        state + trajectory every N frames (utils.checkpoint); `resume=True`
        restarts mid-sequence from that file, skipping completed frames.
      * `collect_vis`: keep (image, inverse_depth, valid) for every promoted
        keyframe so the driver can write save_to_vis-style dumps.
      * `debug_checks`: run the checkify-instrumented step (utils/debug.py):
        a NaN/Inf input or estimate, or an out-of-bounds index anywhere in
        the jitted step, raises a LOCALIZED JaxRuntimeError at that frame
        instead of being silently absorbed by the isfinite guards. Several
        times slower; for hunts, not production.
    """
    from odometry_tpu.utils.profiling import StageTimer

    if timer is None:
        timer = StageTimer()
    it: Iterator = iter(frames)
    with timer.stage("io"):
        left0, right0 = next(it)

    jit_init, jit_step = _compiled(cfg, init_pose is not None)
    if debug_checks:
        from odometry_tpu.utils.debug import checked_step

        checked = checked_step(cfg)

        def jit_step(s, l, r):  # noqa: F811 — instrumented replacement
            err, out = checked(s, l, r)
            err.throw()
            return out
    with timer.stage("init"):
        if init_pose is not None:
            state, ok0 = jit_init(
                jnp.asarray(left0), jnp.asarray(right0), jnp.asarray(init_pose)
            )
        else:
            state, ok0 = jit_init(jnp.asarray(left0), jnp.asarray(right0))
        jax.block_until_ready(state.cur_pose)
    if not bool(ok0):
        raise InitFailed("Init 0-th frame failed! (depth frontend)")

    poses = [np.asarray(state.cur_pose)]
    keyframe_ids = [0]
    lost_ids = []
    vis = []
    times = []
    failed_at = None
    done_frames = 0
    if collect_vis:
        vis.append(
            (
                np.asarray(left0, np.float32),
                np.asarray(state.kf_dpyr[0]),
                np.asarray(state.kf_valid),
            )
        )

    if resume and checkpoint_path is not None and os.path.exists(checkpoint_path):
        with timer.stage("resume"):
            payload = _checkpoint_template(state)
            payload = load_pytree(checkpoint_path, payload)
            state = jax.tree_util.tree_map(jnp.asarray, payload["state"])
            poses = [p for p in payload["poses"]]
            keyframe_ids = [int(v) for v in payload["keyframe_ids"]]
            lost_ids = [int(v) for v in payload["lost_ids"]]
            done_frames = int(payload["frame_id"])

    # With the relocalization policy active, a depth failure on a recovery
    # probe is handled by the policy, not fatal to the run.
    stop_on_depth_failure = stop_on_depth_failure and not cfg.keyframe.relocalize
    t_start = time.perf_counter()
    frame_id = done_frames
    for frame_id, (left, right) in enumerate(it, start=1):
        if frame_id <= done_frames:
            continue  # already completed before the resume point
        t0 = time.perf_counter()
        with timer.stage("step"):
            state, out = jit_step(state, jnp.asarray(left), jnp.asarray(right))
        with timer.stage("sync"):
            # ONE packed device->host transfer per frame (StepOutput.summary):
            # separate np.asarray/bool() reads each cost a full round trip.
            summ = np.asarray(out.summary)  # blocks
        times.append((time.perf_counter() - t0) * 1e3)
        out_pose = summ[:16].reshape(4, 4)
        poses.append(out_pose)
        if summ[32] > 0.5:  # promoted
            keyframe_ids.append(frame_id)
            if collect_vis:
                vis.append(
                    (
                        np.asarray(left, np.float32),
                        np.asarray(out.inv_depth),
                        np.asarray(out.valid),
                    )
                )
        if summ[33] > 0.5:  # lost
            lost_ids.append(frame_id)
        if progress is not None:
            progress(frame_id, out)
        if checkpoint_path is not None and checkpoint_every > 0 and (
            frame_id % checkpoint_every == 0
        ):
            with timer.stage("checkpoint"):
                save_pytree(
                    checkpoint_path,
                    _checkpoint_payload(state, poses, keyframe_ids, lost_ids, frame_id),
                )
        if not summ[34] > 0.5:  # depth_ok
            if failed_at is None:
                failed_at = frame_id
            if stop_on_depth_failure:
                break
    total = time.perf_counter() - t_start
    if checkpoint_path is not None and checkpoint_every > 0 and frame_id > done_frames:
        save_pytree(
            checkpoint_path,
            _checkpoint_payload(state, poses, keyframe_ids, lost_ids, frame_id),
        )
    n = len(poses)
    return RunResult(
        poses=np.stack(poses),
        keyframe_ids=keyframe_ids,
        num_frames=n,
        failed_at=failed_at,
        fps=(n - 1 - done_frames) / total if n - 1 > done_frames else 0.0,
        per_frame_ms=times,
        lost_ids=lost_ids,
        stage_report=timer.report(),
        vis=vis,
    )


def _checkpoint_payload(state, poses, keyframe_ids, lost_ids, frame_id):
    return {
        "state": state,
        "poses": np.stack(poses),
        "keyframe_ids": np.asarray(keyframe_ids, np.int64),
        "lost_ids": np.asarray(lost_ids, np.int64),
        "frame_id": np.asarray(frame_id, np.int64),
    }


def _checkpoint_template(state):
    """Structure template for load_pytree; array shapes of the variable-length
    fields are resolved from the file (load_pytree checks shapes only when the
    template leaf has one, so plain Python placeholders stay flexible)."""

    class _AnyShape:
        pass

    return {
        "state": state,
        "poses": _AnyShape(),
        "keyframe_ids": _AnyShape(),
        "lost_ids": _AnyShape(),
        "frame_id": _AnyShape(),
    }
