"""Multi-sequence data-parallel odometry sweep over a device mesh.

The reference is strictly single-sequence, single-thread
(``run_odometry_kitti_offline.cpp:3``); the scaling axis for the
22-sequence KITTI sweep is one sequence per device along a ``seq`` mesh axis
(SURVEY.md §2). Each device advances its own OdometryState; global health and
metrics are reduced with ``psum`` across devices.

Built on ``shard_map`` + ``vmap`` so the same code runs on any mesh size —
including the virtual 8-device CPU mesh used in tests and the driver's
dry-run.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from odometry_tpu.config import PipelineConfig
from odometry_tpu.pipeline.odometry import init, step, OdometryState, StepOutput


def batched_init(
    left_b: jax.Array, right_b: jax.Array, cfg: PipelineConfig, mesh: Mesh
) -> OdometryState:
    """Initialize a batch of sequences, batch axis sharded over mesh axis 'seq'."""

    def local(l, r):
        state, _ = jax.vmap(lambda a, b: init(a, b, cfg))(l, r)
        return state

    f = shard_map(local, mesh=mesh, in_specs=(P("seq"), P("seq")), out_specs=P("seq"), check_vma=False)
    return jax.jit(f)(left_b, right_b)


@functools.cache
def step_fn_for_mesh(cfg: PipelineConfig, mesh: Mesh):
    """The jitted sharded sweep step for (cfg, mesh), cached.

    Exposed (rather than private to :func:`batched_step`) so the scaling
    harness can ``.lower().compile()`` it for cost analysis without running.
    """

    def local(state, l, r):
        new_state, out = jax.vmap(lambda s, a, b: step(s, a, b, cfg))(state, l, r)
        local_ok = jnp.sum(out.depth_ok.astype(jnp.int32))
        total_ok = jax.lax.psum(local_ok, "seq")
        total = jax.lax.psum(jnp.asarray(l.shape[0], jnp.int32), "seq")
        return new_state, out, total_ok == total

    f = shard_map(
        local,
        mesh=mesh,
        in_specs=(P("seq"), P("seq"), P("seq")),
        out_specs=(P("seq"), P("seq"), P()),
        check_vma=False,
    )
    return jax.jit(f)


def batched_step(
    states: OdometryState,
    left_b: jax.Array,
    right_b: jax.Array,
    cfg: PipelineConfig,
    mesh: Mesh,
):
    """One odometry step for every sequence; returns (states, outs, global_ok).

    global_ok is a psum-reduction: True iff every sequence on every
    device is still healthy (depth frontend succeeding).
    """
    return step_fn_for_mesh(cfg, mesh)(states, left_b, right_b)


def run_sweep(
    frames_per_seq,
    cfg: PipelineConfig,
    mesh: Mesh,
):
    """Host loop over a batch of sequences (list of per-seq frame lists).

    All sequences must have equal length; returns stacked poses
    (num_seqs, num_frames, 4, 4).
    """
    import numpy as np

    num_seqs = len(frames_per_seq)
    num_frames = len(frames_per_seq[0])
    lefts0 = jnp.stack([jnp.asarray(f[0][0]) for f in frames_per_seq])
    rights0 = jnp.stack([jnp.asarray(f[0][1]) for f in frames_per_seq])
    states = batched_init(lefts0, rights0, cfg, mesh)
    poses = [np.asarray(states.cur_pose)]
    step_fn = functools.partial(batched_step, cfg=cfg, mesh=mesh)
    for i in range(1, num_frames):
        lefts = jnp.stack([jnp.asarray(f[i][0]) for f in frames_per_seq])
        rights = jnp.stack([jnp.asarray(f[i][1]) for f in frames_per_seq])
        states, outs, global_ok = step_fn(states, lefts, rights)
        poses.append(np.asarray(outs.cur_pose))
    return np.stack(poses, axis=1)  # (num_seqs, num_frames, 4, 4)
