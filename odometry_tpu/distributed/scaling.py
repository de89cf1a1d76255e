"""Multi-host initialization + weak-scaling measurement for the sweep.

The reference has no distribution at all (single thread, one process —
``run_odometry_kitti_offline.cpp:3``); the scaling design (SURVEY.md
§2 end) is data parallelism over sequences via ``shard_map`` on a ``seq`` mesh
axis, with health/metric reductions as the only collectives. This module adds
the two pieces the design needs to run beyond one process:

* :func:`initialize_multihost` — ``jax.distributed.initialize`` wiring, driven
  by explicit args or the standard env vars; a no-op for single-process runs,
  so every driver can call it unconditionally.
* :func:`sweep_scaling_report` — weak-scaling measurement of the sweep step
  at mesh sizes 1..N. Two views are reported, because they answer different
  questions:

  - **analytic** (always meaningful): per-device FLOPs and the collective
    bytes of the compiled SPMD program, read from XLA's cost analysis / HLO.
    Data parallelism over sequences is embarrassingly parallel, so per-device
    FLOPs must stay constant (efficiency = flops(1)/flops(n)) and collective
    traffic must stay O(bytes), independent of frame size. This is the
    property that transfers to a real pod slice, and it is exactly what the
    virtual CPU mesh can validate (its 8 "devices" share the same host cores,
    so wall-clock over virtual devices measures the host, not the design).
  - **wall-clock** (meaningful on real multi-chip hardware): steps/s at each
    mesh size and efficiency vs. size-1, reported so the same harness run on
    a pod slice produces the ≥80 % scaling-efficiency number directly.
"""

from __future__ import annotations

import os
import re
import time
from typing import Sequence

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from odometry_tpu.config import PipelineConfig


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize ``jax.distributed`` for a multi-process (multi-host) run.

    Args fall back to the standard environment variables
    (``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``).
    Returns True when a multi-process runtime was initialized, False
    for the single-process no-op, so callers can branch on it for logging.

    After this returns True, ``jax.devices()`` is the GLOBAL device list and
    the meshes built by :mod:`odometry_tpu.distributed.mesh` span hosts; DP
    sweep inputs must then be created per-host with
    :func:`stack_local_frames`.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes in (None, 1):
        return False  # single process: nothing to do
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def stack_local_frames(frames: Sequence, mesh: Mesh) -> tuple[jax.Array, jax.Array]:
    """Build the globally-sharded (S, H, W) left/right stacks for the sweep
    from THIS process's local (left, right) frame pairs.

    Single-process meshes take the fast path (device_put of the full stack);
    multi-process meshes assemble the global array from per-process shards
    without ever materializing remote data locally.
    """
    lefts = jnp.stack([jnp.asarray(l) for l, _ in frames])
    rights = jnp.stack([jnp.asarray(r) for _, r in frames])
    sharding = NamedSharding(mesh, P("seq"))
    if jax.process_count() == 1:
        return jax.device_put(lefts, sharding), jax.device_put(rights, sharding)
    make = jax.make_array_from_process_local_data
    return make(sharding, np.asarray(lefts)), make(sharding, np.asarray(rights))


def _collective_bytes(compiled) -> int:
    """Sum the output bytes of all-reduce/all-gather ops in the compiled HLO —
    the sweep's total per-step collective traffic."""
    try:
        hlo = compiled.as_text()
    except Exception:
        return -1
    total = 0
    sizes = {"f32": 4, "s32": 4, "u32": 4, "bf16": 2, "f16": 2,
             "pred": 1, "s8": 1, "u8": 1, "f64": 8, "s64": 8}
    # HLO text shape: `%name = s32[2,3]{...} all-reduce(...)`, or the tuple
    # form `%name = (s32[], s32[]) all-reduce(...)`; `-start` variants are the
    # async halves (count only those, `-done` repeats the shape).
    for line in hlo.splitlines():
        m = re.search(
            r"=\s*(\(?[^=]*?\)?)\s*(all-reduce|all-gather|reduce-scatter)(-start)?\(",
            line,
        )
        if not m or f"{m.group(2)}-done" in line:
            continue
        for dtype, dims in re.findall(r"([a-z][a-z0-9]*)\[([0-9,]*)\]", m.group(1)):
            n = 1
            for d in filter(None, dims.split(",")):
                n *= int(d)
            total += n * sizes.get(dtype, 4)
    return total


def sweep_scaling_report(
    cfg: PipelineConfig,
    mesh_sizes: Sequence[int],
    *,
    reps: int = 3,
    timed: bool | None = None,
) -> list[dict]:
    """Measure the sweep step at each mesh size; one dict per size.

    Keys: n, flops_per_device, collective_bytes, analytic_efficiency_pct,
    and (when `timed`) steps_per_s, wall_efficiency_pct. `timed` defaults to
    True on real accelerator platforms and False on CPU (where the virtual
    devices share host cores and wall-clock measures the host, not scaling).
    """
    from odometry_tpu.camera import Pinhole
    from odometry_tpu.data.synthetic import make_scene, render_stereo
    from odometry_tpu.distributed.sweep import batched_init, step_fn_for_mesh

    if timed is None:
        timed = jax.devices()[0].platform != "cpu"

    cam_cfg = cfg.camera
    cam = Pinhole.create(cam_cfg.fx, cam_cfg.fy, cam_cfg.cx, cam_cfg.cy)
    rows: list[dict] = []
    base_flops = None
    base_rate = None
    for n in mesh_sizes:
        devs = np.array(jax.devices()[:n])
        mesh = Mesh(devs, ("seq",))
        frames = []
        for s in range(n):
            scene = make_scene(s, depth=14.0)
            l, r, _ = render_stereo(
                scene, cam, cam_cfg.baseline, jnp.eye(4), cam_cfg.height, cam_cfg.width
            )
            frames.append((l, r))
        left_b, right_b = stack_local_frames(frames, mesh)
        states = batched_init(left_b, right_b, cfg, mesh)

        step = step_fn_for_mesh(cfg, mesh)
        lowered = step.lower(states, left_b, right_b)
        compiled = lowered.compile()
        cost = compiled.cost_analysis() or {}
        if isinstance(cost, list):  # older jax returns [dict]
            cost = cost[0] if cost else {}
        flops = float(cost.get("flops", float("nan")))
        cbytes = _collective_bytes(compiled)
        if base_flops is None:
            base_flops = flops
        row = {
            "n": n,
            "flops_per_device": flops,
            "collective_bytes": cbytes,
            "analytic_efficiency_pct": round(100.0 * base_flops / flops, 1)
            if flops == flops and flops > 0
            else float("nan"),
        }
        if timed:
            new_states, outs, ok = compiled(states, left_b, right_b)
            jax.block_until_ready(new_states.cur_pose)
            t0 = time.perf_counter()
            for _ in range(reps):
                new_states, outs, ok = compiled(states, left_b, right_b)
            jax.block_until_ready(new_states.cur_pose)
            dt = (time.perf_counter() - t0) / reps
            rate = n / dt  # sequences advanced per second
            if base_rate is None:
                base_rate = rate
            row["steps_per_s"] = round(rate, 2)
            row["wall_efficiency_pct"] = round(100.0 * rate / (base_rate * n), 1)
        rows.append(row)
    return rows


def format_scaling_table(rows: list[dict]) -> str:
    cols = ["n", "flops_per_device", "collective_bytes",
            "analytic_efficiency_pct", "steps_per_s", "wall_efficiency_pct"]
    present = [c for c in cols if any(c in r for r in rows)]
    lines = ["  ".join(f"{c:>24s}" for c in present)]
    for r in rows:
        lines.append("  ".join(f"{str(r.get(c, '-')):>24s}" for c in present))
    return "\n".join(lines)
