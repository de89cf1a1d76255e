"""Benchmark: full odometry pipeline frames/s on one device, KITTI-sized.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "mte_median",
"per_seed"}.

Baseline: the reference C++ tracks at ~30 ms/frame on one CPU core
(README.md:80) and additionally runs its stereo frontend every frame, so
33.3 fps is a generous single-core full-pipeline figure (BASELINE.md).

Workload: 376x1241 grayscale stereo at KITTI flow magnitudes (synthetic
scenes — no dataset is fetched), 4-level pyramids, frame-to-keyframe LM
tracking, semi-dense stereo depth on keyframe promotion, production
`fast_config` (sub-pixel warps, aligned pyramids, lazy depth, identity reset
on promotion — strictly more accurate than the reference's quirk set; see
config.py). Driven frame-by-frame through the cached jitted step.
Accuracy is checked against exact synthetic ground truth; frames/s is timed
only on the seeds that track (mte under the gate), so no rate is taken on a
diverged trajectory.
"""

import json
import sys
import time

import numpy as np

NUM_FRAMES = 49
SEEDS = (4, 5, 11)
MTE_GATE = 0.15


def run_seeds(cfg, seeds=SEEDS, scene_seed=None):
    """Run each seed's plane scene under its own trajectory through
    run_sequence (`scene_seed` renders that one scene under every
    trajectory instead).

    Returns one (seed, mte, device-resident frames, failed_at) per seed;
    mte is inf where the first frame's depth failed.
    The gate is the MEDIAN over the seeds: one scene or trajectory can be
    green or red on luck (the wider sweep is tools/accuracy_sweep.py, which
    builds its scenes the same way). Frames are staged in device memory up
    front, as a prefetcher would.
    """
    import jax
    import jax.numpy as jnp

    from odometry_tpu.camera import Pinhole
    from odometry_tpu.data.synthetic import make_scene, drive_trajectory, render_stereo
    from odometry_tpu.eval.metrics import mean_translation_error
    from odometry_tpu.pipeline.runner import InitFailed, run_sequence

    H, W = cfg.camera.height, cfg.camera.width
    cam = Pinhole.create(cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy)
    render = jax.jit(lambda scene, T: render_stereo(scene, cam, cfg.camera.baseline, T, H, W))
    runs = []
    for seed in seeds:
        scene = make_scene(seed if scene_seed is None else scene_seed, depth=14.0)
        poses = drive_trajectory(NUM_FRAMES, step=0.35, seed=seed)
        frames = [tuple(render(scene, jnp.asarray(T))[:2]) for T in poses]
        try:
            res = run_sequence(frames, cfg)
        except InitFailed:
            runs.append((seed, float("inf"), frames, 0))
            continue
        mte = float(mean_translation_error(poses[: res.num_frames], res.poses))
        runs.append((seed, mte, frames, res.failed_at))
    return runs


def check_gate(runs):
    """Median mte over the seeds; exits when depth failed or the median is
    not under MTE_GATE."""
    mtes = [mte for _, mte, _, _ in runs]
    for seed, _, _, failed_at in runs:
        if failed_at is not None:
            raise SystemExit(f"depth frontend failed at frame {failed_at} (seed {seed})")
    med = float(np.median(mtes))
    if not med < MTE_GATE:
        raise SystemExit(f"bench accuracy regression: median mte={med} ({mtes})")
    return med


def throughput(cfg, frames, reps=5):
    """Median frames/s of `reps` replays of the sequence through the cached
    compiled step, one sync at the end of each (async dispatch keeps host and
    device overlapped). Each replay starts from the first frame's state, so
    it repeats the run that was scored; one untimed replay first runs every
    branch once."""
    import jax

    from odometry_tpu.pipeline.runner import _compiled

    jit_init, jit_step = _compiled(cfg, False)
    rates = []
    for rep in range(reps + 1):
        state, _ = jit_init(*frames[0])
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        for (l, r) in frames[1:]:
            state, out = jit_step(state, l, r)
        jax.block_until_ready(out.cur_pose)
        if rep:
            rates.append((len(frames) - 1) / (time.perf_counter() - t0))
    return float(np.median(rates))


def timed_seeds(cfg, runs):
    """Per seed {"seed", "mte", "fps"}: fps is None where the seed's mte is
    not under MTE_GATE (a lost track does other work per frame)."""
    return [{"seed": seed, "mte": mte,
             "fps": throughput(cfg, frames) if mte < MTE_GATE else None}
            for seed, mte, frames, _ in runs]


def measure(cfg):
    """(median mte, per-seed rows, median frames/s over the seeds that
    track) for the bench workload under `cfg`; exits if the gate fails."""
    runs = run_seeds(cfg)
    med = check_gate(runs)
    rows = timed_seeds(cfg, runs)
    fps = float(np.median([r["fps"] for r in rows if r["fps"] is not None]))
    return med, rows, fps


def main():
    from odometry_tpu.config import fast_config
    from odometry_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    med, rows, fps = measure(fast_config())

    baseline_fps = 1000.0 / 30.0  # reference tracking-only latency, README.md:80
    print(
        json.dumps(
            {
                "metric": "full_pipeline_frames_per_second_kitti_size_1chip",
                "value": fps,
                "unit": "frames/s",
                "vs_baseline": fps / baseline_fps,
                "mte_median": med,
                "per_seed": rows,
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
