"""End to end A/B of the stereo search on the GPU: the Triton band kernel
against the XLA cost-matrix path, through bench.py's workload.

  python tools/search_ab.py                 # sides xla, triton, triton, xla
  python tools/search_ab.py --scene 3       # one plane scene under every trajectory
  python tools/search_ab.py --seeds 0,1,2   # other seeds than bench.py's

Each side runs in its own process, one after the other, so that one JAX
process holds the card at a time; the order alternates so that drift over
the call (clocks, heat) falls on both sides. A side runs bench.py's seeds
(49 frames, 0.35 m steps) in the fast preset (lazy depth: the band search on
promotion frames), the accurate preset (depth and the band search with the
lr check on every frame) and the parity preset (`kitti_config`: depth and the
full search on every frame), and prints one JSON line per (preset, seed):
mte, and bench.py's throughput where the seed tracks. The xla side replaces the
kernel's entry point with the cost-matrix search before anything is traced.
The summary compares frames/s on the seeds that track in every run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = ("fast", "accurate", "parity")


def run_side(side: str, seeds: list[int] | None, scene: int | None):
    sys.path.insert(0, ROOT)
    import jax

    import bench
    from odometry_tpu.config import accurate_config, fast_config, kitti_config
    from odometry_tpu.kernels import disparity, disparity_triton
    from odometry_tpu.utils.compile_cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("search_ab: needs a GPU")
    enable_compile_cache()
    if side == "xla":
        disparity_triton.band_winner_maps = (
            lambda a, b, interpret=False, **kw: disparity.cost_matrix_winner_maps(a, b, **kw))
    for preset, cfg_fn in zip(PRESETS, (fast_config, accurate_config, kitti_config)):
        cfg = cfg_fn()
        runs = bench.run_seeds(cfg, seeds=seeds or bench.SEEDS, scene_seed=scene)
        for (_, _, _, failed_at), row in zip(runs, bench.timed_seeds(cfg, runs)):
            print(json.dumps(dict(side=side, preset=preset, scene=scene,
                                  failed_at=failed_at, **row)), flush=True)


def summarize(rows, order):
    for preset in PRESETS:
        runs = [[r for r in rows if r["run"] == k and r["preset"] == preset]
                for k in range(len(order))]
        seeds = [r["seed"] for r in runs[0]]
        tracked = [s for i, s in enumerate(seeds) if all(run[i]["fps"] for run in runs)]
        print(f"{preset}: seeds {seeds}, tracking in every run {tracked}")
        for side in dict.fromkeys(order):
            mine = [run for run, name in zip(runs, order) if name == side]
            mtes = [[round(r["mte"], 4) for r in run] for run in mine]
            fps = [float(np.median([r["fps"] for r in run if r["seed"] in tracked]))
                   for run in mine] if tracked else None
            print(f"  {side}: mte per run {mtes}; median frames/s per run {fps}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--order", default="xla,triton,triton,xla")
    ap.add_argument("--seeds", default=None, help="comma-separated; default bench.py's")
    ap.add_argument("--scene", type=int, default=None,
                    help="render this plane scene under every trajectory")
    ap.add_argument("--side", choices=("xla", "triton"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.side:
        run_side(args.side, args.seeds and [int(v) for v in args.seeds.split(",")],
                 args.scene)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())
    order = args.order.split(",")
    rows = []
    for k, side in enumerate(order):
        cmd = [sys.executable, os.path.abspath(__file__), "--side", side]
        if args.seeds:
            cmd += ["--seeds", args.seeds]
        if args.scene is not None:
            cmd += ["--scene", str(args.scene)]
        out = subprocess.run(cmd, check=True, stdout=subprocess.PIPE, text=True).stdout
        print(out, end="", flush=True)
        rows += [dict(json.loads(line), run=k) for line in out.splitlines()
                 if line.startswith("{")]
    summarize(rows, order)
    return 0


if __name__ == "__main__":
    sys.exit(main())
