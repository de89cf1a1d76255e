"""Multi-seed / multi-scene accuracy sweep backing the preset tuning.

The bench gate (bench.py: mte < 0.15 on one plane trajectory) is one
trajectory wide; this harness measures the fast/accurate presets over
SEEDS trajectory seeds x three scene families (the bench's plane scene, the
parity tests' driving geometry, and a natural ridged texture with the
photometric nuisance model applied) at full KITTI size, reports
median/min/max, and exits nonzero if any config's MEDIAN is not green with
margin. Results table is written to ACCURACY.md.

Run on the GPU:  python tools/accuracy_sweep.py
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np

SEEDS = [3, 4, 5, 11, 23]
GATE = 0.15
MARGIN = 0.30  # require median <= GATE * (1 - MARGIN)
# The textured family deliberately stresses the algorithm class's known
# limitation — a raw photometric residual with no illumination model
# (lm_optimizer.cpp:217) on C0 multi-octave texture with sensor nuisances —
# so its gate is the bench gate itself, without the clean families' extra
# 30% margin (measured difficulty ~2x the clean families for BOTH presets;
# the opt-in TrackerConfig.affine_light halves its tail, see
# kernels/points.fit_affine_ab).
FAMILY_MARGIN = {"plane": MARGIN, "driving": MARGIN, "textured": 0.0}


def run():
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from odometry_tpu.camera import Pinhole
    from odometry_tpu.config import accurate_config, fast_config
    from odometry_tpu.data.synthetic import (
        PhotometricNuisance,
        apply_nuisance,
        drive_trajectory,
        make_driving_scene,
        make_natural_scene,
        make_scene,
        render_stereo,
    )
    from odometry_tpu.eval.metrics import mean_translation_error
    from odometry_tpu.pipeline.runner import run_sequence

    num_frames = 49
    rows = []
    for cfg_name, cfg_fn in (("fast", fast_config), ("accurate", accurate_config)):
        cfg = cfg_fn()
        H, W = cfg.camera.height, cfg.camera.width
        cam = Pinhole.create(cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy)
        render = jax.jit(
            lambda scene, T: render_stereo(scene, cam, cfg.camera.baseline, T, H, W)
        )
        # Trajectories are lateral-dominant (drive_trajectory): 49 frames x
        # step meters of sideways travel. Steps are chosen to keep the camera
        # inside each scene's textured envelope (the plane's blob field spans
        # ~+-1.5*depth laterally; the driving corridor's side walls sit at
        # +-side_x) — a sweep that drives out of the world measures the
        # fixture, not the presets.
        # Third family ("textured"): natural multi-octave ridged texture PLUS
        # the photometric nuisance model (exposure drift, inter-eye gain
        # mismatch, vignette, sensor noise) — the closest available proxy for
        # the real-sensor data the reference validated on (test_optimizer.cpp
        # :23-26, test_disparity.cpp:17).
        for scene_name, scene_fn, step, nuis in (
            ("plane", lambda s: make_scene(s, depth=14.0), 0.25, None),
            ("driving", lambda s: make_driving_scene(s, side_x=20.0, wall_z=26.0),
             0.25, None),
            ("textured", lambda s: make_natural_scene(s, depth=14.0), 0.25,
             lambda s: PhotometricNuisance(seed=s)),
        ):
            mtes = []
            for seed in SEEDS:
                scene = scene_fn(seed)
                nu = nuis(seed) if nuis is not None else None
                poses = drive_trajectory(num_frames, step=step, seed=seed)
                frames = []
                for fi, T in enumerate(poses):
                    l, r, _ = render(scene, jnp.asarray(T))
                    if nu is not None:
                        l = apply_nuisance(np.asarray(l), fi, nu, eye=0)
                        r = apply_nuisance(np.asarray(r), fi, nu, eye=1)
                    frames.append((l, r))
                t0 = time.perf_counter()
                try:
                    res = run_sequence(frames, cfg)
                except RuntimeError as e:  # init-frame depth failure
                    print(f"{cfg_name:9s} {scene_name:8s} seed {seed:3d}: {e}",
                          flush=True)
                    mtes.append(float("inf"))
                    continue
                dt = time.perf_counter() - t0
                if res.failed_at is not None:
                    mte = float("inf")
                else:
                    mte = float(mean_translation_error(poses[: res.num_frames], res.poses))
                mtes.append(mte)
                print(
                    f"{cfg_name:9s} {scene_name:8s} seed {seed:3d}: mte {mte:8.4f} "
                    f"kf {len(res.keyframe_ids):2d} lost {len(res.lost_ids)} "
                    f"({dt:.1f}s)",
                    flush=True,
                )
            mtes = np.asarray(mtes)
            rows.append(
                dict(
                    config=cfg_name,
                    scene=scene_name,
                    median=float(np.median(mtes)),
                    min=float(mtes.min()),
                    max=float(mtes.max()),
                    n_green=int((mtes < GATE).sum()),
                    n=len(mtes),
                )
            )

    lines = [
        "# ACCURACY — multi-seed preset sweep",
        "",
        f"{len(SEEDS)} trajectory seeds x 3 scene families x 2 presets, full KITTI",
        f"size (376x1241), 49 frames each, `tools/accuracy_sweep.py`. Gate: mte <",
        f"{GATE} (bench.py); margin requirement: median <= {GATE * (1 - MARGIN):.3f}",
        f"for the clean families, median <= {GATE:.2f} for `textured` (it",
        "deliberately stresses the class's no-illumination-model limitation on",
        "C0 natural texture + sensor nuisances — ~2x clean-family difficulty",
        "for both presets; opt-in TrackerConfig.affine_light halves its tail).",
        "",
        "| config | scene | median mte | min | max | green |",
        "|---|---|---|---|---|---|",
    ]
    ok = True
    for r in rows:
        lines.append(
            f"| {r['config']} | {r['scene']} | {r['median']:.4f} | {r['min']:.4f} "
            f"| {r['max']:.4f} | {r['n_green']}/{r['n']} |"
        )
        if r["median"] > GATE * (1 - FAMILY_MARGIN[r["scene"]]):
            ok = False
    import datetime
    import subprocess

    import jax

    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip() if dev.platform == "gpu" else ""
    stamp = datetime.date.today().isoformat()
    lines += ["", f"Measured on: {dev.platform} {dev.device_kind} ({card}), {stamp}. "
              f"Seeds: {SEEDS}.", ""]
    out = "\n".join(lines)
    print(out)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "ACCURACY.md"), "w") as f:
        f.write(out)
    if not ok:
        print("FAIL: a preset median is outside the margin", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(run())
