"""Command-line drivers (the reference's C9-C11 executables, unified).

  python -m odometry_tpu.cli run-kitti --data /path/kitti --seq 00 --frames 130
  python -m odometry_tpu.cli run-tum --data /path/tum_seq --frames 32
  python -m odometry_tpu.cli run-synthetic --frames 60
  python -m odometry_tpu.cli eval-disparity --data /path/middlebury
  python -m odometry_tpu.cli run-live --watch /path/incoming

run-kitti mirrors ``run_odometry_kitti_offline.cpp``: first-N-frame KITTI
eval with the reference metric, devkit-format pose export, keyframe dumps.
run-tum is the sensor-depth tracker path (``test_optimizer.cpp`` role).
eval-disparity is the ``test_disparity.cpp`` harness. run-live replaces the
comment-only ``run_odometry_live.cpp`` stub with a working watch-directory
loop.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np


def _config(name: str):
    from odometry_tpu import config as C

    return {
        "parity": C.kitti_config,
        "accurate": C.accurate_config,
        "fast": C.fast_config,
    }[name]()


def cmd_run_kitti(args):
    import jax.numpy as jnp

    from odometry_tpu.data import kitti
    from odometry_tpu.eval.export import save_kitti_poses
    from odometry_tpu.eval.metrics import mean_translation_error, ate_rmse, rpe
    from odometry_tpu.pipeline.runner import run_sequence

    from odometry_tpu.config import adapt_to_camera

    cfg = _config(args.config)
    cam = kitti.load_calib(args.data, args.seq)
    if args.kf_threshold is not None:
        cfg = dataclasses.replace(
            cfg, keyframe=dataclasses.replace(
                cfg.keyframe, motion_threshold=args.kf_threshold))
    cfg = adapt_to_camera(
        dataclasses.replace(cfg, camera=cam,
                            depth_every_frame=not args.lazy_depth))
    gt = None
    try:
        gt = kitti.load_poses(args.data, args.seq, args.frames)
    except FileNotFoundError:
        print("no GT poses found; skipping metrics", file=sys.stderr)

    frames = kitti.stereo_frames(args.data, args.seq, count=args.frames)
    init_pose = None
    if gt is not None:
        init_pose = np.eye(4, dtype=np.float32)
        init_pose[:3, :] = gt[0]
    ckpt = None
    if args.checkpoint_every and args.out:
        os.makedirs(args.out, exist_ok=True)
        ckpt = os.path.join(args.out, f"{args.seq}_checkpoint.npz")
    res = run_sequence(
        frames, cfg, init_pose=init_pose,
        checkpoint_path=ckpt, checkpoint_every=args.checkpoint_every,
        resume=args.resume, collect_vis=bool(args.dump_vis and args.out),
    )

    out = {
        "num_frames": res.num_frames,
        "fps": round(res.fps, 2),
        "keyframes": len(res.keyframe_ids),
        "failed_at": res.failed_at,
        "lost_frames": res.lost_ids,
        "stages": {k: round(v["mean_ms"], 3) for k, v in res.stage_report.items()},
    }
    if gt is not None:
        n = res.num_frames
        out["mean_translation_error_m"] = round(mean_translation_error(gt[:n], res.poses), 4)
        out["ate_rmse_m"] = round(ate_rmse(gt[:n], res.poses), 4)
        t_rpe, r_rpe = rpe(gt[:n], res.poses)
        out["rpe_trans_m"] = round(t_rpe, 4)
        out["rpe_rot_rad"] = round(r_rpe, 5)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        save_kitti_poses(os.path.join(args.out, f"{args.seq}.txt"), res.poses)
        if gt is not None:
            save_kitti_poses(os.path.join(args.out, f"{args.seq}_gt.txt"), gt[: res.num_frames])
        if args.dump_vis and res.vis:
            from odometry_tpu.eval.export import save_keyframe_dumps

            save_keyframe_dumps(
                os.path.join(args.out, "vis"),
                images=[v[0] for v in res.vis],
                disparities=[v[1] for v in res.vis],
                masks=[v[2] for v in res.vis],
                keyframe_ids=res.keyframe_ids[: len(res.vis)],
                disparity_scale=cfg.camera.fx * cfg.camera.baseline,
            )
    print(json.dumps(out))


def cmd_run_tum(args):
    import jax
    import jax.numpy as jnp

    from odometry_tpu.camera import Pinhole
    from odometry_tpu.config import tum_rgbd_config
    from odometry_tpu.data import tum
    from odometry_tpu.geometry import se3_compose, se3_inverse
    from odometry_tpu.image import gaussian_image_pyramid, depth_pyramid
    from odometry_tpu.tracking.tracker import prepare_keyframe, solve_pose_points

    cfg = tum_rgbd_config().tracker
    cam_cfg = tum_rgbd_config().camera
    cam = Pinhole.create(cam_cfg.fx, cam_cfg.fy, cam_cfg.cx, cam_cfg.cy)
    assoc = tum.read_associations_full(args.data)
    if args.frames:
        assoc = assoc[: args.frames]
    if not assoc:
        print("no frames found", file=sys.stderr)
        return 1
    frames = []
    for a in assoc:
        gray = tum.load_gray(a.gray_path)
        depth = tum.load_depth(a.depth_path)
        inv = np.where(depth > 0, 1.0 / np.maximum(depth, 1e-6), 0.0).astype(np.float32)
        frames.append((gray, inv))

    # Ground truth: from the association file when it carries poses
    # (reference 12-column format), else timestamp-associated from
    # groundtruth.txt (test_optimizer.cpp:116-157 semantics).
    gt_poses = None
    gt_matched = None
    if assoc[0].gt_pose is not None:
        gt_poses = np.stack([a.gt_pose for a in assoc])
        gt_matched = np.ones(len(assoc), bool)
    else:
        try:
            ts, gt = tum.load_groundtruth(args.data)
            frame_ts = np.asarray([a.gray_ts for a in assoc])
            gt_poses, gt_matched = tum.associate_groundtruth(frame_ts, ts, gt)
        except FileNotFoundError:
            pass

    # Frame-to-frame tracking with sensor depth (test_optimizer.cpp behaviour).
    gray0, inv0 = frames[0]
    pyr = gaussian_image_pyramid(jnp.asarray(gray0), cfg.num_levels, True)
    dpyr = depth_pyramid(jnp.asarray(inv0), cfg.num_levels,
                         indexing=cfg.depth_decimation)
    kfl = prepare_keyframe(pyr, dpyr, cfg)
    solve = jax.jit(lambda k, p: solve_pose_points(k, p, cam, cfg))
    poses = [np.eye(4, dtype=np.float32)]
    import time as _t

    t0 = _t.perf_counter()
    for gray, inv in frames[1:]:
        pyr_cur = gaussian_image_pyramid(jnp.asarray(gray), cfg.num_levels, True)
        res = solve(kfl, pyr_cur)
        poses.append(np.asarray(se3_compose(jnp.asarray(poses[-1]), se3_inverse(res.T))))
        dpyr = depth_pyramid(jnp.asarray(inv), cfg.num_levels, indexing=cfg.depth_decimation)
        kfl = prepare_keyframe(pyr_cur, dpyr, cfg)
    dt = _t.perf_counter() - t0
    out = {"num_frames": len(poses), "fps": round((len(poses) - 1) / dt, 2)}
    if gt_poses is not None and gt_matched.any():
        from odometry_tpu.eval.metrics import ate_rmse

        pred = np.stack(poses)
        # Reference metric (test_optimizer.cpp:101-112): per-frame absolute
        # translation error with the trajectory seeded at the first matched
        # GT pose, averaged over frames 1..N-1.
        first = int(np.nonzero(gt_matched)[0][0])
        seed = gt_poses[first] @ np.linalg.inv(pred[first])
        pred_seeded = np.einsum("ab,nbc->nac", seed, pred)
        m = gt_matched.copy()
        m[first] = False  # reference divides by N-1, skipping the seed frame
        errs = np.linalg.norm(
            pred_seeded[m][:, :3, 3] - gt_poses[m][:, :3, 3], axis=1
        )
        out["num_gt_matched"] = int(gt_matched.sum())
        out["avg_translation_error_m"] = round(float(errs.mean()), 4) if len(errs) else None
        out["ate_rmse_m"] = round(ate_rmse(gt_poses[gt_matched], pred[gt_matched]), 4)
    print(json.dumps(out))


def cmd_run_synthetic(args):
    import jax.numpy as jnp

    from odometry_tpu.camera import Pinhole
    from odometry_tpu.data.synthetic import make_scene, drive_trajectory, stereo_sequence
    from odometry_tpu.eval.metrics import ate_rmse, mean_translation_error
    from odometry_tpu.pipeline.runner import run_sequence

    cfg = _config(args.config)
    cfg = dataclasses.replace(cfg, depth_every_frame=not args.lazy_depth)
    if args.height and args.width:
        from odometry_tpu.config import CameraConfig, TrackerConfig, DepthConfig

        scale = args.width / 1241.0
        cfg = dataclasses.replace(
            cfg,
            camera=CameraConfig(
                fx=718.856 * scale, fy=718.856 * scale,
                cx=args.width / 2.0, cy=args.height / 2.0,
                height=args.height, width=args.width,
            ),
            tracker=dataclasses.replace(cfg.tracker, num_levels=3,
                                        max_iterations=(10, 20, 30)),
            depth=dataclasses.replace(cfg.depth, block_rows=8, block_cols=16,
                                      min_valid_points=30),
        )
    cam = Pinhole.create(cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy)
    scene = make_scene(args.seed, depth=14.0)
    poses = drive_trajectory(args.frames, step=0.35, seed=args.seed)
    frames = stereo_sequence(scene, cam, cfg.camera.baseline, poses,
                             cfg.camera.height, cfg.camera.width)
    res = run_sequence(frames, cfg)
    n = res.num_frames
    print(json.dumps({
        "num_frames": n,
        "fps": round(res.fps, 2),
        "keyframes": len(res.keyframe_ids),
        "lost_frames": res.lost_ids,
        "mean_translation_error_m": round(mean_translation_error(poses[:n], res.poses), 4),
        "ate_rmse_m": round(ate_rmse(poses[:n], res.poses), 4),
        "stages": {k: round(v["mean_ms"], 3) for k, v in res.stage_report.items()},
    }))


def cmd_eval_disparity(args):
    import jax.numpy as jnp

    from odometry_tpu.config import CameraConfig, DepthConfig
    from odometry_tpu.data.middlebury import load_pair
    from odometry_tpu.depth.estimator import compute_depth
    from odometry_tpu.eval.disparity_eval import disparity_histograms

    left, right, gt_disp = load_pair(args.data, disp_scale=args.disp_scale)
    H, W = left.shape
    cam = CameraConfig(fx=args.fx, fy=args.fx, cx=W / 2, cy=H / 2,
                       baseline=args.baseline, height=H, width=W)
    dcfg = DepthConfig(min_valid_points=50)
    res = compute_depth(jnp.asarray(left), jnp.asarray(right), cam, dcfg)
    pred_disp = np.asarray(res.inv_depth) * cam.fx * cam.baseline
    report = disparity_histograms(pred_disp, gt_disp, np.asarray(res.valid),
                                  fx=cam.fx, baseline=cam.baseline)
    report["frame_ok"] = bool(res.ok)
    print(json.dumps(report, indent=2))


def cmd_run_live(args):
    """Watch a directory for incoming stereo pairs and track online."""
    import time

    import jax.numpy as jnp

    from odometry_tpu.data.kitti import load_gray
    from odometry_tpu.pipeline.odometry import init, step
    import jax

    cfg = _config(args.config)
    jit_init = jax.jit(lambda l, r: init(l, r, cfg))
    jit_step = jax.jit(lambda s, l, r: step(s, l, r, cfg))
    state = None
    seen = set()
    print(f"watching {args.watch} for '<id>_left.png' / '<id>_right.png' pairs...",
          file=sys.stderr)
    idle = 0.0
    while idle < args.timeout:
        pairs = {}
        for f in sorted(os.listdir(args.watch)):
            if f.endswith("_left.png"):
                fid = f[: -len("_left.png")]
                rp = os.path.join(args.watch, fid + "_right.png")
                if fid not in seen and os.path.exists(rp):
                    pairs[fid] = (os.path.join(args.watch, f), rp)
        if not pairs:
            time.sleep(0.05)
            idle += 0.05
            continue
        idle = 0.0
        for fid, (lp, rp) in sorted(pairs.items()):
            seen.add(fid)
            left = jnp.asarray(load_gray(lp))
            right = jnp.asarray(load_gray(rp))
            if state is None:
                state, ok = jit_init(left, right)
                print(json.dumps({"frame": fid, "init": bool(ok)}))
            else:
                state, out = jit_step(state, left, right)
                t = np.asarray(out.cur_pose)[:3, 3]
                print(json.dumps({
                    "frame": fid,
                    "t": [round(float(v), 4) for v in t],
                    "keyframe": bool(out.promoted),
                    "depth_ok": bool(out.depth_ok),
                }), flush=True)
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="odometry_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    k = sub.add_parser("run-kitti")
    k.add_argument("--data", required=True)
    k.add_argument("--seq", default="00")
    k.add_argument("--frames", type=int, default=130)
    k.add_argument("--config", default="parity", choices=["parity", "accurate", "fast"])
    k.add_argument("--lazy-depth", action="store_true")
    k.add_argument("--kf-threshold", type=float, default=None,
                   help="keyframe promotion motion threshold (reference "
                        "hard-codes 1.1, run_odometry_kitti_offline.cpp:258)")
    k.add_argument("--out", default=None)
    k.add_argument("--dump-vis", action="store_true",
                   help="write per-keyframe gray/disparity/mask PNGs (save_to_vis)")
    k.add_argument("--checkpoint-every", type=int, default=0,
                   help="persist state+trajectory every N frames (needs --out)")
    k.add_argument("--resume", action="store_true",
                   help="resume from the checkpoint file in --out")
    k.set_defaults(fn=cmd_run_kitti)

    t = sub.add_parser("run-tum")
    t.add_argument("--data", required=True)
    t.add_argument("--frames", type=int, default=32)
    t.set_defaults(fn=cmd_run_tum)

    s = sub.add_parser("run-synthetic")
    s.add_argument("--frames", type=int, default=60)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--config", default="accurate", choices=["parity", "accurate", "fast"])
    s.add_argument("--lazy-depth", action="store_true")
    s.add_argument("--height", type=int, default=0)
    s.add_argument("--width", type=int, default=0)
    s.set_defaults(fn=cmd_run_synthetic)

    d = sub.add_parser("eval-disparity")
    d.add_argument("--data", required=True)
    d.add_argument("--fx", type=float, default=718.856)
    d.add_argument("--baseline", type=float, default=0.537)
    d.add_argument("--disp-scale", type=float, default=1.0)
    d.set_defaults(fn=cmd_eval_disparity)

    l = sub.add_parser("run-live")
    l.add_argument("--watch", required=True)
    l.add_argument("--config", default="fast", choices=["parity", "accurate", "fast"])
    l.add_argument("--timeout", type=float, default=10.0)
    l.set_defaults(fn=cmd_run_live)

    args = p.parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    from odometry_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    sys.exit(main())
