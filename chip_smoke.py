"""Smoke test of the system's main path on the GPU, at KITTI size (376x1241).

  python chip_smoke.py          # one card
  python chip_smoke.py --multi  # four cards: the sharded paths only

One card runs, in order, each phase failing loudly:

  device    require a GPU; print its kind, count, name and power limit
  parity    GPU against JAX's CPU device, in this process, at 376x1241:
            disparity winner maps (fast band and full search), the image
            pyramid, the photometric normal equations (dense and point),
            se3_exp / se3_log
  odometry  `odometry_tpu.cli run-synthetic`, fast preset with lazy depth
            (49 frames) and parity preset (depth and full search on every
            frame), then bench.py's three-seed accuracy gate and the
            throughput of each seed that tracks
  slam      run_slam over an out-and-back drive: BA plus loop closure must
            cut the endpoint error of plain odometry

With --multi it runs only the multi-card paths and their one-card
comparisons: the sequence sweep on a 4-card ``seq`` mesh against each
sequence run alone, and sharded windowed BA against ``mapping/ba``.

Each phase prints its wall seconds and XLA compile seconds. The last line of
stdout is ``{"ok": true, "device": {...}}``; the script exits non-zero and
prints no such line when any phase fails or JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import time

import numpy as np


class CompileClock:
    """Sums JAX's compile-time events (backend compile; trace + lowering)."""

    def __init__(self):
        self.backend = 0.0
        self.trace = 0.0

    def __call__(self, event, duration_secs, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.backend += duration_secs
        elif event in ("/jax/core/compile/jaxpr_trace_duration",
                       "/jax/core/compile/jaxpr_to_mlir_module_duration"):
            self.trace += duration_secs


@contextlib.contextmanager
def phase(name, clock):
    b0, t0, w0 = clock.backend, clock.trace, time.perf_counter()
    print(f"[{name}] start", flush=True)
    yield
    print(f"[{name}] done wall_s={time.perf_counter() - w0:.3f} "
          f"compile_s={clock.backend - b0:.3f} trace_lower_s={clock.trace - t0:.3f}",
          flush=True)


def device_phase(need: int):
    """Return the GPU devices, or exit non-zero when JAX finds no GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {devs[0].platform!r}")
    if len(devs) < need:
        raise SystemExit(f"chip_smoke: needs {need} GPUs, JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device_kind={devs[0].device_kind} count={len(devs)}")
    for line in smi.splitlines():
        print(f"nvidia-smi: {line}")
    return devs


def last_line(devs) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}})


def timed(fn, *args, reps=5):
    """Median wall ms of a compiled call, after one warm-up call."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def on(dev, fn, *args):
    """Run jit(fn) with its array arguments placed on `dev`; numpy results."""
    import jax

    args = [jax.device_put(a, dev) for a in args]
    return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*args))


# ---------------------------------------------------------------- parity --

def _kitti_pair(cfg, seed=3):
    import jax
    import jax.numpy as jnp

    from odometry_tpu.camera import Pinhole
    from odometry_tpu.data.synthetic import drive_trajectory, make_scene, render_stereo

    c = cfg.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    poses = drive_trajectory(2, step=0.35, seed=seed)
    scene = make_scene(seed, depth=14.0)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        f0 = jax.jit(lambda T: render_stereo(scene, cam, c.baseline, T, c.height, c.width))
        l0, r0, z0 = (np.asarray(a) for a in f0(jnp.asarray(poses[0])))
        l1, _, _ = (np.asarray(a) for a in f0(jnp.asarray(poses[1])))
    T10 = np.linalg.inv(poses[1]) @ poses[0]  # frame-0 camera -> frame-1 camera
    return cam, l0, r0, z0, l1, T10.astype(np.float32)


def parity_phase(gpu, cpu):
    import jax
    import jax.numpy as jnp

    from odometry_tpu.config import fast_config, kitti_config
    from odometry_tpu.depth.estimator import search_band
    from odometry_tpu.eval.parity import F32_EPS, compare_winner_maps
    from odometry_tpu.geometry import se3_exp, se3_log
    from odometry_tpu.image import gaussian_blur3, gaussian_image_pyramid
    from odometry_tpu.kernels.disparity import disparity_winner_maps
    from odometry_tpu.kernels.photometric import normal_equations, residual_jacobian
    from odometry_tpu.kernels.points import (
        extract_points, normal_equations_points, residual_jacobian_points)
    from odometry_tpu.kernels.select import select_points

    fast, kitti = fast_config(), kitti_config()
    cam, l0, r0, z0, l1, T10 = _kitti_pair(fast)
    ls, rs = on(cpu, gaussian_blur3, l0), on(cpu, gaussian_blur3, r0)

    # Disparity winner maps: the fast preset's band with the lr check, and
    # the parity preset's full search. On the GPU `auto` runs the Triton
    # band kernel; on the CPU, the XLA path.
    for name, cfg in (("fast_band", fast), ("kitti_full", kitti)):
        d = cfg.depth
        max_d, min_d = search_band(cfg.camera, d)
        kw = dict(boundary=d.boundary, max_disparity=max_d, min_disparity=min_d,
                  lr_check=True)
        fn = lambda a, b: disparity_winner_maps(a, b, **kw)  # noqa: E731
        got, want = on(gpu, fn, ls, rs), on(cpu, fn, ls, rs)
        counts = compare_winner_maps(ls, rs, got, want, boundary=d.boundary,
                                     max_disparity=max_d, min_disparity=min_d)
        a, b = jax.device_put(ls, gpu), jax.device_put(rs, gpu)
        ms = timed(jax.jit(fn), a, b)
        print(f"parity disparity {name} band=[{min_d},{max_d}] {counts} gpu_ms={ms:.3f}")

    # Image pyramid: 5-tap sums of values in [0, 255]; the two devices may
    # order or fuse the sums differently, a few f32 ulps of 255.
    pyr = lambda a: gaussian_image_pyramid(a, 4, True)  # noqa: E731
    errs = [float(np.max(np.abs(g - c))) for g, c in zip(on(gpu, pyr, l0), on(cpu, pyr, l0))]
    if not max(errs) <= 16 * F32_EPS * 255:
        raise AssertionError(f"pyramid max error per level {errs}")
    print(f"parity pyramid levels=4 max_abs_err={max(errs):.3g}")

    # Photometric normal equations at a fixed pose, dense and point lanes.
    # The residual systems are built once on the CPU, so both devices reduce
    # the same J and r (sub-pixel warps would otherwise differ by a few ulps
    # of the coordinate, times the image gradient). Bound: f32 with HIGHEST,
    # |gpu - cpu| <= 1e-5 of the entry's sum of |terms|.
    inv0 = np.where(z0 > 0, 1.0 / z0, 0.0).astype(np.float32)
    sel = on(cpu, lambda a: select_points(a, boundary=4, block_rows=16, block_cols=32,
                                          grad_th=8.0, max_points_per_block=80), ls)

    def dense_system(img_kf, inv, img_cur, T):
        return residual_jacobian(img_kf, inv, img_cur, cam, T, interp="bilinear")

    def point_system(img_kf, inv, mask, img_cur, T):
        pts = extract_points(inv, mask, fast.tracker.point_capacity, order="row")
        kf_i = img_kf[pts.ys.astype(jnp.int32), pts.xs.astype(jnp.int32)]
        return residual_jacobian_points(pts, img_cur, cam, T, kf_intensity=kf_i,
                                        interp="bilinear")

    for name, build, reduce, args in (
        ("dense", dense_system, normal_equations, (l0, inv0, l1, T10)),
        ("points", point_system, normal_equations_points,
         (l0, inv0, sel & (inv0 > 0), l1, T10)),
    ):
        sys_ = on(cpu, build, *args)
        fn = lambda s_: reduce(s_, jnp.ones_like(s_.r))[:2]  # noqa: E731
        g, c = on(gpu, fn, sys_), on(cpu, fn, sys_)
        Ja = np.abs(np.asarray(sys_.J, np.float64).reshape(-1, 6))
        ra = np.abs(np.asarray(sys_.r, np.float64).reshape(-1))
        worst = 0.0
        for k, scale in enumerate((Ja.T @ Ja, Ja.T @ ra)):
            rel = np.abs(g[k] - c[k]) / np.maximum(scale, 1e-30)
            worst = max(worst, float(rel.max()))
        if not worst <= 1e-5:
            raise AssertionError(f"normal equations {name}: rel error {worst}")
        print(f"parity normal_equations {name} lanes={ra.size} max_rel_err={worst:.3g}")

    # SE(3): exp of 4096 random twists and the log of the result; f32 with
    # HIGHEST products agrees to a few ulps, TF32 would not (~1e-3). Angles
    # stay below 2.5 rad: near pi the log is ill-conditioned on any device.
    rng = np.random.default_rng(0)
    xi = rng.standard_normal((4096, 6)).astype(np.float32)
    w = xi[:, 3:]
    w *= (rng.uniform(0.0, 2.5, 4096) / np.linalg.norm(w, axis=1))[:, None]
    f = jax.vmap(lambda v: (se3_exp(v), se3_log(se3_exp(v))))
    (Tg, lg), (Tc, lc) = on(gpu, f, xi), on(cpu, f, xi)
    e_exp, e_log = float(np.abs(Tg - Tc).max()), float(np.abs(lg - lc).max())
    if not (e_exp <= 1e-5 and e_log <= 1e-4):
        raise AssertionError(f"se3 parity exp {e_exp} log {e_log}")
    print(f"parity se3 exp_max_err={e_exp:.3g} log_max_err={e_log:.3g}")


# -------------------------------------------------------------- odometry --

def run_cli(argv):
    """odometry_tpu.cli in this process; returns its JSON result."""
    from odometry_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli {argv} returned {rc}")
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"cli {' '.join(argv)} -> {json.dumps(out)}")
    return out


def odometry_phase():
    import bench
    from odometry_tpu.config import fast_config

    # Bound: the bench gate. Seed 0 tracks at about a tenth of it in both
    # presets (mte 0.0163 fast over 49 frames, 0.0659 parity over 6, on an
    # H100), so a lost track or a kernel fault that moves depth fails here.
    for argv, frames in (
        (["run-synthetic", "--config", "fast", "--lazy-depth", "--frames", "49"], 49),
        (["run-synthetic", "--config", "parity", "--frames", "6"], 6),
    ):
        out = run_cli(argv)
        if out["num_frames"] != frames or not out["mean_translation_error_m"] < bench.MTE_GATE:
            raise AssertionError(f"run-synthetic {argv}: {out}")

    med, rows, fps = bench.measure(fast_config())
    print(f"bench mte_median={med:.4f} fps_median={fps:.2f} per_seed="
          f"{[(r['seed'], round(r['mte'], 4), r['fps'] and round(r['fps'], 2)) for r in rows]}")


# ------------------------------------------------------------------ slam --

def slam_phase():
    import dataclasses

    import jax
    import jax.numpy as jnp

    from odometry_tpu.camera import Pinhole
    from odometry_tpu.config import fast_config
    from odometry_tpu.data.synthetic import make_driving_scene, render_stereo
    from odometry_tpu.mapping.loop_closure import LoopClosureConfig
    from odometry_tpu.pipeline.slam import run_slam

    cfg = fast_config()
    # Promote every ~3-4 frames so the map holds enough keyframes for a
    # loop-closure proposal (the reference's 1.1 promotes ~4 in all).
    cfg = dataclasses.replace(
        cfg, keyframe=dataclasses.replace(cfg.keyframe, motion_threshold=0.4))
    c = cfg.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    scene = make_driving_scene(3, side_x=20.0, wall_z=26.0)
    n_half, step = 24, 0.35  # 49 frames, ~17 m out and back to the start
    poses = []
    for k in range(2 * n_half + 1):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = (0.1 * np.sin(0.9 * k), 0.0, step * (k if k <= n_half else 2 * n_half - k))
        poses.append(T)
    render = jax.jit(lambda T: render_stereo(scene, cam, c.baseline, T, c.height, c.width)[:2])
    frames = [render(jnp.asarray(T)) for T in poses]
    lc = LoopClosureConfig(radius=1.5, min_separation=3, min_inliers=200)

    odo = run_slam(frames, cfg, map_capacity=32, window=4, ba_every=100, loop_closure=False)
    slam = run_slam(frames, cfg, map_capacity=32, window=4, ba_every=2,
                    loop_closure=True, lc_cfg=lc)
    gt = np.stack(poses)
    end_odo = float(np.linalg.norm(odo.poses[-1][:3, 3] - gt[-1, :3, 3]))
    end_slam = float(np.linalg.norm(slam.poses[-1][:3, 3] - gt[-1, :3, 3]))
    print(f"slam frames={slam.num_frames} keyframes={len(slam.keyframe_ids)} "
          f"ba_runs={slam.ba_runs} closures={slam.loop_closures} "
          f"end_err_odom={end_odo:.4f} end_err_slam={end_slam:.4f} "
          f"fps_odom={odo.fps:.2f} fps_slam={slam.fps:.2f} (compile included)")
    if slam.failed_at is not None or odo.failed_at is not None:
        raise AssertionError("slam: depth failed")
    if slam.loop_closures < 1 or slam.ba_runs < 1:
        raise AssertionError("slam: no loop closure or no BA run")
    if not end_slam < end_odo:
        raise AssertionError(f"slam: endpoint error {end_slam} not below odometry {end_odo}")


# ----------------------------------------------------------------- multi --

def _ba_problem(cfg, K=4, P=4096, seed=31):
    """A KITTI-size BA window: K rendered keyframes, P point lanes each,
    perturbed poses (frame 0 is the gauge)."""
    import jax
    import jax.numpy as jnp

    from odometry_tpu.camera import Pinhole
    from odometry_tpu.data.synthetic import drive_trajectory, make_scene, render
    from odometry_tpu.geometry import se3_exp
    from odometry_tpu.image import gaussian_blur3
    from odometry_tpu.image.sampling import clip_gather_2d
    from odometry_tpu.kernels.points import extract_points
    from odometry_tpu.kernels.select import select_points
    from odometry_tpu.mapping.ba import BAProblem

    c = cfg.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    scene = make_scene(seed, depth=12.0)
    gt = drive_trajectory(K, step=0.3, seed=seed)

    @jax.jit
    def keyframe(T):
        img, z = render(scene, cam, T, c.height, c.width)
        sel = select_points(gaussian_blur3(img), boundary=4, grad_th=8.0)
        pts = extract_points(1.0 / z, sel, P, order="spread")
        inten = clip_gather_2d(img, pts.ys.astype(jnp.int32), pts.xs.astype(jnp.int32))
        return img, pts, inten

    kfs = [keyframe(jnp.asarray(T)) for T in gt]
    rng = np.random.default_rng(seed)
    poses0 = gt.copy()
    for k in range(1, K):
        xi = rng.standard_normal(6).astype(np.float32) * 0.01
        xi[3:] *= 0.1
        poses0[k] = poses0[k] @ np.asarray(se3_exp(jnp.asarray(xi)))
    problem = BAProblem(
        images=jnp.stack([k[0] for k in kfs]),
        xs=jnp.stack([k[1].xs for k in kfs]),
        ys=jnp.stack([k[1].ys for k in kfs]),
        inv_depth=jnp.stack([k[1].inv_depth for k in kfs]),
        intensity=jnp.stack([k[2] for k in kfs]),
        point_valid=jnp.stack([k[1].valid for k in kfs]),
        pose=jnp.asarray(poses0),
        kf_valid=jnp.ones((K,), bool),
    )
    return problem, cam


def multi_phase(devs, clock):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from odometry_tpu.camera import Pinhole
    from odometry_tpu.config import fast_config
    from odometry_tpu.data.synthetic import drive_trajectory, make_driving_scene, render_stereo
    from odometry_tpu.distributed.ba_dist import ba_solve_sharded
    from odometry_tpu.eval.parity import sweep_matches_single
    from odometry_tpu.mapping.ba import BAConfig, ba_solve

    cfg = fast_config()
    c = cfg.camera
    cam = Pinhole.create(c.fx, c.fy, c.cx, c.cy)
    n = len(devs)
    with phase("multi_ba", clock):
        problem, bacam = _ba_problem(cfg)
        # run_slam's mode: motion-only BA over a 4-keyframe window.
        bcfg = BAConfig(window=problem.xs.shape[0], iters=4, fix_depths=True)
        single = ba_solve(problem, bacam, bcfg)
        shard = ba_solve_sharded(problem, bacam, Mesh(np.array(devs), ("model",)), bcfg)
        # Tolerance: the psum adds the lanes' terms in another order. Poses
        # agree to f32 noise; the cost is a mean over ~3e4 residuals, whose
        # f32 sum may move by up to n*eps (~4e-3) in another order, 1e-3 is
        # allowed. A lost or doubled shard would change the residual count.
        e_pose = float(np.abs(np.asarray(single.pose) - np.asarray(shard.pose)).max())
        e_depth = float(np.abs(np.asarray(single.inv_depth) - np.asarray(shard.inv_depth)).max())
        e_cost = abs(float(single.cost_final) - float(shard.cost_final)) / float(single.cost_final)
        print(f"multi ba lanes={problem.xs.shape} residuals={int(shard.num_residuals)} "
              f"cost {float(single.cost_initial):.3f}->{float(single.cost_final):.3f} "
              f"pose_diff={e_pose:.3g} inv_depth_diff={e_depth:.3g} cost_rel_diff={e_cost:.3g}")
        if int(single.num_residuals) != int(shard.num_residuals):
            raise AssertionError("sharded BA counted other residuals")
        if not (e_pose <= 2e-4 and e_depth <= 1e-6 and e_cost <= 1e-3):
            raise AssertionError(f"sharded BA differs: pose {e_pose} inv_depth {e_depth} "
                                 f"cost {e_cost}")
    with phase("multi_sweep", clock):
        frames_per_seq, gt_per_seq = [], []
        for s in range(n):
            scene = make_driving_scene(s, side_x=20.0, wall_z=26.0)
            render = jax.jit(lambda T, scene=scene: render_stereo(
                scene, cam, c.baseline, T, c.height, c.width)[:2])
            poses = drive_trajectory(8, step=0.25, seed=s)
            gt_per_seq.append(poses)
            frames_per_seq.append([render(jnp.asarray(T)) for T in poses])
        # The mesh is one flat `seq` axis: every card reaches every other
        # at the same NVLink rate, so the layout follows the algorithm.
        rows = sweep_matches_single(frames_per_seq, gt_per_seq, cfg,
                                    Mesh(np.array(devs), ("seq",)))
        print(f"multi sweep streams={n} frames=8 per stream (frames both track, "
              f"max rot diff, max trans diff m): "
              f"{[(k, float(f'{r:.3g}'), float(f'{t:.3g}')) for k, r, t in rows]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sweep and sharded-BA comparisons")
    args = ap.parse_args(argv)

    devs = device_phase(4 if args.multi else 1)
    if args.multi:
        devs = devs[:4]

    import jax

    from odometry_tpu.utils.compile_cache import enable_compile_cache

    print(f"compile_cache={enable_compile_cache()}")
    clock = CompileClock()
    jax.monitoring.register_event_duration_secs_listener(clock)
    t0 = time.perf_counter()
    if args.multi:
        multi_phase(devs, clock)
    else:
        cpu = jax.devices("cpu")[0]
        with phase("parity", clock):
            parity_phase(devs[0], cpu)
        with phase("odometry", clock):
            odometry_phase()
        with phase("slam", clock):
            slam_phase()
    print(f"total wall_s={time.perf_counter() - t0:.3f} compile_s={clock.backend:.3f} "
          f"trace_lower_s={clock.trace:.3f}")
    print(last_line(devs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
