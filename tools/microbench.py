"""Parameterized device-time microbenchmarks for the hot ops.

Usage: python tools/microbench.py [suite ...]    (default: all)

Suites:
  gather   XLA gather formulations at odometry point counts
  sample   gather-based vs one-hot-matmul bilinear sampling
  lm       tracker LM iteration device time vs point count + small-op tail
  pyramid  4-level image pyramid
  depth    depth-frontend stage breakdown (select/search/extract/refine)
  step     full odometry step device time via an in-dispatch scan

All timings are TRUE DEVICE TIME: the measured body runs K times inside one
dispatched fori_loop/scan (chained through a data dependency so XLA cannot
hoist it), which removes per-call dispatch overhead from the numbers.
Conclusions drawn from these experiments are recorded in PERF.md — update it
when numbers move.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def dev_time(body, K=100, reps=3):
    """ms per invocation of `body(i, acc) -> f32 contribution`, in-dispatch."""

    def f():
        def b(i, acc):
            return acc + body(i, acc)

        return jax.lax.fori_loop(0, K, b, jnp.float32(0.0))

    jf = jax.jit(f)
    jax.block_until_ready(jf())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jf()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps / K * 1e3


def wall_time(fn, *args, reps=3):
    """ms per call including dispatch (jitted + warmed)."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def suite_gather():
    key = jax.random.PRNGKey(0)
    H, W = 376, 1241
    img = jax.random.uniform(key, (H, W), jnp.float32) * 255.0
    flat = img.reshape(-1)
    print("== gather formulations (ms/op, device time) ==")
    for N in (8192, 40960):
        idx = jax.random.randint(key, (N,), 0, H * W)
        rows = {
            "flat 1D idx": lambda i, a, idx=idx: flat[idx + (i % 2)].sum() * 0.0,
            "sorted idx": lambda i, a, idx=jnp.sort(idx): flat[idx + (i % 2)].sum() * 0.0,
            "(N/128,128) idx": lambda i, a, idx=idx.reshape(-1, 128): flat[idx + (i % 2)].sum() * 0.0,
        }
        for name, body in rows.items():
            print(f"  N={N:6d} {name:16s} {dev_time(body):8.4f}")
    sidx = jax.random.randint(key, (40960,), 0, 64 * 128)
    small = jax.random.uniform(key, (64 * 128,), jnp.float32)
    print(f"  8K-elem operand, N=40960      {dev_time(lambda i, a: small[sidx + (i % 2)].sum() * 0.0):8.4f}")
    tidx = jax.random.randint(key, (128,), 0, H * W)
    print(f"  N=128 (fixed-cost floor)      {dev_time(lambda i, a: flat[tidx + (i % 2)].sum() * 0.0):8.4f}")


def suite_sample():
    from odometry_tpu.image.sampling import sample_bilinear, sample_channels_mm

    key = jax.random.PRNGKey(0)
    H, W = 376, 1241
    img = jax.random.uniform(key, (H, W), jnp.float32) * 255.0
    imgs3 = jnp.stack([img, img, img])
    print("== bilinear sampling: gather vs one-hot matmul (ms/op) ==")
    for N in (8192, 40960):
        u = jax.random.uniform(key, (N,), jnp.float32) * (W - 2)
        v = jax.random.uniform(key, (N,), jnp.float32) * (H - 2)
        t_g = dev_time(lambda i, a: sample_bilinear(img, u + (i % 2), v).sum() * 0.0)
        t_m1 = dev_time(lambda i, a: sample_channels_mm(img[None], u + (i % 2), v).sum() * 0.0)
        t_m3 = dev_time(lambda i, a: sample_channels_mm(imgs3, u + (i % 2), v).sum() * 0.0)
        print(f"  N={N:6d} gather {t_g:8.4f}   mm C=1 {t_m1:8.4f}   mm C=3 {t_m3:8.4f}")


def suite_lm():
    from odometry_tpu.camera import Pinhole
    from odometry_tpu.geometry import se3_compose, se3_exp
    from odometry_tpu.image.pyramid import central_gradients
    from odometry_tpu.kernels.points import (
        PointSet,
        normal_equations_points,
        residual_jacobian_points,
    )
    from odometry_tpu.solvers.linear6 import solve_spd6
    from odometry_tpu.solvers.robust import robust_weights

    key = jax.random.PRNGKey(0)
    H, W = 376, 1241
    img = jax.random.uniform(key, (H, W), jnp.float32) * 255.0
    cam = Pinhole.create(718.0, 718.0, 620.0, 188.0)
    grads = central_gradients(img)
    print("== tracker LM iteration (ms/iter, device time) ==")
    for N in (8192, 16384, 40960):
        idx = jax.random.randint(key, (N,), 0, H * W)
        pts = PointSet(
            xs=(idx % W).astype(jnp.float32),
            ys=(idx // W).astype(jnp.float32),
            inv_depth=jnp.full((N,), 0.1, jnp.float32),
            valid=jnp.ones((N,), bool),
            num=jnp.asarray(N, jnp.int32),
        )
        kf_i = jax.random.uniform(key, (N,), jnp.float32)

        for interp in ("bilinear", "mm"):
            def body(i, acc, pts=pts, kf_i=kf_i, interp=interp):
                T = se3_exp(jnp.full((6,), 1e-6 * acc))
                sys_ = residual_jacobian_points(
                    pts, img, cam, T, kf_intensity=kf_i, interp=interp, grads=grads
                )
                w = robust_weights("huber", sys_.r, sys_.valid, huber_delta=28.0,
                                   tdist_dof=200.0, tdist_sigma_init=5.0)
                eqs = normal_equations_points(sys_, w)
                A = eqs.JtWJ + 0.01 * jnp.diag(jnp.diag(eqs.JtWJ)) + 1e-12 * jnp.eye(6)
                delta = solve_spd6(A, -eqs.JtWr)
                return delta.sum() * 0.0

            print(f"  N={N:6d} interp={interp:8s} {dev_time(body):8.4f}")

    # Small-op tail: the 6x6 solve + se3_exp alone.
    A6 = jnp.eye(6) * 3.0
    b6 = jnp.ones((6,))
    t = dev_time(lambda i, a: solve_spd6(A6 + a, b6).sum() * 0.0)
    print(f"  solve_spd6 alone              {t:8.4f}")
    t = dev_time(lambda i, a: se3_compose(se3_exp(b6 * 1e-6 * a), jnp.eye(4))[0, 0] * 0.0)
    print(f"  se3_exp+compose alone         {t:8.4f}")


def suite_pyramid():
    from odometry_tpu.image.pyramid import gaussian_image_pyramid

    key = jax.random.PRNGKey(0)
    H, W = 376, 1241
    img = jax.random.uniform(key, (H, W), jnp.float32) * 255.0
    print("== pyramid (ms/op, device time) ==")

    def full(i, a):
        p = gaussian_image_pyramid(img + a, 4, True)
        return p[0][0, 0] * 0.0 + p[3][0, 0] * 0.0

    print(f"  4-level image pyramid         {dev_time(full):8.4f}")


def suite_depth():
    from odometry_tpu.camera import Pinhole
    from odometry_tpu.config import fast_config
    from odometry_tpu.data.synthetic import make_scene, render_stereo
    from odometry_tpu.depth.estimator import (
        compute_depth, refine_depth_points, search_band)
    from odometry_tpu.image.pyramid import gaussian_blur3
    from odometry_tpu.kernels.disparity import disparity_search
    from odometry_tpu.kernels.points import extract_points
    from odometry_tpu.kernels.select import select_points

    cfg = fast_config()
    H, W = cfg.camera.height, cfg.camera.width
    cam = Pinhole.create(cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy)
    scene = make_scene(3, depth=14.0)
    l, r, _ = jax.jit(lambda: render_stereo(scene, cam, cfg.camera.baseline, jnp.eye(4), H, W))()
    ls, rs = gaussian_blur3(l), gaussian_blur3(r)
    d = cfg.depth
    print("== depth frontend breakdown (ms/op, device time) ==")

    t = dev_time(lambda i, a: select_points(
        ls + a, boundary=d.boundary, block_rows=d.block_rows, block_cols=d.block_cols,
        grad_th=d.grad_th, max_points_per_block=d.max_points_per_block,
    ).sum().astype(jnp.float32) * 0.0, K=20)
    print(f"  select_points                 {t:8.3f}")

    sel = select_points(ls, boundary=d.boundary, block_rows=d.block_rows,
                        block_cols=d.block_cols, grad_th=d.grad_th,
                        max_points_per_block=d.max_points_per_block)
    max_disp, min_disp = search_band(cfg.camera, d)

    t = dev_time(lambda i, a: disparity_search(
        ls + a, rs, sel, fx=cam.fx, baseline=cfg.camera.baseline, boundary=d.boundary,
        ssd_th=d.ssd_th, max_disparity=max_disp, min_disparity=min_disp,
        lr_check=d.lr_check, lr_tol=d.lr_tol,
    ).inv_depth[0, 0] * 0.0, K=20)
    print(f"  disparity_search              {t:8.3f}")

    disp = disparity_search(ls, rs, sel, fx=cam.fx, baseline=cfg.camera.baseline,
                            boundary=d.boundary, ssd_th=d.ssd_th, max_disparity=max_disp,
                            min_disparity=min_disp, lr_check=d.lr_check, lr_tol=d.lr_tol)
    cap = min(d.max_residuals, d.block_rows * d.block_cols * d.max_points_per_block)
    t = dev_time(lambda i, a: extract_points(disp.inv_depth + a, sel, cap).xs.sum() * 0.0, K=20)
    print(f"  extract_points (cap={cap:5d})   {t:8.3f}")

    pts = extract_points(disp.inv_depth, sel, cap)
    t = dev_time(lambda i, a: refine_depth_points(
        l + a, r, pts, cfg.camera, cfg.depth)[0].sum() * 0.0, K=5)
    print(f"  refine_depth_points           {t:8.3f}")

    t = dev_time(lambda i, a: compute_depth(
        l + a, r, cfg.camera, cfg.depth).inv_depth[0, 0] * 0.0, K=5)
    print(f"  compute_depth (full)          {t:8.3f}")


def suite_step():
    from odometry_tpu.camera import Pinhole
    from odometry_tpu.config import fast_config
    from odometry_tpu.data.synthetic import drive_trajectory, make_scene, render_stereo
    from odometry_tpu.pipeline.odometry import init, step

    cfg = fast_config()
    H, W = cfg.camera.height, cfg.camera.width
    cam = Pinhole.create(cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy)
    scene = make_scene(3, depth=14.0)
    poses = drive_trajectory(17, step=0.35, seed=4)
    render = jax.jit(lambda t_: render_stereo(scene, cam, cfg.camera.baseline, t_, H, W))
    frames = [render(jnp.asarray(T))[:2] for T in poses]
    state, _ = jax.jit(lambda l, r: init(l, r, cfg))(*frames[0])
    lefts = jnp.stack([f[0] for f in frames[1:]])
    rights = jnp.stack([f[1] for f in frames[1:]])

    def scan_steps(state, lefts, rights):
        def b(s, lr):
            s2, out = step(s, lr[0], lr[1], cfg)
            return s2, out.cur_pose

        return jax.lax.scan(b, state, (lefts, rights))

    t = wall_time(jax.jit(scan_steps), state, lefts, rights, reps=5)
    n = lefts.shape[0]
    print("== full step (fast_config) ==")
    print(f"  scan/{n} device time          {t / n:8.4f} ms/frame -> {n * 1000 / t:.0f} fps")

    jstep = jax.jit(lambda s, l, r: step(s, l, r, cfg))
    t = wall_time(jstep, state, lefts[0], rights[0], reps=20)
    print(f"  single dispatched step        {t:8.4f} ms/frame -> {1000 / t:.0f} fps")


SUITES = {
    "gather": suite_gather,
    "sample": suite_sample,
    "lm": suite_lm,
    "pyramid": suite_pyramid,
    "depth": suite_depth,
    "step": suite_step,
}


def main():
    names = sys.argv[1:] or list(SUITES)
    for n in names:
        SUITES[n]()


if __name__ == "__main__":
    main()
