"""Windowed photometric bundle adjustment with Schur-complement reduction.

The beyond-reference backend (SURVEY.md §7 step 7, BASELINE.json north star):
jointly refine the last K keyframe poses AND their points' inverse depths by
minimizing cross-keyframe photometric error, DSO-style.

Problem structure. Each point p owned by keyframe i with inverse depth d_p
produces residuals in every other window keyframe j where its reprojection
lands:

    r_{ijp} = I_j( project( T_j^-1 T_i  backproject(u_p, d_p) ) ) - I_i(u_p)

Variables: 6-DOF pose perturbations eps_k (right-multiplicative, camera
frame) for each window keyframe + one inverse depth per point. The Hessian is

    H = [ Hpp  Hpd ]        Hdd diagonal (depths independent given poses)
        [ Hpd' Hdd ]

so the pose system is reduced by the Schur complement

    (Hpp - Hpd Hdd^-1 Hpd') dxi = bp - Hpd Hdd^-1 bd

— a (6K x 6K) dense solve (42x42 for the default 7-keyframe window) — and
depths back-substitute as dd = (bd - Hpd' dxi) / Hdd.

Batching: everything is batched over (observer j, point lane p) with the
pair/pose-block accumulations as einsum contractions; the only scattered
memory access is the bilinear image sampling. The point-lane axis is the
sharding axis for distributed BA (distributed/ba_dist.py): each device
reduces its own lanes' contributions and the 6K x 6K system is psum-reduced
across devices.

Gauge: the oldest window keyframe is pinned by a large diagonal prior on its
pose block.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import functools

from odometry_tpu.camera.pinhole import Pinhole
from odometry_tpu.geometry import se3_exp, se3_inverse

_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


class BAConfig(NamedTuple):
    window: int = 7
    iters: int = 4
    huber_delta: float = 28.0
    damping: float = 1e-3
    gauge_prior: float = 1e8
    min_inv_depth: float = 1e-3
    # Refined depths outside this band keep their previous value.
    min_depth: float = 0.1
    max_depth: float = 1000.0
    # Motion-only mode: keep inverse depths fixed (no Schur block). Use when
    # depths are trusted (e.g. stereo-initialized) or the scene is
    # near-planar, where free depths make photometric BA gauge-degenerate
    # (any homography-consistent pose/plane family has equal cost).
    fix_depths: bool = False


class BAProblem(NamedTuple):
    """A BA window: K keyframes with P point lanes each (struct-of-arrays)."""

    images: jax.Array  # (K, H, W) level-0 keyframe images
    xs: jax.Array  # (K, P) point pixel x in the owner frame
    ys: jax.Array  # (K, P)
    inv_depth: jax.Array  # (K, P)
    intensity: jax.Array  # (K, P) owner-frame intensity at the point
    point_valid: jax.Array  # (K, P) bool
    pose: jax.Array  # (K, 4, 4) cam-to-world
    kf_valid: jax.Array  # (K,) bool


class BAResult(NamedTuple):
    pose: jax.Array  # (K, 4, 4) refined poses
    inv_depth: jax.Array  # (K, P) refined inverse depths
    cost_initial: jax.Array
    cost_final: jax.Array
    num_residuals: jax.Array


def _sample_bilinear_batch(images, j_idx, u, v):
    """Bilinear sample images[j] at (u, v); all inputs (K, P, K?) shaped flat.

    images: (K, H, W); j_idx broadcastable int array selecting the image per
    element; u, v same shape as j_idx.
    """
    K, H, W = images.shape
    u = jnp.clip(u, 0.0, W - 1.0)
    v = jnp.clip(v, 0.0, H - 1.0)
    x0 = jnp.floor(u)
    y0 = jnp.floor(v)
    fx = u - x0
    fy = v - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    x1i = jnp.minimum(x0i + 1, W - 1)
    y1i = jnp.minimum(y0i + 1, H - 1)
    flat = images.reshape(-1)
    base = j_idx * (H * W)

    def g(yi, xi):
        return jnp.take(flat, base + yi * W + xi)

    v00 = g(y0i, x0i)
    v01 = g(y0i, x1i)
    v10 = g(y1i, x0i)
    v11 = g(y1i, x1i)
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return top * (1.0 - fy) + bot * fy


def _linearize(problem: BAProblem, cam: Pinhole, cfg: BAConfig, jac: bool = True):
    """Build residuals + Jacobian blocks for all (owner i, observer j, point).

    Returns per-element arrays shaped (K, K, P): owner axis i, observer axis
    j, point lane p; plus Jacobians J_i, J_j (..., 6) and J_d (...,).

    With ``jac=False`` (the step-acceptance cost evaluation) the gradient
    sampling and Jacobian chain are skipped and (r, w, None, None, None,
    valid) is returned — a residual-only pass at ~1/3 the samples.
    """
    K, P = problem.xs.shape
    H, W = problem.images.shape[1:]

    d = problem.inv_depth  # (K, P)
    safe_d = jnp.where(jnp.abs(d) < cfg.min_inv_depth, 1.0, d)
    Z0 = 1.0 / safe_d
    X0 = Z0 * (problem.xs - cam.cx) / cam.fx  # (K, P) owner-cam point
    Y0 = Z0 * (problem.ys - cam.cy) / cam.fy
    P_i = jnp.stack([X0, Y0, Z0], axis=-1)  # (K, P, 3)

    # Relative transforms T_ji = T_j^-1 T_i for all pairs: (K, K, 4, 4),
    # first index j (observer), second i (owner).
    inv_pose = jax.vmap(se3_inverse)(problem.pose)  # (K, 4, 4) world->cam
    T_rel = _einsum("jab,ibc->jiac", inv_pose, problem.pose)  # (j, i, 4, 4)

    R = T_rel[..., :3, :3]  # (j, i, 3, 3)
    t = T_rel[..., :3, 3]  # (j, i, 3)
    # Transform owner points into each observer frame: (j, i, P, 3).
    P_j = _einsum("jiab,ipb->jipa", R, P_i) + t[:, :, None, :]
    Xj, Yj, Zj = P_j[..., 0], P_j[..., 1], P_j[..., 2]
    safe_Zj = jnp.where(Zj == 0, 1.0, Zj)
    u = cam.fx * Xj / safe_Zj + cam.cx
    v = cam.fy * Yj / safe_Zj + cam.cy

    j_idx = jax.lax.broadcasted_iota(jnp.int32, (K, K, P), 0)
    i_idx = jax.lax.broadcasted_iota(jnp.int32, (K, K, P), 1)
    margin = 2.0
    valid = (
        problem.point_valid[None, :, :]
        & (jnp.abs(d[None, :, :]) >= cfg.min_inv_depth)
        & problem.kf_valid[None, :, None]
        & problem.kf_valid[:, None, None]
        & (j_idx != i_idx)
        & (Zj > 0.05)
        & (u >= margin)
        & (u <= W - 1 - margin)
        & (v >= margin)
        & (v <= H - 1 - margin)
    )

    I_obs = _sample_bilinear_batch(problem.images, j_idx, u, v)
    r = I_obs - problem.intensity[None, :, :]  # (j, i, P)

    if not jac:
        absr = jnp.abs(r)
        w = jnp.where(
            absr <= cfg.huber_delta, 1.0, cfg.huber_delta / jnp.maximum(absr, 1e-12)
        )
        w = w * valid.astype(r.dtype)
        return r, w, None, None, None, valid

    gx = 0.5 * (
        _sample_bilinear_batch(problem.images, j_idx, u + 1.0, v)
        - _sample_bilinear_batch(problem.images, j_idx, u - 1.0, v)
    )
    gy = 0.5 * (
        _sample_bilinear_batch(problem.images, j_idx, u, v + 1.0)
        - _sample_bilinear_batch(problem.images, j_idx, u, v - 1.0)
    )

    # Image-projection chain: row vector dr/dX_j (j, i, P, 3).
    inv_Zj = 1.0 / safe_Zj
    gfxz = gx * cam.fx * inv_Zj
    gfyz = gy * cam.fy * inv_Zj
    dr_dPj = jnp.stack(
        [gfxz, gfyz, -(gfxz * Xj + gfyz * Yj) * inv_Zj], axis=-1
    )

    # d X_j / d eps_i = R_ji [I | -hat(P_i)]  -> J_i = dr_dPj . that (1x6).
    # Translational part: dr_dPj @ R_ji. Rotational part uses the row-vector
    # identity a' hat(P) = (a x P)', so a' (-hat(P_i)) = -(a x P_i)'.
    a_i = _einsum("jipa,jiab->jipb", dr_dPj, R)  # (j,i,P,3)
    Jrot_i = -jnp.cross(a_i, jnp.broadcast_to(P_i[None], a_i.shape))
    J_i = jnp.concatenate([a_i, Jrot_i], axis=-1)  # (j, i, P, 6)

    # d X_j / d eps_j = [-I | hat(X_j)] -> J_j = [-dr_dPj | (dr_dPj x P_j)].
    Jrot_j = jnp.cross(dr_dPj, P_j)
    J_j = jnp.concatenate([-dr_dPj, Jrot_j], axis=-1)  # (j, i, P, 6)

    # d X_j / d d_p = R_ji dP_i/dd = -(X_j - t)/d.
    dPj_dd = -(P_j - t[:, :, None, :]) / safe_d[None, :, :, None]
    J_d = jnp.sum(dr_dPj * dPj_dd, axis=-1)  # (j, i, P)

    # Huber weights (tracker-consistent).
    absr = jnp.abs(r)
    w = jnp.where(absr <= cfg.huber_delta, 1.0, cfg.huber_delta / jnp.maximum(absr, 1e-12))
    w = w * valid.astype(r.dtype)
    return r, w, J_i, J_j, J_d, valid


def _assemble_and_reduce(r, w, J_i, J_j, J_d, K, cfg: BAConfig):
    """Accumulate block Hessian, apply Schur complement, return reduced system.

    All contractions are einsums over the (j, i, P) element axes; the outputs
    are (6K, 6K) / (6K,) plus per-point depth quantities.
    """
    # Pose-pose blocks. For element (j, i, p): rows live in blocks i and j.
    # Hpp[i, i] += Ji' w Ji ; Hpp[j, j] += Jj' w Jj ; Hpp[i, j] += Ji' w Jj.
    H_ii = _einsum("jipa,jip,jipb->iab", J_i, w, J_i)  # sum over j, p
    H_jj = _einsum("jipa,jip,jipb->jab", J_j, w, J_j)  # sum over i, p
    H_ij = _einsum("jipa,jip,jipb->ijab", J_i, w, J_j)  # (i, j, 6, 6)
    b_i = -_einsum("jipa,jip,jip->ia", J_i, w, r)
    b_j = -_einsum("jipa,jip,jip->ja", J_j, w, r)

    Hpp = jnp.zeros((K, K, 6, 6), jnp.float32)
    diag = H_ii + H_jj  # (K, 6, 6)
    Hpp = Hpp.at[jnp.arange(K), jnp.arange(K)].add(diag)
    off_mask = 1.0 - jnp.eye(K)
    H_ij = H_ij * off_mask[:, :, None, None]
    Hpp = Hpp + H_ij + jnp.swapaxes(jnp.swapaxes(H_ij, 0, 1), 2, 3)
    bp = b_i + b_j  # (K, 6)

    # Depth diagonal + couplings.
    Hdd = _einsum("jip,jip,jip->ip", J_d, w, J_d)  # (K=i owner, P)
    bd = -_einsum("jip,jip,jip->ip", J_d, w, r)
    # Coupling of point (i, p) to pose blocks: to its own block i via J_i, to
    # each observer block j via J_j.
    C_own = _einsum("jipa,jip,jip->ipa", J_i, w, J_d)  # (i, P, 6)
    C_obs = _einsum("jipa,jip,jip->jipa", J_j, w, J_d)  # (j, i, P, 6)
    # Full coupling tensor B[(i,p), k(6)]: (i, P, K, 6)
    B = jnp.swapaxes(C_obs, 0, 1).transpose(0, 2, 1, 3)  # (i, P, j, 6)
    B = B.at[jnp.arange(K), :, jnp.arange(K), :].add(C_own)

    # Schur complement over depths.
    safe_Hdd = jnp.where(Hdd > 1e-12, Hdd, 1.0)
    inv_Hdd = jnp.where(Hdd > 1e-12, 1.0 / safe_Hdd, 0.0)  # dead depths drop out
    if cfg.fix_depths:
        inv_Hdd = jnp.zeros_like(inv_Hdd)  # Schur term vanishes; dd = 0
    # Hred -= sum_{i,p} B (1/Hdd) B'
    Hred_corr = _einsum("ipka,ip,iplb->kalb", B, inv_Hdd, B)
    bred_corr = _einsum("ipka,ip,ip->ka", B, inv_Hdd, bd)

    Hpp_full = Hpp.transpose(0, 2, 1, 3).reshape(6 * K, 6 * K)
    Hred = Hpp_full - Hred_corr.reshape(6 * K, 6 * K)
    bred = (bp - bred_corr).reshape(6 * K)
    return Hred, bred, Hdd, bd, B, inv_Hdd


def _cost(r, w):
    n = jnp.maximum(jnp.sum(w > 0), 1)
    return jnp.sum(w * r * r) / n.astype(r.dtype), jnp.sum(w > 0)


def ba_solve(problem: BAProblem, cam: Pinhole, cfg: BAConfig = BAConfig()) -> BAResult:
    """Damped Gauss-Newton on the reduced pose system + depth back-substitution.

    Runs a fixed small number of iterations (static unroll). Each candidate
    step's cost is evaluated AFTER applying it (a residual-only pass) and the
    step is rolled back if the cost increased — true LM-style acceptance, so
    a diverging final step is never silently kept.
    """
    K, P = problem.xs.shape

    def one_iter(state):
        pose, inv_depth, cur_cost = state
        prob = problem._replace(pose=pose, inv_depth=inv_depth)
        r, w, J_i, J_j, J_d, valid = _linearize(prob, cam, cfg)
        cost, nres = _cost(r, w)
        Hred, bred, Hdd, bd, B, inv_Hdd = _assemble_and_reduce(
            r, w, J_i, J_j, J_d, K, cfg
        )
        # Gauge prior on the OLDEST valid keyframe (block 0 by convention:
        # callers order the window oldest-first).
        gauge = jnp.zeros(6 * K).at[:6].set(cfg.gauge_prior)
        Hred = Hred + jnp.diag(gauge)
        Hred = Hred + cfg.damping * jnp.diag(jnp.diag(Hred)) + 1e-6 * jnp.eye(6 * K)
        dxi = jnp.linalg.solve(Hred, bred)
        dxi = jnp.where(jnp.all(jnp.isfinite(dxi)), dxi, jnp.zeros_like(dxi))
        dxi_k = dxi.reshape(K, 6)
        # Depth back-substitution: dd = (bd - B . dxi) / Hdd.
        dd = (bd - _einsum("ipka,ka->ip", B, dxi_k)) * inv_Hdd

        new_pose = _einsum("kab,kbc->kac", pose, jax.vmap(se3_exp)(dxi_k))
        new_inv = inv_depth + dd
        # Keep refined depths only when they stay plausible.
        depth_ok = (new_inv > 1.0 / cfg.max_depth) & (new_inv < 1.0 / cfg.min_depth)
        new_inv = jnp.where(depth_ok, new_inv, inv_depth)

        # Accept/reject on the POST-step cost: one residual-only pass at the
        # candidate; roll back if it increased (no silent diverging steps).
        r2, w2, *_ = _linearize(
            problem._replace(pose=new_pose, inv_depth=new_inv), cam, cfg, jac=False
        )
        cand_cost, _ = _cost(r2, w2)
        accept = cand_cost <= cost
        pose_out = jnp.where(accept, new_pose, pose)
        inv_out = jnp.where(accept, new_inv, inv_depth)
        out_cost = jnp.where(accept, cand_cost, cost)
        return (pose_out, inv_out, out_cost), (cost, nres)

    state = (problem.pose, problem.inv_depth, jnp.asarray(jnp.inf, jnp.float32))
    costs = []
    nres = jnp.asarray(0)
    for _ in range(cfg.iters):
        state, (c, nres) = one_iter(state)
        costs.append(c)
    pose, inv_depth, final_cost = state
    return BAResult(
        pose=pose,
        inv_depth=inv_depth,
        cost_initial=costs[0],
        cost_final=final_cost,
        num_residuals=nres,
    )
