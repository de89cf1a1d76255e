"""Distributed windowed BA: point lanes sharded over the mesh, psum reduction.

The Schur-reduced pose system is a sum over point lanes:

    Hred = Hpp - sum_p B_p B_p' / Hdd_p,     bred = bp - sum_p B_p bd_p / Hdd_p

so sharding the point-lane axis over a ``model`` mesh axis makes each device
linearize and reduce only its own lanes; one ``psum`` of the (6K x 6K, 6K)
system across devices replicates the reduced problem, every device solves the tiny
dense system redundantly (cheaper than a gather), and depth back-substitution
is purely local. This is the SURVEY.md §2 "distributed BA solved via
Schur-complement reduction over collectives" design.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from odometry_tpu.camera.pinhole import Pinhole
from odometry_tpu.geometry import se3_exp
from odometry_tpu.mapping.ba import (
    BAConfig,
    BAProblem,
    BAResult,
    _assemble_and_reduce,
    _cost,
    _linearize,
)

_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


def ba_solve_sharded(
    problem: BAProblem, cam: Pinhole, mesh: Mesh, cfg: BAConfig = BAConfig()
) -> BAResult:
    """Distributed ba_solve: identical math, point lanes split over "model".

    `problem` arrays with a point axis must have P divisible by the mesh
    "model" axis size. Images and poses are replicated.
    """
    K, Ptotal = problem.xs.shape

    repl = P()
    lanes = P(None, "model")  # (K, P) arrays split on the point axis

    in_specs = BAProblem(
        images=repl,
        xs=lanes,
        ys=lanes,
        inv_depth=lanes,
        intensity=lanes,
        point_valid=lanes,
        pose=repl,
        kf_valid=repl,
    )
    out_specs = BAResult(
        pose=repl,
        inv_depth=lanes,
        cost_initial=repl,
        cost_final=repl,
        num_residuals=repl,
    )

    def local(prob: BAProblem) -> BAResult:
        def one_iter(state):
            pose, inv_depth, prev_cost = state
            p = prob._replace(pose=pose, inv_depth=inv_depth)
            r, w, J_i, J_j, J_d, valid = _linearize(p, cam, cfg)
            # Local partial cost -> global mean via psum.
            local_sq = jnp.sum(w * r * r)
            local_n = jnp.sum(w > 0)
            tot_sq = jax.lax.psum(local_sq, "model")
            tot_n = jnp.maximum(jax.lax.psum(local_n, "model"), 1)
            cost = tot_sq / tot_n.astype(r.dtype)

            Hred, bred, Hdd, bd, B, inv_Hdd = _assemble_and_reduce(
                r, w, J_i, J_j, J_d, K, cfg
            )
            # THE collective: reduce the Schur system over the point shards.
            Hred = jax.lax.psum(Hred, "model")
            bred = jax.lax.psum(bred, "model")

            gauge = jnp.zeros(6 * K).at[:6].set(cfg.gauge_prior)
            Hred = Hred + jnp.diag(gauge)
            Hred = Hred + cfg.damping * jnp.diag(jnp.diag(Hred)) + 1e-6 * jnp.eye(6 * K)
            dxi = jnp.linalg.solve(Hred, bred)
            dxi = jnp.where(jnp.all(jnp.isfinite(dxi)), dxi, jnp.zeros_like(dxi))
            dxi_k = dxi.reshape(K, 6)
            dd = (bd - _einsum("ipka,ka->ip", B, dxi_k)) * inv_Hdd

            new_pose = _einsum("kab,kbc->kac", pose, jax.vmap(se3_exp)(dxi_k))
            new_inv = inv_depth + dd
            depth_ok = (new_inv > 1.0 / cfg.max_depth) & (new_inv < 1.0 / cfg.min_depth)
            new_inv = jnp.where(depth_ok, new_inv, inv_depth)

            # Post-step acceptance (matches mapping/ba.py): residual-only
            # pass at the candidate, global cost via psum, roll back on
            # increase.
            r2, w2, *_ = _linearize(
                prob._replace(pose=new_pose, inv_depth=new_inv), cam, cfg, jac=False
            )
            cand_sq = jax.lax.psum(jnp.sum(w2 * r2 * r2), "model")
            cand_n = jnp.maximum(jax.lax.psum(jnp.sum(w2 > 0), "model"), 1)
            cand_cost = cand_sq / cand_n.astype(r2.dtype)
            accept = cand_cost <= cost
            pose_out = jnp.where(accept, new_pose, pose)
            inv_out = jnp.where(accept, new_inv, inv_depth)
            out_cost = jnp.where(accept, cand_cost, cost)
            return (pose_out, inv_out, out_cost), (cost, local_n)

        state = (prob.pose, prob.inv_depth, jnp.asarray(jnp.inf, jnp.float32))
        costs = []
        nres_local = jnp.asarray(0)
        for _ in range(cfg.iters):
            state, (c, nres_local) = one_iter(state)
            costs.append(c)
        pose, inv_depth, final_cost = state
        nres = jax.lax.psum(nres_local, "model")
        return BAResult(pose, inv_depth, costs[0], final_cost, nres)

    f = shard_map(local, mesh=mesh, in_specs=(in_specs,), out_specs=out_specs,
                  check_vma=False)
    return jax.jit(f)(problem)
