"""SE(3) pose-graph optimization (odometry chains + loop closures).

The backend layer the reference's vestigial ``GlobalMap`` (C8) was headed
toward. Standard formulation: nodes are keyframe poses T_k (cam-to-world),
edges are relative-pose measurements Z_e between nodes (i_e, j_e) with
residual

    r_e = log( Z_e^-1  T_i^-1 T_j )        (6-vector twist)

minimized by damped Gauss-Newton under right-multiplicative perturbations
T <- T exp(xi), with the g2o-style small-residual Jacobian approximation
J_j = I, J_i = -Adj(T_j^-1 T_i). All edges are processed as one batch; the
block Hessian is scatter-assembled and solved densely (6N x 6N — fine for
hundreds of keyframes; N is the ring-buffer capacity).

Gauge: node 0 pinned with a strong diagonal prior.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from odometry_tpu.geometry import (
    se3_adjoint,
    se3_compose,
    se3_exp,
    se3_inverse,
    se3_log,
)

_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


class PoseGraph(NamedTuple):
    poses: jax.Array  # (N, 4, 4)
    edge_i: jax.Array  # (E,) int32
    edge_j: jax.Array  # (E,) int32
    edge_T: jax.Array  # (E, 4, 4) measured T_i^-1 T_j
    edge_weight: jax.Array  # (E,) scalar information weight (0 disables)


class PoseGraphResult(NamedTuple):
    poses: jax.Array
    cost_initial: jax.Array
    cost_final: jax.Array


def odometry_edges(poses: jax.Array, weight: float = 1.0):
    """Consecutive-pose edges from a trajectory (measurement = current chain)."""
    n = poses.shape[0]
    i = jnp.arange(n - 1, dtype=jnp.int32)
    j = i + 1
    Z = jax.vmap(lambda a, b: se3_compose(se3_inverse(a), b))(poses[:-1], poses[1:])
    w = jnp.full((n - 1,), weight, jnp.float32)
    return i, j, Z, w


def _residuals(graph: PoseGraph):
    Ti = graph.poses[graph.edge_i]
    Tj = graph.poses[graph.edge_j]
    rel = jax.vmap(lambda a, b: se3_compose(se3_inverse(a), b))(Ti, Tj)
    err_T = jax.vmap(lambda z, m: se3_compose(se3_inverse(z), m))(graph.edge_T, rel)
    r = jax.vmap(se3_log)(err_T)  # (E, 6)
    return r, rel


def pose_graph_cost(graph: PoseGraph) -> jax.Array:
    r, _ = _residuals(graph)
    return jnp.sum(graph.edge_weight[:, None] * r * r)


def optimize_pose_graph(
    graph: PoseGraph,
    iters: int = 10,
    damping: float = 1e-6,
    gauge_prior: float = 1e9,
) -> PoseGraphResult:
    N = graph.poses.shape[0]

    def gn_iter(poses, _):
        g = graph._replace(poses=poses)
        r, rel = _residuals(g)
        w = graph.edge_weight
        cost = jnp.sum(w[:, None] * r * r)

        # J_j = I ; J_i = -Adj(T_j^-1 T_i) = -Adj(rel^-1).
        Adj = jax.vmap(lambda m: se3_adjoint(se3_inverse(m)))(rel)  # (E, 6, 6)
        Ji = -Adj
        # Block assembly.
        H = jnp.zeros((N, N, 6, 6), jnp.float32)
        b = jnp.zeros((N, 6), jnp.float32)
        wJi = Ji * w[:, None, None]
        H = H.at[graph.edge_i, graph.edge_i].add(_einsum("eab,eac->ebc", wJi, Ji))
        H = H.at[graph.edge_j, graph.edge_j].add(
            w[:, None, None] * jnp.broadcast_to(jnp.eye(6), Ji.shape)
        )
        # Off-diagonal block H[i, j] = Ji^T W (Jj = I).
        HijT = jnp.swapaxes(Ji, 1, 2) * w[:, None, None]
        H = H.at[graph.edge_i, graph.edge_j].add(HijT)
        H = H.at[graph.edge_j, graph.edge_i].add(jnp.swapaxes(HijT, 1, 2))
        b = b.at[graph.edge_i].add(-_einsum("eba,eb->ea", Ji, w[:, None] * r))
        b = b.at[graph.edge_j].add(-(w[:, None] * r))

        Hfull = H.transpose(0, 2, 1, 3).reshape(6 * N, 6 * N)
        gauge = jnp.zeros(6 * N).at[:6].set(gauge_prior)
        Hfull = Hfull + jnp.diag(gauge) + damping * jnp.eye(6 * N)
        dxi = jnp.linalg.solve(Hfull, b.reshape(-1))
        dxi = jnp.where(jnp.all(jnp.isfinite(dxi)), dxi, jnp.zeros_like(dxi))
        new_poses = _einsum(
            "kab,kbc->kac", poses, jax.vmap(se3_exp)(dxi.reshape(N, 6))
        )
        return new_poses, cost

    poses, costs = jax.lax.scan(gn_iter, graph.poses, None, length=iters)
    final_cost = pose_graph_cost(graph._replace(poses=poses))
    return PoseGraphResult(poses, costs[0], final_cost)
