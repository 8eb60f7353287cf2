"""Distributed pose-graph assembly: unary Hessian blocks built per shard.

The bundle-adjustment layer of SURVEY.md §7 step 7. Each per-keyframe NID
measurement lives on the device that produced it
(`refine_per_keyframe_sharded` leaves its RefineResult kf-sharded), so the
corresponding unary normal-equation blocks — ``w J^T J`` (6x6) and
``-w J^T r`` (6,) per node — are assembled in place with `shard_map` over
the ``kf`` axis and only then gathered for the chain solve. The
gathered payload is 42 floats per keyframe per Gauss-Newton iteration,
so the distributed smoother is latency-, not bandwidth-, bound; the
block-tridiagonal Schur sweep itself (`opt.pose_graph.solve_block_
tridiagonal`) is O(K) tiny 6x6 ops and runs replicated.

The reference has no counterpart — it never reconciles per-keyframe poses
(`PointCloudProcessor/src/PointCloudProcessor.cpp:495-519` applies raw
corrections directly).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core import se3
from ..opt import pose_graph
from . import mesh as mesh_lib


def absolute_blocks_sharded(
    mesh: Mesh, poses: se3.SE3, meas: se3.SE3, weight: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Keyframe-sharded unary-factor assembly (same math as
    `opt.pose_graph.absolute_blocks`). Outputs stay kf-sharded; XLA inserts
    the all-gather where the replicated chain solve consumes them."""

    def local(q, t, mq, mt, w):
        return pose_graph.absolute_blocks(se3.SE3(q, t), se3.SE3(mq, mt), w)

    kf = P(mesh_lib.KF_AXIS)
    return jax.shard_map(
        local, mesh=mesh, in_specs=(kf,) * 5, out_specs=(kf, kf)
    )(poses.q, poses.t, meas.q, meas.t, weight)


@functools.partial(
    jax.jit, static_argnames=("mesh", "iterations")
)
def optimize_sharded(
    mesh: Mesh,
    poses: se3.SE3,
    odo_meas: se3.SE3,
    abs_meas: se3.SE3,
    *,
    abs_weight: jnp.ndarray,
    odo_weight: float | jnp.ndarray = 1.0,
    anchor_weight: float = 1e4,
    damping: float = 1e-6,
    iterations: int = 8,
) -> pose_graph.PoseGraphResult:
    """`opt.pose_graph.optimize` with the unary assembly sharded over ``kf``.

    Semantically identical to the local solver (tests assert equality);
    the difference is placement: node states replicate, measurement blocks
    assemble on their home shard and reduce across devices.
    """
    K = poses.q.shape[0]
    dtype = poses.q.dtype
    odo_w = jnp.broadcast_to(jnp.asarray(odo_weight, dtype), (K - 1,))
    anchor = se3.SE3(poses.q[0], poses.t[0])

    def step(P_: se3.SE3, _):
        Hd_a, b_a = absolute_blocks_sharded(mesh, P_, abs_meas, abs_weight)
        Hd_anchor, b_anchor = pose_graph.absolute_blocks(
            se3.SE3(P_.q[:1], P_.t[:1]),
            se3.SE3(anchor.q[None], anchor.t[None]),
            jnp.full((1,), anchor_weight, dtype),
        )
        Hd_o, Hu, b_o, _ = pose_graph._between_blocks(P_, odo_meas, odo_w)
        diag = Hd_a + Hd_o
        diag = diag.at[0].add(Hd_anchor[0])
        diag = diag + damping * jnp.eye(6, dtype=dtype)
        rhs = b_a + b_o
        rhs = rhs.at[0].add(b_anchor[0])
        xi = pose_graph.solve_block_tridiagonal(diag, Hu, rhs)
        return se3.compose(P_, se3.exp(xi)), None

    final, _ = jax.lax.scan(step, poses, None, length=iterations)
    # Residual norms evaluated replicated (cheap, diagnostic only).
    res0 = _residual_norm(poses, odo_meas, abs_meas, abs_weight, odo_w)
    res1 = _residual_norm(final, odo_meas, abs_meas, abs_weight, odo_w)
    return pose_graph.PoseGraphResult(
        poses=final,
        residual_norm=res1,
        initial_residual_norm=res0,
        iterations=jnp.asarray(iterations, jnp.int32),
    )


def _residual_norm(P_, odo_meas, abs_meas, abs_weight, odo_w):
    r_abs = jax.vmap(
        lambda q, t, mq, mt: se3.log(
            se3.compose(se3.inverse(se3.SE3(mq, mt)), se3.SE3(q, t))
        )
    )(P_.q, P_.t, abs_meas.q, abs_meas.t)
    rel = pose_graph.relative_measurements(P_)
    r_odo = jax.vmap(
        lambda zq, zt, mq, mt: se3.log(
            se3.compose(se3.inverse(se3.SE3(mq, mt)), se3.SE3(zq, zt))
        )
    )(rel.q, rel.t, odo_meas.q, odo_meas.t)
    return jnp.sqrt(
        jnp.sum(abs_weight[:, None] * r_abs * r_abs)
        + jnp.sum(odo_w[:, None] * r_odo * r_odo)
    )
