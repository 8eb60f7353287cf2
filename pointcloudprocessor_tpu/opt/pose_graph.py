"""Pose-graph fusion of per-keyframe NID corrections with odometry.

The reference applies one global correction (or per-keyframe manual poses)
directly to the VO trajectory and never reconciles them against each other
(`PointCloudProcessor/src/PointCloudProcessor.cpp:495-519`): a noisy
per-keyframe estimate goes straight into colorization. Here the per-keyframe
NID refinements (`opt/refine.refine_pose_per_keyframe`) become *absolute
measurement factors* on a pose graph whose *between factors* are the VO
relative motions, and a Gauss-Newton smoother solves for the maximum a
posteriori trajectory. This is the rebuild's bundle-adjustment layer
(SURVEY.md §5/§7 step 7): the normal equations of a chain-plus-unary factor
graph are block-tridiagonal, so the solve is exact block Gaussian
elimination (a Schur-complement sweep down the chain) in O(K) 6x6 ops via
`lax.scan` — no dense (6K)^2 matrix is ever materialized, and per-node
Hessian blocks assembled on keyframe-sharded devices reduce across devices before
the tiny replicated sweep (`parallel/pose_graph_shard.py`).

All transforms follow the repo convention: poses are camera-to-world SE(3),
right-perturbed ``T_i <- T_i @ exp(xi_i)``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import se3


class PoseGraphResult(NamedTuple):
    poses: se3.SE3  # (K,) optimized camera-to-world poses
    residual_norm: jnp.ndarray  # final weighted residual 2-norm
    initial_residual_norm: jnp.ndarray
    iterations: jnp.ndarray


class _Blocks(NamedTuple):
    diag: jnp.ndarray  # (K, 6, 6) H_{i,i}
    upper: jnp.ndarray  # (K-1, 6, 6) H_{i,i+1}; lower blocks are transposes
    rhs: jnp.ndarray  # (K, 6) -J^T W r


def relative_measurements(poses: se3.SE3) -> se3.SE3:
    """Chain measurements Z_i = T_i^{-1} T_{i+1} from a trajectory (K,)."""
    a = se3.SE3(poses.q[:-1], poses.t[:-1])
    b = se3.SE3(poses.q[1:], poses.t[1:])
    return se3.compose(se3.inverse(a), b)


def _between_residual(xi_i, xi_j, Ti: se3.SE3, Tj: se3.SE3, Z: se3.SE3):
    """log(Z^{-1} (Ti exp(xi_i))^{-1} (Tj exp(xi_j))) — 6-vector."""
    Ti_p = se3.compose(Ti, se3.exp(xi_i))
    Tj_p = se3.compose(Tj, se3.exp(xi_j))
    rel = se3.compose(se3.inverse(Ti_p), Tj_p)
    return se3.log(se3.compose(se3.inverse(Z), rel))


def _unary_residual(xi, T: se3.SE3, M: se3.SE3):
    """log(M^{-1} (T exp(xi))) — pulls node toward measurement M."""
    return se3.log(se3.compose(se3.inverse(M), se3.compose(T, se3.exp(xi))))


def absolute_blocks(
    poses: se3.SE3, meas: se3.SE3, weight: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-node unary-factor normal-equation contributions.

    Returns ``(H_diag (K,6,6), rhs (K,6))`` with ``rhs = -w J^T r``. This is
    the piece that shards cleanly over keyframes (each NID measurement lives
    on the device that refined it); `parallel/pose_graph_shard.py` wraps it
    in `shard_map`.
    """

    def one(q, t, mq, mt, w):
        T = se3.SE3(q, t)
        M = se3.SE3(mq, mt)
        zero = jnp.zeros(6, q.dtype)
        r = _unary_residual(zero, T, M)
        J = jax.jacfwd(_unary_residual)(zero, T, M)
        return w * (J.T @ J), -w * (J.T @ r)

    return jax.vmap(one)(poses.q, poses.t, meas.q, meas.t, weight)


def _between_blocks(poses: se3.SE3, odo: se3.SE3, weight: jnp.ndarray):
    """Chain-factor contributions: (diag add (K,6,6), upper (K-1,6,6), rhs add (K,6))."""
    K = poses.q.shape[0]
    Ti = se3.SE3(poses.q[:-1], poses.t[:-1])
    Tj = se3.SE3(poses.q[1:], poses.t[1:])

    def one(qi, ti, qj, tj, zq, zt, w):
        A = se3.SE3(qi, ti)
        B = se3.SE3(qj, tj)
        Z = se3.SE3(zq, zt)
        zero = jnp.zeros(6, qi.dtype)
        r = _between_residual(zero, zero, A, B, Z)
        Ji = jax.jacfwd(_between_residual, argnums=0)(zero, zero, A, B, Z)
        Jj = jax.jacfwd(_between_residual, argnums=1)(zero, zero, A, B, Z)
        return (
            w * (Ji.T @ Ji),
            w * (Jj.T @ Jj),
            w * (Ji.T @ Jj),
            -w * (Ji.T @ r),
            -w * (Jj.T @ r),
            w * jnp.sum(r * r),
        )

    Hii, Hjj, Hij, bi, bj, sq = jax.vmap(one)(
        Ti.q, Ti.t, Tj.q, Tj.t, odo.q, odo.t, weight
    )
    dtype = poses.q.dtype
    diag = (
        jnp.zeros((K, 6, 6), dtype).at[:-1].add(Hii).at[1:].add(Hjj)
    )
    rhs = jnp.zeros((K, 6), dtype).at[:-1].add(bi).at[1:].add(bj)
    return diag, Hij, rhs, jnp.sum(sq)


def solve_block_tridiagonal(
    diag: jnp.ndarray, upper: jnp.ndarray, rhs: jnp.ndarray
) -> jnp.ndarray:
    """Solve H x = rhs for symmetric block-tridiagonal H in O(K) 6x6 ops.

    Forward sweep is exact block Gaussian elimination — each step forms the
    Schur complement of the eliminated node onto its successor — followed by
    back-substitution. ``diag`` (K,6,6), ``upper`` (K-1,6,6) = H_{i,i+1},
    ``rhs`` (K,6).
    """

    def fwd(carry, inp):
        Cp, gp = carry  # Schur-reduced diagonal block and rhs of node i-1
        D, U_prev, b = inp  # U_prev = H_{i-1,i}
        CinvU = jnp.linalg.solve(Cp, U_prev)  # (6,6)
        C = D - U_prev.T @ CinvU
        g = b - CinvU.T @ gp
        return (C, g), (Cp, gp)

    K = diag.shape[0]
    init = (diag[0], rhs[0])
    (C_last, g_last), (Cs, gs) = jax.lax.scan(
        fwd, init, (diag[1:], upper, rhs[1:])
    )
    # Cs/gs hold the reduced systems of nodes 0..K-2; C_last/g_last node K-1.
    x_last = jnp.linalg.solve(C_last, g_last)

    def bwd(x_next, inp):
        C, U, g = inp  # node i's reduced block, H_{i,i+1}, reduced rhs
        x = jnp.linalg.solve(C, g - U @ x_next)
        return x, x

    _, xs = jax.lax.scan(bwd, x_last, (Cs, upper, gs), reverse=True)
    return jnp.concatenate([xs, x_last[None]], axis=0)


@functools.partial(jax.jit, static_argnames=("iterations",))
def optimize(
    poses: se3.SE3,  # (K,) initial camera-to-world trajectory
    odo_meas: se3.SE3,  # (K-1,) VO relative motions
    abs_meas: se3.SE3,  # (K,) per-keyframe refined poses
    *,
    abs_weight: jnp.ndarray,  # (K,) >=0; 0 masks nodes without a measurement
    odo_weight: float | jnp.ndarray = 1.0,
    anchor_weight: float = 1e4,
    damping: float = 1e-6,
    iterations: int = 8,
) -> PoseGraphResult:
    """Gauss-Newton MAP trajectory over chain + unary factors.

    Node 0 additionally carries a prior at its initial value scaled by
    ``anchor_weight`` so the gauge is fixed even when ``abs_weight`` masks
    most nodes. Fixed iteration count (jit-static); the chain solve is the
    block-tridiagonal Schur sweep of :func:`solve_block_tridiagonal`.
    """
    K = poses.q.shape[0]
    dtype = poses.q.dtype
    odo_w = jnp.broadcast_to(jnp.asarray(odo_weight, dtype), (K - 1,))
    anchor = se3.SE3(poses.q[0], poses.t[0])

    def residual_norm(P: se3.SE3) -> jnp.ndarray:
        r_abs = jax.vmap(lambda q, t, mq, mt: _unary_residual(
            jnp.zeros(6, dtype), se3.SE3(q, t), se3.SE3(mq, mt)
        ))(P.q, P.t, abs_meas.q, abs_meas.t)
        rel = relative_measurements(P)
        r_odo = jax.vmap(lambda zq, zt, mq, mt: se3.log(
            se3.compose(se3.inverse(se3.SE3(mq, mt)), se3.SE3(zq, zt))
        ))(rel.q, rel.t, odo_meas.q, odo_meas.t)
        return jnp.sqrt(
            jnp.sum(abs_weight[:, None] * r_abs * r_abs)
            + jnp.sum(odo_w[:, None] * r_odo * r_odo)
        )

    def step(P: se3.SE3, _):
        Hd_a, b_a = absolute_blocks(P, abs_meas, abs_weight)
        Hd_anchor, b_anchor = absolute_blocks(
            se3.SE3(P.q[:1], P.t[:1]),
            se3.SE3(anchor.q[None], anchor.t[None]),
            jnp.full((1,), anchor_weight, dtype),
        )
        Hd_o, Hu, b_o, _ = _between_blocks(P, odo_meas, odo_w)
        diag = Hd_a + Hd_o
        diag = diag.at[0].add(Hd_anchor[0])
        diag = diag + damping * jnp.eye(6, dtype=dtype)
        rhs = b_a + b_o
        rhs = rhs.at[0].add(b_anchor[0])
        xi = solve_block_tridiagonal(diag, Hu, rhs)
        return se3.compose(P, se3.exp(xi)), None

    r0 = residual_norm(poses)
    final, _ = jax.lax.scan(step, poses, None, length=iterations)
    return PoseGraphResult(
        poses=final,
        residual_norm=residual_norm(final),
        initial_residual_norm=r0,
        iterations=jnp.asarray(iterations, jnp.int32),
    )


def smooth_refined_trajectory(
    c2w: se3.SE3,  # (K,) VO camera-to-world keyframe poses
    corrections: se3.SE3,  # (K,) per-keyframe NID corrections (camera-frame)
    *,
    converged: jnp.ndarray | None = None,  # (K,) bool from RefineResult
    abs_weight: float = 1.0,
    odo_weight: float = 10.0,
    iterations: int = 8,
) -> PoseGraphResult:
    """Fuse per-keyframe NID corrections into a smoothed trajectory.

    Measurements are ``c2w_i @ corr_i`` — the composition order of
    `PointCloudProcessor/src/PointCloudProcessor.cpp:507` — with
    non-converged refinements (if ``converged`` given) weighted to zero so
    they only ride the odometry chain.
    """
    meas = se3.compose(c2w, corrections)
    K = c2w.q.shape[0]
    w = jnp.full((K,), abs_weight, c2w.q.dtype)
    if converged is not None:
        w = w * converged.astype(c2w.q.dtype)
    return optimize(
        c2w,
        relative_measurements(c2w),
        meas,
        abs_weight=w,
        odo_weight=odo_weight,
        iterations=iterations,
    )
