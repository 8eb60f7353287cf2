"""SE(3) / quaternion math as pure, batched, jittable JAX functions.

Replaces the reference's Sophus::SE3d usage (e.g.
`PointCloudProcessor/src/vlcal/calib/visual_camera_calibration.cpp:151` and
the Ceres SE3 manifold) and the slerp/lerp trajectory interpolation of
`PointCloudProcessor/scripts/pose_interp.py:25-138` with batched f32
array code.

Conventions
-----------
* Quaternions are stored ``(w, x, y, z)`` — the order used by the odometry
  files (``ts x y z qw qx qy qz``, parsed at
  `PointCloudProcessor/src/PointCloudProcessor.cpp:970-978`) and by
  ``Eigen::Quaterniond(w, x, y, z)``.
* An SE(3) element is the pair ``(q, t)``: rotation quaternion + translation.
  Functions are batched: any leading dimensions broadcast.
* Tangent vectors are 6-vectors ``[rho, omega]`` (translation part first),
  matching Sophus' ``SE3::exp`` so the solver semantics map 1:1.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_EPS = 1e-8


class SE3(NamedTuple):
    """A (batch of) rigid transform(s): ``x -> R(q) @ x + t``.

    Attributes:
        q: (..., 4) unit quaternion(s), (w, x, y, z).
        t: (..., 3) translation(s).
    """

    q: jnp.ndarray
    t: jnp.ndarray

    # Convenience operator sugar; the functional API below is canonical.
    def __matmul__(self, other: "SE3") -> "SE3":
        return compose(self, other)

    def apply(self, points: jnp.ndarray) -> jnp.ndarray:
        return transform_points(self, points)

    def inverse(self) -> "SE3":
        return inverse(self)


# ---------------------------------------------------------------------------
# Quaternion primitives
# ---------------------------------------------------------------------------


def quat_normalize(q: jnp.ndarray) -> jnp.ndarray:
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_multiply(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product of (w,x,y,z) quaternions."""
    aw, ax, ay, az = jnp.moveaxis(a, -1, 0)
    bw, bx, by, bz = jnp.moveaxis(b, -1, 0)
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conjugate(q: jnp.ndarray) -> jnp.ndarray:
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vector(s) v (..., 3) by quaternion(s) q (..., 4).

    Uses the expanded 15-multiply form (no matrix materialisation), which XLA
    fuses into the surrounding elementwise graph.
    """
    w = q[..., :1]
    u = q[..., 1:]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """(..., 4) wxyz -> (..., 3, 3) rotation matrix."""
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) rotation matrix -> (..., 4) wxyz quaternion.

    Branch-free Shepperd-style extraction: compute all four candidate
    quaternions and select the best-conditioned one, so it is jit/vmap safe.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, 1e-12))

    # Candidate 0: trace-dominant
    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = jnp.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], axis=-1)
    # Candidate 1: m00 dominant
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = jnp.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], axis=-1)
    # Candidate 2: m11 dominant
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = jnp.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], axis=-1)
    # Candidate 3: m22 dominant
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = jnp.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], axis=-1)

    scores = jnp.stack([tr, m00, m11, m22], axis=-1)
    best = jnp.argmax(scores, axis=-1)
    qs = jnp.stack([q0, q1, q2, q3], axis=-2)  # (..., 4 candidates, 4)
    q = jnp.take_along_axis(qs, best[..., None, None].astype(jnp.int32).repeat(4, axis=-1), axis=-2)[..., 0, :]
    return quat_normalize(q)


def quat_angle(q: jnp.ndarray) -> jnp.ndarray:
    """Rotation angle (radians, in [0, pi]) of quaternion(s)."""
    w = jnp.clip(jnp.abs(q[..., 0]), 0.0, 1.0)
    return 2.0 * jnp.arccos(w)


def quat_slerp(q0: jnp.ndarray, q1: jnp.ndarray, frac: jnp.ndarray) -> jnp.ndarray:
    """Spherical linear interpolation with the exact branch structure of
    `PointCloudProcessor/scripts/pose_interp.py:66-88`:

    * if dot(q0, q1) >= 1: linear interpolation,
    * else slerp with theta = arccos(|dot|), and the q1 coefficient negated
      when dot < 0 (shortest-path correction).
    """
    d = jnp.sum(q0 * q1, axis=-1)
    theta = jnp.arccos(jnp.clip(jnp.abs(d), 0.0, 1.0 - 1e-7))
    sin_theta = jnp.sin(theta)
    lin = d >= 1.0
    s0 = jnp.where(lin, 1.0 - frac, jnp.sin((1.0 - frac) * theta) / jnp.maximum(sin_theta, _EPS))
    s1 = jnp.where(lin, frac, jnp.sin(frac * theta) / jnp.maximum(sin_theta, _EPS))
    s1 = jnp.where(d < 0.0, -s1, s1)
    return s0[..., None] * q0 + s1[..., None] * q1


# ---------------------------------------------------------------------------
# SE(3) group ops
# ---------------------------------------------------------------------------


def identity(dtype=jnp.float32, batch_shape=()) -> SE3:
    q = jnp.broadcast_to(jnp.asarray([1.0, 0, 0, 0], dtype=dtype), batch_shape + (4,))
    t = jnp.zeros(batch_shape + (3,), dtype=dtype)
    return SE3(q, t)


def from_qt(q_wxyz: jnp.ndarray, t: jnp.ndarray) -> SE3:
    return SE3(quat_normalize(jnp.asarray(q_wxyz)), jnp.asarray(t))


def compose(a: SE3, b: SE3) -> SE3:
    """a ∘ b (apply b first, then a) — matches `t_c2w * T_correction` at
    `PointCloudProcessor/src/PointCloudProcessor.cpp:507`."""
    return SE3(quat_normalize(quat_multiply(a.q, b.q)), quat_rotate(a.q, b.t) + a.t)


def inverse(x: SE3) -> SE3:
    qinv = quat_conjugate(x.q)
    return SE3(qinv, -quat_rotate(qinv, x.t))


def transform_points(x: SE3, points: jnp.ndarray) -> jnp.ndarray:
    """Apply transform(s) to points (..., 3). Batch dims of x broadcast
    against leading dims of points."""
    return quat_rotate(x.q[..., None, :] if x.q.ndim == points.ndim - 1 else x.q, points) + (
        x.t[..., None, :] if x.t.ndim == points.ndim - 1 else x.t
    )


def transform_xyz(
    T: SE3, x: jnp.ndarray, y: jnp.ndarray, z: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Apply a single transform to points given as separate coordinate
    arrays, returning separate arrays.

    Hot-path form: pipelines keep coordinates as separate 1D arrays and
    only stack at API boundaries (a materialized (N, 3) result puts a
    size-3 axis minor, which tiled accelerator layouts pad).
    """
    R = quat_to_matrix(T.q)
    cx = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + T.t[0]
    cy = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + T.t[1]
    cz = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + T.t[2]
    return cx, cy, cz


def matrix(x: SE3) -> jnp.ndarray:
    """(..., 4, 4) homogeneous matrix."""
    R = quat_to_matrix(x.q)
    top = jnp.concatenate([R, x.t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], dtype=x.t.dtype), x.t.shape[:-1] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def from_matrix(m: jnp.ndarray) -> SE3:
    return SE3(matrix_to_quat(m[..., :3, :3]), m[..., :3, 3])


def _skew(w: jnp.ndarray) -> jnp.ndarray:
    wx, wy, wz = jnp.moveaxis(w, -1, 0)
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [z, -wz, wy, wz, z, -wx, -wy, wx, z], axis=-1
    ).reshape(w.shape[:-1] + (3, 3))


def exp(tangent: jnp.ndarray) -> SE3:
    """SE(3) exponential map. ``tangent = [rho (3), omega (3)]`` (Sophus order).

    Taylor-guarded for small angles so it is differentiable at 0.
    """
    rho, omega = tangent[..., :3], tangent[..., 3:]
    theta2 = jnp.sum(omega * omega, axis=-1)
    # Wide Taylor window (theta < 0.1 rad): the exact branch's 1-cos(theta)
    # cancels catastrophically in f32 for small theta; the theta^4 Taylor
    # terms keep the truncation error at ~f32 eps at the boundary.
    small = theta2 < 1e-2
    # NaN-safe branching: the unselected `where` branch is still evaluated (and
    # differentiated), so its denominators must be clamped away from zero.
    theta2_safe = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta = jnp.sqrt(theta2_safe)
    theta4 = theta2 * theta2

    # Quaternion exp of omega/2.
    half = 0.5 * theta
    sinc_half = jnp.where(
        small, 0.5 - theta2 / 48.0 + theta4 / 3840.0, jnp.sin(half) / theta
    )
    qw = jnp.where(small, 1.0 - theta2 / 8.0 + theta4 / 384.0, jnp.cos(half))
    qv = omega * sinc_half[..., None]
    q = quat_normalize(jnp.concatenate([qw[..., None], qv], axis=-1))

    # V matrix: I + (1-cos)/theta^2 W + (theta-sin)/theta^3 W^2
    W = _skew(omega)
    W2 = W @ W
    a = jnp.where(
        small, 0.5 - theta2 / 24.0 + theta4 / 720.0, (1.0 - jnp.cos(theta)) / theta2_safe
    )
    b = jnp.where(
        small,
        1.0 / 6.0 - theta2 / 120.0 + theta4 / 5040.0,
        (theta - jnp.sin(theta)) / (theta2_safe * theta),
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=tangent.dtype), W.shape)
    V = eye + a[..., None, None] * W + b[..., None, None] * W2
    t = jnp.squeeze(V @ rho[..., :, None], -1)
    return SE3(q, t)


def log(x: SE3) -> jnp.ndarray:
    """SE(3) logarithm: inverse of :func:`exp`. Returns (..., 6) [rho, omega]."""
    q = quat_normalize(x.q)
    # Ensure w >= 0 for a principal log.
    q = jnp.where(q[..., :1] < 0, -q, q)
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    # Differentiable-at-identity formulation: |v| has a NaN derivative at 0,
    # so the small branch is written in terms of the smooth |v|^2 (this is
    # load-bearing — the pose-graph Jacobians evaluate log at exactly-zero
    # residuals when the graph is consistent). The Taylor window is wide
    # (theta < ~0.1 rad): the exact branch's 1-cos(theta) cancels
    # catastrophically in f32 below that, while the Taylor truncation error
    # at the boundary is ~f32 eps.
    v2 = jnp.sum(q[..., 1:] * q[..., 1:], axis=-1)
    small = v2 < 2.5e-3  # |v| = sin(theta/2), so theta < ~0.1 rad
    vnorm = jnp.sqrt(jnp.where(small, 1.0, v2))
    theta = 2.0 * jnp.arctan2(vnorm, w)
    w_safe = jnp.maximum(w, 0.5)  # small branch only (w ~ 1 there)
    # scale = 2 atan2(|v|, w)/|v| = (2/w)(1 - t^2/3 + t^4/5 - ...), t = |v|/w
    t2 = v2 / (w_safe * w_safe)
    scale = jnp.where(
        small,
        (2.0 / w_safe) * (1.0 - t2 / 3.0 + t2 * t2 / 5.0),
        theta / vnorm,
    )
    omega = q[..., 1:] * scale[..., None]

    theta2 = jnp.sum(omega * omega, axis=-1)
    theta2_safe = jnp.where(small, jnp.ones_like(theta2), theta2)
    W = _skew(omega)
    W2 = W @ W
    # V^{-1} = I - W/2 + (1/theta^2)(1 - theta sin / (2 (1-cos))) W^2
    theta_c = jnp.sqrt(theta2_safe)
    coeff = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - theta_c * jnp.sin(theta_c) / (2.0 * jnp.maximum(1.0 - jnp.cos(theta_c), 1e-12)))
        / theta2_safe,
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), W.shape)
    Vinv = eye - 0.5 * W + coeff[..., None, None] * W2
    rho = jnp.squeeze(Vinv @ x.t[..., :, None], -1)
    return jnp.concatenate([rho, omega], axis=-1)


def delta_magnitudes(a: SE3, b: SE3) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(translation delta norm, rotation delta angle) between two transforms —
    the convergence metric of
    `PointCloudProcessor/src/vlcal/calib/visual_camera_calibration.cpp:67-72`."""
    d = compose(inverse(a), b)
    return jnp.linalg.norm(d.t, axis=-1), quat_angle(d.q)


# ---------------------------------------------------------------------------
# Trajectory interpolation (pose_interp.py semantics)
# ---------------------------------------------------------------------------


def interpolate_trajectory(
    pose_times: jnp.ndarray,
    quats_wxyz: jnp.ndarray,
    positions: jnp.ndarray,
    query_times: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Interpolate a pose track at query timestamps: slerp on rotation, lerp on
    translation — the semantics of
    `PointCloudProcessor/scripts/pose_interp.py:54-94` rebuilt as a single
    vectorised gather + slerp (no Python loop over requests).

    Args:
        pose_times: (M,) ascending timestamps of the input track.
        quats_wxyz: (M, 4) track quaternions.
        positions: (M, 3) track positions.
        query_times: (Q,) requested timestamps.

    Returns:
        (Q, 4) quaternions and (Q, 3) positions.
    """
    upper = jnp.clip(jnp.searchsorted(pose_times, query_times, side="right"), 1, len(pose_times) - 1)
    lower = upper - 1
    t0 = pose_times[lower]
    t1 = pose_times[upper]
    frac = jnp.where(t1 > t0, (query_times - t0) / jnp.maximum(t1 - t0, _EPS), 0.0).astype(
        positions.dtype
    )
    q = quat_slerp(quats_wxyz[lower], quats_wxyz[upper], frac)
    p = (1.0 - frac)[..., None] * positions[lower] + frac[..., None] * positions[upper]
    return quat_normalize(q), p
