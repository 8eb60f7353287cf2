"""Camera projection models as pure jittable functions on batched arrays.

Array-native rebuild of the reference's camera abstraction
(`PointCloudProcessor/include/camera/generic_camera_base.hpp:18-41`,
`pinhole.hpp:11-67`, `create_camera.cpp:33-49`). The reference dispatches
virtually and instantiates Ceres Jets for autodiff; here a camera is a small
pytree and projection is an ordinary differentiable function, so `jax.grad`
/ `jax.vmap` replace Jet templates.

Only the "pinhole" + "plumb_bob" model is registered — the reference's
factory likewise supports only pinhole (fisheye/atan/omnidir are commented
out at `create_camera.cpp:33-49`).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """Pinhole intrinsics + plumb_bob distortion.

    A pytree whose ``width``/``height`` are STATIC metadata (they size
    z-buffer grids and image gathers, so they must be compile-time
    constants), while intrinsics/distortion are traced leaves (so the same
    executable serves refined intrinsics).

    Attributes:
        intrinsic: (4,) [fx, fy, cx, cy]
            (reference: ``K_camera_coefficients``, `PointCloudProcessor.cpp:62`).
        distortion: (5,) [k1, k2, p1, p2, k3]
            (reference ordering per `pinhole.hpp:14-19`).
        width, height: image size in pixels (static Python ints).
    """

    intrinsic: jnp.ndarray
    distortion: jnp.ndarray
    width: int = dataclasses.field(metadata=dict(static=True))
    height: int = dataclasses.field(metadata=dict(static=True))

    def project(self, points: jnp.ndarray) -> jnp.ndarray:
        return project(self, points)

    def image_size(self) -> tuple[int, int]:
        return (self.width, self.height)


def create_camera(model: str, intrinsic, distortion, width: int, height: int) -> PinholeCamera:
    """Factory; parity with `camera::create_camera`
    (`PointCloudProcessor/src/camera/create_camera.cpp`)."""
    if model != "pinhole":
        raise ValueError(
            f"camera model '{model}' not supported (reference supports only 'pinhole', "
            "create_camera.cpp:33-49)"
        )
    return PinholeCamera(
        intrinsic=jnp.asarray(intrinsic, jnp.float32),
        distortion=jnp.asarray(distortion, jnp.float32),
        width=int(width),
        height=int(height),
    )


def distort(camera: PinholeCamera, pt: jnp.ndarray) -> jnp.ndarray:
    """plumb_bob distortion of normalized image coords (..., 2).

    Exact semantics of `PointCloudProcessor/include/camera/pinhole.hpp:13-38`
    (radial r2/r4/r6 + tangential) — also duplicated in the pipeline at
    `PointCloudProcessor/include/PointCloudProcessor.hpp:100-123`.
    """
    k1, k2, p1, p2, k3 = (camera.distortion[i] for i in range(5))
    x, y = pt[..., 0], pt[..., 1]
    x2, y2, xy = x * x, y * y, x * y
    r2 = x2 + y2
    r4 = r2 * r2
    r6 = r2 * r4
    r_coeff = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    t1 = 2.0 * xy
    t2 = r2 + 2.0 * x2
    t3 = r2 + 2.0 * y2
    xd = r_coeff * x + p1 * t1 + p2 * t2
    yd = r_coeff * y + p1 * t3 + p2 * t1
    return jnp.stack([xd, yd], axis=-1)


def project_xyz(
    camera: PinholeCamera, px: jnp.ndarray, py: jnp.ndarray, pz: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Project camera-frame points given as separate coordinate arrays to
    pixel coordinate arrays ``(u, v)``.

    Hot-path form: no (N, 3) or (N, 2) stack is ever materialized (see
    `se3.transform_xyz`).
    """
    safe_z = jnp.where(jnp.abs(pz) < 1e-9, jnp.where(pz < 0, -1e-9, 1e-9), pz)
    x = px / safe_z
    y = py / safe_z
    k1, k2, p1, p2, k3 = (camera.distortion[i] for i in range(5))
    x2, y2, xy = x * x, y * y, x * y
    r2 = x2 + y2
    r4 = r2 * r2
    r6 = r2 * r4
    r_coeff = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    xd = r_coeff * x + p1 * (2.0 * xy) + p2 * (r2 + 2.0 * x2)
    yd = r_coeff * y + p1 * (r2 + 2.0 * y2) + p2 * (2.0 * xy)
    fx, fy, cx, cy = (camera.intrinsic[i] for i in range(4))
    return fx * xd + cx, fy * yd + cy


def project_uv(
    camera: PinholeCamera, points: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Project camera-frame 3D points (..., 3) to pixel coordinate ARRAYS
    ``(u, v)``, each (...,). See :func:`project_xyz` for the layout
    rationale."""
    return project_xyz(
        camera, points[..., 0], points[..., 1], points[..., 2]
    )


def project(camera: PinholeCamera, points: jnp.ndarray) -> jnp.ndarray:
    """Project camera-frame 3D points (..., 3) to pixels (..., 2).

    Matches `pinhole.hpp:40-51`: perspective divide -> distort -> K. Points
    with z ≈ 0 are guarded against division blow-up; callers gate on z > 0
    (as the reference does at `PointCloudProcessor.cpp:748`).
    """
    u, v = project_uv(camera, points)
    return jnp.stack([u, v], axis=-1)


def in_image_uv(
    camera: PinholeCamera, u: jnp.ndarray, v: jnp.ndarray
) -> jnp.ndarray:
    """Bounds mask from separate pixel-coordinate arrays (hot-path form)."""
    uf = jnp.floor(u)
    vf = jnp.floor(v)
    return (uf >= 0) & (uf < camera.width) & (vf >= 0) & (vf < camera.height)


def in_image(camera: PinholeCamera, pixels: jnp.ndarray) -> jnp.ndarray:
    """Bounds mask using the reference's integer-truncation convention
    (`view_culling.cpp:284-288`: cast to int then compare against [0, size))."""
    return in_image_uv(camera, pixels[..., 0], pixels[..., 1])


def undistort(camera: PinholeCamera, pt_d: jnp.ndarray, iterations: int = 8) -> jnp.ndarray:
    """Invert plumb_bob distortion by fixed-point iteration (OpenCV-style).

    Replaces the reference's derivative-free Nelder-Mead projection inversion
    (`PointCloudProcessor/src/vlcal/common/estimate_fov.cpp:17-34`) with a
    jittable iteration: x_{k+1} = (x_d - tangential(x_k)) / radial(x_k).
    """
    k1, k2, p1, p2, k3 = (camera.distortion[i] for i in range(5))

    def body(_, x):
        xx, yy = x[..., 0], x[..., 1]
        x2, y2, xy = xx * xx, yy * yy, xx * yy
        r2 = x2 + y2
        r_coeff = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2.0 * p1 * xy + p2 * (r2 + 2.0 * x2)
        dy = p1 * (r2 + 2.0 * y2) + 2.0 * p2 * xy
        xn = (pt_d[..., 0] - dx) / r_coeff
        yn = (pt_d[..., 1] - dy) / r_coeff
        return jnp.stack([xn, yn], axis=-1)

    return jax.lax.fori_loop(0, iterations, body, pt_d)


def bearing(camera: PinholeCamera, pixels: jnp.ndarray) -> jnp.ndarray:
    """Unit bearing vector(s) for pixel(s) (..., 2) — replaces
    `vlcal::estimate_direction` (`estimate_fov.cpp:17-34`)."""
    fx, fy, cx, cy = (camera.intrinsic[i] for i in range(4))
    pt_d = jnp.stack([(pixels[..., 0] - cx) / fx, (pixels[..., 1] - cy) / fy], axis=-1)
    pt_n = undistort(camera, pt_d)
    d = jnp.concatenate([pt_n, jnp.ones(pt_n.shape[:-1] + (1,), pt_n.dtype)], axis=-1)
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def fov(camera: PinholeCamera) -> jnp.ndarray:
    """Max view angle over the corner probes {(0,0), (W/2,0), (0,H/2)} —
    semantics of `vlcal::estimate_camera_fov` (`estimate_fov.cpp:36-51`)."""
    corners = jnp.asarray(
        [[0.0, 0.0], [camera.width / 2.0, 0.0], [0.0, camera.height / 2.0]], jnp.float32
    )
    dirs = bearing(camera, corners)
    return jnp.max(jnp.arccos(jnp.clip(dirs[..., 2], -1.0, 1.0)))
