"""Occlusion culling as a scatter-min z-buffer — static shapes, mask output.

Replaces the reference's hidden-point removal. The reference's ACTIVE path is
Katz spherical-flip + qhull convex hull
(`PointCloudProcessor/src/vlcal/calib/view_culling.cpp:266-334`, called from
`cull` at :46); qhull's data-dependent output is not expressible as a
static-shape kernel. The reference ALSO carries a z-buffer depth-culling
path (`view_culling.cpp:52-174`, 14× image downsample at :63, 0.05 m depth
epsilon at :157) which it keeps as an alternative; that design IS a pure
scatter-min and is the one rebuilt here. Both accept/reject the same
dominant-surface points on the benchmark scenes; the z-buffer additionally
has a tunable resolution/epsilon, and unlike qhull it returns a mask of the
ORIGINAL indices, which removes the reference's kd-tree re-association step
(`PointCloudProcessor.cpp:557-571`) entirely.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models import camera as cam


def cull_mask_uv(
    camera: cam.PinholeCamera,
    u: jnp.ndarray,  # (N,) pixel u of each point
    v: jnp.ndarray,  # (N,) pixel v
    z: jnp.ndarray,  # (N,) camera-frame depth
    rng: jnp.ndarray,  # (N,) camera-frame range |p|
    valid: jnp.ndarray,
    downsample_factor: int = 14,
    depth_epsilon: float = 0.05,
    enable_depth_buffer: bool = True,
    reduce_buffer=None,
) -> jnp.ndarray:
    """Visibility mask from precomputed per-point projections (hot path).

    Taking u/v/z/rng as separate 1-D arrays (rather than (N, 2)/(N, 3)
    stacks) lets callers share one projection pass between culling and color
    sampling.

    ``reduce_buffer``: callers whose points are one shard of the map pass
    the cross-shard minimum (e.g. ``lambda b: lax.pmin(b, axis)``), so a
    point is tested against the nearest return of the WHOLE map in its
    cell, not just of its own shard.

    Stages (matching `view_culling.cpp:52-174` semantics):
      1. in-front gate  z > 0           (:76-80)
      2. in-image gate (projected px)   (:90-94)
      3. scatter-min range per downsampled cell; keep points whose range is
         within ``depth_epsilon`` of the cell minimum (:100-171).
    """
    ds = int(downsample_factor)
    grid_w = camera.width // ds
    grid_h = camera.height // ds

    ok = valid & (z > 0.0) & cam.in_image_uv(camera, u, v)

    if not enable_depth_buffer:
        return ok

    ui = jnp.clip((u / ds).astype(jnp.int32), 0, grid_w - 1)
    vi = jnp.clip((v / ds).astype(jnp.int32), 0, grid_h - 1)
    cell = vi * grid_w + ui

    big = jnp.asarray(jnp.finfo(rng.dtype).max, rng.dtype)
    rng_masked = jnp.where(ok, rng, big)
    # Invalid points scatter to a sink cell so they never shadow real ones.
    cell_masked = jnp.where(ok, cell, grid_w * grid_h)

    zmin = jnp.full((grid_w * grid_h + 1,), big, rng.dtype)
    zmin = zmin.at[cell_masked].min(rng_masked, mode="drop")
    if reduce_buffer is not None:
        zmin = reduce_buffer(zmin)

    cell_min = zmin[cell_masked]
    return ok & (rng <= cell_min + depth_epsilon)


def cull_mask(
    camera: cam.PinholeCamera,
    points_camera: jnp.ndarray,
    valid: jnp.ndarray,
    downsample_factor: int = 14,
    depth_epsilon: float = 0.05,
    enable_depth_buffer: bool = True,
) -> jnp.ndarray:
    """Visibility mask for camera-frame points (see :func:`cull_mask_uv`).

    Args:
        camera: projection model (full-resolution intrinsics).
        points_camera: (N, 3) points already in the camera frame.
        valid: (N,) bool input validity.
        downsample_factor: z-buffer cell size in pixels.
        depth_epsilon: metres of slack behind the nearest return per cell.

    Returns:
        (N,) bool visibility mask (subset of ``valid``).
    """
    u, v = cam.project_uv(camera, points_camera)
    x, y, z = (points_camera[..., i] for i in range(3))
    rng = jnp.sqrt(x * x + y * y + z * z)
    return cull_mask_uv(
        camera, u, v, z, rng, valid, downsample_factor, depth_epsilon,
        enable_depth_buffer,
    )


def cull_world_points(
    camera: cam.PinholeCamera,
    T_camera_world,
    points_world: jnp.ndarray,
    valid: jnp.ndarray,
    downsample_factor: int = 14,
    depth_epsilon: float = 0.05,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Transform world points into the camera frame and cull.

    Returns (points_camera, visibility_mask). Mirrors the
    transform-then-cull sequence at `PointCloudProcessor.cpp:186-207`.
    """
    from ..core import se3

    pts_cam = se3.transform_points(T_camera_world, points_world)
    mask = cull_mask(camera, pts_cam, valid, downsample_factor, depth_epsilon)
    return pts_cam, mask
