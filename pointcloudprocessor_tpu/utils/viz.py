"""Headless visualization: LiDAR-image overlays and cloud renders.

Rebuild of the reference's L7 viewer stack for display-less accelerator hosts:

- :func:`overlay_intensity` — the `PointsColorUpdater` live recoloring
  (`PointCloudProcessor/src/vlcal/common/points_color_updater.cpp:37-61`:
  project each point with the current transform, color by TURBO(intensity),
  alpha-blend over the camera image) as one jittable scatter — the
  reference redraws on a 50 ms background thread
  (`visual_lidar_visualizer.cpp:89-100`); here any pose/blend renders as a
  pure function call to a PNG.
- :func:`render_cloud` — `PointCloudProcessor::visualizePointCloud`
  (`src/PointCloudProcessor.cpp:1077-1102`, an interactive PCL viewer) as a
  matplotlib scatter snapshot.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import se3
from ..models import camera as cam
from . import colormap


@functools.partial(jax.jit, static_argnames=("point_radius",))
def overlay_intensity(
    camera: cam.PinholeCamera,
    image_rgb: jnp.ndarray,  # (H, W, 3) uint8/float
    points: jnp.ndarray,  # (N, 3)
    intensity: jnp.ndarray,  # (N,) in [0, 1]
    valid: jnp.ndarray,  # (N,)
    T_camera_points: Optional[se3.SE3] = None,
    blend: float = 0.65,
    point_radius: int = 1,
) -> jnp.ndarray:
    """Blend TURBO-colored projected points over the image; returns (H, W, 3)
    float32 in [0, 255]. ``blend`` is the slider of the reference GUI
    (`visual_lidar_visualizer.cpp:39-78`)."""
    if T_camera_points is not None:
        points = se3.transform_points(T_camera_points, points)
    px = cam.project(camera, points)
    ok = valid & (points[..., 2] > 0) & cam.in_image(camera, px)
    u = jnp.clip(px[:, 0].astype(jnp.int32), 0, camera.width - 1)
    v = jnp.clip(px[:, 1].astype(jnp.int32), 0, camera.height - 1)
    color = colormap.turbo(intensity) * 255.0

    img = image_rgb.astype(jnp.float32)
    # Scatter the blended color at each point's pixel footprint.
    flat_shape = (camera.height * camera.width, 3)
    out = img.reshape(flat_shape)
    for dy in range(-point_radius + 1, point_radius):
        for dx in range(-point_radius + 1, point_radius):
            uu = jnp.clip(u + dx, 0, camera.width - 1)
            vv = jnp.clip(v + dy, 0, camera.height - 1)
            idx = jnp.where(ok, vv * camera.width + uu, flat_shape[0])
            base = jnp.take(out, jnp.minimum(idx, flat_shape[0] - 1), axis=0)
            blended = base * (1.0 - blend) + color * blend
            out = out.at[idx].set(jnp.where(ok[:, None], blended, base), mode="drop")
    return out.reshape(camera.height, camera.width, 3)


def save_overlay_png(path: str, overlay: jnp.ndarray) -> None:
    import cv2

    arr = np.clip(np.asarray(overlay), 0, 255).astype(np.uint8)
    cv2.imwrite(path, arr[:, :, ::-1])  # RGB -> BGR


def render_cloud(
    path: str,
    points: np.ndarray,
    rgb: Optional[np.ndarray] = None,
    intensity: Optional[np.ndarray] = None,
    valid: Optional[np.ndarray] = None,
    max_points: int = 300_000,
    views=(("top (x-y)", 0, 1), ("front (x-z)", 0, 2)),
) -> None:
    """Scatter-render the cloud to PNG (colored by RGB, else TURBO
    intensity, else depth)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = np.asarray(points)
    if valid is not None:
        keep = np.asarray(valid)
        pts = pts[keep]
        rgb = None if rgb is None else np.asarray(rgb)[keep]
        intensity = None if intensity is None else np.asarray(intensity)[keep]
    if len(pts) > max_points:
        sel = np.linspace(0, len(pts) - 1, max_points).astype(np.int64)
        pts = pts[sel]
        rgb = None if rgb is None else rgb[sel]
        intensity = None if intensity is None else intensity[sel]

    if rgb is not None:
        c = np.clip(np.asarray(rgb) / 255.0, 0, 1)
    elif intensity is not None:
        c = np.asarray(colormap.turbo(jnp.asarray(intensity, jnp.float32)))
    else:
        z = pts[:, 2]
        rng = max(z.max() - z.min(), 1e-9)
        c = np.asarray(colormap.turbo(jnp.asarray((z - z.min()) / rng, jnp.float32)))

    fig, axes = plt.subplots(1, len(views), figsize=(7 * len(views), 6))
    axes = np.atleast_1d(axes)
    for ax, (title, i, j) in zip(axes, views):
        ax.scatter(pts[:, i], pts[:, j], s=0.2, c=c, rasterized=True)
        ax.set_title(title)
        ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
