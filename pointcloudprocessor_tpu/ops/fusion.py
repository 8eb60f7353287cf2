"""Multi-view scored color fusion ops (vectorised, static-shape).

Rebuilds the reference's observation scoring + top-5 blending
(`PointCloudProcessor/src/PointCloudProcessor.cpp:557-629`,
`include/PointCloudProcessor.hpp:205-236`, `include/RGBCloud.hpp:8-51`).

The reference accumulates per-point observation LISTS across keyframes
(hash map of vectors), sorts each by score and blends the top 5. Lists and
sorts don't map to static shapes; instead each point carries a fixed top-K register
(scores + colors) updated with a vectorised replace-min as keyframes stream
through a `lax.scan` — the final top-K set is identical (ties aside) and the
blend is the same score-weighted average.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class TopKColors(NamedTuple):
    """Per-point running best-K color observations.

    Layout note: the slot axis K leads (K, N) so the long point axis is
    minor (a tiny minor axis K=5 pads in tiled layouts).
    Colors live as 0xRRGGBB-packed int32, one word per observation.

    scores: (K, N) finalScore per slot; empty slots hold -inf.
    rgb:    (K, N) packed int32 colors.
    """

    scores: jnp.ndarray
    rgb: jnp.ndarray


def pack_rgb(rgb: jnp.ndarray) -> jnp.ndarray:
    """Pack (..., 3) [0,255] colors into 0xRRGGBB int32 (...,)."""
    c = jnp.clip(rgb, 0, 255).astype(jnp.int32)
    return (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]


def unpack_rgb(packed: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """Unpack 0xRRGGBB int32 (...,) to (..., 3) colors."""
    r = (packed >> 16) & 0xFF
    g = (packed >> 8) & 0xFF
    b = packed & 0xFF
    return jnp.stack([r, g, b], axis=-1).astype(dtype)


def pack_image_rgb(image: jnp.ndarray) -> jnp.ndarray:
    """Pack an (H, W, 3) uint8 image into a flat (H*W,) 0xRRGGBB int32 array.

    One sequential-bandwidth pass per keyframe; downstream per-point color
    gathers then fetch ONE int32 word instead of a 3-byte sub-row.
    """
    im = image.astype(jnp.int32)
    return ((im[..., 0] << 16) | (im[..., 1] << 8) | im[..., 2]).reshape(-1)


def init_topk(num_points: int, k: int = 5, dtype=jnp.float32) -> TopKColors:
    return TopKColors(
        scores=jnp.full((k, num_points), -jnp.inf, dtype),
        rgb=jnp.zeros((k, num_points), jnp.int32),
    )


def update_topk(
    state: TopKColors, score: jnp.ndarray, rgb: jnp.ndarray, valid: jnp.ndarray
) -> TopKColors:
    """Insert one candidate observation per point (replace the current min
    slot if the candidate beats it). O(K) vector ops, no sort.

    ``rgb`` is packed int32 (N,); float (..., 3) input is packed on entry
    for convenience.
    """
    if rgb.ndim == score.ndim + 1:
        rgb = pack_rgb(rgb)
    cand = jnp.where(valid, score, -jnp.inf)
    k = state.scores.shape[0]
    min_val = jnp.min(state.scores, axis=0)  # (N,)
    min_idx = jnp.argmin(state.scores, axis=0)
    do = cand > min_val
    onehot = (jnp.arange(k)[:, None] == min_idx[None, :]) & do[None, :]
    new_scores = jnp.where(onehot, cand[None, :], state.scores)
    new_rgb = jnp.where(onehot, rgb[None, :], state.rgb)
    return TopKColors(new_scores, new_rgb)


def blend_topk(state: TopKColors) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Score-weighted average of the stored top-K observations — semantics of
    `smoothColors` (`PointCloudProcessor.cpp:604-631`).

    Returns:
        rgb: (N, 3) blended colors [0, 255].
        colored: (N,) bool — point received at least one observation
            (uncolored points are dropped downstream per
            ``removePointsWithNoColor``, hpp:238-252).
    """
    w = jnp.where(jnp.isfinite(state.scores), state.scores, 0.0)  # (K, N)
    total = jnp.sum(w, axis=0)
    colored = total > 0.0
    inv = 1.0 / jnp.maximum(total, 1e-12)
    r = jnp.sum(((state.rgb >> 16) & 0xFF).astype(w.dtype) * w, axis=0) * inv
    g = jnp.sum(((state.rgb >> 8) & 0xFF).astype(w.dtype) * w, axis=0) * inv
    b = jnp.sum((state.rgb & 0xFF).astype(w.dtype) * w, axis=0) * inv
    return jnp.stack([r, g, b], axis=-1), colored


# ---------------------------------------------------------------------------
# Observation scores
# ---------------------------------------------------------------------------


def orientation_score(
    points_camera: jnp.ndarray,
    camera_position_world: jnp.ndarray | None = None,
    score_floor: float = 0.2,
    reference_compat: bool = False,
) -> jnp.ndarray:
    """Viewing-angle score in [floor, 1].

    Intended semantics (`PointCloudProcessor.hpp:205-220`): cosine of the
    angle between the viewing ray and the optical axis, affinely mapped to
    [0.2, 1]. The reference arithmetic subtracts the WORLD-frame camera
    position from the CAMERA-frame point (a frame mix-up); set
    ``reference_compat=True`` to replicate that exactly.
    """
    if reference_compat and camera_position_world is not None:
        view = points_camera - camera_position_world
    else:
        view = points_camera
    cos = view[..., 2] / jnp.maximum(jnp.linalg.norm(view, axis=-1), 1e-12)
    s = (cos + 1.0) * 0.5
    return score_floor + (1.0 - score_floor) * s


def distance_score(
    points_camera: jnp.ndarray, optimal_distance: float = 2.0, score_floor: float = 0.2
) -> jnp.ndarray:
    """Distance-to-optimum score in [floor, 1]
    (`PointCloudProcessor.hpp:222-236`: |d - 2| / 2, clamped)."""
    d = jnp.linalg.norm(points_camera, axis=-1)
    diff = jnp.minimum(jnp.abs(d - optimal_distance) / optimal_distance, 1.0)
    return score_floor + (1.0 - score_floor) * (1.0 - diff)


def final_score(points_camera, camera_position_world=None, *, optimal_distance=2.0, score_floor=0.2, reference_compat=False):
    """(orientation + distance) / 2 — `PointCloudProcessor.cpp:588`."""
    o = orientation_score(points_camera, camera_position_world, score_floor, reference_compat)
    d = distance_score(points_camera, optimal_distance, score_floor)
    return 0.5 * (o + d)


def final_score_xyz(
    x: jnp.ndarray,
    y: jnp.ndarray,
    z: jnp.ndarray,
    rng: jnp.ndarray,  # |p| precomputed (shared with the z-buffer cull)
    camera_position_world: jnp.ndarray | None = None,
    *,
    optimal_distance: float = 2.0,
    score_floor: float = 0.2,
    reference_compat: bool = False,
) -> jnp.ndarray:
    """`final_score` on separate coordinate arrays (hot-path form — no
    (N, 3) stack, and the range norm is shared with culling)."""
    if reference_compat and camera_position_world is not None:
        vx = x - camera_position_world[0]
        vy = y - camera_position_world[1]
        vz = z - camera_position_world[2]
        vn = jnp.sqrt(vx * vx + vy * vy + vz * vz)
        cos = vz / jnp.maximum(vn, 1e-12)
    else:
        cos = z / jnp.maximum(rng, 1e-12)
    o = score_floor + (1.0 - score_floor) * ((cos + 1.0) * 0.5)
    diff = jnp.minimum(jnp.abs(rng - optimal_distance) / optimal_distance, 1.0)
    d = score_floor + (1.0 - score_floor) * (1.0 - diff)
    return 0.5 * (o + d)


def gaussian_distance_score(
    points_camera: jnp.ndarray, ideal_distance: float = 2.0, sigma: float = 1.0
) -> jnp.ndarray:
    """Gaussian distance score ``exp(-(d - ideal)^2 / (2 sigma^2))`` — the
    alternative scoring of the reference's secondary colorizer
    (`src/vlcal/pointColorization.cpp:17-20`)."""
    d = jnp.linalg.norm(points_camera, axis=-1)
    return jnp.exp(-((d - ideal_distance) ** 2) / (2.0 * sigma * sigma))


def smooth_colors_local(
    points: jnp.ndarray,
    rgb: jnp.ndarray,
    colored: jnp.ndarray,
    radius: float,
    max_neighbors: int = 32,
    bucket_capacity: int = 32,
    chunk_size: int = 65536,
) -> jnp.ndarray:
    """Inverse-distance-weighted color smoothing over spatial neighborhoods —
    `smoothColorsWithLocalRegion` (`PointCloudProcessor.cpp:634-703`): for
    every point, average neighbor colors within ``radius`` with weight
    ``1 / (1 + d^2)`` (self included at full weight). The reference walks an
    octree with OpenMP; here neighborhoods come from the grid hash and the
    averages are one batched pass.

    Only ``colored`` points contribute and are smoothed; others keep their
    color. Returns the new (N, 3) colors.
    """
    from . import knn

    n = points.shape[0]
    grid = knn.build(points, colored, radius, max(2 * n, 1024), bucket_capacity)
    idx, dist, ok = knn.chunked_radius_neighbors(
        grid, points, points, radius, max_neighbors, chunk_size=chunk_size
    )
    w = jnp.where(ok, 1.0 / (1.0 + dist * dist), 0.0)
    neigh_rgb = rgb[jnp.maximum(idx, 0)]  # (N, K, 3)
    total = jnp.sum(w, axis=1)
    blended = jnp.sum(neigh_rgb * w[..., None], axis=1) / jnp.maximum(total, 1e-12)[:, None]
    return jnp.where((colored & (total > 0))[:, None], blended, rgb)


# ---------------------------------------------------------------------------
# Image sampling
# ---------------------------------------------------------------------------


def sample_nearest(image: jnp.ndarray, pixels: jnp.ndarray) -> jnp.ndarray:
    """Sample image (H, W, C) or (H, W) at pixel coords with the reference's
    integer-truncation convention (`PointCloudProcessor.cpp:752-753`:
    ``static_cast<int>``). Out-of-range pixels clamp; callers mask."""
    h, w = image.shape[0], image.shape[1]
    u = jnp.clip(pixels[..., 0].astype(jnp.int32), 0, w - 1)
    v = jnp.clip(pixels[..., 1].astype(jnp.int32), 0, h - 1)
    return image[v, u]


def hsv_adjust(rgb: jnp.ndarray, saturation_scale: float = 1.0, brightness_scale: float = 1.0) -> jnp.ndarray:
    """Scale HSV saturation/value of an RGB [0,255] image — semantics of
    `PointCloudProcessor.cpp:722-741`. No-op (and free after XLA DCE) at the
    reference's default scales of 1.0."""
    if saturation_scale == 1.0 and brightness_scale == 1.0:
        return rgb
    x = rgb / 255.0
    mx = jnp.max(x, axis=-1)
    mn = jnp.min(x, axis=-1)
    delta = mx - mn
    s = jnp.where(mx > 0, delta / jnp.maximum(mx, 1e-12), 0.0)
    v = mx
    # Scale s, v; rebuild via the standard HSV->RGB using original hue ratios.
    s2 = jnp.clip(s * saturation_scale, 0.0, 1.0)
    v2 = jnp.clip(v * brightness_scale, 0.0, 1.0)
    # Rebuild: each channel = v2 * (1 - s2 * (1 - orig_channel_ratio))
    ratio = jnp.where(delta[..., None] > 0, (mx[..., None] - x) / jnp.maximum(delta[..., None], 1e-12), 0.0)
    out = v2[..., None] * (1.0 - s2[..., None] * ratio)
    return jnp.clip(out * 255.0, 0.0, 255.0)
