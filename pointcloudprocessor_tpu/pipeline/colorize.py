"""Projective colorization + multi-view fusion — the jittable heart of the
pipeline.

Rebuilds `pcdColorizationAndSmooth`
(`PointCloudProcessor/src/PointCloudProcessor.cpp:474-631`) as one
`lax.scan` over keyframes on fixed-capacity arrays:

reference (per keyframe, through disk + kd-tree)          this module
--------------------------------------------------        ----------------------------
transformPointCloud world->cam (:521)                     SE3 apply (fused)
ViewCulling::cull / qhull HPR   (:527)                    scatter-min z-buffer mask
generateColorMap project+sample (:705-767)                project + gather
kd-tree radiusSearch to map index (:557-571)              identity (masks keep indices)
RGBCloud observation lists      (:586-591)                per-point top-K registers
smoothColors sort+top5 blend    (:604-631)                blend_topk
removePointsWithNoColor         (hpp:238-252)             `colored` mask

The kd-tree re-association step disappears entirely: culling returns a mask
over ORIGINAL map indices, so observations land at their own index.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core import se3
from ..models import camera as cam
from ..ops import fusion, zbuffer


class KeyframeObservation(NamedTuple):
    """Per-point observation of one keyframe (all (N,) / (N,.) aligned with
    the input map cloud). Colors are 0xRRGGBB-packed int32 — unpack with
    `fusion.unpack_rgb` at API boundaries; the packed form keeps the
    gather and top-K register traffic at one word per observation."""

    points_camera: jnp.ndarray  # (N, 3)
    pixels: jnp.ndarray  # (N, 2)
    visible: jnp.ndarray  # (N,) bool
    rgb_packed: jnp.ndarray  # (N,) int32 0xRRGGBB
    score: jnp.ndarray  # (N,) finalScore
    label: Optional[jnp.ndarray] = None  # (N,) int32 mask label


def observe_keyframe(
    camera: cam.PinholeCamera,
    image_rgb: jnp.ndarray,  # (H, W, 3) uint8/float
    T_camera_world: se3.SE3,
    points_world: jnp.ndarray,
    valid: jnp.ndarray,
    mask_image: Optional[jnp.ndarray] = None,  # (H, W) int32
    camera_position_world: Optional[jnp.ndarray] = None,
    *,
    downsample_factor: int = 14,
    depth_epsilon: float = 0.05,
    optimal_distance: float = 2.0,
    score_floor: float = 0.2,
    saturation_scale: float = 1.0,
    brightness_scale: float = 1.0,
    reference_compat_orientation: bool = False,
    culling_method: str = "zbuffer",
    hpr_radius: float = 90000.0,
    hpr_tolerance: float = 0.05,
    hpr_impl: str = "auto",
    hpr_dense_cutoff: int = 100_000,
    zbuffer_reduce=None,
) -> KeyframeObservation:
    """Project the map into one keyframe: cull, sample colors, score.

    Fuses the reference's transform -> cull -> generateColorMap -> score
    sequence (`PointCloudProcessor.cpp:495-591`) into one traced graph.
    All per-point intermediates flow as separate 1D arrays (u, v, z, range)
    rather than materialized (N, 2)/(N, 3) stacks.

    ``culling_method`` selects the visibility test, mirroring the refine
    path's `CullingConfig.method`: the reference runs its ONE culling
    (`ViewCulling::cull`, qhull HPR on the active path) in colorization
    too (`PointCloudProcessor.cpp:527`) — so when the pipeline is
    configured for HPR culling, the fusion's per-keyframe visibility must
    be the HPR mask as well, or fused colors diverge from the reference
    at occlusion shadow boundaries (golden-occluded parity).

    ``zbuffer_reduce``: cross-shard reduction of the z-buffer when
    ``points_world`` is one shard of the map (see
    `ops/zbuffer.cull_mask_uv`'s ``reduce_buffer``).
    """
    x, y, z = se3.transform_xyz(
        T_camera_world,
        points_world[..., 0],
        points_world[..., 1],
        points_world[..., 2],
    )
    rng = jnp.sqrt(x * x + y * y + z * z)
    u, v = cam.project_xyz(camera, x, y, z)
    if culling_method == "hpr":
        from ..ops import hpr as hpr_ops

        pts_cam = jnp.stack([x, y, z], axis=-1)
        gate = (
            valid
            & (z > 0.0)
            & (u >= 0) & (u < camera.width)
            & (v >= 0) & (v < camera.height)
        )
        impl = hpr_impl
        if impl == "auto":
            impl = "grid" if points_world.shape[0] > hpr_dense_cutoff else "dense"
        fn = hpr_ops.hpr_mask_grid if impl == "grid" else hpr_ops.hpr_mask
        vis = fn(pts_cam, gate, radius=hpr_radius, tolerance=hpr_tolerance)
    else:
        vis = zbuffer.cull_mask_uv(
            camera, u, v, z, rng, valid,
            downsample_factor=downsample_factor, depth_epsilon=depth_epsilon,
            reduce_buffer=zbuffer_reduce,
        )

    h, w = image_rgb.shape[0], image_rgb.shape[1]
    ui = jnp.clip(u.astype(jnp.int32), 0, w - 1)
    vi = jnp.clip(v.astype(jnp.int32), 0, h - 1)
    flat = vi * w + ui
    # Pack the image once (sequential-bandwidth), gather one int32 word per
    # point, and HSV-adjust the samples: nearest sampling commutes with the
    # per-pixel color map, and adjusting N points beats adjusting H*W pixels
    # (12x fewer at the reference's 4096x3000 / 1M-point scale).
    rgb_packed = fusion.pack_image_rgb(image_rgb)[flat]
    if saturation_scale != 1.0 or brightness_scale != 1.0:
        rgb_packed = fusion.pack_rgb(
            fusion.hsv_adjust(
                fusion.unpack_rgb(rgb_packed), saturation_scale, brightness_scale
            )
        )
    score = fusion.final_score_xyz(
        x, y, z, rng,
        camera_position_world,
        optimal_distance=optimal_distance,
        score_floor=score_floor,
        reference_compat=reference_compat_orientation,
    )
    label = None
    if mask_image is not None:
        label = mask_image.reshape(-1)[flat].astype(jnp.int32)
    # API-boundary stacks; DCE'd when the caller (e.g. fuse) ignores them.
    pixels = jnp.stack([u, v], axis=-1)
    pts_cam = jnp.stack([x, y, z], axis=-1)
    return KeyframeObservation(pts_cam, pixels, vis, rgb_packed, score, label)


@functools.partial(
    jax.jit,
    static_argnames=(
        "downsample_factor",
        "depth_epsilon",
        "saturation_scale",
        "brightness_scale",
        "mask_highlight_value",
        "culling_method",
        "hpr_radius",
        "hpr_tolerance",
        "hpr_impl",
        "hpr_dense_cutoff",
    ),
)
def keyframe_rgb_mask(
    camera: cam.PinholeCamera,
    points_world: jnp.ndarray,  # (N, 3)
    valid: jnp.ndarray,  # (N,)
    image_rgb: jnp.ndarray,  # (H, W, 3) uint8
    mask_image: jnp.ndarray,  # (H, W) int32
    kf_pose: se3.SE3,  # camera->world
    T_correction: se3.SE3,
    *,
    downsample_factor: int = 14,
    depth_epsilon: float = 0.05,
    saturation_scale: float = 1.0,
    brightness_scale: float = 1.0,
    mask_highlight_value: int = 255,
    culling_method: str = "zbuffer",
    hpr_radius: float = 90000.0,
    hpr_tolerance: float = 0.05,
    hpr_impl: str = "auto",
    hpr_dense_cutoff: int = 100_000,
):
    """One keyframe's colored+mask-labelled view for artifact dumps.

    Rebuilds `generateColorMap` + `generateSegmentMap`
    (`PointCloudProcessor.cpp:705-816`) for the per-keyframe
    ``<ts>_rgb-mask.pcd`` files written at :539-546: camera-frame points,
    sampled rgb (label==255 points painted red, :806-811), mask label.
    Returns ``(points_camera (N,3), rgb (N,3), label (N,), visible (N,))``
    at full map capacity — the caller compacts with ``visible`` at the host
    I/O boundary.
    """
    T_c2w = se3.compose(kf_pose, T_correction)
    obs = observe_keyframe(
        camera,
        image_rgb,
        se3.inverse(T_c2w),
        points_world,
        valid,
        mask_image=mask_image,
        camera_position_world=kf_pose.t,
        downsample_factor=downsample_factor,
        depth_epsilon=depth_epsilon,
        saturation_scale=saturation_scale,
        brightness_scale=brightness_scale,
        culling_method=culling_method,
        hpr_radius=hpr_radius,
        hpr_tolerance=hpr_tolerance,
        hpr_impl=hpr_impl,
        hpr_dense_cutoff=hpr_dense_cutoff,
    )
    rgb = fusion.unpack_rgb(obs.rgb_packed)
    highlight = obs.label == mask_highlight_value
    rgb = jnp.where(highlight[:, None], jnp.asarray([255.0, 0.0, 0.0]), rgb)
    return obs.points_camera, rgb, obs.label, obs.visible


class FusionResult(NamedTuple):
    rgb: jnp.ndarray  # (N, 3) blended color [0,255]
    colored: jnp.ndarray  # (N,) bool
    best_label: Optional[jnp.ndarray]  # (N,) int32 label of best observation
    observation_count: jnp.ndarray  # (N,) int32


@functools.partial(
    jax.jit,
    static_argnames=(
        "top_k",
        "downsample_factor",
        "depth_epsilon",
        "optimal_distance",
        "score_floor",
        "saturation_scale",
        "brightness_scale",
        "reference_compat_orientation",
        "with_masks",
        "culling_method",
        "hpr_radius",
        "hpr_tolerance",
        "hpr_impl",
        "hpr_dense_cutoff",
    ),
)
def fuse(
    camera: cam.PinholeCamera,
    points_world: jnp.ndarray,  # (N, 3)
    valid: jnp.ndarray,  # (N,)
    images: jnp.ndarray,  # (K, H, W, 3) uint8
    kf_poses: se3.SE3,  # batched (K,) camera->world
    T_correction: se3.SE3,  # scalar correction (NID / manual), identity if none
    mask_images: Optional[jnp.ndarray] = None,  # (K, H, W) int32
    *,
    top_k: int = 5,
    downsample_factor: int = 14,
    depth_epsilon: float = 0.05,
    optimal_distance: float = 2.0,
    score_floor: float = 0.2,
    saturation_scale: float = 1.0,
    brightness_scale: float = 1.0,
    reference_compat_orientation: bool = False,
    with_masks: bool = False,
    culling_method: str = "zbuffer",
    hpr_radius: float = 90000.0,
    hpr_tolerance: float = 0.05,
    hpr_impl: str = "auto",
    hpr_dense_cutoff: int = 100_000,
) -> FusionResult:
    """Colorize the map from all keyframes and blend top-K observations.

    The correction composes as ``T_c2w_optimized = T_c2w * T_correction``
    (`PointCloudProcessor.cpp:507,516`); it may be a single transform (NID)
    or batched per keyframe (manual per-keyframe poses, the
    `frame->getManualOptimizedPose()` branch at :510-519). Keyframes stream
    through `lax.scan` so only one image is in the working set at a
    time; the per-point top-K registers are the only
    cross-keyframe state.
    """
    n = points_world.shape[0]
    k = images.shape[0]
    corr_q = jnp.broadcast_to(T_correction.q, (k, 4))
    corr_t = jnp.broadcast_to(T_correction.t, (k, 3))
    state0 = (
        fusion.init_topk(n, top_k),
        jnp.full((n,), -jnp.inf, jnp.float32),  # best score (for label)
        jnp.zeros((n,), jnp.int32),  # best label
        jnp.zeros((n,), jnp.int32),  # observation count
    )

    def step(state, inputs):
        topk, best_s, best_l, count = state
        if with_masks and mask_images is not None:
            image, pose_q, pose_t, cq, ct, mask_img = inputs
        else:
            image, pose_q, pose_t, cq, ct = inputs
            mask_img = None
        T_c2w = se3.compose(se3.SE3(pose_q, pose_t), se3.SE3(cq, ct))
        T_w2c = se3.inverse(T_c2w)
        obs = observe_keyframe(
            camera,
            image,
            T_w2c,
            points_world,
            valid,
            mask_image=mask_img,
            camera_position_world=pose_t,
            downsample_factor=downsample_factor,
            depth_epsilon=depth_epsilon,
            optimal_distance=optimal_distance,
            score_floor=score_floor,
            saturation_scale=saturation_scale,
            brightness_scale=brightness_scale,
            reference_compat_orientation=reference_compat_orientation,
            culling_method=culling_method,
            hpr_radius=hpr_radius,
            hpr_tolerance=hpr_tolerance,
            hpr_impl=hpr_impl,
            hpr_dense_cutoff=hpr_dense_cutoff,
        )
        topk = fusion.update_topk(topk, obs.score, obs.rgb_packed, obs.visible)
        s = jnp.where(obs.visible, obs.score, -jnp.inf)
        better = s > best_s
        best_s = jnp.where(better, s, best_s)
        if obs.label is not None:
            best_l = jnp.where(better, obs.label, best_l)
        count = count + obs.visible.astype(jnp.int32)
        return (topk, best_s, best_l, count), None

    xs = (
        (images, kf_poses.q, kf_poses.t, corr_q, corr_t, mask_images)
        if (with_masks and mask_images is not None)
        else (images, kf_poses.q, kf_poses.t, corr_q, corr_t)
    )
    (topk, best_s, best_l, count), _ = jax.lax.scan(step, state0, xs)
    rgb, colored = fusion.blend_topk(topk)
    return FusionResult(
        rgb=rgb,
        colored=colored & valid,
        best_label=best_l if (with_masks and mask_images is not None) else None,
        observation_count=count,
    )
