"""Pipeline orchestration — the `PointCloudProcessor::process()` equivalent.

Rebuilds the stage sequence of
`PointCloudProcessor/src/PointCloudProcessor.cpp:1007-1032`:

    loadImagesAndOdometry -> loadPointCloud (crop [+ MLS]) -> selectKeyframes
    -> viewCulling (+ optional per-keyframe dumps) -> [NID refine]
    -> colorize + fuse -> save outputs

with one structural difference: stages hand off DEVICE ARRAYS, not ASCII
PCD files (the reference writes culled clouds to disk at :213-222 and the
optimizer re-reads them at `visual_camera_calibration.cpp:160-167`).
Per-keyframe artifact dumps remain available for parity/debugging.
"""

from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import cloud as cl
from ..core import se3
from ..io import images as img_io
from ..io import odometry as odom_io
from ..io import pcd
from ..models import camera as cam
from ..ops import zbuffer
from ..opt import nid as nid_mod
from ..opt import refine
from ..utils.config import PipelineConfig
from . import colorize, ingest, keyframes


@dataclass
class PipelineResult:
    colored_cloud_path: str = ""
    mask_cloud_path: str = ""
    num_keyframes: int = 0
    num_colored_points: int = 0
    T_correction: Optional[se3.SE3] = None
    nid_value: float = float("nan")
    timings: dict = field(default_factory=dict)


def _make_camera(cfg: PipelineConfig) -> cam.PinholeCamera:
    return cam.create_camera(
        cfg.camera.model,
        cfg.camera.intrinsic,
        cfg.camera.distortion,
        cfg.camera.width,
        cfg.camera.height,
    )


def _extrinsic_lidar_to_cam(cfg: PipelineConfig) -> Optional[se3.SE3]:
    """T_camera<-lidar from config, or None when ``extrinsic.apply`` is off.

    The reference's R_lidar2cam/t_lidar2cam (`PointCloudProcessor.cpp:51-54`)
    are initialized but never used; behind the flag they enter the pose chain
    as T_c2w = T_odom(lidar->world) ∘ inverse(T_camera<-lidar)."""
    if not cfg.extrinsic.apply:
        return None
    R = jnp.asarray(cfg.extrinsic.rotation, jnp.float32)
    t = jnp.asarray(cfg.extrinsic.translation, jnp.float32)
    m = jnp.concatenate([R, t[:, None]], axis=1)
    m = jnp.concatenate(
        [m, jnp.asarray([[0.0, 0.0, 0.0, 1.0]], jnp.float32)], axis=0
    )
    return se3.from_matrix(m)


def _frame_pose(frame, T_l2c: Optional[se3.SE3]) -> se3.SE3:
    """Camera-to-world pose of one frame (odometry [∘ extrinsic chain])."""
    T = se3.SE3(
        q=se3.quat_normalize(jnp.asarray(frame.quat_wxyz, jnp.float32)),
        t=jnp.asarray(frame.position, jnp.float32),
    )
    return T if T_l2c is None else se3.compose(T, se3.inverse(T_l2c))


def _camera_to_world(frames, idx, T_l2c: Optional[se3.SE3] = None) -> se3.SE3:
    base = se3.SE3(
        q=se3.quat_normalize(jnp.asarray(np.stack([frames[i].quat_wxyz for i in idx]), jnp.float32)),
        t=jnp.asarray(np.stack([frames[i].position for i in idx]), jnp.float32),
    )
    return base if T_l2c is None else se3.compose(base, se3.inverse(T_l2c))


@functools.partial(
    jax.jit,
    static_argnames=("method", "downsample_factor", "impl", "dense_cutoff"),
)
def _cull_device(
    camera,
    q_c2w,
    t_c2w,
    points,
    valid,
    *,
    method,
    downsample_factor,
    depth_epsilon,
    radius,
    tolerance,
    impl,
    dense_cutoff,
):
    """One jitted dispatch per keyframe cull: the pose algebra + transform +
    cull chain is one compiled program instead of dozens of eager
    dispatches. Takes the camera-to-world pose and inverts inside the
    trace."""
    T_w2c = se3.inverse(se3.SE3(q_c2w, t_c2w))
    if method == "hpr":
        from ..ops import hpr

        return hpr.cull_world_points(
            camera, T_w2c, points, valid,
            radius=radius, tolerance=tolerance,
            impl=impl, dense_cutoff=dense_cutoff,
        )
    return zbuffer.cull_world_points(
        camera, T_w2c, points, valid,
        downsample_factor=downsample_factor, depth_epsilon=depth_epsilon,
    )


@jax.jit
def _take_rows(arr, idx):
    return jnp.take(arr, idx, axis=0)


def cull_keyframe_host(camera, map_cloud, T_c2w, cfg, device_points=False):
    """Visibility indices for one keyframe (host-compacted).

    ``device_points``: return the camera-frame points as the DEVICE array
    instead of pulling all N rows to the host — callers that only need the
    visible subset compact on device first."""
    pts_cam, mask = _cull_device(
        camera,
        T_c2w.q,
        T_c2w.t,
        map_cloud.points,
        map_cloud.valid,
        method=cfg.culling.method,
        downsample_factor=cfg.culling.downsample_factor,
        depth_epsilon=cfg.culling.depth_epsilon,
        radius=cfg.culling.hidden_points_removal_max_z,
        tolerance=cfg.culling.hpr_tolerance,
        impl=cfg.culling.hpr_impl,
        dense_cutoff=cfg.culling.hpr_dense_cutoff,
    )
    vis = np.flatnonzero(np.asarray(mask))
    return vis, (pts_cam if device_points else np.asarray(pts_cam))


_normalize_jit = jax.jit(cl.normalize_intensity)


@jax.jit
def _points_in_frame(q_c2w, t_c2w, points):
    return se3.transform_points(se3.inverse(se3.SE3(q_c2w, t_c2w)), points)


def build_nid_keyframes(
    camera,
    map_cloud,
    frames,
    kf_idx,
    cfg,
    save_dir: str = "",
    T_correction: Optional[se3.SE3] = None,
):
    """Cull per keyframe and assemble the padded NIDKeyframe batch.

    Mirrors `viewCullingAndSaveFilteredPcds` (:178-224) + the data loading in
    `estimate_pose_bfgs` (:160-178), without the disk round-trip (optional
    dumps preserved when ``save_dir`` is set).

    ``T_correction`` (scalar or batched (K,)) re-culls at the corrected pose
    ``T_c2w ∘ T_correction`` (`PointCloudProcessor.cpp:507` composition) for
    ``NIDConfig.recull_every_outer_iter``: the VISIBILITY mask updates, but
    point coordinates stay in the raw keyframe camera frame so the refine's
    correction composition is identical across outer iterations.
    """
    cap = cfg.culled_capacity
    pts_list, int_list, val_list, bin_list = [], [], [], []
    norm_cloud = _normalize_jit(map_cloud)
    intensity_np = np.asarray(norm_cloud.intensity)  # one pull, reused per kf
    T_l2c = _extrinsic_lidar_to_cam(cfg)
    for j, i in enumerate(kf_idx):
        T_c2w = _frame_pose(frames[i], T_l2c)
        T_cull = T_c2w
        if T_correction is not None:
            corr = (
                se3.SE3(T_correction.q[j], T_correction.t[j])
                if T_correction.q.ndim == 2
                else T_correction
            )
            T_cull = se3.compose(T_c2w, corr)
        vis_idx, pts_cam = cull_keyframe_host(
            camera, norm_cloud, T_cull, cfg, device_points=True
        )
        if T_correction is not None:
            # Raw-frame coordinates for the selected (re-culled) indices.
            pts_cam = _points_in_frame(T_c2w.q, T_c2w.t, norm_cloud.points)
        if len(vis_idx) > cap:
            vis_idx = vis_idx[np.linspace(0, len(vis_idx) - 1, cap).astype(np.int64)]
        p = np.zeros((cap, 3), np.float32)
        it = np.zeros((cap,), np.float32)
        v = np.zeros((cap,), bool)
        # Compact ON DEVICE, pull only the visible subset.
        idx_dev = jnp.asarray(vis_idx.astype(np.int32))
        p[: len(vis_idx)] = np.asarray(_take_rows(pts_cam, idx_dev))
        it[: len(vis_idx)] = intensity_np[vis_idx]
        v[: len(vis_idx)] = True
        pts_list.append(p)
        int_list.append(it)
        val_list.append(v)
        gray = img_io.load_gray_normalized(frames[i].image_path)
        # Quantize on HOST and ship uint8: the batch ships 4x smaller than
        # int32 and casts to int32 on device in the batched push below.
        b = np.clip((gray * cfg.nid.bins).astype(np.int32), 0, cfg.nid.bins - 1)
        bin_list.append(b.astype(np.uint8))
        if save_dir:
            ts = ingest.cpp_timestamp(frames[i].timestamp)
            pcd.write(
                os.path.join(save_dir, f"{ts}_beforeNID.pcd"),
                p[: len(vis_idx)],
                intensity=it[: len(vis_idx)],
            )
    bins_u8 = jnp.asarray(np.stack(bin_list))  # (K, H, W) uint8 push
    return nid_mod.NIDKeyframe(
        points=jnp.asarray(np.stack(pts_list)),
        intensity=jnp.asarray(np.stack(int_list)),
        valid=jnp.asarray(np.stack(val_list)),
        bin_image=jax.jit(lambda b: b.astype(jnp.int32))(bins_u8),
    )


def process(cfg: PipelineConfig) -> PipelineResult:
    """Run the full pipeline per the config. Returns paths + stats."""
    import contextlib

    from ..utils import profiling

    t_start = time.perf_counter()
    result = PipelineResult()
    timings = result.timings

    for label, path in (
        ("point_cloud_path", cfg.point_cloud_path),
        ("odometry_path", cfg.odometry_path),
        ("images_folder", cfg.images_folder),
    ):
        if not os.path.exists(path):
            raise FileNotFoundError(f"{label} does not exist: {path!r}")

    camera = _make_camera(cfg)
    os.makedirs(cfg.output_path, exist_ok=True)
    filtered_dir = os.path.join(cfg.output_path, "filtered_pcd")
    os.makedirs(filtered_dir, exist_ok=True)
    metrics_path = (
        os.path.join(cfg.output_path, "metrics.jsonl")
        if cfg.metrics_path == "auto"
        else cfg.metrics_path
    )
    metrics = profiling.MetricsLogger(metrics_path)
    metrics.log("pipeline_start", config_keyframes_cap=cfg.max_keyframes)
    trace_ctx = (
        profiling.trace(cfg.profile_trace_dir)
        if cfg.profile_trace_dir
        else contextlib.nullcontext()
    )
    with trace_ctx:
        result = _process_stages(
            cfg, camera, filtered_dir, result, timings, metrics
        )
    timings["total"] = time.perf_counter() - t_start
    metrics.log("pipeline_done", **{k: round(v, 4) for k, v in timings.items()})
    return result


def _process_stages(cfg, camera, filtered_dir, result, timings, metrics):
    # 1. Frames + odometry (loadImagesAndOdometry, :965-1005).
    frames = ingest.load_frames(
        cfg.odometry_path, cfg.images_folder, cfg.mask_image_folder,
        image_ext=cfg.image_ext,
    )
    if not frames:
        raise ValueError(
            "no frames: no odometry timestamp matched an image file — check "
            f"that images are named '<ts:.6f>{cfg.image_ext}' for the "
            "odometry timestamps"
        )
    traj = ingest.frames_trajectory(frames)
    metrics.log("frames_loaded", count=len(frames))

    # 2. Map load + trajectory crop (loadPointCloud, :92-154).
    t0 = time.perf_counter()
    crop_path = os.path.join(cfg.output_path, "scans-crop.pcd")
    mls_path = os.path.join(cfg.output_path, "scans-crop_mls.pcd")
    resumed_crop = cfg.resume and os.path.exists(
        mls_path if cfg.enable_mls else crop_path
    )
    if resumed_crop:
        # Stage checkpoint: artifacts double as restart points, as the
        # reference's file hand-offs implicitly do (SURVEY §5).
        map_cloud = pcd.read_cloud(
            mls_path if cfg.enable_mls else crop_path, capacity=cfg.map_capacity
        )
        metrics.log("crop_resumed", path=mls_path if cfg.enable_mls else crop_path)
        timings["load_crop"] = time.perf_counter() - t0
    else:
        map_cloud = pcd.read_cloud(cfg.point_cloud_path, capacity=cfg.map_capacity)
        map_cloud = cl.trajectory_crop(
            map_cloud, jnp.asarray(traj.positions), padding=cfg.crop_padding
        )
        pcd.write_cloud(crop_path, map_cloud)
        timings["load_crop"] = time.perf_counter() - t0

        if cfg.enable_mls:
            t0 = time.perf_counter()
            from ..ops import mls as mls_mod

            map_cloud = mls_mod.smooth_cloud(map_cloud, cfg.mls)
            pcd.write_cloud(mls_path, map_cloud)
            timings["mls"] = time.perf_counter() - t0
    metrics.log("map_ready", points=int(map_cloud.count()))

    # 3. Keyframes (selectKeyframes, :1050-1075).
    kf_idx = keyframes.select(traj, cfg.keyframes)[: cfg.max_keyframes]
    result.num_keyframes = len(kf_idx)

    # 4. Culling (+ NID keyframe assembly; viewCullingAndSaveFilteredPcds).
    t0 = time.perf_counter()
    kfs = build_nid_keyframes(camera, map_cloud, frames, kf_idx, cfg, save_dir=filtered_dir)
    timings["culling"] = time.perf_counter() - t0

    from ..utils import profiling as prof

    device_kind = jax.devices()[0].device_kind
    metrics.log(
        "cost_estimate_nid",
        **prof.cost_record(
            prof.nid_cost_estimate(cfg.culled_capacity, len(kf_idx), cfg.nid.bins),
            device_kind,
        ),
    )

    # 5. Optional NID pose refinement (applyNIDBasedPoseOptimization, :156-164).
    T_correction = se3.identity()
    corr_path = os.path.join(cfg.output_path, "nid_correction.json")
    if cfg.enable_nid_optimize:
        if cfg.resume and os.path.exists(corr_path):
            import json

            saved = json.loads(open(corr_path).read())
            T_correction = se3.from_qt(
                jnp.asarray(saved["quat_wxyz"], jnp.float32),
                jnp.asarray(saved["translation"], jnp.float32),
            )
            result.nid_value = saved.get("nid", float("nan"))
            metrics.log("nid_resumed", path=corr_path)
        else:
            t0 = time.perf_counter()
            refine_fn = (
                refine.refine_pose_per_keyframe
                if cfg.nid.per_keyframe
                else refine.refine_pose
            )

            def run_refine(kfs_in, T0, outer_iters):
                kw = {}
                if not cfg.nid.per_keyframe and cfg.nid.coarse_outer_iterations:
                    kw = dict(
                        coarse_outer_iterations=cfg.nid.coarse_outer_iterations,
                        coarse_stride=cfg.nid.coarse_stride,
                    )
                if not cfg.nid.per_keyframe and cfg.nid.frozen_taps:
                    kw.update(
                        frozen_taps=True,
                        frozen_guard_frac=cfg.nid.frozen_guard_frac,
                        frozen_partial_frac=cfg.nid.frozen_partial_frac,
                        frozen_margin=cfg.nid.frozen_margin,
                    )
                if not cfg.nid.per_keyframe and (
                    cfg.nid.carry_hessian or cfg.nid.ftol
                ):
                    kw.update(
                        carry_hessian=cfg.nid.carry_hessian,
                        ftol=cfg.nid.ftol,
                    )
                return refine_fn(
                    camera,
                    kfs_in,
                    T0,
                    bins=cfg.nid.bins,
                    max_outer_iterations=outer_iters,
                    max_inner_iterations=cfg.nid.max_inner_iterations,
                    delta_trans_thresh=cfg.nid.delta_trans_thresh,
                    delta_rot_thresh=np.radians(cfg.nid.delta_rot_thresh_deg),
                    trust_region_trans=cfg.nid.trust_region_trans,
                    trust_region_rot=np.radians(cfg.nid.trust_region_rot_deg),
                    **kw,
                )

            if cfg.nid.recull_every_outer_iter:
                # Host-level outer loop: one on-device outer iteration per
                # pass, re-culling visibility at the corrected pose between
                # passes (the improvement the reference forgoes — it reloads
                # the same culled clouds, visual_camera_calibration.cpp:160-167).
                res = None
                for outer in range(cfg.nid.max_outer_iterations):
                    if outer > 0:
                        kfs = build_nid_keyframes(
                            camera, map_cloud, frames, kf_idx, cfg,
                            T_correction=T_correction,
                        )
                    res = run_refine(kfs, T_correction, 1)
                    dt, dr = se3.delta_magnitudes(
                        T_correction, res.T_camera_lidar
                    )
                    T_correction = res.T_camera_lidar
                    converged = (np.asarray(dt) < cfg.nid.delta_trans_thresh) & (
                        np.asarray(dr) < np.radians(cfg.nid.delta_rot_thresh_deg)
                    )
                    metrics.log(
                        "nid_recull_outer", outer=outer + 1,
                        max_dt=float(np.max(np.asarray(dt))),
                        max_dr=float(np.max(np.asarray(dr))),
                    )
                    if bool(np.all(converged)):
                        break
                res = res._replace(
                    outer_iterations=jnp.asarray(outer + 1, jnp.int32),
                    converged=jnp.asarray(converged),
                )
            else:
                res = run_refine(kfs, T_correction, cfg.nid.max_outer_iterations)
                T_correction = res.T_camera_lidar
            result.nid_value = float(jnp.sum(res.nid))
            if cfg.nid.per_keyframe and cfg.nid.smooth_trajectory:
                # Pose-graph MAP smoothing: fuse the independent per-keyframe
                # corrections with the VO chain, then fold the smoothed
                # trajectory back into per-keyframe corrections so the
                # colorization branch keeps its single interface.
                from ..opt import pose_graph

                c2w = _camera_to_world(frames, kf_idx, _extrinsic_lidar_to_cam(cfg))
                pg = pose_graph.smooth_refined_trajectory(
                    c2w,
                    T_correction,
                    converged=res.converged,
                    abs_weight=cfg.nid.smooth_abs_weight,
                    odo_weight=cfg.nid.smooth_odo_weight,
                )
                T_correction = se3.compose(se3.inverse(c2w), pg.poses)
                metrics.log(
                    "pose_graph_smoothed",
                    residual_norm=float(pg.residual_norm),
                    initial_residual_norm=float(pg.initial_residual_norm),
                )
            timings["nid_refine"] = time.perf_counter() - t0
            import json

            with open(corr_path, "w") as f:
                json.dump(
                    {
                        "quat_wxyz": np.asarray(T_correction.q).tolist(),
                        "translation": np.asarray(T_correction.t).tolist(),
                        "nid": result.nid_value,
                        "per_keyframe": bool(cfg.nid.per_keyframe),
                        "outer_iterations": np.asarray(res.outer_iterations).tolist(),
                        "converged": np.asarray(res.converged).tolist(),
                    },
                    f,
                    indent=2,
                )
            metrics.log(
                "nid_refined",
                nid=result.nid_value,
                outer_iterations=np.asarray(res.outer_iterations).tolist(),
                converged=np.asarray(res.converged).tolist(),
            )
    result.T_correction = T_correction

    # 5b. Optional manual initial guess from picked 2D-3D pairs
    # (applyInitialGuessManual, :166-176; headless — see manual_guess.py).
    # Per-keyframe manual poses take precedence over the shared NID
    # correction, as in the colorization branch at :510-519.
    if cfg.enable_manual_guess and cfg.correspondences_path:
        t0 = time.perf_counter()
        from . import manual_guess

        manual, have = manual_guess.estimate_keyframe_corrections(
            camera, frames, kf_idx, cfg.correspondences_path, cfg.pnp
        )
        have_arr = jnp.asarray(np.asarray(have, bool))
        T_correction = se3.SE3(
            q=jnp.where(have_arr[:, None], manual.q, T_correction.q),
            t=jnp.where(have_arr[:, None], manual.t, T_correction.t),
        )
        manual_guess.save_corrections_json(
            os.path.join(cfg.output_path, "manual_poses.json"),
            frames, kf_idx, manual, have,
        )
        timings["manual_guess"] = time.perf_counter() - t0

    # 6. Colorize + fuse (pcdColorizationAndSmooth, :474-631).
    t0 = time.perf_counter()
    images = np.stack([img_io.load_rgb(frames[i].image_path) for i in kf_idx])
    masks = None
    with_masks = bool(cfg.mask_image_folder)
    if with_masks:
        loaded = []
        for i in kf_idx:
            try:
                loaded.append(img_io.load_mask(frames[i].mask_path))
            except (FileNotFoundError, OSError):
                loaded.append(np.zeros((cfg.camera.height, cfg.camera.width), np.int32))
        masks = jnp.asarray(np.stack(loaded))
    poses = _camera_to_world(frames, kf_idx, _extrinsic_lidar_to_cam(cfg))
    fused = colorize.fuse(
        camera,
        map_cloud.points,
        map_cloud.valid,
        jnp.asarray(images),
        poses,
        T_correction,
        mask_images=masks,
        top_k=cfg.fusion.top_k,
        downsample_factor=cfg.culling.downsample_factor,
        depth_epsilon=cfg.culling.depth_epsilon,
        optimal_distance=cfg.fusion.optimal_distance,
        score_floor=cfg.fusion.score_floor,
        saturation_scale=cfg.fusion.saturation_scale,
        brightness_scale=cfg.fusion.brightness_scale,
        reference_compat_orientation=cfg.fusion.reference_compat_orientation,
        with_masks=with_masks,
        # The reference colorizes through the SAME ViewCulling as the
        # refine path (`PointCloudProcessor.cpp:527`): honor the configured
        # method here too, or fused colors diverge from the oracle at
        # occlusion shadow boundaries (tests/test_golden_occluded.py).
        culling_method=cfg.culling.method,
        hpr_radius=cfg.culling.hidden_points_removal_max_z,
        hpr_tolerance=cfg.culling.hpr_tolerance,
        hpr_impl=cfg.culling.hpr_impl,
        hpr_dense_cutoff=cfg.culling.hpr_dense_cutoff,
    )
    timings["colorize_fuse"] = time.perf_counter() - t0
    metrics.log(
        "cost_estimate_colorize",
        **prof.cost_record(
            prof.colorize_fuse_cost(
                int(map_cloud.points.shape[0]), len(kf_idx),
                cfg.camera.height, cfg.camera.width, cfg.fusion.top_k,
            ),
            device_kind,
        ),
    )

    # 6b. Optional spatial color smoothing (smoothColorsWithLocalRegion,
    # :634-703).
    fused_rgb = fused.rgb
    if cfg.fusion.local_smoothing_radius > 0:
        t0 = time.perf_counter()
        from ..ops import fusion as fusion_ops

        fused_rgb = fusion_ops.smooth_colors_local(
            map_cloud.points, fused.rgb, fused.colored,
            cfg.fusion.local_smoothing_radius,
        )
        timings["local_smoothing"] = time.perf_counter() - t0

    # 7. Save outputs (saveColorizedPointCloud, :866-963).
    keep = fused.colored if cfg.fusion.drop_uncolored else map_cloud.valid
    out_cloud = map_cloud._replace(rgb=fused_rgb, valid=keep)
    out_path = os.path.join(cfg.output_path, "cloudInWorldWithRGB.pcd")
    pcd.write_cloud(out_path, out_cloud, include=("rgb",))
    result.colored_cloud_path = out_path
    result.num_colored_points = int(jnp.sum(keep))

    if with_masks:
        from ..utils import colormap

        # Per-keyframe <ts>_rgb-mask.pcd dumps + world-frame accumulation
        # (`PointCloudProcessor.cpp:539-550`): each keyframe's visible points
        # with its own sampled colors and mask labels, written in the camera
        # frame, then accumulated (concatenated, duplicates across keyframes)
        # into cloudInWorldWithRGBandMask.pcd — the file the reference's
        # two-arg saveColorizedPointCloud writes at :912-928. World
        # coordinates are the original map points (the reference's
        # cam->world round-trip recovers them up to f32 noise).
        acc_pts, acc_rgb, acc_lab = [], [], []
        map_pts_np = np.asarray(map_cloud.points)
        for j, i in enumerate(kf_idx):
            pts_cam, rgb_k, lab_k, vis_k = colorize.keyframe_rgb_mask(
                camera,
                map_cloud.points,
                map_cloud.valid,
                jnp.asarray(images[j]),
                masks[j],
                se3.SE3(poses.q[j], poses.t[j]),
                (
                    se3.SE3(T_correction.q[j], T_correction.t[j])
                    if T_correction.q.ndim == 2
                    else T_correction
                ),
                downsample_factor=cfg.culling.downsample_factor,
                depth_epsilon=cfg.culling.depth_epsilon,
                culling_method=cfg.culling.method,
                hpr_radius=cfg.culling.hidden_points_removal_max_z,
                hpr_tolerance=cfg.culling.hpr_tolerance,
                hpr_impl=cfg.culling.hpr_impl,
                hpr_dense_cutoff=cfg.culling.hpr_dense_cutoff,
                saturation_scale=cfg.fusion.saturation_scale,
                brightness_scale=cfg.fusion.brightness_scale,
                mask_highlight_value=cfg.fusion.mask_highlight_value,
            )
            sel = np.flatnonzero(np.asarray(vis_k))
            pcd.write(
                os.path.join(
                    filtered_dir,
                    f"{ingest.cpp_timestamp(frames[i].timestamp)}_rgb-mask.pcd",
                ),
                np.asarray(pts_cam)[sel],
                rgb=np.asarray(rgb_k)[sel],
                mask_label=np.asarray(lab_k)[sel],
            )
            acc_pts.append(map_pts_np[sel])
            acc_rgb.append(np.asarray(rgb_k)[sel])
            acc_lab.append(np.asarray(lab_k)[sel])
        mask_path = os.path.join(cfg.output_path, "cloudInWorldWithRGBandMask.pcd")
        pcd.write(
            mask_path,
            np.concatenate(acc_pts) if acc_pts else np.zeros((0, 3), np.float32),
            rgb=np.concatenate(acc_rgb) if acc_rgb else None,
            mask_label=np.concatenate(acc_lab) if acc_lab else None,
        )
        result.mask_cloud_path = mask_path
        # Jet-colormapped label cloud (generateSegmentMapWithColor, :818-864).
        mapped = colormap.jet(jnp.asarray(fused.best_label, jnp.float32) / 255.0)
        pcd.write_cloud(
            os.path.join(cfg.output_path, "cloudInWorldWithMaskAndMappedColor.pcd"),
            out_cloud._replace(rgb=mapped * 255.0),
            include=("rgb",),
        )

    metrics.log("outputs_saved", colored_points=result.num_colored_points)
    return result
