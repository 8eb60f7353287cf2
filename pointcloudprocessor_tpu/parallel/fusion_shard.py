"""Multi-device colorization fusion over the (kf, pt) mesh.

The single-device path (`pipeline/colorize.fuse`) streams keyframes through
a `lax.scan`, updating per-point top-K color registers. Here the work
splits both ways:

* keyframes shard over ``kf`` — each device row scans only its local
  keyframes (the OpenMP-over-keyframes analogue, but across chips);
* map points shard over ``pt`` — each column owns a slice of the cloud;
  the per-keyframe z-buffer reduces over ``pt`` (`pmin`, one coarse
  buffer per keyframe) so occluders on another shard still occlude.

Cross-keyframe merge: every device ends with a top-K register for ITS
keyframes; registers `all_gather` over ``kf`` (K_dev * top_k floats per
point — tiny next to the image data) and a single
`top_k` re-selects the global best K. The result is identical to the
serial scan (ties aside) because top-K of a union equals top-K of
concatenated per-shard top-Ks.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core import se3
from ..models import camera as cam
from ..pipeline import colorize
from ..ops import fusion
from . import mesh as mesh_lib


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "top_k", "downsample_factor", "depth_epsilon", "optimal_distance",
        "score_floor", "with_masks",
    ),
)
def fuse_sharded(
    camera: cam.PinholeCamera,
    points_world: jnp.ndarray,  # (N, 3), shard over pt
    valid: jnp.ndarray,  # (N,)
    images: jnp.ndarray,  # (K, H, W, 3), shard over kf
    kf_poses: se3.SE3,  # (K,) camera->world, shard over kf
    T_correction: se3.SE3,  # (K,) or scalar correction
    mesh: Mesh,
    mask_images: Optional[jnp.ndarray] = None,  # (K, H, W) int32, shard over kf
    *,
    top_k: int = 5,
    downsample_factor: int = 14,
    depth_epsilon: float = 0.05,
    optimal_distance: float = 2.0,
    score_floor: float = 0.2,
    with_masks: bool = False,
) -> colorize.FusionResult:
    """SPMD fuse with the same contract as `colorize.fuse` (defaults-only
    color adjust). K must divide the ``kf`` axis size, N the mesh size."""
    k_total = images.shape[0]
    corr_q = jnp.broadcast_to(T_correction.q, (k_total, 4))
    corr_t = jnp.broadcast_to(T_correction.t, (k_total, 3))
    n = points_world.shape[0]

    def local(points, valid_, imgs, pq, pt_, cq, ct, masks):
        # points: (N_loc, 3); imgs: (K_loc, H, W, 3).
        n_loc = points.shape[0]
        state0 = (
            fusion.init_topk(n_loc, top_k),
            jnp.full((n_loc,), -jnp.inf, jnp.float32),
            jnp.zeros((n_loc,), jnp.int32),
            jnp.zeros((n_loc,), jnp.int32),
        )

        def step(state, inputs):
            topk, best_s, best_l, count = state
            if with_masks:
                image, q, t, cq_, ct_, m = inputs
            else:
                image, q, t, cq_, ct_ = inputs
                m = None
            T_c2w = se3.compose(se3.SE3(q, t), se3.SE3(cq_, ct_))
            obs = colorize.observe_keyframe(
                camera, image, se3.inverse(T_c2w), points, valid_,
                mask_image=m, camera_position_world=t,
                downsample_factor=downsample_factor, depth_epsilon=depth_epsilon,
                optimal_distance=optimal_distance, score_floor=score_floor,
                # Occluders may live on another point shard: every device
                # tests its points against the z-buffer of the whole map.
                zbuffer_reduce=lambda zb: jax.lax.pmin(zb, mesh_lib.PT_AXIS),
            )
            topk = fusion.update_topk(topk, obs.score, obs.rgb_packed, obs.visible)
            s = jnp.where(obs.visible, obs.score, -jnp.inf)
            better = s > best_s
            best_s = jnp.where(better, s, best_s)
            if obs.label is not None:
                best_l = jnp.where(better, obs.label, best_l)
            count = count + obs.visible.astype(jnp.int32)
            return (topk, best_s, best_l, count), None

        xs = (imgs, pq, pt_, cq, ct) + ((masks,) if with_masks else ())
        (topk, best_s, best_l, count), _ = jax.lax.scan(step, state0, xs)

        # Merge registers across the keyframe shards (kf axis): top-K of a
        # union equals top-K of the concatenated per-shard top-Ks, and the
        # replace-min tournament of update_topk computes it slot-row by
        # slot-row in the lane-friendly (K, N) layout (S*K tiny inserts).
        g_scores = jax.lax.all_gather(topk.scores, mesh_lib.KF_AXIS)  # (S, K, N_loc)
        g_rgb = jax.lax.all_gather(topk.rgb, mesh_lib.KF_AXIS)
        s_flat = g_scores.reshape(-1, n_loc)  # (S*K, N_loc)
        r_flat = g_rgb.reshape(-1, n_loc)

        def insert(i, st):
            row = s_flat[i]
            return fusion.update_topk(st, row, r_flat[i], jnp.isfinite(row))

        merged = jax.lax.fori_loop(
            0, s_flat.shape[0], insert, fusion.init_topk(n_loc, top_k)
        )
        rgb, colored = fusion.blend_topk(merged)

        # Best-score label across shards.
        g_bs = jax.lax.all_gather(best_s, mesh_lib.KF_AXIS)  # (S, N_loc)
        g_bl = jax.lax.all_gather(best_l, mesh_lib.KF_AXIS)
        winner = jnp.argmax(g_bs, axis=0)
        best_l = jnp.take_along_axis(g_bl, winner[None, :], axis=0)[0]
        count = jax.lax.psum(count, mesh_lib.KF_AXIS)
        return rgb, colored & valid_, best_l, count

    mask_arg = mask_images if with_masks else jnp.zeros((k_total, 1, 1), jnp.int32)
    rgb, colored, best_l, count = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P(mesh_lib.PT_AXIS),  # points (replicated over kf)
            P(mesh_lib.PT_AXIS),  # valid
            P(mesh_lib.KF_AXIS),  # images (replicated over pt)
            P(mesh_lib.KF_AXIS),  # pose q
            P(mesh_lib.KF_AXIS),  # pose t
            P(mesh_lib.KF_AXIS),  # correction q
            P(mesh_lib.KF_AXIS),  # correction t
            P(mesh_lib.KF_AXIS),  # masks
        ),
        out_specs=(P(mesh_lib.PT_AXIS), P(mesh_lib.PT_AXIS), P(mesh_lib.PT_AXIS), P(mesh_lib.PT_AXIS)),
        # Outputs ARE kf-replicated (they follow the kf all_gather), but the
        # static varying-axes inference can't prove it for the bool/int ones.
        check_vma=False,
    )(points_world, valid, images, kf_poses.q, kf_poses.t, corr_q, corr_t, mask_arg)

    return colorize.FusionResult(
        rgb=rgb,
        colored=colored,
        best_label=best_l if with_masks else None,
        observation_count=count,
    )
