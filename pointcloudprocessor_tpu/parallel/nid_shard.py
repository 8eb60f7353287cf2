"""Multi-device NID refinement: keyframes and points sharded over a mesh.

The multi-device replacement for the reference's OpenMP parallel cost
evaluation (`visual_camera_calibration.cpp:110-114`): each device computes
the NID histograms for its (keyframe-shard × point-shard), histograms
reduce over the point axis with `psum`, per-keyframe NIDs reduce over the
keyframe axis with `psum`. The BFGS state (6-dim tangent + 6x6 inverse
Hessian) is replicated — collectives carry only (bins x bins + 2*bins + 1)
floats per keyframe per evaluation, so the solve needs next to no
interconnect bandwidth and is bound by the projection/gather/histogram.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core import se3
from ..models import camera as cam
from ..opt import bfgs
from ..opt import nid as _nid
from ..opt.nid import (
    _PARTIAL_BLOCK,
    NIDKeyframe,
    TapCache,
    _gather_taps,
    _histograms_from_taps,
    _partial_refresh_taps,
    _project_all,
    nid_from_histograms,
    prepare_keyframes,
)
from . import mesh as mesh_lib


def sharded_multi_nid_loss(
    camera: cam.PinholeCamera,
    T_camera_lidar: se3.SE3,
    kfs: NIDKeyframe,
    mesh: Mesh,
    bins: int = 16,
) -> jnp.ndarray:
    """Sum of NIDs over keyframes, computed SPMD over the (kf, pt) mesh.

    Input layout: every NIDKeyframe field has a leading keyframe axis;
    points/intensity/valid additionally shard their point axis over ``pt``;
    bin_image replicates over ``pt`` (each point shard samples the full
    image) and shards over ``kf``.
    """

    kfs = prepare_keyframes(kfs)  # no-op when the solver prepared already

    def local(points, intensity, valid, bin_image, tap_rows):
        # points: (K_local, N_local, 3) etc.; bin_image: (K_local, H, W).
        lk = NIDKeyframe(points, intensity, valid, bin_image, tap_rows)
        proj, knot, inl = _project_all(camera, T_camera_lidar, lk)
        s = proj - knot.astype(proj.dtype)
        taps = _gather_taps(camera, lk, knot)
        inl_f = inl.astype(proj.dtype)

        def per_kf(taps1, s1, inten1, inl1):
            bin_pts = jnp.clip((inten1 * bins).astype(jnp.int32), 0, bins - 1)
            hj, hi, hp, num = _histograms_from_taps(
                taps1, s1, bin_pts, inl1, bins, None
            )
            # Reduce histogram mass over the point shards.
            hj = jax.lax.psum(hj, mesh_lib.PT_AXIS)
            hi = jax.lax.psum(hi, mesh_lib.PT_AXIS)
            hp = jax.lax.psum(hp, mesh_lib.PT_AXIS)
            num = jax.lax.psum(num, mesh_lib.PT_AXIS)
            return nid_from_histograms(hj, hi, hp, num)

        local_sum = jnp.sum(jax.vmap(per_kf)(taps, s, intensity, inl_f))
        return jax.lax.psum(local_sum, mesh_lib.KF_AXIS)

    # check_vma=False: the Pallas histogram kernel's out_shape carries no
    # varying-mesh-axes annotation, which trips shard_map's vma checker;
    # replication of the psum'd scalar output is guaranteed manually.
    return jax.shard_map(
        local,
        mesh=mesh,
        check_vma=False,
        in_specs=(
            P(mesh_lib.KF_AXIS, mesh_lib.PT_AXIS),  # points
            P(mesh_lib.KF_AXIS, mesh_lib.PT_AXIS),  # intensity
            P(mesh_lib.KF_AXIS, mesh_lib.PT_AXIS),  # valid
            P(mesh_lib.KF_AXIS),  # bin_image (replicated over pt)
            P(mesh_lib.KF_AXIS),  # tap_rows (replicated over pt)
        ),
        out_specs=P(),
    )(kfs.points, kfs.intensity, kfs.valid, kfs.bin_image, kfs.tap_rows)


def make_sharded_loss(mesh: Mesh):
    """Adapter with the `multi_nid_loss` signature for opt.refine.refine_pose."""

    def loss_fn(camera, T, kfs, bins):
        return sharded_multi_nid_loss(camera, T, kfs, mesh, bins)

    return loss_fn


def make_sharded_frozen(mesh: Mesh, partial_frac: float = 0.0):
    """Sharded implementations of the frozen-tap objective
    (`opt/nid.TapCache` / `multi_nid_loss_cached` semantics, SPMD over the
    (kf, pt) mesh) for `opt.refine.refine_pose(frozen_taps=True,
    frozen_impl=...)`.

    The cache fields live sharded exactly like the point arrays (taps/knot
    (K, N, 2) over (kf, pt); inlier (K, N)); the staleness decision psums
    the drift counts over BOTH axes so every device takes the same
    `lax.cond` branch, and the re-gather happens shard-locally (tap tables
    are replicated over pt, as in the direct sharded loss).

    ``partial_frac`` enables the partial (drifted-blocks-only) refresh of
    `opt/nid._partial_refresh_taps`, evaluated SHARD-LOCALLY: the
    partial-vs-full capacity `lax.cond` may diverge across devices (both
    branches are collective-free and produce identical cache semantics, so
    divergence is purely a per-device performance choice); the ``partials``
    diagnostic counts a refresh as partial only when EVERY device took the
    partial path (pmin).
    """
    pkp = P(mesh_lib.KF_AXIS, mesh_lib.PT_AXIS)
    pk = P(mesh_lib.KF_AXIS)
    both = (mesh_lib.KF_AXIS, mesh_lib.PT_AXIS)

    def _table_args(kfs):
        """(extra shard_map args, extra in_specs, rebuild) for the optional
        wide table — sharded over kf, replicated over pt. ``rebuild``
        reassembles a local NIDKeyframe from (points, intensity, valid,
        tap_rows, *extras) with the right optional fields."""
        if kfs.tap_wide is None:
            extras, specs = (), ()
        else:
            extras, specs = (kfs.tap_wide,), (pk,)

        def rebuild(points, intensity, valid, tap_rows, *ex):
            return NIDKeyframe(points, intensity, valid, None, tap_rows,
                               ex[0] if ex else None)

        return extras, specs, rebuild

    def make_cache(camera, T, kfs) -> TapCache:
        _, _, rebuild = _table_args(kfs)

        def local(points, intensity, valid, tap_rows, *extras):
            lk = rebuild(points, intensity, valid, tap_rows, *extras)
            proj, knot, inl = _project_all(camera, T, lk)
            if _nid._wide_margin_of(lk):
                taps = _nid._gather_wide(camera, lk, knot)
            else:
                taps = _gather_taps(camera, lk, knot)
            return taps, knot, inl.astype(proj.dtype)

        args, specs, _ = _table_args(kfs)
        # Wide caches are (K, rows, N): the point axis moves to position 2.
        taps_spec = (
            P(mesh_lib.KF_AXIS, None, mesh_lib.PT_AXIS)
            if kfs.tap_wide is not None
            else pkp
        )
        taps, knot, inlf = jax.shard_map(
            local,
            mesh=mesh,
            check_vma=False,
            in_specs=(pkp, pkp, pkp, pk) + specs,
            out_specs=(taps_spec, pkp, pkp),
        )(kfs.points, kfs.intensity, kfs.valid, kfs.tap_rows, *args)
        return TapCache(
            taps,
            knot,
            inlf,
            jnp.asarray(1, jnp.int32),
            jnp.asarray(0, jnp.int32),
            jnp.asarray(0.0, jnp.float32),
        )

    def cached_loss(
        camera, T, kfs, cache, bins, guard_frac=0.25, allow_refresh=True
    ):
        margin = _nid._wide_margin_of(kfs)
        _, _, rebuild = _table_args(kfs)

        def local(points, intensity, valid, tap_rows, c_taps, c_knot, c_inl,
                  *extras):
            lk = rebuild(points, intensity, valid, tap_rows, *extras)
            proj, knot_true, inl_true = _project_all(camera, T, lk)

            shift = jnp.max(
                jnp.abs(
                    knot_true.astype(jnp.float32) - c_knot.astype(jnp.float32)
                ),
                axis=-1,
            )
            care = inl_true | (c_inl > 0)
            thr = jnp.float32(margin + 1.0)
            drifted = (shift >= thr) & care
            n_care = jnp.maximum(
                jax.lax.psum(jnp.sum(care), both), 1
            ).astype(jnp.float32)
            frac1 = jax.lax.psum(jnp.sum(drifted), both) / n_care
            frac2 = jax.lax.psum(
                jnp.sum((shift >= thr + 1.0) & care), both
            ) / n_care
            stale = ((frac1 > guard_frac) | (frac2 > 0.001)) & allow_refresh

            k_loc, n_loc = points.shape[0], points.shape[1]
            block = _PARTIAL_BLOCK
            nb = n_loc // block if n_loc % block == 0 else 0
            cap = int(round(nb * partial_frac)) if partial_frac > 0 else 0
            inl_true_f = inl_true.astype(proj.dtype)

            def full(_):
                taps_f = (
                    _nid._gather_wide(camera, lk, knot_true)
                    if margin
                    else _gather_taps(camera, lk, knot_true)
                )
                return taps_f, knot_true, inl_true_f, jnp.asarray(1, jnp.int32)

            def fresh(_):
                if 0 < cap <= nb:
                    dirty = jnp.any(
                        drifted.reshape(k_loc, nb, block), axis=2
                    )
                    can_partial = jnp.max(jnp.sum(dirty, axis=1)) <= cap
                    in_dirty = jnp.broadcast_to(
                        dirty[:, :, None], (k_loc, nb, block)
                    ).reshape(k_loc, n_loc)

                    def partial(_):
                        # Same recenter rules as opt/nid.multi_nid_loss_cached:
                        # wide windows keep clean points' anchors; margin 0
                        # recenters wholesale (exact, bit-identical solves).
                        if margin:
                            taps_f = _nid._partial_refresh_wide(
                                camera, lk, c_taps, knot_true, dirty, cap
                            )
                            knot_f = jnp.where(
                                in_dirty[..., None], knot_true, c_knot
                            )
                            inl_f = jnp.where(in_dirty, inl_true_f, c_inl)
                        else:
                            taps_f = _partial_refresh_taps(
                                camera, lk, c_taps, knot_true, dirty, cap
                            )
                            knot_f = knot_true
                            inl_f = inl_true_f
                        return taps_f, knot_f, inl_f, jnp.asarray(1, jnp.int32)

                    t_, k_, i_, _one = jax.lax.cond(
                        can_partial, partial, full, None
                    )
                    return t_, k_, i_, can_partial.astype(jnp.int32)

                t_, k_, i_, _one = full(None)
                return t_, k_, i_, jnp.asarray(0, jnp.int32)

            taps, knot, inlf, part = jax.lax.cond(
                stale,
                fresh,
                lambda _: (c_taps, c_knot, c_inl, jnp.asarray(0, jnp.int32)),
                None,
            )
            # Replicated diagnostic: partial only if every device was.
            part = jax.lax.pmin(jax.lax.pmin(part, mesh_lib.KF_AXIS),
                                mesh_lib.PT_AXIS)
            if margin:
                dk = jnp.clip(knot_true - knot, -margin, margin)
                taps_eval = _nid._select_from_wide(taps, dk, margin)
                eff_knot = knot + dk
            else:
                taps_eval = taps
                eff_knot = knot
            s = jnp.clip(
                proj - jax.lax.stop_gradient(eff_knot).astype(proj.dtype),
                -1.5,
                2.5,
            )

            def per_kf(taps1, s1, inten1, inl1):
                bin_pts = jnp.clip(
                    (inten1 * bins).astype(jnp.int32), 0, bins - 1
                )
                hj, hi, hp, num = _histograms_from_taps(
                    taps1, s1, bin_pts, inl1, bins, None
                )
                hj = jax.lax.psum(hj, mesh_lib.PT_AXIS)
                hi = jax.lax.psum(hi, mesh_lib.PT_AXIS)
                hp = jax.lax.psum(hp, mesh_lib.PT_AXIS)
                num = jax.lax.psum(num, mesh_lib.PT_AXIS)
                return nid_from_histograms(hj, hi, hp, num)

            losses = jax.vmap(per_kf)(taps_eval, s, intensity, inlf)
            loss = jax.lax.psum(jnp.sum(losses), mesh_lib.KF_AXIS)
            inc = stale.astype(jnp.int32)
            return loss, taps, knot, inlf, inc, part, frac1 * inc.astype(
                jnp.float32
            )

        args, specs, _ = _table_args(kfs)
        taps_spec = (
            P(mesh_lib.KF_AXIS, None, mesh_lib.PT_AXIS)
            if kfs.tap_wide is not None
            else pkp
        )
        loss, taps, knot, inlf, inc, part, drift = jax.shard_map(
            local,
            mesh=mesh,
            check_vma=False,
            in_specs=(pkp, pkp, pkp, pk, taps_spec, pkp, pkp) + specs,
            out_specs=(P(), taps_spec, pkp, pkp, P(), P(), P()),
        )(
            kfs.points,
            kfs.intensity,
            kfs.valid,
            kfs.tap_rows,
            cache.taps,
            cache.knot,
            cache.inlier,
            *args,
        )
        return loss, TapCache(
            taps,
            knot,
            inlf,
            cache.refreshes + inc,
            cache.partials + part,
            cache.drift_accum + drift,
        )

    return make_cache, cached_loss


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "bins", "max_outer_iterations", "max_inner_iterations"),
)
def refine_per_keyframe_sharded(
    camera: cam.PinholeCamera,
    kfs: NIDKeyframe,
    T_init: se3.SE3,
    mesh: Mesh,
    *,
    bins: int = 16,
    max_outer_iterations: int = 10,
    max_inner_iterations: int = 64,
):
    """Per-keyframe NID refinement with keyframes sharded over the ``kf``
    mesh axis. The solves are independent (no collectives): each device runs
    the vmapped BFGS for its local keyframe shard — the embarrassingly
    parallel limit of the reference's OpenMP-over-keyframes pattern. Returns
    a RefineResult batched over keyframes (kf-sharded outputs)."""
    from ..opt.refine import refine_pose_per_keyframe

    kfs = prepare_keyframes(kfs)
    k = kfs.points.shape[0]
    q0 = jnp.broadcast_to(T_init.q, (k, 4))
    t0 = jnp.broadcast_to(T_init.t, (k, 3))

    def local(points, intensity, valid, bin_image, tap_rows, q, t):
        return refine_pose_per_keyframe(
            camera,
            NIDKeyframe(points, intensity, valid, bin_image, tap_rows),
            se3.SE3(q, t),
            bins=bins,
            max_outer_iterations=max_outer_iterations,
            max_inner_iterations=max_inner_iterations,
        )

    kf_spec = P(mesh_lib.KF_AXIS)
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(kf_spec,) * 7,
        out_specs=kf_spec,
        check_vma=False,
    )(kfs.points, kfs.intensity, kfs.valid, kfs.bin_image, kfs.tap_rows, q0, t0)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh",
        "bins",
        "max_outer_iterations",
        "max_inner_iterations",
        "frozen_taps",
        "frozen_partial_frac",
        "frozen_margin",
        "coarse_outer_iterations",
        "coarse_stride",
        "carry_hessian",
    ),
)
def refine_pose_sharded(
    camera: cam.PinholeCamera,
    kfs: NIDKeyframe,
    T_init: se3.SE3,
    mesh: Mesh,
    *,
    bins: int = 16,
    max_outer_iterations: int = 10,
    max_inner_iterations: int = 64,
    frozen_taps: bool = False,
    frozen_guard_frac: float = 0.25,
    frozen_partial_frac: float = 0.0,
    frozen_margin: int = 0,
    coarse_outer_iterations: int = 0,
    coarse_stride: int = 4,
    carry_hessian: bool = False,
    ftol: float = 0.0,
):
    """Multi-device version of opt.refine.refine_pose (same semantics,
    including the optional frozen-tap gather reuse — the cache shards with
    the points, see :func:`make_sharded_frozen` — and the coarse-to-fine
    schedule: the coarse phase's strided point subsample slices the SHARDED
    point axis, so each device's shard subsamples locally and the histogram
    psum tree is unchanged; it gives the tuned frozen+c2f schedule a
    multi-device twin)."""
    from ..opt.refine import refine_pose

    # Tap tables built once, outside the solver loops (sharded over kf with
    # their bin images).
    kfs = prepare_keyframes(
        kfs, wide_margin=frozen_margin if frozen_taps else 0
    )
    # refine_pose is itself jitted; calling it inside jit simply inlines.
    return refine_pose(
        camera,
        kfs,
        T_init,
        bins=bins,
        max_outer_iterations=max_outer_iterations,
        max_inner_iterations=max_inner_iterations,
        loss_fn=make_sharded_loss(mesh),
        frozen_taps=frozen_taps,
        frozen_guard_frac=frozen_guard_frac,
        frozen_impl=(
            make_sharded_frozen(mesh, partial_frac=frozen_partial_frac)
            if frozen_taps
            else None
        ),
        coarse_outer_iterations=coarse_outer_iterations,
        coarse_stride=coarse_stride,
        carry_hessian=carry_hessian,
        ftol=ftol,
    )
