"""NID pose refinement: trust-region-guarded inner BFGS + outer re-solve loop.

Rebuilds `VisualCameraCalibration::calibrate` / `estimate_pose_bfgs`
(`PointCloudProcessor/src/vlcal/calib/visual_camera_calibration.cpp:49-129`)
as one jitted computation:

* the pose is parameterized as ``T = T_init ∘ exp(xi)`` (right perturbation,
  the Sophus ceres manifold convention used at :205),
* the trust-region guard (reject iterates >0.2 m / >2° from the inner-solve
  start, :102) becomes a +inf objective outside the region, which the
  BFGS line search backtracks out of — Ceres' failed-evaluation semantics,
* the outer loop restarts the inner solve from the new pose until
  ``delta_t < delta_trans_thresh`` and ``delta_r < delta_rot_thresh`` or
  ``max_outer_iterations`` (:53-81), as a `lax.while_loop`.

The reference re-reads the same culled clouds from disk every outer
iteration (:160-167) — i.e. it does NOT re-cull; points here likewise stay
fixed across outer iterations (re-culling is available upstream via
``NIDConfig.recull_every_outer_iter``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import se3
from ..models import camera as cam
from ..utils.config import NIDConfig
from . import bfgs
from . import nid as _nid
from .nid import NIDKeyframe, multi_nid_loss


class RefineResult(NamedTuple):
    T_camera_lidar: se3.SE3
    nid: jnp.ndarray  # final summed NID
    outer_iterations: jnp.ndarray
    converged: jnp.ndarray
    evaluations: jnp.ndarray  # total objective (value+grad) evaluations
    gathers: jnp.ndarray = 0  # tap-table gathers (frozen_taps mode only;
    # without frozen taps every evaluation gathers, reported as 0 here)
    partial_gathers: jnp.ndarray = 0  # gathers served by the partial
    # (drifted-blocks-only) refresh path; subset of ``gathers``
    gather_drift: jnp.ndarray = 0.0  # sum over refreshes of the drifted
    # fraction at refresh time (mean = gather_drift / gathers)


def _guarded_objective(camera, kfs, bins, trust_trans, trust_rot, loss_fn):
    """xi -> sum NID at T_init∘exp(xi), +inf outside the trust region."""

    def objective(xi, T_init: se3.SE3):
        T = se3.compose(T_init, se3.exp(xi))
        loss = loss_fn(camera, T, kfs, bins)
        # Trust region in the tangent of the inner-solve start pose.
        trans = jnp.linalg.norm(se3.exp(xi).t)
        rot = jnp.linalg.norm(xi[3:])
        outside = (trans > trust_trans) | (rot > trust_rot)
        big = jnp.asarray(jnp.inf, loss.dtype)
        return jnp.where(outside, big, loss)

    return objective


def _subsample_keyframes(kfs: NIDKeyframe, stride: int) -> NIDKeyframe:
    """Every ``stride``-th point of each keyframe (static shapes; tap table
    and bin image shared). Culled points arrive in map or raster order, so a
    strided slice is a spatially unbiased subsample."""
    return kfs._replace(
        points=kfs.points[:, ::stride],
        intensity=kfs.intensity[:, ::stride],
        valid=kfs.valid[:, ::stride],
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "bins",
        "max_outer_iterations",
        "max_inner_iterations",
        "loss_fn",
        "coarse_outer_iterations",
        "coarse_stride",
        "frozen_taps",
        "frozen_impl",
        "frozen_partial_frac",
        "frozen_margin",
        "sort_points",
        "carry_hessian",
    ),
)
def refine_pose(
    camera: cam.PinholeCamera,
    kfs: NIDKeyframe,  # batched over keyframes
    T_init: se3.SE3,
    *,
    bins: int = 16,
    max_outer_iterations: int = 10,
    max_inner_iterations: int = 64,
    delta_trans_thresh: float = 0.01,
    delta_rot_thresh: float = 0.017453,  # 1 degree, hpp:24
    trust_region_trans: float = 0.2,
    trust_region_rot: float = 0.034907,  # 2 degrees, :102
    loss_fn=multi_nid_loss,
    coarse_outer_iterations: int = 0,
    coarse_stride: int = 4,
    frozen_taps: bool = False,
    frozen_guard_frac: float = 0.25,  # traced (sweepable without recompile)
    frozen_impl=None,
    frozen_partial_frac: float = 0.0,
    frozen_margin: int = 0,
    sort_points: bool | None = None,
    carry_hessian: bool = False,
    ftol: float = 0.0,  # traced (sweepable without recompile)
) -> RefineResult:
    """Optimize the shared camera<-lidar correction transform over keyframes.

    ``coarse_outer_iterations`` > 0 enables a coarse-to-fine schedule with
    no reference analogue (the reference always evaluates all points,
    `visual_camera_calibration.cpp:160-178`): the first outer solves run on
    every ``coarse_stride``-th point — each objective evaluation scales with
    the point count, so a 4x subsample cuts the eval cost up to 4x — and
    the FINAL outer solves always run at full
    resolution with identical convergence criteria, so the returned pose
    minimizes the exact full-resolution objective. The NID plateau
    (CLAUDE.md) means coarse iterations only need to reach the basin.

    ``frozen_taps`` enables the guarded frozen-gather objective
    (`opt/nid.multi_nid_loss_cached`, no reference analogue): the tap-table
    row gather is reused across
    evaluations whose anchor pixels haven't drifted (line-search probes and
    near-convergence steps move projections sub-pixel), and re-gathered as
    soon as more than ``frozen_guard_frac`` of live points drift >= 1 px or
    any meaningful mass drifts >= 2 px (see `multi_nid_loss_cached` for the
    measured error bounds behind the thresholds).
    Accuracy contract: the solve descends a surrogate that coincides with
    the exact objective at every refresh and drifts by a guard-bounded
    extrapolation in between; the returned ``nid`` is always a FRESH
    full-resolution evaluation at the final pose, and tests assert the
    frozen solve reaches an objective value at parity with the exact solve
    (tests/test_nid.py).

    ``frozen_partial_frac`` (static, frozen_taps only): serve refreshes
    whose drifted-block fraction fits the capacity by re-gathering ONLY the
    drifted 128-point blocks (`opt/nid._partial_refresh_taps`) — the cache
    after a partial refresh is bit-identical to a full refresh for every
    live point (an int32 anchor that moved <1 px did not move), at
    drift-proportional cost instead of the full 2.1M-row gather.

    ``frozen_margin`` (static, frozen_taps only; 0..2): cache WIDE
    (4+2m)^2 tap windows instead of 4x4 rows (`opt/nid.build_wide_tap_table`)
    — the same one gather index per point, but evaluations select the
    exact 4x4 sub-window with elementwise arithmetic for any anchor drift
    within +-m px, so the refresh guard
    thresholds shift from 1/2 px to m+1/m+2 px and most refreshes simply
    stop firing. Composes with ``frozen_partial_frac``: the over-margin
    set is a smooth screen-space region, block-coherent under the raster
    sort.

    ``carry_hessian``: warm-start each inner BFGS solve with the previous
    solve's inverse-Hessian approximation (outer iterations re-solve the
    same objective from a nearby pose; Ceres restarts from identity every
    `ceres::Solve`, `visual_camera_calibration.cpp:204-233`).

    ``ftol`` (traced): per-inner-solve relative function-decrease exit
    (Ceres function_tolerance semantics); 0 disables.
    """
    if sort_points is None:
        # The raster sort makes drift fields BLOCK-COHERENT for the partial
        # refresh (the over-margin set is a smooth region in screen space,
        # so in raster order it occupies contiguous bands of 128-point
        # blocks — in map order every block is dirty and the partial path
        # cannot win). Without it the sort is pure overhead (a sort per
        # solve) plus an f32 summation-order change.
        sort_points = frozen_taps and frozen_partial_frac > 0
    if loss_fn is multi_nid_loss:
        # Pose-independent tap tables: built once here, reused by every
        # objective evaluation inside the solver loops (the wide window
        # table only when the frozen cache will select from it).
        kfs = _nid.prepare_keyframes(
            kfs, wide_margin=frozen_margin if frozen_taps else 0
        )
    else:
        # A custom loss (e.g. the sharded one) must bring its own frozen
        # implementation (parallel/nid_shard.make_sharded_frozen).
        assert not frozen_taps or frozen_impl is not None, (
            "frozen_taps with a custom loss_fn requires frozen_impl"
        )
    if sort_points:
        # Raster-sort the points ONCE at the solve's start pose: the NID
        # histograms are permutation-invariant (up to f32 summation order).
        # The trust region bounds pose motion, so the order stays
        # near-sorted for the whole solve.
        kfs = _nid.sort_by_raster(camera, T_init, kfs)
    make_cache_fn, cached_loss_fn = frozen_impl or (
        _nid.make_tap_cache,
        functools.partial(
            _nid.multi_nid_loss_cached, partial_frac=frozen_partial_frac
        ),
    )
    eye6 = jnp.eye(6, dtype=T_init.t.dtype)

    class Outer(NamedTuple):
        T: se3.SE3
        nid: jnp.ndarray
        it: jnp.ndarray
        done: jnp.ndarray
        evals: jnp.ndarray
        gathers: jnp.ndarray
        pgathers: jnp.ndarray
        drift: jnp.ndarray
        H: jnp.ndarray  # carried inverse-Hessian metric (carry_hessian)

    def solve_phase(init: Outer, phase_kfs, max_iters, use_frozen) -> Outer:
        objective = _guarded_objective(
            camera, phase_kfs, bins, trust_region_trans, trust_region_rot,
            loss_fn,
        )

        def cond(st: Outer):
            return (~st.done) & (st.it < max_iters)

        if use_frozen:

            def guarded_cached(xi, T_init_, cache):
                T = se3.compose(T_init_, se3.exp(xi))
                trans = jnp.linalg.norm(se3.exp(xi).t)
                rot = jnp.linalg.norm(xi[3:])
                outside = (trans > trust_region_trans) | (rot > trust_region_rot)
                loss, cache = cached_loss_fn(
                    camera,
                    T,
                    phase_kfs,
                    cache,
                    bins,
                    guard_frac=frozen_guard_frac,
                    # A rejected iterate's gather would be wasted work.
                    allow_refresh=~outside,
                )
                big = jnp.asarray(jnp.inf, loss.dtype)
                return jnp.where(outside, big, loss), cache

            # The cache is built once per phase and carried ACROSS outer
            # iterations (knots are stored absolute, so a cache gathered
            # under one outer parameterization stays valid in the next —
            # the guard alone decides when the pose has moved enough to
            # re-gather).
            cache0 = make_cache_fn(camera, init.T, phase_kfs)

            def body(carry):
                st, cache = carry

                def vg_c(xi, c):
                    (v, c2), g = jax.value_and_grad(
                        lambda x, cc: guarded_cached(x, st.T, cc), has_aux=True
                    )(xi, c)
                    return v, g, c2

                res, cache = bfgs.minimize_cached(
                    vg_c,
                    jnp.zeros(6, st.T.t.dtype),
                    cache,
                    max_iterations=max_inner_iterations,
                    # Carry the inverse-Hessian metric across outer
                    # iterations: the outer loop re-solves the SAME
                    # objective from a nearby pose, so the curvature
                    # H learned last time is a far better metric than
                    # restarting at identity (Ceres restarts every
                    # ceres::Solve, :204-233 — not a ceiling to respect).
                    # A virgin H (exactly identity, no solve yet) still
                    # gets the classic first-update scaling.
                    H0=st.H if carry_hessian else None,
                    scale_initial=jnp.all(st.H == eye6)
                    if carry_hessian
                    else True,
                    ftol=ftol,
                )
                T_new = se3.compose(st.T, se3.exp(res.x))
                dt, dr = se3.delta_magnitudes(st.T, T_new)
                converged = (dt < delta_trans_thresh) & (dr < delta_rot_thresh)
                return (
                    Outer(
                        T=T_new,
                        nid=res.value,
                        it=st.it + 1,
                        done=converged,
                        evals=st.evals + res.evaluations,
                        # refreshes counts within this phase's cache; add the
                        # phase-entry total so coarse-phase gathers persist.
                        gathers=init.gathers + cache.refreshes,
                        pgathers=init.pgathers + cache.partials,
                        drift=init.drift + cache.drift_accum,
                        H=res.H if carry_hessian else st.H,
                    ),
                    cache,
                )

            final, _ = jax.lax.while_loop(
                lambda c: cond(c[0]), body, (init, cache0)
            )
            return final

        def body_plain(st: Outer):
            res = bfgs.minimize(
                lambda xi: objective(xi, st.T),
                jnp.zeros(6, st.T.t.dtype),
                max_iterations=max_inner_iterations,
                H0=st.H if carry_hessian else None,
                scale_initial=jnp.all(st.H == eye6) if carry_hessian else True,
                ftol=ftol,
            )
            T_new = se3.compose(st.T, se3.exp(res.x))
            dt, dr = se3.delta_magnitudes(st.T, T_new)
            converged = (dt < delta_trans_thresh) & (dr < delta_rot_thresh)
            return Outer(
                T=T_new,
                nid=res.value,
                it=st.it + 1,
                done=converged,
                evals=st.evals + res.evaluations,
                gathers=st.gathers,
                pgathers=st.pgathers,
                drift=st.drift,
                H=res.H if carry_hessian else st.H,
            )

        return jax.lax.while_loop(cond, body_plain, init)

    init = Outer(
        T=T_init,
        nid=jnp.asarray(jnp.inf, T_init.t.dtype),
        it=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False),
        evals=jnp.asarray(0, jnp.int32),
        gathers=jnp.asarray(0, jnp.int32),
        pgathers=jnp.asarray(0, jnp.int32),
        drift=jnp.asarray(0.0, jnp.float32),
        H=eye6,
    )
    if coarse_outer_iterations > 0 and coarse_stride > 1:
        # The coarse phase always runs the plain objective: its evaluations
        # are already ~4x cheaper (subsampled gather), it is where the solve
        # takes its LARGE steps (so frozen taps would refresh constantly at
        # best, or wander on the noisier subsampled surrogate at worst —
        # measured round 3: frozen+c2f was SLOWER than either alone), and
        # exactness during the basin search keeps the warm start honest.
        coarse = solve_phase(
            init,
            _subsample_keyframes(kfs, coarse_stride),
            coarse_outer_iterations,
            use_frozen=False,
        )
        # Fine phase starts from the coarse pose with a reset iteration /
        # convergence state (the coarse phase only warms the initial guess).
        # The carried H transfers too: the NID objective is count-normalized,
        # so the subsampled coarse surface's curvature is the same metric at
        # ~the same scale as the full-resolution surface's.
        init = Outer(
            T=coarse.T,
            nid=init.nid,
            it=jnp.asarray(0, jnp.int32),
            done=jnp.asarray(False),
            evals=coarse.evals,
            gathers=coarse.gathers,
            pgathers=coarse.pgathers,
            drift=coarse.drift,
            H=coarse.H,
        )
    final = solve_phase(init, kfs, max_outer_iterations, use_frozen=frozen_taps)
    nid_final = final.nid
    if frozen_taps:
        # Report the EXACT full-resolution objective at the final pose, not
        # the last surrogate value (one extra forward evaluation).
        nid_final = loss_fn(camera, final.T, kfs, bins)
    return RefineResult(
        T_camera_lidar=final.T,
        nid=nid_final,
        outer_iterations=final.it,
        converged=final.done,
        evaluations=final.evals,
        gathers=final.gathers,
        partial_gathers=final.pgathers,
        gather_drift=final.drift,
    )


@functools.partial(
    jax.jit,
    static_argnames=("bins", "max_outer_iterations", "max_inner_iterations"),
)
def refine_pose_per_keyframe(
    camera: cam.PinholeCamera,
    kfs: NIDKeyframe,  # batched over keyframes
    T_init: se3.SE3,  # scalar or batched (K,) initial correction(s)
    *,
    bins: int = 16,
    max_outer_iterations: int = 10,
    max_inner_iterations: int = 64,
    delta_trans_thresh: float = 0.01,
    delta_rot_thresh: float = 0.017453,
    trust_region_trans: float = 0.2,
    trust_region_rot: float = 0.034907,
) -> RefineResult:
    """Independent NID correction per keyframe (batched solves, lockstep).

    The batched generalization of the reference's per-keyframe manual
    optimized poses (`FrameData::addManualOptimizedPose`, honored by the
    colorization branch `PointCloudProcessor.cpp:510-519`): where the
    reference needs a human in the GUI loop per keyframe, here every
    keyframe runs its own full BFGS refinement simultaneously under one
    `vmap` — and, in `parallel/nid_shard.refine_per_keyframe_sharded`,
    keyframes spread across devices with no cross-device reduction at all
    (the solves are independent). The returned RefineResult fields are all
    batched with a leading keyframe axis.
    """
    kfs = _nid.prepare_keyframes(kfs)
    k = kfs.points.shape[0]
    q0 = jnp.broadcast_to(T_init.q, (k, 4))
    t0 = jnp.broadcast_to(T_init.t, (k, 3))

    def solve_one(p, i, v, b, tap, q, t):
        kf1 = NIDKeyframe(p[None], i[None], v[None], b[None], tap[None])
        return refine_pose(
            camera,
            kf1,
            se3.SE3(q, t),
            bins=bins,
            max_outer_iterations=max_outer_iterations,
            max_inner_iterations=max_inner_iterations,
            delta_trans_thresh=delta_trans_thresh,
            delta_rot_thresh=delta_rot_thresh,
            trust_region_trans=trust_region_trans,
            trust_region_rot=trust_region_rot,
        )

    return jax.vmap(solve_one)(
        kfs.points, kfs.intensity, kfs.valid, kfs.bin_image, kfs.tap_rows, q0, t0
    )
