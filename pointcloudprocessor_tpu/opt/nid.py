"""Normalized Information Distance (NID) photometric objective.

Differentiable rebuild of the reference's Ceres-templated NID cost
(`PointCloudProcessor/include/vlcal/costs/nid_cost.hpp:24-126`) and its
multi-keyframe sum (`src/vlcal/calib/visual_camera_calibration.cpp:86-129`),
formulated as batched array work instead of a per-point scatter loop:

reference (per point, serial)                 here (all points, batched)
-------------------------------------        ------------------------------
project, floor -> knot, s                    vectorised project/floor
4x4 cubic B-spline weights (hpp:71-92)       (N,4)x(N,4) outer -> (N,16)
image lookups at 16 knots                    one (N,16) gather of a
                                             precomputed per-pixel bin map
hist(bin_img, bin_pts) += w  (scatter)       one-hot(bin_pts)^T @ w_img
                                             = (bins,N)@(N,bins) contraction
entropies + NID (hpp:95-105)                 identical formulas

Gradients: `jax.grad` differentiates through the spline weights ``s`` (the
pose-dependent continuous part); knot indices, image bins and the point
histogram are piecewise-constant in the pose and are stop-gradiented —
exactly the same differentiability structure as the reference, where knots
use `get_real` (hpp:61) and `hist_points` is a plain double vector (hpp:49).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core import se3
from ..models import camera as cam

# Uniform cubic B-spline basis matrix (rows: knots -1,0,1,2), transposed
# convention matching nid_cost.hpp:35-39 (divided by 6).
_SPLINE = (
    jnp.asarray(
        [
            [1.0, -3.0, 3.0, -1.0],
            [4.0, 0.0, -6.0, 3.0],
            [1.0, 3.0, 3.0, -3.0],
            [0.0, 0.0, 0.0, 1.0],
        ],
        jnp.float32,
    )
    / 6.0
)


def quantize_image(image_gray01: jnp.ndarray, bins: int = 16) -> jnp.ndarray:
    """Precompute the per-pixel intensity bin map (int32) once per keyframe
    (the reference re-quantizes per point per iteration, hpp:88)."""
    b = jnp.minimum((image_gray01 * bins).astype(jnp.int32), bins - 1)
    return jnp.maximum(b, 0)


class NIDKeyframe(NamedTuple):
    """Device-resident per-keyframe data for the NID objective.

    points/intensity/valid are fixed-capacity (padded); bin_image is the
    quantized grayscale image. Intensities must be pre-normalized to [0, 1]
    (`visual_lidar_data.cpp:87-96` semantics — see cloud.normalize_intensity).

    ``tap_rows`` is the optional precomputed (H*W, 2) int32 window table from
    :func:`build_tap_table`: each pixel's 16 4-bit bin values, nibble-packed
    into two words, so each point fetches its whole 4x4 spline window as
    ONE 8-byte row instead of 16 scalar texels (and the table takes 8 bytes
    per pixel). The table is pose-independent, so optimizers build it once
    per solve (:func:`prepare_keyframes`) and every objective evaluation
    reuses it.
    """

    points: jnp.ndarray  # (N, 3) in the keyframe CAMERA frame (pre-correction)
    intensity: jnp.ndarray  # (N,)
    valid: jnp.ndarray  # (N,)
    bin_image: jnp.ndarray  # (H, W) int32
    tap_rows: Optional[jnp.ndarray] = None  # (H*W, 2) int32 packed nibbles
    # WIDE window table for the frozen cache (build_wide_tap_table):
    # (H*W, 4+2*margin) int32, word r of pixel p = the 4+2*margin nibble-
    # packed bins of window row r. One gather index per point fetches the
    # whole (4+2m)^2 window, so cached taps absorb +-margin px of anchor
    # drift with an exact elementwise sub-window select instead of a
    # re-gather (see _select_from_wide / TapCache).
    tap_wide: Optional[jnp.ndarray] = None


def pack_tap_nibbles(taps: jnp.ndarray) -> jnp.ndarray:
    """(N, 16) tap values in [0, 16) -> (N, 2) int32, nibble t of word t//8
    at bit 4*(t%8). Requires bins <= 16."""
    t = taps.astype(jnp.uint32)
    words = []
    for c in range(2):
        w = jnp.zeros(taps.shape[0], jnp.uint32)
        for j in range(8):
            w = w | (t[:, c * 8 + j] << (4 * j))
        words.append(w)
    return jnp.stack(words, axis=-1).astype(jnp.int32)


def unpack_tap_nibbles(packed: jnp.ndarray) -> jnp.ndarray:
    """(N, 2) int32 -> (N, 16) int32 tap values (inverse of pack)."""
    w = packed.astype(jnp.uint32)
    taps = [
        (w[:, t // 8] >> jnp.uint32(4 * (t % 8))) & jnp.uint32(0xF) for t in range(16)
    ]
    return jnp.stack(taps, axis=-1).astype(jnp.int32)


def _tap_word_planes(bin_image: jnp.ndarray):
    """(H, W) bin image -> two (H, W) int32 nibble-packed word planes
    (words 0/1 of each pixel's 4x4 B-spline window; taps dy=-1..2 outer,
    dx=-1..2 inner, edges clamped). 16 shifted ORs, a pure stencil — no
    (H*W, 16) intermediate (786 MB at 4096x3000)."""
    h, w = bin_image.shape
    p = jnp.pad(bin_image, ((1, 2), (1, 2)), mode="edge").astype(jnp.uint32)
    words = [jnp.zeros((h, w), jnp.uint32), jnp.zeros((h, w), jnp.uint32)]
    for t in range(16):
        dy, dx = t // 4 - 1, t % 4 - 1
        tap = p[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
        words[t // 8] = words[t // 8] | (tap << jnp.uint32(4 * (t % 8)))
    return words[0].astype(jnp.int32), words[1].astype(jnp.int32)


def build_tap_table(bin_image: jnp.ndarray) -> jnp.ndarray:
    """(H, W) bin image -> (H*W, 2) int32 nibble-packed tap-row table
    (see :func:`_tap_word_planes`; matches the direct path bit-exactly)."""
    h, w = bin_image.shape
    w0, w1 = _tap_word_planes(bin_image)
    return jnp.stack([w0.reshape(-1), w1.reshape(-1)], axis=-1)


def build_wide_tap_table(bin_image: jnp.ndarray, margin: int) -> jnp.ndarray:
    """(H, W) bin image -> (H*W, 4+2*margin) int32 WIDE window table.

    Word r of pixel (x, y) nibble-packs the bins at image row
    ``y + r - 1 - margin``, columns ``x - 1 - margin .. x + 2 + margin``
    (edges clamped) — a (4+2*margin)^2 window centered like the 4x4
    B-spline window but with ``margin`` extra pixels on every side. The
    window width must fit one word's 8 nibbles: margin <= 2. A pure
    stencil (shifted ORs), same structure as :func:`_tap_word_planes`."""
    h, w = bin_image.shape
    rows = 4 + 2 * margin
    assert 1 <= margin <= 2, "wide window width must fit 8 nibbles"
    p = jnp.pad(
        bin_image,
        ((1 + margin, 2 + margin), (1 + margin, 2 + margin)),
        mode="edge",
    ).astype(jnp.uint32)
    words = []
    for r in range(rows):
        word = jnp.zeros((h, w), jnp.uint32)
        for j in range(rows):
            tap = p[r: r + h, j: j + w]
            word = word | (tap << jnp.uint32(4 * j))
        words.append(word.reshape(-1).astype(jnp.int32))
    return jnp.stack(words, axis=-1)  # (H*W, rows)


def prepare_keyframes(kfs: NIDKeyframe, wide_margin: int = 0) -> NIDKeyframe:
    """Attach the precomputed tap table (batched over the keyframe axis).
    Idempotent; called by the optimizers at solve entry.

    ``wide_margin`` (1..2): additionally build the wide window table for
    the margin-tolerant frozen cache (:func:`build_wide_tap_table`)."""
    if kfs.tap_rows is None:
        kfs = kfs._replace(tap_rows=jax.vmap(build_tap_table)(kfs.bin_image))
    if wide_margin and kfs.tap_wide is None:
        kfs = kfs._replace(
            tap_wide=jax.vmap(
                lambda b: build_wide_tap_table(b, wide_margin)
            )(kfs.bin_image)
        )
    return kfs


def sort_by_raster(
    camera: "cam.PinholeCamera", T_camera_lidar: se3.SE3, kfs: NIDKeyframe
) -> NIDKeyframe:
    """Permute each keyframe's points into projected raster order.

    The NID histograms are plain sums over points, so any per-keyframe
    permutation of (points, intensity, valid) leaves the objective unchanged
    (up to f32 summation order). Sorted by the anchor pixel's raster index,
    consecutive points fetch monotonically increasing (usually adjacent)
    tap-table rows, and points that drift across a pixel boundary form
    contiguous runs — what the partial tap-cache refresh
    (:func:`_partial_refresh_taps`) needs to re-gather whole blocks. The
    order is computed ONCE at the solve's initial pose; the trust region
    bounds pose motion to 0.2 m / 2 deg (`visual_camera_calibration.cpp:102`),
    which moves anchors by at most a few pixels, so the order stays
    near-sequential for the whole solve.

    Out-of-view or invalid points sort to the end (their taps are masked
    out by ``inlier`` anyway). Idempotent in effect: re-sorting an already
    sorted keyframe is a no-op permutation.
    """

    def one(points, intensity, valid):
        pts_cam = se3.transform_points(T_camera_lidar, points)
        proj = cam.project(camera, pts_cam)
        knot = jnp.floor(proj).astype(jnp.int32)
        inb = (
            valid
            & (knot[:, 0] >= 0)
            & (knot[:, 0] < camera.width)
            & (knot[:, 1] >= 0)
            & (knot[:, 1] < camera.height)
            & (pts_cam[:, 2] > 0)
        )
        anchor = knot[:, 1] * camera.width + knot[:, 0]
        key = jnp.where(inb, anchor, jnp.int32(2**31 - 1))
        # ONE multi-operand lax.sort: the sorting network carries every
        # payload column along with the key, so there are no permutation
        # gathers (argsort + five gathers).
        _, x_, y_, z_, i_, v_ = jax.lax.sort(
            (key, points[:, 0], points[:, 1], points[:, 2],
             intensity, valid.astype(jnp.int8)),
            num_keys=1,
        )
        return jnp.stack([x_, y_, z_], axis=-1), i_, v_.astype(bool)

    p, i, v = jax.vmap(one)(kfs.points, kfs.intensity, kfs.valid)
    return kfs._replace(points=p, intensity=i, valid=v)


def spline_weights(s: jnp.ndarray) -> jnp.ndarray:
    """(..., ) fractional offsets -> (..., 4) cubic B-spline weights.

    Matches nid_cost.hpp:71-77: beta = C @ [1, s, s^2, s^3]. Full f32
    (HIGHEST): a default-precision f32 dot may run in TF32 on a GPU."""
    powers = jnp.stack([jnp.ones_like(s), s, s * s, s * s * s], axis=-1)
    return jnp.matmul(
        powers, _SPLINE.T.astype(s.dtype), precision=jax.lax.Precision.HIGHEST
    )


def _joint_histogram_xla(taps, s, bin_pts, inlier_f, bins: int):
    """Plain-XLA (bins, bins) joint histogram [point_bin, image_bin]: the
    reference of :func:`ops.nid_hist.joint_histogram`, and the path on
    every platform but CUDA."""
    bx = spline_weights(s[:, 0])  # (N, 4)
    by = spline_weights(s[:, 1])  # (N, 4)
    b_img = unpack_tap_nibbles(taps)  # (N, 16)

    # Weights in matching (dy, dx) order.
    w = (by[:, :, None] * bx[:, None, :]).reshape(-1, 16) * inlier_f[:, None]

    # Per-point image-bin mass: accumulate the 16 taps into `bins` buckets.
    # Unrolled over taps: each step is an (N, bins) masked add, fusable by XLA.
    w_img = jnp.zeros((w.shape[0], bins), w.dtype)
    for k in range(16):
        w_img = w_img + w[:, k:k + 1] * jax.nn.one_hot(b_img[:, k], bins, dtype=w.dtype)

    # hist_points is pose-independent (hpp:49): no gradient through P.
    P = jax.lax.stop_gradient(jax.nn.one_hot(bin_pts, bins, dtype=w.dtype))
    # HIGHEST: full f32. TF32 (a GPU's f32 default) keeps ~3 decimal
    # digits, and reduced-precision passes visibly move the NID against
    # the f64 oracle.
    return jnp.einsum("nb,nc->bc", P, w_img, precision=jax.lax.Precision.HIGHEST)


def _joint_histogram_kernel(taps, s, bin_pts, inlier_f, bins: int):
    from ..ops import nid_hist

    return nid_hist.joint_histogram(taps, s, bin_pts, inlier_f, bins)


def _histograms_from_taps(
    taps: jnp.ndarray,  # (N, 2) int32 nibble-packed window rows
    s: jnp.ndarray,  # (N, 2) fractional offsets (pose-differentiable)
    bin_pts: jnp.ndarray,  # (N,) int32
    inlier_f: jnp.ndarray,  # (N,) float 0/1 (stop-gradiented by callers)
    bins: int,
    use_pallas: bool | None,
):
    """Post-gather half of :func:`nid_histograms`: joint/marginal histograms
    from already-fetched tap rows. Shared by the direct path and the
    frozen-tap cached objective (:func:`multi_nid_loss_cached`).

    ``use_pallas``: None runs the fused kernel (`ops/nid_hist`) on CUDA
    devices and the XLA path on every other platform, chosen when the
    program is lowered (``jax.lax.platform_dependent``); True/False force
    one implementation."""
    inlier_f = jax.lax.stop_gradient(inlier_f)
    args = (taps, s, bin_pts, inlier_f)
    xla = functools.partial(_joint_histogram_xla, bins=bins)
    kernel = functools.partial(_joint_histogram_kernel, bins=bins)
    if use_pallas is None:
        hist_joint = jax.lax.platform_dependent(*args, cuda=kernel, default=xla)
    else:
        hist_joint = (kernel if use_pallas else xla)(*args)
    hist_points = jnp.sum(
        jax.nn.one_hot(bin_pts, bins, dtype=s.dtype) * inlier_f[:, None], axis=0
    )
    # Image marginal = per-point-bin sums of the joint; differentiating
    # through the joint keeps its pose gradient exact.
    hist_image = jnp.sum(hist_joint, axis=0)
    num = jnp.sum(inlier_f)
    return hist_joint, hist_image, hist_points, num


def nid_histograms(
    camera: cam.PinholeCamera,
    T_camera_lidar: se3.SE3,
    kf: NIDKeyframe,
    bins: int = 16,
    use_pallas: bool | None = None,
):
    """Joint / marginal histograms for one keyframe under a candidate pose.

    Returns (hist_joint (bins,bins), hist_image (bins,), hist_points (bins,),
    num_inliers). All mass-normalized by the inlier count, as in
    nid_cost.hpp:95-99. ``use_pallas``: see :func:`_histograms_from_taps`.
    """
    pts_cam = se3.transform_points(T_camera_lidar, kf.points)
    proj = cam.project(camera, pts_cam)

    knot = jnp.floor(jax.lax.stop_gradient(proj)).astype(jnp.int32)  # (N, 2)
    s = proj - knot.astype(proj.dtype)

    w_img_px, h_img_px = camera.width, camera.height
    inlier = (
        kf.valid
        & (knot[:, 0] >= 0)
        & (knot[:, 0] < w_img_px)
        & (knot[:, 1] >= 0)
        & (knot[:, 1] < h_img_px)
        & (jax.lax.stop_gradient(pts_cam[:, 2]) > 0)
    )
    inlier_f = inlier.astype(proj.dtype)

    # 16-tap fetch, ONE row gather per point: each tap-table row holds the
    # whole 4x4 window in (dy, dx) order.
    tap_rows = kf.tap_rows if kf.tap_rows is not None else build_tap_table(kf.bin_image)
    anchor = (
        jnp.clip(knot[:, 1], 0, h_img_px - 1) * w_img_px
        + jnp.clip(knot[:, 0], 0, w_img_px - 1)
    )
    bin_pts = jnp.clip((kf.intensity * bins).astype(jnp.int32), 0, bins - 1)
    taps = jnp.take(tap_rows, anchor, axis=0)  # (N, 2) int32 packed
    return _histograms_from_taps(taps, s, bin_pts, inlier_f, bins, use_pallas)


class TapCache(NamedTuple):
    """Frozen gather state for the cached NID objective.

    The tap-table row gather is one of the larger parts of an objective
    evaluation, but its input —
    each point's anchor pixel, ``floor(project(T, p))`` — moves SUB-PIXEL
    between most solver evaluations: line-search probes and converged-phase
    BFGS steps shift the projection by fractions of a pixel, leaving the
    4x4 spline window of almost every point unchanged. The cache therefore
    holds the most recent gathered taps plus the knots/inlier gate they
    were gathered at; :func:`multi_nid_loss_cached` reuses them until
    anchors measurably drift, then re-gathers (one `lax.cond`).

    No reference analogue — the reference re-reads image values per point
    per evaluation inside Ceres (`nid_cost.hpp:78-92`). See
    `opt/refine.refine_pose(frozen_taps=...)` for the accuracy contract.
    """

    taps: jnp.ndarray  # (K, N, 2) int32 nibble-packed window rows
    knot: jnp.ndarray  # (K, N, 2) int32 anchor knots at gather time
    inlier: jnp.ndarray  # (K, N) float 0/1 gate at gather time
    refreshes: jnp.ndarray  # () int32 refresh count (diagnostics)
    partials: jnp.ndarray  # () int32 refreshes served by the PARTIAL path
    drift_accum: jnp.ndarray  # () f32 sum of frac1 at refresh time (so the
    # mean drifted fraction per refresh = drift_accum / refreshes is
    # observable from outside the solve loops — sizes partial_frac)


def _project_all(camera: cam.PinholeCamera, T: se3.SE3, kfs: NIDKeyframe):
    """Batched projection over keyframes: (proj (K,N,2), knot (K,N,2) int32,
    inlier (K,N) bool). Same gates as :func:`nid_histograms`."""

    def one(points, valid):
        pts_cam = se3.transform_points(T, points)
        proj = cam.project(camera, pts_cam)
        knot = jnp.floor(jax.lax.stop_gradient(proj)).astype(jnp.int32)
        inl = (
            valid
            & (knot[:, 0] >= 0)
            & (knot[:, 0] < camera.width)
            & (knot[:, 1] >= 0)
            & (knot[:, 1] < camera.height)
            & (jax.lax.stop_gradient(pts_cam[:, 2]) > 0)
        )
        return proj, knot, inl

    return jax.vmap(one)(kfs.points, kfs.valid)


def _anchors(camera: cam.PinholeCamera, knot: jnp.ndarray) -> jnp.ndarray:
    """(…, 2) int32 knots -> (…,) clamped flat pixel indices."""
    return jnp.clip(knot[..., 1], 0, camera.height - 1) * camera.width + jnp.clip(
        knot[..., 0], 0, camera.width - 1
    )


def _gather_taps(
    camera: cam.PinholeCamera,
    kfs: NIDKeyframe,
    knot: jnp.ndarray,
) -> jnp.ndarray:
    """(K, N, 2) knots -> (K, N, 2) packed tap rows (one row gather per
    point from each keyframe's (H*W, 2) tap table)."""
    return jax.vmap(lambda rows, a: jnp.take(rows, a, axis=0))(
        kfs.tap_rows, _anchors(camera, knot)
    )


_PARTIAL_BLOCK = 128  # points per refresh block


def _partial_refresh_taps(
    camera: cam.PinholeCamera,
    kfs: NIDKeyframe,
    cache_taps: jnp.ndarray,  # (K, N, 2)
    knot_true: jnp.ndarray,  # (K, N, 2)
    dirty: jnp.ndarray,  # (K, nb) bool — blocks containing >=1 drifted point
    cap: int,  # static per-keyframe dirty-block capacity
) -> jnp.ndarray:
    """Re-gather only the dirty blocks of the tap cache.

    Anchor knots are int32, so "drifted < 1 px" means the knot is UNCHANGED:
    every clean-block live point's cached row is bit-identical to what a
    full re-gather would fetch (the tap table is pose-independent). The
    refresh therefore gathers rows only for points in blocks with at least
    one drifted live point and scatters them back, so a refresh at drifted
    fraction f gathers ~f·amplification of a full gather's rows instead of
    all of them. Block granularity (128 points) keeps the scatter-back
    cheap: 128-point rows cost ONE scatter index each instead of 128.

    Callers guarantee max dirty-count <= cap (else they take the full
    gather). The reference has no analogue — it re-reads every point's
    image window per evaluation (`nid_cost.hpp:78-92`); the cache itself
    is the recorded deviation (see :class:`TapCache`).
    """
    k, n, _ = cache_taps.shape
    block = _PARTIAL_BLOCK
    nb = n // block
    anchor = _anchors(camera, knot_true)  # (K, N)

    def one(taps_k, rows_k, anchor_k, dirty_k):
        # Compacted dirty-block ids: ascending sort of (id if dirty else nb)
        # over nb elements — trivially cheap next to the row gathers.
        iota = jnp.arange(nb, dtype=jnp.int32)
        blk = jnp.sort(jnp.where(dirty_k, iota, jnp.int32(nb)))[:cap]  # (cap,)
        blk_c = jnp.minimum(blk, nb - 1)
        anc = jnp.take(anchor_k.reshape(nb, block), blk_c, axis=0)  # (cap, B)
        new_rows = jnp.take(rows_k, anc.reshape(-1), axis=0)  # (cap*B, 2)
        flat = taps_k.reshape(nb, block * 2)
        flat = flat.at[blk].set(
            new_rows.reshape(cap, block * 2), mode="drop"
        )
        return flat.reshape(n, 2)

    return jax.vmap(one)(cache_taps, kfs.tap_rows, anchor, dirty)


def _wide_margin_of(kfs: NIDKeyframe) -> int:
    """Static margin of the attached wide table (0 = no wide table)."""
    if kfs.tap_wide is None:
        return 0
    return (kfs.tap_wide.shape[-1] - 4) // 2


def _gather_wide(
    camera: cam.PinholeCamera, kfs: NIDKeyframe, knot: jnp.ndarray
) -> jnp.ndarray:
    """(K, N, 2) knots -> (K, rows, N) wide window planes (one take index
    per point from the (H*W, rows) wide table; transposed so the long
    point axis stays minor — the select reads whole word planes)."""
    anchor = _anchors(camera, knot)
    g = jax.vmap(lambda tw, a: jnp.take(tw, a, axis=0))(kfs.tap_wide, anchor)
    return jnp.swapaxes(g, 1, 2)


def _select_from_wide(
    wide: jnp.ndarray,  # (K, rows, N) int32 window planes
    dk: jnp.ndarray,  # (K, N, 2) int32 window offset in [-margin, margin]
    margin: int,
) -> jnp.ndarray:
    """Select each point's 4x4 sub-window -> (K, N, 2) packed words.

    The sub-window at offset (du, dv) of a wide window anchored at c is
    BIT-IDENTICAL to the 4x4 tap row at anchor c + (du, dv) (same image
    bins), so cached wide taps absorb +-margin px of anchor drift exactly.
    Pure elementwise arithmetic on whole word planes: a (2*margin+1)-way
    word select per window row plus one variable nibble shift — no
    gather."""
    dv = dk[..., 1] + margin  # (K, N) in [0, 2*margin]
    sh = (jnp.uint32(4) * (dk[..., 0] + margin).astype(jnp.uint32))  # (K, N)
    halves = []
    for i in range(4):
        w = wide[:, i, :]
        for d in range(1, 2 * margin + 1):
            w = jnp.where(dv == d, wide[:, i + d, :], w)
        half = (
            jax.lax.shift_right_logical(w.astype(jnp.uint32), sh)
            & jnp.uint32(0xFFFF)
        )
        halves.append(half)
    w0 = halves[0] | (halves[1] << jnp.uint32(16))
    w1 = halves[2] | (halves[3] << jnp.uint32(16))
    return jnp.stack([w0.astype(jnp.int32), w1.astype(jnp.int32)], axis=-1)


def _partial_refresh_wide(
    camera: cam.PinholeCamera,
    kfs: NIDKeyframe,
    cache_taps: jnp.ndarray,  # (K, rows, N)
    knot_true: jnp.ndarray,
    dirty: jnp.ndarray,  # (K, nb) bool
    cap: int,
) -> jnp.ndarray:
    """Dirty-blocks-only wide re-gather (see :func:`_partial_refresh_taps`;
    here the scatter-back rides the (rows, nb, B) middle axis)."""
    k, rows, n = cache_taps.shape
    block = _PARTIAL_BLOCK
    nb = n // block
    anchor = _anchors(camera, knot_true)  # (K, N)

    def one(taps_k, tw_k, anchor_k, dirty_k):
        iota = jnp.arange(nb, dtype=jnp.int32)
        blk = jnp.sort(jnp.where(dirty_k, iota, jnp.int32(nb)))[:cap]
        blk_c = jnp.minimum(blk, nb - 1)
        anc = jnp.take(anchor_k.reshape(nb, block), blk_c, axis=0)  # (cap, B)
        new = jnp.take(tw_k, anc.reshape(-1), axis=0)  # (cap*B, rows)
        new = jnp.moveaxis(new.reshape(cap, block, rows), 2, 0)  # (rows, cap, B)
        t3 = taps_k.reshape(rows, nb, block)
        t3 = t3.at[:, blk, :].set(new, mode="drop")
        return t3.reshape(rows, n)

    return jax.vmap(one)(cache_taps, kfs.tap_wide, anchor, dirty)


def make_tap_cache(
    camera: cam.PinholeCamera,
    T_camera_lidar: se3.SE3,
    kfs: NIDKeyframe,
) -> TapCache:
    """Fresh gather at ``T_camera_lidar`` (kfs must carry tap_rows —
    see :func:`prepare_keyframes`). With a wide table attached
    (prepare_keyframes(wide_margin=...)), the cache holds (K, rows, N)
    wide window planes instead of (K, N, 2) rows."""
    proj, knot, inl = _project_all(camera, T_camera_lidar, kfs)
    if _wide_margin_of(kfs):
        taps = _gather_wide(camera, kfs, knot)
    else:
        taps = _gather_taps(camera, kfs, knot)
    return TapCache(
        taps,
        knot,
        inl.astype(proj.dtype),
        jnp.asarray(1, jnp.int32),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(0.0, jnp.float32),
    )


def multi_nid_loss_cached(
    camera: cam.PinholeCamera,
    T_camera_lidar: se3.SE3,
    kfs: NIDKeyframe,
    cache: TapCache,
    bins: int = 16,
    guard_frac: float = 0.25,
    allow_refresh=True,
    use_pallas: bool | None = None,
    partial_frac: float = 0.0,
):
    """Sum of per-keyframe NIDs with a guarded frozen-tap gather.

    Returns ``(loss, cache')``. Semantics: identical to
    :func:`multi_nid_loss` whenever the gather is fresh (anchor knots match
    the current pose); between refreshes, points whose anchor drifted by a
    pixel evaluate the PREVIOUS window's cubic extended one knot past its
    span — measured on the synthetic wall scene, a uniform 0.5 px drift
    (47% of points on a new anchor) perturbs the summed NID by ~9e-5 with
    gradient cosine 1.0000, and even a full 1 px drift stays at ~5e-5; at
    >= 2 px the extrapolation produces negative histogram mass and the NID
    degrades sharply. The guard therefore re-gathers as soon as more than
    ``guard_frac`` of live points drift >= 1 px (fidelity cap) or more than
    0.1% drift >= 2 px (hard validity cap), and ``s`` is clipped to
    [-1.5, 2.5] so the rare not-yet-refreshed far point cannot poison the
    histogram with unbounded weights.

    ``allow_refresh`` (traced bool) suppresses the refresh for evaluations
    whose result is discarded anyway (trust-region rejections).

    ``partial_frac`` (static, 0 disables): at a refresh, when at most
    ``partial_frac`` of each keyframe's 128-point blocks contain a drifted
    live point, re-gather ONLY those blocks (:func:`_partial_refresh_taps`)
    instead of all N rows — bit-identical histograms (clean blocks' live
    rows cannot differ: an int32 knot that moved <1 px did not move), at
    ~drift-proportional cost. Refreshes above the capacity take the full
    gather as before.
    """
    assert kfs.tap_rows is not None, "call prepare_keyframes first"
    proj, knot_true, inl_true = _project_all(camera, T_camera_lidar, kfs)

    # Anchor drift vs the cache, measured over points live under either
    # gate. f32 on purpose: behind-camera knots can be ~1e9 and int32
    # differences would overflow; those points are masked by `care` but the
    # arithmetic still runs.
    shift = jnp.max(
        jnp.abs(knot_true.astype(jnp.float32) - cache.knot.astype(jnp.float32)),
        axis=-1,
    )  # (K, N)
    care = inl_true | (cache.inlier > 0)
    n_care = jnp.maximum(jnp.sum(care), 1).astype(jnp.float32)
    # Drift thresholds scale with the cached window's margin: a margin-m
    # wide window serves exact sub-windows up to m px of anchor drift, so
    # "needs refresh" starts at m+1 (extrapolation regime) and "invalid"
    # at m+2 — for m=0 these are exactly the round-3/4 1 px / 2 px guards.
    margin = _wide_margin_of(kfs)
    thr = jnp.float32(margin + 1.0)
    drifted = (shift >= thr) & care
    frac1 = jnp.sum(drifted) / n_care
    frac2 = jnp.sum((shift >= thr + 1.0) & care) / n_care
    stale = ((frac1 > guard_frac) | (frac2 > 0.001)) & allow_refresh

    k_kf, n_pts = kfs.points.shape[0], kfs.points.shape[1]
    block = _PARTIAL_BLOCK
    nb = n_pts // block if n_pts % block == 0 else 0
    cap = int(round(nb * partial_frac)) if partial_frac > 0 else 0
    inl_true_f = inl_true.astype(proj.dtype)

    def fresh(c: TapCache) -> TapCache:
        def full(_):
            taps = (
                _gather_wide(camera, kfs, knot_true)
                if margin
                else _gather_taps(camera, kfs, knot_true)
            )
            return taps, knot_true, inl_true_f

        # partial_frac=1.0 (cap == nb) forces the partial path whenever any
        # block is dirty — costs more than a full gather, but exercises the
        # partial machinery unconditionally (exactness tests, probes).
        if 0 < cap <= nb:
            dirty = jnp.any(drifted.reshape(k_kf, nb, block), axis=2)
            can_partial = jnp.max(jnp.sum(dirty, axis=1)) <= cap
            in_dirty = jnp.broadcast_to(
                dirty[:, :, None], (k_kf, nb, block)
            ).reshape(k_kf, n_pts)

            def partial(_):
                if margin:
                    taps = _partial_refresh_wide(
                        camera, kfs, c.taps, knot_true, dirty, cap
                    )
                    # Only refreshed points recenter — a clean point's wide
                    # window stays anchored where it was gathered (still
                    # covers, by the margin guard) and recentring its knot
                    # without re-gathering would desync the select.
                    knot = jnp.where(in_dirty[..., None], knot_true, c.knot)
                    inl = jnp.where(in_dirty, inl_true_f, c.inlier)
                else:
                    taps = _partial_refresh_taps(
                        camera, kfs, c.taps, knot_true, dirty, cap
                    )
                    # Margin 0: recentring is free and EXACT for every care
                    # point (a clean care point's int32 knot did not move),
                    # and keeps the guard state identical to a full
                    # refresh's — the partial solve is bit-identical to the
                    # full-refresh solve (tested).
                    knot = knot_true
                    inl = inl_true_f
                return taps, knot, inl

            taps, knot, inl = jax.lax.cond(can_partial, partial, full, None)
            partial_inc = can_partial.astype(jnp.int32)
        else:
            taps, knot, inl = full(None)
            partial_inc = jnp.asarray(0, jnp.int32)
        return TapCache(
            taps,
            knot,
            inl,
            c.refreshes + 1,
            c.partials + partial_inc,
            c.drift_accum + frac1,
        )

    cache = jax.lax.cond(stale, fresh, lambda c: c, cache)

    if margin:
        # Exact sub-window select: for every point within +-margin of its
        # cached anchor this reproduces the fresh 4x4 tap row bit-exactly;
        # beyond the margin the clamp pins the window edge and the cubic
        # extrapolates through the s-clip below, exactly like the margin-0
        # drifted case.
        dk = jnp.clip(knot_true - cache.knot, -margin, margin)
        taps_eval = _select_from_wide(cache.taps, dk, margin)
        eff_knot = cache.knot + dk
    else:
        taps_eval = cache.taps
        eff_knot = cache.knot

    # Clip keeps the few not-yet-refreshed far points' weights bounded (the
    # clip boundary is outside everything the guard lets through, so live
    # gradients are unaffected).
    s = jnp.clip(
        proj - jax.lax.stop_gradient(eff_knot).astype(proj.dtype), -1.5, 2.5
    )  # (K, N, 2)

    def one(taps, s1, inten, inl_f):
        bin_pts = jnp.clip((inten * bins).astype(jnp.int32), 0, bins - 1)
        return nid_from_histograms(
            *_histograms_from_taps(taps, s1, bin_pts, inl_f, bins, use_pallas)
        )

    losses = jax.vmap(one)(taps_eval, s, kfs.intensity, cache.inlier)
    return jnp.sum(losses), cache


def nid_from_histograms(hist_joint, hist_image, hist_points, num):
    """Entropies -> NID, formulas of nid_cost.hpp:95-105 (log(p + 1e-6)).

    Probabilities are clamped to >= 0 before the entropy terms: the
    frozen-tap path evaluates cubic weights extrapolated up to the
    [-1.5, 2.5] clip for the rare not-yet-refreshed drifted point, and
    extrapolated B-spline weights go negative (~-0.56 worst case per tap) —
    a low-mass bin can end up with net-negative probability, and
    log(p + 1e-6) of a negative p is NaN. A NaN on an inner solve's FIRST
    evaluation would silently stall that whole inner solve (the line search
    rejects non-finite probes, so the incumbent value stays NaN and no step
    is ever accepted). The clamp uses where(p < 0) rather than maximum so it
    is an identity in value AND gradient for every exact-path histogram
    (true B-spline partitions of unity are non-negative; lax.max's VJP would
    halve the gradient of exactly-empty bins via tie-splitting)."""
    denom = jnp.maximum(num, 1.0)
    clamp = lambda p: jnp.where(p < 0, jnp.zeros_like(p), p)
    pj = clamp(hist_joint / denom)
    pi = clamp(hist_image / denom)
    pp = clamp(hist_points / denom)
    H_image = -jnp.sum(pi * jnp.log(pi + 1e-6))
    H_points = -jnp.sum(pp * jnp.log(pp + 1e-6))
    H_joint = -jnp.sum(pj * jnp.log(pj + 1e-6))
    MI = H_image + H_points - H_joint
    return (H_joint - MI) / jnp.maximum(H_joint, 1e-12)


def nid_loss(
    camera: cam.PinholeCamera,
    T_camera_lidar: se3.SE3,
    kf: NIDKeyframe,
    bins: int = 16,
    use_pallas: bool | None = None,
) -> jnp.ndarray:
    """Scalar NID in [0, 1] for one keyframe (lower = better alignment)."""
    return nid_from_histograms(
        *nid_histograms(camera, T_camera_lidar, kf, bins, use_pallas=use_pallas)
    )


def multi_nid_loss(
    camera: cam.PinholeCamera,
    T_camera_lidar: se3.SE3,
    kfs: NIDKeyframe,  # batched: leading keyframe axis on every field
    bins: int = 16,
    use_pallas: bool | None = None,
) -> jnp.ndarray:
    """Sum of per-keyframe NIDs — `MultiNIDCost::operator()`
    (`visual_camera_calibration.cpp:94-123`). The reference parallelizes
    keyframes with OpenMP (:110); here they vmap (and, in
    `parallel/nid_shard.py`, shard across devices with a `psum`)."""
    if kfs.tap_rows is None:
        losses = jax.vmap(lambda p, i, v, b: nid_loss(
            camera, T_camera_lidar, NIDKeyframe(p, i, v, b), bins, use_pallas
        ))(kfs.points, kfs.intensity, kfs.valid, kfs.bin_image)
        return jnp.sum(losses)

    proj, knot, inl = _project_all(camera, T_camera_lidar, kfs)
    s = proj - knot.astype(proj.dtype)  # knot already stop-gradiented
    taps = _gather_taps(camera, kfs, knot)
    inl_f = inl.astype(proj.dtype)

    def one(taps1, s1, inten, inl1):
        bin_pts = jnp.clip((inten * bins).astype(jnp.int32), 0, bins - 1)
        return nid_from_histograms(
            *_histograms_from_taps(taps1, s1, bin_pts, inl1, bins, use_pallas)
        )

    losses = jax.vmap(one)(taps, s, kfs.intensity, inl_f)
    return jnp.sum(losses)
