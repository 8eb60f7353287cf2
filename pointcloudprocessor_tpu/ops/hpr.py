"""Hidden-point removal: Katz spherical flip + support-function hull test.

Static-shape rebuild of the reference's ACTIVE occlusion-culling path
(`PointCloudProcessor/src/vlcal/calib/view_culling.cpp:266-334`:
spherical flip `pt + 2*(R-|pt|)*pt/|pt|` at :292 with R = 90000 from
`view_culling.hpp:14`, then a qhull convex hull whose vertices are the
visible points, called from `cull` at :46).

qhull's data-dependent combinatorics have no static-shape form, but the hull
*membership test* can: a flipped point f_i is a hull vertex iff it is the
unique maximizer of the support function ⟨f, d⟩ for some direction d.
Because the flip is radial and R >> |p|, the flipped cloud hugs a sphere of
radius ≈ 2R, so the supporting direction of a vertex is (to O(|p|/R)) its
own bearing u_i = p_i/|p_i|. The test used here is therefore:

    visible(i)  ⇔  max_j ⟨f_j, u_i⟩ − ⟨f_i, u_i⟩ ≤ tolerance

i.e. "is point i (approximately) the farthest flipped point along its own
viewing ray". Geometrically this hides p_i exactly when a closer point
q (r_q < r_p) lies within angle θ < sqrt(2·(r_p − r_q − tol)/(2R)) of its
ray — the same depth-vs-angular-resolution trade-off the qhull hull
encodes, with R playing the identical role. The whole test is one blocked
(N,3)×(3,N) max-reduction — dense array work with static shapes, and like
`ops/zbuffer.py` it returns a mask over the ORIGINAL indices, which removes
the reference's kd-tree re-association step (`PointCloudProcessor.cpp:557-571`).

Accuracy vs the exact hull is validated in tests/test_hpr.py against
scipy.spatial.ConvexHull on synthetic occluder scenes.

Numerics: supports are ~2R in magnitude, so f32 ulp at the default
R = 90000 is ~0.015 m; the default tolerance (0.05 m, the z-buffer path's
depth epsilon) sits safely above it. Matmuls run at Precision.HIGHEST —
the bf16-decomposed default would bury the depth signal entirely.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

DEFAULT_RADIUS = 90000.0  # view_culling.hpp:14


def spherical_flip(points: jnp.ndarray, radius: float = DEFAULT_RADIUS) -> jnp.ndarray:
    """Katz spherical flip: p -> p + 2*(R - |p|) * p/|p|  (view_culling.cpp:292).

    Points at the origin map to the origin (they stay strictly inside the
    hull, i.e. hidden — the camera centre itself is never "visible").
    """
    r = jnp.linalg.norm(points, axis=-1, keepdims=True)
    safe = jnp.maximum(r, 1e-12)
    return points * ((2.0 * radius - r) / safe)


def _support_block(flipped: jnp.ndarray, dirs_block: jnp.ndarray, chunk: int) -> jnp.ndarray:
    """max_j ⟨flipped_j, d⟩ for each direction d in the block.

    flipped: (Nc, chunk, 3) pre-chunked (zero-padded); dirs_block: (B, 3).
    Scans point chunks with a running max so peak memory is (chunk, B).
    """

    def step(best, f_chunk):
        s = jax.lax.dot_general(
            f_chunk,
            dirs_block,
            (((1,), (1,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )  # (chunk, B)
        return jnp.maximum(best, jnp.max(s, axis=0)), None

    init = jnp.full((dirs_block.shape[0],), -jnp.inf, flipped.dtype)
    best, _ = jax.lax.scan(step, init, flipped)
    return best


@functools.partial(jax.jit, static_argnames=("radius", "tolerance", "block", "chunk"))
def hpr_mask(
    points_camera: jnp.ndarray,
    valid: jnp.ndarray,
    radius: float = DEFAULT_RADIUS,
    tolerance: float = 0.05,
    block: int = 2048,
    chunk: int = 16384,
) -> jnp.ndarray:
    """Visibility mask for camera-frame points via spherical-flip HPR.

    Args:
        points_camera: (N, 3) points in the camera frame (origin = viewpoint,
            matching the world→camera transform the reference applies before
            `cull`, `PointCloudProcessor.cpp:186-207`).
        valid: (N,) bool input validity.
        radius: spherical-flip radius R (view_culling.hpp:14).
        tolerance: metres of support-function slack; plays the role the
            z-buffer path's ``depth_epsilon`` plays (view_culling.cpp:157).
        block/chunk: direction-block and point-chunk sizes bounding peak
            memory at chunk × block × 4 bytes.

    Returns:
        (N,) bool visibility mask (subset of ``valid``).
    """
    n = points_camera.shape[0]
    r = jnp.linalg.norm(points_camera, axis=-1)
    ok = valid & (r > 1e-9)
    u = points_camera / jnp.maximum(r, 1e-12)[:, None]

    # Hidden/invalid contributors flip to the origin: support 0 never wins.
    flipped = jnp.where(ok[:, None], u * (2.0 * radius - r)[:, None], 0.0)

    pad_pts = (-n) % chunk
    f_chunks = jnp.pad(flipped, ((0, pad_pts), (0, 0))).reshape(-1, chunk, 3)

    pad_dirs = (-n) % block
    dirs = jnp.pad(jnp.where(ok[:, None], u, 0.0), ((0, pad_dirs), (0, 0)))
    d_blocks = dirs.reshape(-1, block, 3)

    support = jax.lax.map(
        lambda d: _support_block(f_chunks, d, chunk), d_blocks
    ).reshape(-1)[:n]

    self_support = 2.0 * radius - r
    return ok & (support - self_support <= tolerance)


def _erode_parabolic_axis(m: jnp.ndarray, cell: jnp.ndarray, radius: float, window: int, axis: int):
    """1D lower-envelope pass: m'[c] = min_{|k|<=window} m[c+k] + R*(k*cell)^2.

    One axis of the separable parabolic min-convolution (du^2 + dv^2 splits
    across axes); ``cell`` is the runtime angular cell size of this axis.
    """
    big = jnp.asarray(jnp.finfo(m.dtype).max, m.dtype)
    pad = [(0, 0), (0, 0)]
    pad[axis] = (window, window)
    mp = jnp.pad(m, pad, constant_values=big)

    def step(best, k):
        sl = jax.lax.dynamic_slice_in_dim(mp, k, m.shape[axis], axis)
        pen = radius * ((k - window).astype(m.dtype) * cell) ** 2
        # big + pen overflows f32 to inf — harmless under min.
        return jnp.minimum(best, sl + pen), None

    best, _ = jax.lax.scan(step, jnp.full_like(m, big), jnp.arange(2 * window + 1))
    return best


@functools.partial(
    jax.jit, static_argnames=("radius", "tolerance", "grid_size", "window")
)
def hpr_mask_grid(
    points_camera: jnp.ndarray,
    valid: jnp.ndarray,
    radius: float = DEFAULT_RADIUS,
    tolerance: float = 0.05,
    grid_size: int = 512,
    window: int = 16,
) -> jnp.ndarray:
    """O(N) visibility mask equivalent to :func:`hpr_mask` at scale.

    The dense support test hides point i exactly when some j satisfies
    ``(2R - r_j)·cosθ_ij > 2R - r_i + tol``; expanding ``cosθ ≈ 1 - θ²/2``
    (the flip radius R = 9e4 makes the O(r·θ²) remainder sub-millimetre)
    gives the *parabolic z-buffer* rule

        hidden(i) ⇔ ∃j: r_j + R·θ_ij² < r_i − tol

    which this kernel evaluates in O(N + G²·window) instead of O(N²):
    scatter-min of ranges onto a G×G gnomonic grid (θ² ≈ |Δ(x/z, y/z)|²,
    an overestimate off-axis — errs toward keeping points, like ``tol``),
    a separable parabolic min-convolution (two 1D lower-envelope passes),
    and one gather per point. At 262k points the dense path is ~0.4 TFLOP
    per cull; this is ~5 MFLOP-equivalent.

    Scope bound (documented, not silent): interactions are captured up to
    θ ≤ window·cell, i.e. occluders can hide points at most
    ``R·(window·cell)²`` metres behind them (cell = FoV/grid_size; ≈57 m
    at FoV 0.8 rad with the defaults). Beyond that the kernel errs toward
    visible — raise ``window`` (linear cost) for deeper scenes.
    """
    n = points_camera.shape[0]
    dt = points_camera.dtype
    big = jnp.asarray(jnp.finfo(dt).max, dt)
    x, y, z = (points_camera[..., i] for i in range(3))
    r = jnp.sqrt(x * x + y * y + z * z)
    ok = valid & (z > 1e-9) & (r > 1e-9)

    ax = jnp.where(ok, x / jnp.maximum(z, 1e-9), 0.0)
    ay = jnp.where(ok, y / jnp.maximum(z, 1e-9), 0.0)
    lo_x = jnp.min(jnp.where(ok, ax, jnp.inf))
    hi_x = jnp.max(jnp.where(ok, ax, -jnp.inf))
    lo_y = jnp.min(jnp.where(ok, ay, jnp.inf))
    hi_y = jnp.max(jnp.where(ok, ay, -jnp.inf))
    g = grid_size
    cu = jnp.maximum((hi_x - lo_x) / g, 1e-9)
    cv = jnp.maximum((hi_y - lo_y) / g, 1e-9)
    iu = jnp.clip(((ax - lo_x) / cu).astype(jnp.int32), 0, g - 1)
    iv = jnp.clip(((ay - lo_y) / cv).astype(jnp.int32), 0, g - 1)
    cell = jnp.where(ok, iv * g + iu, g * g)  # sink cell for masked points

    zmin = jnp.full((g * g + 1,), big, dt)
    zmin = zmin.at[cell].min(jnp.where(ok, r, big), mode="drop")
    m = zmin[: g * g].reshape(g, g)

    m = _erode_parabolic_axis(m, cv, radius, window, axis=0)
    m = _erode_parabolic_axis(m, cu, radius, window, axis=1)

    eroded = m.reshape(-1)[jnp.minimum(cell, g * g - 1)]
    return ok & ~(eroded < r - tolerance)


def cull_world_points(
    camera,
    T_camera_world,
    points_world: jnp.ndarray,
    valid: jnp.ndarray,
    radius: float = DEFAULT_RADIUS,
    tolerance: float = 0.05,
    impl: str = "auto",
    dense_cutoff: int = 100_000,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Transform world points into the camera frame and HPR-cull, gated to
    the camera frustum first (`hidden_points_removal` pre-filters to the
    image bounds + FoV at view_culling.cpp:270-289 before flipping).

    ``impl``: "dense" = exact support matmul (O(N²) work — ~0.4 TFLOP
    per cull at 262k points), "grid" = parabolic-z-buffer approximation
    (O(N), see :func:`hpr_mask_grid`), "auto" = grid above ``dense_cutoff``
    points. Returns (points_camera, visibility_mask).
    """
    from ..core import se3
    from ..models import camera as cam

    pts_cam = se3.transform_points(T_camera_world, points_world)
    in_front = pts_cam[..., 2] > 0.0
    pixels = cam.project(camera, pts_cam)
    gate = valid & in_front & cam.in_image(camera, pixels)
    if impl == "auto":
        impl = "grid" if points_world.shape[0] > dense_cutoff else "dense"
    fn = hpr_mask_grid if impl == "grid" else hpr_mask
    return pts_cam, fn(pts_cam, gate, radius=radius, tolerance=tolerance)
