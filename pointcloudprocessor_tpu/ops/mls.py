"""Moving-Least-Squares surface smoothing as batched linear algebra.

Replaces `pcl::MovingLeastSquares` as driven by the reference
(`PointCloudProcessor/src/cloudSmooth.cpp:124-154`, params configured at
`src/PointCloudProcessor.cpp:67-86`): for every point, fit a local plane to
its radius neighborhood, then a weighted order-2 bivariate polynomial of
height over the tangent frame (Gaussian weights ``exp(-d^2/sqr_gauss)``),
and project the point onto that surface. Optional upsampling regenerates
extra points on the fitted surfaces (SAMPLE_LOCAL_PLANE /
RANDOM_UNIFORM_DENSITY / VOXEL_GRID_DILATION, `cloudSmooth.cpp:133-152`).

Formulation: neighborhoods come from the grid-hash (:mod:`.knn`), and the
per-point fits are *batched* normal-equation solves — (N, 6, 6) systems and
(N, 3, 3) covariance eigenproblems evaluated as one fused chunked pass, not a
per-point kd-tree walk with 30 OpenMP threads (`cloudSmooth.cpp:130`).
The full stage (SOR -> MLS -> SOR, `cloudSmooth.cpp:110-164`) is
:func:`smooth_cloud`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import cloud as cl
from ..utils.config import MLSConfig
from . import knn, sor, voxel


class MLSSurface(NamedTuple):
    """Per-point fitted local surface.

    origin: (N, 3) weighted neighborhood mean (frame origin).
    normal: (N, 3) unit plane normal.
    tangent_u/tangent_v: (N, 3) orthonormal tangent axes.
    coeffs: (N, 6) polynomial coefficients of h(u,v) =
        c0 + c1 u + c2 v + c3 u^2 + c4 uv + c5 v^2.
    ok: (N,) bool — enough neighbors for a fit (>= 3; polynomial needs >= 6,
        otherwise coeffs describe the plane, i.e. zeros).
    """

    origin: jnp.ndarray
    normal: jnp.ndarray
    tangent_u: jnp.ndarray
    tangent_v: jnp.ndarray
    coeffs: jnp.ndarray
    ok: jnp.ndarray


def _chol_solve(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched SPD solve via a fully UNROLLED Cholesky (d = static, small).

    `jnp.linalg.solve` on (N, d, d) batches lowers to LU custom calls /
    loops; for the d∈{3,6} systems of the MLS fits this
    unrolled form is pure elementwise code over the batch — every L
    entry is one (N,) array, no matrix ops at all.
    """
    d = A.shape[-1]
    L = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * d
    for i in range(d):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * d
    for i in reversed(range(d)):
        s = y[i]
        for k in range(i + 1, d):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, -1)


def _smallest_eigvec_3x3(C: jnp.ndarray) -> jnp.ndarray:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3).

    Two inverse-iteration steps on (C - sigma I) with sigma just below the
    smallest Gershgorin bound — branch-free and batched (no LAPACK custom
    call), robust enough for covariance matrices of surface patches.
    """
    tr = jnp.trace(C, axis1=-2, axis2=-1)
    # Shift so the target eigenvalue is the largest of the inverse; ridge
    # keeps the solve well-posed when the patch is exactly planar.
    shift = 1e-6 * (tr[..., None, None] + 1e-12) * jnp.eye(3, dtype=C.dtype)
    A = C + shift
    # Inverse iteration: v <- A^-1 v, twice, from a fixed non-degenerate seed.
    v0 = jnp.ones(C.shape[:-2] + (3,), C.dtype) * jnp.asarray([0.577, 0.577, 0.577], C.dtype)
    sol = _chol_solve(A, v0)
    sol = sol / jnp.maximum(jnp.linalg.norm(sol, axis=-1, keepdims=True), 1e-20)
    sol = _chol_solve(A, sol)
    sol = _chol_solve(A, sol)
    return sol / jnp.maximum(jnp.linalg.norm(sol, axis=-1, keepdims=True), 1e-20)


def _tangent_frame(n: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Deterministic orthonormal (u, v) completing unit normal n."""
    # Pick the world axis least aligned with n.
    ref = jnp.where(
        (jnp.abs(n[..., 0:1]) < 0.9),
        jnp.asarray([1.0, 0.0, 0.0], n.dtype),
        jnp.asarray([0.0, 1.0, 0.0], n.dtype),
    )
    u = jnp.cross(n, ref)
    u = u / jnp.maximum(jnp.linalg.norm(u, axis=-1, keepdims=True), 1e-20)
    v = jnp.cross(n, u)
    return u, v


def fit_surfaces(
    points: jnp.ndarray,
    queries: jnp.ndarray,
    neigh_idx: jnp.ndarray,
    neigh_ok: jnp.ndarray,
    sqr_gauss_param: float,
    polynomial_order: int = 2,
    neigh_pts: jnp.ndarray | None = None,
) -> MLSSurface:
    """Fit the local MLS surface around every query point.

    points: (N, 3) cloud the neighbor indices refer to.
    queries: (M, 3) fit centers (the cloud itself in the smoothing pass).
    neigh_idx/neigh_ok: (M, K) from :func:`knn.radius_neighbors`.
    neigh_pts: optional (M, K, 3) neighbor positions (from
        `knn.radius_neighbors_with_points`) — skips the (M, K) scalar
        gather from ``points``.
    """
    q = queries
    npts = neigh_pts if neigh_pts is not None else points[jnp.maximum(neigh_idx, 0)]
    w = neigh_ok.astype(points.dtype)
    d2 = jnp.sum((npts - q[:, None, :]) ** 2, axis=-1)
    # PCL weight: exp(-d^2 / sqr_gauss) (MovingLeastSquares theta), masked.
    w = w * jnp.exp(-d2 / sqr_gauss_param)

    wsum = jnp.maximum(jnp.sum(w, axis=1), 1e-20)
    mean = jnp.sum(npts * w[..., None], axis=1) / wsum[:, None]  # (M, 3)
    centered = (npts - mean[:, None, :]) * jnp.sqrt(w)[..., None]
    # Full f32 (HIGHEST) on every fit contraction: a default-precision f32
    # dot may run in TF32 on a GPU.
    hi = jax.lax.Precision.HIGHEST
    C = jnp.einsum("mki,mkj->mij", centered, centered, precision=hi)  # (M, 3, 3) weighted cov
    normal = _smallest_eigvec_3x3(C)
    # Orient towards the query side consistently (sign is arbitrary otherwise).
    sgn = jnp.sign(jnp.sum(normal * (q - mean), axis=-1))
    normal = normal * jnp.where(sgn == 0, 1.0, sgn)[:, None]
    tu, tv = _tangent_frame(normal)

    cnt = jnp.sum(neigh_ok, axis=1)
    if polynomial_order >= 2:
        rel = npts - mean[:, None, :]
        u = jnp.sum(rel * tu[:, None, :], axis=-1)  # (M, K)
        v = jnp.sum(rel * tv[:, None, :], axis=-1)
        h = jnp.sum(rel * normal[:, None, :], axis=-1)
        A = jnp.stack([jnp.ones_like(u), u, v, u * u, u * v, v * v], axis=-1)  # (M, K, 6)
        Aw = A * w[..., None]
        AtA = jnp.einsum("mki,mkj->mij", Aw, A, precision=hi)
        Ath = jnp.einsum("mki,mk->mi", Aw, h, precision=hi)
        ridge = 1e-8 * jnp.eye(6, dtype=points.dtype)
        coeffs = _chol_solve(AtA + ridge, Ath)
        # Fall back to the plane (zero coeffs) when under-determined.
        coeffs = jnp.where((cnt >= 6)[:, None], coeffs, jnp.zeros_like(coeffs))
    else:
        coeffs = jnp.zeros(q.shape[:1] + (6,), points.dtype)

    return MLSSurface(
        origin=mean, normal=normal, tangent_u=tu, tangent_v=tv,
        coeffs=coeffs, ok=cnt >= 3,
    )


def project_onto(surf: MLSSurface, pts: jnp.ndarray, owner: jnp.ndarray | None = None):
    """Project points onto (their own / ``owner``'s) fitted surface.

    Returns (positions, normals). Matches PCL's SIMPLE projection: express
    the point in the local frame, replace its height by the polynomial value,
    and tilt the normal by the polynomial gradient.
    """
    s = surf if owner is None else jax.tree.map(lambda a: a[owner], surf)
    rel = pts - s.origin
    u = jnp.sum(rel * s.tangent_u, axis=-1)
    v = jnp.sum(rel * s.tangent_v, axis=-1)
    c = s.coeffs
    h = c[..., 0] + c[..., 1] * u + c[..., 2] * v + c[..., 3] * u * u + c[..., 4] * u * v + c[..., 5] * v * v
    pos = s.origin + u[..., None] * s.tangent_u + v[..., None] * s.tangent_v + h[..., None] * s.normal
    du = c[..., 1] + 2.0 * c[..., 3] * u + c[..., 4] * v
    dv = c[..., 2] + c[..., 4] * u + 2.0 * c[..., 5] * v
    n = s.normal - du[..., None] * s.tangent_u - dv[..., None] * s.tangent_v
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    pos = jnp.where(s.ok[..., None], pos, pts)
    return pos, n


def fit_surfaces_moments(
    queries: jnp.ndarray,  # (M, 3)
    cx: jnp.ndarray,  # (M, C) candidate x (+inf in empty slots)
    cy: jnp.ndarray,
    cz: jnp.ndarray,
    search_radius: float,
    sqr_gauss_param: float,
    polynomial_order: int = 2,
) -> MLSSurface:
    """Selection-free MLS fit: weighted moments over ALL in-radius
    candidates, straight from the 27-cell candidate planes.

    The round-4 anatomy (tools/mls_anatomy) put 93% of the MLS pass in the
    neighbor stage; this formulation removes its two dominant parts — the
    `approx_min_k` selection and the bucket-INDEX row gather (validity
    comes from the coordinate planes' +inf empties) — and also the
    truncation to ``max_neighbors``: PCL's MovingLeastSquares fits over
    every point the radius search returns (`cloudSmooth.cpp:124-154`
    drives `pcl::MovingLeastSquares` with a kd-tree radius search, no
    cap), so this is MORE reference-faithful than the top-K path. Both
    passes (plane, then polynomial in the plane frame) reduce over the
    candidate axis with Gaussian weights; empty/out-of-radius slots carry
    zero weight.
    """
    q = queries
    dx = cx - q[:, 0:1]
    dy = cy - q[:, 1:2]
    dz = cz - q[:, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    inr = jnp.isfinite(cz) & (d2 <= search_radius * search_radius)
    w = jnp.where(inr, jnp.exp(-jnp.where(inr, d2, 0.0) / sqr_gauss_param), 0.0)
    dx = jnp.where(inr, dx, 0.0)
    dy = jnp.where(inr, dy, 0.0)
    dz = jnp.where(inr, dz, 0.0)

    wsum = jnp.maximum(jnp.sum(w, axis=1), 1e-20)  # (M,)
    mx = jnp.sum(w * dx, axis=1) / wsum
    my = jnp.sum(w * dy, axis=1) / wsum
    mz = jnp.sum(w * dz, axis=1) / wsum
    mean = q + jnp.stack([mx, my, mz], axis=-1)

    # Weighted covariance about the mean (relative coords keep f32 happy).
    ex = dx - mx[:, None]
    ey = dy - my[:, None]
    ez = dz - mz[:, None]
    cxx = jnp.sum(w * ex * ex, axis=1)
    cxy = jnp.sum(w * ex * ey, axis=1)
    cxz = jnp.sum(w * ex * ez, axis=1)
    cyy = jnp.sum(w * ey * ey, axis=1)
    cyz = jnp.sum(w * ey * ez, axis=1)
    czz = jnp.sum(w * ez * ez, axis=1)
    C = jnp.stack(
        [
            jnp.stack([cxx, cxy, cxz], -1),
            jnp.stack([cxy, cyy, cyz], -1),
            jnp.stack([cxz, cyz, czz], -1),
        ],
        -2,
    )  # (M, 3, 3)
    normal = _smallest_eigvec_3x3(C)
    sgn = jnp.sign(jnp.sum(normal * (q - mean), axis=-1))
    normal = normal * jnp.where(sgn == 0, 1.0, sgn)[:, None]
    tu, tv = _tangent_frame(normal)

    cnt = jnp.sum(inr, axis=1)
    if polynomial_order >= 2:
        # Local-frame coordinates per candidate (rel = cand - mean).
        rx = ex
        ry = ey
        rz = ez
        u = rx * tu[:, 0:1] + ry * tu[:, 1:2] + rz * tu[:, 2:3]
        v = rx * tv[:, 0:1] + ry * tv[:, 1:2] + rz * tv[:, 2:3]
        h = rx * normal[:, 0:1] + ry * normal[:, 1:2] + rz * normal[:, 2:3]
        # A = [1, u, v, u^2, uv, v^2]: A^T W A's 36 entries are weighted
        # monomial moments M[a,b] = sum w u^a v^b with a+b <= 4 — only 15
        # DISTINCT ones (plus 6 rhs moments), so 21 reductions over the
        # candidate axis instead of 42; no (M, C, 6) tensor ever exists.
        pow_u = [jnp.ones_like(u), u, u * u]
        pow_u.append(pow_u[2] * u)
        pow_u.append(pow_u[3] * u)
        pow_v = [jnp.ones_like(v), v, v * v]
        pow_v.append(pow_v[2] * v)
        pow_v.append(pow_v[3] * v)
        mom = {}
        for a in range(5):
            for b_ in range(5 - a):
                mom[(a, b_)] = jnp.sum(w * pow_u[a] * pow_v[b_], axis=1)
        exps = [(0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2)]
        AtA = jnp.stack(
            [
                jnp.stack(
                    [
                        mom[(exps[i][0] + exps[j][0], exps[i][1] + exps[j][1])]
                        for j in range(6)
                    ],
                    -1,
                )
                for i in range(6)
            ],
            -2,
        )  # (M, 6, 6)
        wh = w * h
        Ath = jnp.stack(
            [jnp.sum(wh * pow_u[a] * pow_v[b_], axis=1) for a, b_ in exps], -1
        )  # (M, 6)
        ridge = 1e-8 * jnp.eye(6, dtype=q.dtype)
        coeffs = _chol_solve(AtA + ridge, Ath)
        coeffs = jnp.where((cnt >= 6)[:, None], coeffs, jnp.zeros_like(coeffs))
    else:
        coeffs = jnp.zeros(q.shape[:1] + (6,), q.dtype)

    return MLSSurface(
        origin=mean, normal=normal, tangent_u=tu, tangent_v=tv,
        coeffs=coeffs, ok=cnt >= 3,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "search_radius",
        "max_neighbors",
        "sqr_gauss_param",
        "polynomial_order",
        "bucket_capacity",
        "table_size",
        "chunk_size",
        "fit_impl",
        "dedup_candidates",
    ),
)
def _mls_smooth_jit(
    points,
    valid,
    *,
    search_radius,
    max_neighbors,
    sqr_gauss_param,
    polynomial_order,
    bucket_capacity,
    table_size,
    chunk_size,
    fit_impl="moments",
    dedup_candidates=False,
):
    """One-dispatch MLS pass: grid build + `lax.map` over query chunks, each
    chunk doing neighbor query -> weighted fit -> projection. The chunking
    bounds the (chunk, 27*B) candidate tensor in on-chip memory while XLA
    pipelines the chunks — no eager per-chunk dispatch.

    ``dedup_candidates`` (moments fit only): process queries grouped by
    voxel cell so each cell's 27-bucket candidate window is fetched once
    per RUN instead of once per query (`knn.candidate_points_dedup`) —
    per-index gather cost scales with index count, and the per-query fetch
    is the moments pass's dominant term. One multi-payload sort groups the
    queries at entry and one restores original order at exit (both cheap
    next to the gathers); chunks with more runs than the capacity, or
    clouds beyond the packable cell extent, fall back to the per-query
    fetch inside a `lax.cond` — results are EXACTLY equal either way (same
    candidate sets in the same bucket order)."""
    n = points.shape[0]
    grid = knn.build(
        points, valid, cell_size=search_radius,
        table_size=table_size, bucket_capacity=bucket_capacity,
        store_points=True,  # row-gathered candidates (see knn.HashGrid)
    )
    pad = (-n) % chunk_size
    run_cap = chunk_size // 4
    dedup = bool(dedup_candidates) and fit_impl == "moments"
    if dedup:
        from .voxel import voxel_coords, voxel_hash

        cells = voxel_coords(points, search_radius)
        key, fits = knn.pack_cell_key(cells)
        h = jnp.where(valid, voxel_hash(cells, table_size), jnp.int32(table_size))
        iota = jnp.arange(n, dtype=jnp.int32)
        # Group queries by (hash, exact cell key): hash-major matches the
        # bucket table's own grouping; the exact key splits rare hash
        # collisions so run grouping never merges distinct cells.
        _, key_s, xs, ys, zs, orig = jax.lax.sort(
            (h, key, points[:, 0], points[:, 1], points[:, 2], iota),
            num_keys=2,
        )
        q_all = jnp.stack([xs, ys, zs], axis=-1)
        # Pad with a key no real cell produces (bit 30) so pad rows form
        # their own run and never extend a real one.
        key_all = jnp.pad(key_s, (0, pad), constant_values=jnp.int32(1 << 30))
        q_pad = jnp.pad(q_all, ((0, pad), (0, 0)))
        qc = q_pad.reshape(-1, chunk_size, 3)
        kc = key_all.reshape(-1, chunk_size)
    else:
        fits = jnp.asarray(True)
        qc = jnp.pad(points, ((0, pad), (0, 0))).reshape(-1, chunk_size, 3)
        kc = jnp.zeros((qc.shape[0], chunk_size), jnp.int32)

    def one(args):
        q, kkey = args
        if fit_impl == "moments":
            if dedup:
                def fetch_dedup(_):
                    cx, cy, cz, ok = knn.candidate_points_dedup(
                        grid, q, kkey, run_cap
                    )
                    return jax.lax.cond(
                        ok & fits,
                        lambda c: c,
                        lambda _: knn.candidate_points(grid, q),
                        (cx, cy, cz),
                    )

                cx, cy, cz = fetch_dedup(None)
            else:
                cx, cy, cz = knn.candidate_points(grid, q)
            surf = fit_surfaces_moments(
                q, cx, cy, cz, search_radius, sqr_gauss_param, polynomial_order
            )
        else:
            idx, npts, _, ok = knn.radius_neighbors_with_points(
                grid, points, q, search_radius, max_neighbors, select="approx"
            )
            surf = fit_surfaces(
                points, q, idx, ok, sqr_gauss_param, polynomial_order,
                neigh_pts=npts,
            )
        pos, nrm = project_onto(surf, q)
        return surf, pos, nrm

    surf, pos, nrm = jax.lax.map(one, (qc, kc))
    flat = lambda a: a.reshape((-1,) + a.shape[2:])
    if dedup:
        # Restore original order with ONE row scatter of the packed
        # 26-channel payload (pos, nrm, surf fields): ~1 per-index tax for
        # all channels together. (A 27-operand payload-carrying lax.sort
        # computes the same thing but its XLA sort expansion compiles for
        # 30+ minutes at 1M points — measured, and the scatter is cheaper
        # at run time too. Per-channel unsort gathers would pay the
        # per-index tax 20+ times.)
        orig_pad = jnp.pad(orig, (0, pad), constant_values=jnp.int32(n))
        s = jax.tree.map(flat, surf)
        payload = jnp.concatenate(
            [flat(pos), flat(nrm), s.origin, s.normal, s.tangent_u,
             s.tangent_v, s.coeffs,
             s.ok.astype(pos.dtype)[:, None]],
            axis=1,
        )  # (Npad, 25)
        out = jnp.zeros((n + 1, payload.shape[1]), payload.dtype)
        out = out.at[orig_pad].set(payload, mode="drop")[:n]
        surf_o = MLSSurface(
            origin=out[:, 6:9], normal=out[:, 9:12],
            tangent_u=out[:, 12:15], tangent_v=out[:, 15:18],
            coeffs=out[:, 18:24], ok=out[:, 24] > 0.5,
        )
        return out[:, 0:3], out[:, 3:6], surf_o
    unpad = lambda a: flat(a)[:n]
    return unpad(pos), unpad(nrm), jax.tree.map(unpad, surf)


def mls_smooth(
    points: jnp.ndarray,
    valid: jnp.ndarray,
    cfg: MLSConfig,
    chunk_size: int = 16384,
    fit_impl: str = "moments",
    dedup_candidates: bool = True,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, MLSSurface]:
    """Smooth every valid point onto its local MLS surface.

    Returns (positions (N,3), normals (N,3), ok (N,), surfaces). Points whose
    neighborhood is too small keep their position with ok=False (PCL drops
    them from the output; callers AND `ok` into validity). The whole pass —
    hash-grid build, neighbor queries, batched fits, projection — is a single
    jitted dispatch (the batched replacement for PCL MLS's 30-thread kd-tree walk,
    `cloudSmooth.cpp:124-154`).

    ``fit_impl``: "moments" (default) fits over ALL in-radius candidates via
    weighted monomial moments — PCL's exact semantics (no neighbor cap) and
    the round-4 anatomy's fix for the dominant selection cost; "topk" is the
    round-2/3 approx_min_k path (truncates to cfg.max_neighbors).

    ``dedup_candidates`` (moments only, default on): fetch each cell's
    candidate window once per run of cell-grouped queries instead of once
    per query — exactly equal results, at a fraction of the per-index
    gather cost that dominates the pass (see `_mls_smooth_jit`).
    """
    n = points.shape[0]
    pos, nrm, surf = _mls_smooth_jit(
        points,
        valid,
        search_radius=float(cfg.search_radius),
        max_neighbors=int(cfg.max_neighbors),
        sqr_gauss_param=float(cfg.sqr_gauss_param),
        polynomial_order=int(cfg.polynomial_order),
        bucket_capacity=int(cfg.bucket_capacity),
        fit_impl=fit_impl,
        dedup_candidates=dedup_candidates,
        # Half-size table: with bucket_points the table costs T*B*12 bytes,
        # and dense clouds occupy ~n/27 cells, so T=n/2 keeps the collision
        # rate negligible at a quarter of the 2n footprint.
        table_size=max(n // 2, 1024),
        chunk_size=min(chunk_size, max(2 * n, 1024)),
    )
    return pos, nrm, surf.ok & valid, surf


# ---------------------------------------------------------------------------
# Upsampling (`cloudSmooth.cpp:133-152`)
# ---------------------------------------------------------------------------


def _disc_offsets(radius: float, step: float) -> np.ndarray:
    """Static (S, 2) grid of (du, dv) offsets within the disc — the
    SAMPLE_LOCAL_PLANE pattern (`cloudSmooth.cpp:136-139` params)."""
    ax = np.arange(-radius, radius + step * 0.5, step)
    du, dv = np.meshgrid(ax, ax)
    m = du**2 + dv**2 <= radius**2
    return np.stack([du[m], dv[m]], axis=-1).astype(np.float32)


def upsample_local_plane(surf: MLSSurface, valid: jnp.ndarray, cfg: MLSConfig):
    """SAMPLE_LOCAL_PLANE: regenerate a disc of surface samples per point."""
    offs = jnp.asarray(_disc_offsets(cfg.slp_upsampling_radius, cfg.slp_upsampling_stepsize))
    s = offs.shape[0]
    base = surf.origin[:, None, :] + (
        offs[None, :, 0:1] * surf.tangent_u[:, None, :]
        + offs[None, :, 1:2] * surf.tangent_v[:, None, :]
    )  # (N, S, 3)
    n_total = base.shape[0] * s
    pts = base.reshape(n_total, 3)
    owner = jnp.repeat(jnp.arange(base.shape[0], dtype=jnp.int32), s)
    pos, nrm = project_onto(surf, pts, owner=owner)
    ok = (valid & surf.ok)[owner]
    return pos, nrm, ok, owner


def upsample_random_density(surf: MLSSurface, valid: jnp.ndarray, cfg: MLSConfig, key):
    """RANDOM_UNIFORM_DENSITY: ``rud_point_density`` uniform samples in the
    search-radius disc per point (`cloudSmooth.cpp:141-144`)."""
    s = int(cfg.rud_point_density)
    n = surf.origin.shape[0]
    k1, k2 = jax.random.split(key)
    r = cfg.search_radius * jnp.sqrt(jax.random.uniform(k1, (n, s)))
    th = 2.0 * jnp.pi * jax.random.uniform(k2, (n, s))
    du, dv = r * jnp.cos(th), r * jnp.sin(th)
    base = (
        surf.origin[:, None, :]
        + du[..., None] * surf.tangent_u[:, None, :]
        + dv[..., None] * surf.tangent_v[:, None, :]
    )
    pts = base.reshape(n * s, 3)
    owner = jnp.repeat(jnp.arange(n, dtype=jnp.int32), s)
    pos, nrm = project_onto(surf, pts, owner=owner)
    ok = (valid & surf.ok)[owner]
    return pos, nrm, ok, owner


def _dilate_voxels_host(coords: np.ndarray, iterations: int) -> np.ndarray:
    """Host-side binary dilation of an integer voxel set (VOXEL_GRID_DILATION
    grid step, `pcl::MLSResult` dilation). Set ops on packed int64 keys."""
    offs = np.array(
        [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
        np.int64,
    )
    cur = np.unique(coords.astype(np.int64), axis=0)
    for _ in range(iterations):
        grown = (cur[:, None, :] + offs[None, :, :]).reshape(-1, 3)
        # Pack to a single key for uniqueness (21 bits per axis, offset).
        key = ((grown[:, 0] + (1 << 20)) << 42) | ((grown[:, 1] + (1 << 20)) << 21) | (
            grown[:, 2] + (1 << 20)
        )
        _, first = np.unique(key, return_index=True)
        cur = grown[first]
    return cur


def upsample_voxel_grid_dilation(
    points_np: np.ndarray, surf: MLSSurface, valid_np: np.ndarray, cfg: MLSConfig
):
    """VOXEL_GRID_DILATION: dilate the occupied-voxel set and project every
    voxel center onto the MLS surface of its nearest source point
    (`cloudSmooth.cpp:146-152`; voxel/iters at `PointCloudProcessor.cpp:80-81`).
    Dilation runs host-side (dynamic cardinality); projection on device.
    """
    vs = cfg.vgd_voxel_size
    occ = np.floor(points_np[valid_np] / vs).astype(np.int64)
    cells = _dilate_voxels_host(occ, cfg.vgd_iterations)
    centers = (cells.astype(np.float32) + 0.5) * vs

    # Nearest source point per center via the device hash grid.
    pts = jnp.asarray(points_np)
    grid = knn.build(
        pts, jnp.asarray(valid_np),
        cell_size=max(vs * (cfg.vgd_iterations + 1), cfg.search_radius),
        table_size=max(2 * len(points_np), 1024),
        bucket_capacity=cfg.bucket_capacity,
    )
    idx, _, ok = knn.chunked_radius_neighbors(
        grid, pts, jnp.asarray(centers),
        radius=max(vs * (cfg.vgd_iterations + 1), cfg.search_radius),
        max_neighbors=1,
    )
    owner = jnp.maximum(idx[:, 0], 0)
    pos, nrm = project_onto(surf, jnp.asarray(centers), owner=owner)
    return pos, nrm, ok[:, 0] & surf.ok[owner], owner


# ---------------------------------------------------------------------------
# Full stage
# ---------------------------------------------------------------------------


def smooth_cloud(cloud: cl.PointCloud, cfg: MLSConfig, key=None) -> cl.PointCloud:
    """SOR -> MLS (+ upsampling) -> SOR, the `CloudSmooth::process` stage
    (`cloudSmooth.cpp:77-181`). Returns a cloud whose capacity may exceed the
    input's when upsampling multiplies the point count.
    """
    inlier = sor.sor_mask(
        cloud.points, cloud.valid, mean_k=cfg.sor_mean_k, std_mult=cfg.sor_std_dev,
        cell_size=max(cfg.search_radius * 4.0, 0.25),
        bucket_capacity=max(cfg.bucket_capacity, cfg.sor_mean_k),
    )
    valid = cloud.valid & inlier

    pos, nrm, ok, surf = mls_smooth(cloud.points, valid, cfg)
    method = cfg.upsampling.lower()
    if method in ("none", ""):
        out = cloud._replace(points=pos, normals=nrm if cfg.compute_normals else None,
                             valid=valid & ok)
    else:
        if method == "sample_local_plane":
            up_pos, up_nrm, up_ok, owner = upsample_local_plane(surf, valid, cfg)
        elif method == "random_uniform_density":
            key = key if key is not None else jax.random.PRNGKey(0)
            up_pos, up_nrm, up_ok, owner = upsample_random_density(surf, valid, cfg, key)
        elif method == "voxel_grid_dilation":
            up_pos, up_nrm, up_ok, owner = upsample_voxel_grid_dilation(
                np.asarray(cloud.points), surf, np.asarray(valid), cfg
            )
        else:
            raise ValueError(f"unknown MLS upsampling method: {cfg.upsampling!r}")
        out = cl.PointCloud(
            points=up_pos,
            intensity=cloud.intensity[owner],
            valid=up_ok,
            rgb=None if cloud.rgb is None else cloud.rgb[owner],
            mask_label=None if cloud.mask_label is None else cloud.mask_label[owner],
            normals=up_nrm if cfg.compute_normals else None,
        )

    # Second SOR pass (`cloudSmooth.cpp:160-164`).
    inlier2 = sor.sor_mask(
        out.points, out.valid, mean_k=cfg.sor_mean_k, std_mult=cfg.sor_std_dev,
        cell_size=max(cfg.search_radius * 4.0, 0.25),
        bucket_capacity=max(cfg.bucket_capacity, cfg.sor_mean_k),
    )
    return out._replace(valid=out.valid & inlier2)
