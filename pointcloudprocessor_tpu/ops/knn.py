"""Grid-hash neighbor search — the static-shape replacement for kd-trees/octrees.

The reference leans on PCL kd-trees everywhere (MLS neighborhoods
`cloudSmooth.cpp:83,127`, SOR, the color-fusion radius search
`PointCloudProcessor.cpp:480-482,571`, octree smoothing `:642-644`).
Pointer-chasing trees don't map to static-shape array code; instead points are bucketed by a
spatial hash of their voxel cell (`vector3i_hash.hpp:14-37` primes) into a
fixed (table_size, bucket_capacity) index table built with a sort — O(N log N)
on device, static shapes — and queries examine the 27 neighboring cells.

Guarantee: with cell_size >= search radius, every true neighbor within the
radius lies in one of the 27 cells; results are exact up to bucket overflow
(points beyond ``bucket_capacity`` per cell are dropped — size capacity to
the expected density, as the reference sizes its voxel budgets).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .voxel import voxel_coords, voxel_hash


class HashGrid(NamedTuple):
    """Bucketed point index table.

    buckets: (T, B) int32 point indices, -1 = empty slot.
    counts: (T,) int32 occupancy (may exceed B; slots beyond B dropped).
    cell_size: float used for bucketing.
    table_size: static int.
    bucket_points: optional (T, 3*B) point COORDINATES in bucket layout,
        rows laid out [x_0..x_B-1, y_0.., z_0..] (+inf in empty slots).
        Costs T*B*12 bytes but turns the candidate fetch from per-point
        scalar gathers into contiguous ROW gathers. The long axis stays
        minor (96 words/row) rather than a (B, 3) slice layout, whose 3-wide
        minor dim pads in tiled layouts.
    """

    buckets: jnp.ndarray
    counts: jnp.ndarray
    cell_size: float
    table_size: int
    bucket_points: jnp.ndarray | None = None


def build(
    points: jnp.ndarray,
    valid: jnp.ndarray,
    cell_size: float,
    table_size: int,
    bucket_capacity: int = 32,
    store_points: bool = False,
) -> HashGrid:
    """Build the hash grid with a sort (no atomics):

    1. hash each valid point's cell,
    2. sort point indices by hash,
    3. within-bucket rank = position - first position of the hash run,
    4. scatter indices to (table, rank) for rank < capacity.

    ``store_points`` additionally scatters the point coordinates into a
    (T, B, 3) table so queries can fetch candidate positions as rows.
    """
    n = points.shape[0]
    h = voxel_hash(voxel_coords(points, cell_size), table_size)
    h = jnp.where(valid, h, table_size)  # invalid points -> sink bucket

    order = jnp.argsort(h)
    h_sorted = h[order]

    iota = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), h_sorted[1:] != h_sorted[:-1]]
    )
    run_start = jax.lax.cummax(jnp.where(is_start, iota, 0))
    rank = iota - run_start

    counts = jnp.zeros((table_size + 1,), jnp.int32).at[h].add(
        valid.astype(jnp.int32), mode="drop"
    )

    keep = (rank < bucket_capacity) & (h_sorted < table_size)
    flat_slot = jnp.where(
        keep, h_sorted * bucket_capacity + jnp.minimum(rank, bucket_capacity - 1),
        table_size * bucket_capacity,
    )
    buckets = jnp.full((table_size * bucket_capacity + 1,), -1, jnp.int32)
    buckets = buckets.at[flat_slot].set(order.astype(jnp.int32), mode="drop")
    bucket_points = None
    if store_points:
        bp = jnp.full((table_size * bucket_capacity + 1, 3), jnp.inf, points.dtype)
        bp = bp.at[flat_slot].set(points[order], mode="drop")
        # (T, B, 3) -> (T, 3, B) -> (T, 3B): coordinate-major rows keep the
        # gathered slice wide in the lane dimension (see HashGrid docstring).
        bucket_points = (
            bp[:-1].reshape(table_size, bucket_capacity, 3)
            .transpose(0, 2, 1)
            .reshape(table_size, 3 * bucket_capacity)
        )
    return HashGrid(
        buckets=buckets[:-1].reshape(table_size, bucket_capacity),
        counts=counts[:-1],
        cell_size=cell_size,
        table_size=table_size,
        bucket_points=bucket_points,
    )


_OFFSETS = jnp.asarray(
    [[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    jnp.int32,
)  # (27, 3)


def pack_cell_key(cells: jnp.ndarray):
    """(…, 3) int32 cell coords -> (key, fits): a UNIQUE int32 key per cell
    when every coordinate lies in [-512, 511] (a 1024-cell extent per axis —
    e.g. 30 m at the MLS 0.03 m cell). Unlike :func:`voxel_hash`, the key is
    collision-free within bounds, which the dedup candidate fetch needs for
    exact run grouping; ``fits`` gates the fallback when the cloud exceeds
    the packable extent."""
    c = cells + jnp.int32(512)
    fits = jnp.all((c >= 0) & (c < 1024))
    key = c[..., 0] | (c[..., 1] << jnp.int32(10)) | (c[..., 2] << jnp.int32(20))
    return key, fits


def candidate_points_dedup(
    grid: HashGrid,
    q_chunk: jnp.ndarray,  # (M, 3) queries, grouped by cell (runs)
    key_chunk: jnp.ndarray,  # (M,) collision-free cell keys of the queries
    run_cap: int,
):
    """Run-deduplicated candidate coordinate planes.

    For queries arriving grouped by cell (runs of equal ``key_chunk``), the
    27-cell candidate window is IDENTICAL within a run, so it is fetched
    once per run LEADER and broadcast to the run — the (M, 27) per-query
    bucket-row gather (the per-index emitter tax that dominates the MLS
    moments pass) shrinks to (run_cap, 27). Returns
    ``(cx, cy, cz, ok)``: ``ok`` False when the chunk holds more than
    ``run_cap`` runs — the caller must fall back to the per-query fetch
    (`candidate_points`), so exactness is unconditional.

    Replaces the kd-tree radius queries PCL MLS runs per point
    (`cloudSmooth.cpp:124-154`): the reference's kd-tree gets cache reuse
    between nearby queries for free; this is the array equivalent — explicit
    reuse of the shared bucket window across a cell's queries.
    """
    m = q_chunk.shape[0]
    starts = jnp.concatenate(
        [jnp.ones((1,), bool), key_chunk[1:] != key_chunk[:-1]]
    )
    run_id = jnp.cumsum(starts.astype(jnp.int32)) - 1  # (M,)
    n_runs = run_id[-1] + 1
    iota = jnp.arange(m, dtype=jnp.int32)
    lead_pos = jnp.sort(jnp.where(starts, iota, jnp.int32(m)))[:run_cap]
    lead_q = jnp.take(q_chunk, jnp.minimum(lead_pos, m - 1), axis=0)  # (R, 3)
    cells = voxel_coords(lead_q, grid.cell_size)
    neigh = cells[:, None, :] + _OFFSETS[None, :, :]
    hashes = voxel_hash(neigh, grid.table_size)  # (R, 27)
    rows = grid.bucket_points[hashes]  # (R, 27, 3B) — the deduplicated fetch
    b = rows.shape[-1] // 3
    wins = jnp.take(
        rows.reshape(run_cap, -1), jnp.minimum(run_id, run_cap - 1), axis=0
    )  # (M, 27*3B) window broadcast back to the run's queries
    r27 = wins.reshape(m, 27, 3 * b)
    cx = r27[..., 0 * b: 1 * b].reshape(m, -1)
    cy = r27[..., 1 * b: 2 * b].reshape(m, -1)
    cz = r27[..., 2 * b: 3 * b].reshape(m, -1)
    return cx, cy, cz, n_runs <= run_cap


def gather_candidates(grid: HashGrid, query_points: jnp.ndarray) -> jnp.ndarray:
    """(M, 27*B) candidate point indices (-1 = empty) from the 27 cells
    around each query point."""
    cells = voxel_coords(query_points, grid.cell_size)  # (M, 3)
    neigh = cells[:, None, :] + _OFFSETS[None, :, :]  # (M, 27, 3)
    hashes = voxel_hash(neigh, grid.table_size)  # (M, 27)
    cand = grid.buckets[hashes]  # (M, 27, B)
    return cand.reshape(cand.shape[0], -1)


def _candidates_with_points(grid, points, query_points):
    """(cand (M, C), cx, cy, cz each (M, C)): candidate indices and
    coordinates, row-gathered when the grid stores bucket_points (empty
    slots carry +inf coords), scalar-gathered from ``points`` otherwise.
    Coordinates stay as separate (M, C) planes — the long axis in the
    lanes, per the hot-path layout rule."""
    m = query_points.shape[0]
    cells = voxel_coords(query_points, grid.cell_size)
    neigh = cells[:, None, :] + _OFFSETS[None, :, :]
    hashes = voxel_hash(neigh, grid.table_size)  # (M, 27)
    cand = grid.buckets[hashes].reshape(m, -1)
    if grid.bucket_points is not None:
        rows = grid.bucket_points[hashes]  # (M, 27, 3B)
        b = rows.shape[-1] // 3
        cx = rows[..., 0 * b : 1 * b].reshape(m, -1)
        cy = rows[..., 1 * b : 2 * b].reshape(m, -1)
        cz = rows[..., 2 * b : 3 * b].reshape(m, -1)
    else:
        cand_pts = points[jnp.maximum(cand, 0)]
        cx, cy, cz = (cand_pts[..., i] for i in range(3))
    return cand, cx, cy, cz


def candidate_points(grid: HashGrid, query_points: jnp.ndarray):
    """Candidate COORDINATE planes only — (cx, cy, cz) each (M, 27*B),
    +inf in empty slots. Skips the bucket-INDEX row gather entirely: for
    selection-free consumers (the MLS moments fit) validity is carried by
    the +inf coordinates, and the 27M-per-Mquery index-row gathers were
    ~pure overhead (round-4 MLS anatomy). Requires store_points=True."""
    m = query_points.shape[0]
    cells = voxel_coords(query_points, grid.cell_size)
    neigh = cells[:, None, :] + _OFFSETS[None, :, :]
    hashes = voxel_hash(neigh, grid.table_size)  # (M, 27)
    rows = grid.bucket_points[hashes]  # (M, 27, 3B)
    b = rows.shape[-1] // 3
    cx = rows[..., 0 * b: 1 * b].reshape(m, -1)
    cy = rows[..., 1 * b: 2 * b].reshape(m, -1)
    cz = rows[..., 2 * b: 3 * b].reshape(m, -1)
    return cx, cy, cz


def radius_neighbors_with_points(
    grid: HashGrid,
    points: jnp.ndarray,
    query_points: jnp.ndarray,
    radius: float,
    max_neighbors: int,
    exclude_self_index: jnp.ndarray | None = None,
    select: str = "exact",
):
    """radius_neighbors that also returns the selected neighbor POSITIONS
    (M, K, 3) — taken from the candidate tensor already in registers, so
    callers skip a second (M, K) scalar gather from ``points``.

    ``select="approx"`` uses `lax.approx_min_k` (an approximate partial
    reduction; exact on CPU) — ~0.95 recall of the true k nearest, right for
    weighted-aggregation consumers like the MLS fits; keep "exact" when the
    caller needs the precise nearest set."""
    cand, cx, cy, cz = _candidates_with_points(grid, points, query_points)
    cand_valid = cand >= 0
    dx = cx - query_points[:, 0:1]
    dy = cy - query_points[:, 1:2]
    dz = cz - query_points[:, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    big = jnp.asarray(jnp.inf, d2.dtype)
    d2 = jnp.where(cand_valid & (d2 <= radius * radius), d2, big)
    if exclude_self_index is not None:
        d2 = jnp.where(cand == exclude_self_index[:, None], big, d2)

    k = min(max_neighbors, cand.shape[1])
    if select == "approx":
        top_d2, top_idx = jax.lax.approx_min_k(d2, k)
    else:
        neg_top, top_idx = jax.lax.top_k(-d2, k)
        top_d2 = -neg_top
    ok = top_d2 < big  # finite <=> in-radius valid candidate
    dist = jnp.sqrt(jnp.maximum(top_d2, 0.0))
    idx = jnp.take_along_axis(cand, top_idx, axis=1)
    pts_sel = jnp.stack(
        [jnp.take_along_axis(c, top_idx, axis=1) for c in (cx, cy, cz)], axis=-1
    )
    pts_sel = jnp.where(ok[..., None], pts_sel, 0.0)
    return jnp.where(ok, idx, -1), pts_sel, jnp.where(ok, dist, big), ok


def radius_neighbors(
    grid: HashGrid,
    points: jnp.ndarray,
    query_points: jnp.ndarray,
    radius: float,
    max_neighbors: int,
    exclude_self_index: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Up to ``max_neighbors`` nearest points within ``radius`` per query.

    Returns (indices (M, K), distances (M, K), valid_mask (M, K)); invalid
    slots have index -1 and distance +inf. The nearest-first ordering comes
    from a top-k over the 27-bucket candidate set.
    """
    idx, _, dist, ok = radius_neighbors_with_points(
        grid, points, query_points, radius, max_neighbors, exclude_self_index
    )
    return idx, dist, ok


def chunked_radius_neighbors(
    grid: HashGrid,
    points: jnp.ndarray,
    query_points: jnp.ndarray,
    radius: float,
    max_neighbors: int,
    chunk_size: int = 65536,
    exclude_self: bool = False,
):
    """Memory-bounded radius_neighbors: processes queries in chunks with
    `lax.map` so the (chunk, 27*B) candidate tensor stays small."""
    m = query_points.shape[0]
    pad = (-m) % chunk_size
    qp = jnp.pad(query_points, ((0, pad), (0, 0)))
    qi = jnp.pad(jnp.arange(m, dtype=jnp.int32), (0, pad), constant_values=-1)
    qp = qp.reshape(-1, chunk_size, 3)
    qi = qi.reshape(-1, chunk_size)

    def one(args):
        q, i = args
        return radius_neighbors(
            grid, points, q, radius, max_neighbors,
            exclude_self_index=i if exclude_self else None,
        )

    idx, dist, ok = jax.lax.map(one, (qp, qi))
    unpad = lambda a: a.reshape(-1, *a.shape[2:])[:m]
    return unpad(idx), unpad(dist), unpad(ok)
