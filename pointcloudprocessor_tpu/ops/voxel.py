"""Voxel-grid ops: hashing, downsampling, budgeted random grid sampling.

Static-shape replacements for the reference's spatial-hash sampling
(`PointCloudProcessor/include/vlcal/common/vector3i_hash.hpp:14-37`,
`src/vlcal/common/frame_cpu.cpp:363-451` voxelgrid averaging, `:454-509`
randomgrid budgeted sampling). Instead of an unordered_map, voxels are keyed
by a 3D integer hash into a fixed-size table; collisions are resolved by
accepting the first writer per slot (scatter-min on point index), which is
the same "representative point per voxel" contract with O(1) memory.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Prime multipliers of the reference's XORCombineVector3iHash
# (vector3i_hash.hpp:14-37 uses p1=73856093, p2=19349669, p3=83492791).
_P1 = jnp.uint32(73856093)
_P2 = jnp.uint32(19349669)
_P3 = jnp.uint32(83492791)


def voxel_coords(points: jnp.ndarray, voxel_size: float) -> jnp.ndarray:
    """(N, 3) int32 voxel coordinates."""
    return jnp.floor(points / voxel_size).astype(jnp.int32)


def voxel_hash(coords: jnp.ndarray, table_size: int) -> jnp.ndarray:
    """XOR-combine spatial hash of integer voxel coords -> [0, table_size)."""
    c = coords.astype(jnp.uint32)
    h = (c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3)
    return (h % jnp.uint32(table_size)).astype(jnp.int32)


def voxel_downsample_mask(
    points: jnp.ndarray,
    valid: jnp.ndarray,
    voxel_size: float,
    table_size: int | None = None,
) -> jnp.ndarray:
    """Keep one representative (lowest-index valid) point per voxel.

    Semantics of `randomgrid_sampling` with budget 1 / `voxelgrid` dedup; the
    GUI display path uses exactly this at 3 mm
    (`visual_lidar_data.cpp:65-69`). Hash collisions merge distinct voxels
    (rate ~N/table_size); size the table ≥ 4N for <25% collisions.
    """
    n = points.shape[0]
    table_size = table_size or max(4 * n, 1024)
    h = voxel_hash(voxel_coords(points, voxel_size), table_size)
    idx = jnp.arange(n, dtype=jnp.int32)
    sink = jnp.asarray(n, jnp.int32)
    h_masked = jnp.where(valid, h, table_size)  # invalid -> sink bucket
    winners = jnp.full((table_size + 1,), sink, jnp.int32)
    winners = winners.at[h_masked].min(jnp.where(valid, idx, sink), mode="drop")
    return valid & (winners[h_masked] == idx)


def voxel_average(
    points: jnp.ndarray,
    values: jnp.ndarray,
    valid: jnp.ndarray,
    voxel_size: float,
    table_size: int,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-voxel mean of positions and attribute values (scatter-add +
    count), the contract of `voxelgrid_sampling` attribute averaging
    (`frame_cpu.cpp:363-451`).

    Returns (mean_points (T,3), mean_values (T,...), counts (T,)) over the
    hash table; empty slots have count 0.
    """
    h = voxel_hash(voxel_coords(points, voxel_size), table_size)
    h = jnp.where(valid, h, table_size)
    w = valid.astype(points.dtype)
    counts = jnp.zeros((table_size + 1,), points.dtype).at[h].add(w, mode="drop")
    sum_pts = jnp.zeros((table_size + 1, 3), points.dtype).at[h].add(points * w[:, None], mode="drop")
    vshape = values.shape[1:] if values.ndim > 1 else ()
    vw = w.reshape((-1,) + (1,) * len(vshape))
    sum_val = jnp.zeros((table_size + 1,) + vshape, points.dtype).at[h].add(values * vw, mode="drop")
    denom = jnp.maximum(counts, 1.0)
    return (
        (sum_pts / denom[:, None])[:-1],
        (sum_val / denom.reshape((-1,) + (1,) * len(vshape)))[:-1],
        counts[:-1],
    )


def randomgrid_sampling_mask(
    key: jax.Array,
    points: jnp.ndarray,
    valid: jnp.ndarray,
    voxel_resolution: float,
    sampling_rate: float,
    table_size: int | None = None,
) -> jnp.ndarray:
    """Budgeted per-voxel random sampling — `randomgrid_sampling`
    (`frame_cpu.cpp:454-509`) as a static-shape mask.

    Reference semantics reproduced: per-voxel budget
    ``ceil(rate·N / n_voxels)`` (:484), voxels at or under budget keep all
    points, over-budget voxels keep a uniform random subset (:492-497), and
    a global cap of ``1.2·rate·N`` trims by a second uniform draw
    (:500-504). ``sampling_rate >= 0.99`` is a no-op (:455-458).

    In-voxel ranking runs as one lexsort by (voxel slot, random priority)
    instead of per-voxel reservoir sampling — O(N log N) on sorted lanes
    rather than hash-map chasing.
    """
    if sampling_rate >= 0.99:
        return valid
    n = points.shape[0]
    table_size = table_size or max(4 * n, 1024)
    h = voxel_hash(voxel_coords(points, voxel_resolution), table_size)
    h = jnp.where(valid, h, table_size)  # invalid -> sink bucket
    n_valid = jnp.sum(valid.astype(jnp.int32))

    occupied = jnp.zeros((table_size + 1,), jnp.int32).at[h].max(
        valid.astype(jnp.int32), mode="drop"
    )
    n_voxels = jnp.maximum(jnp.sum(occupied[:-1]), 1)
    budget = jnp.ceil(sampling_rate * n_valid / n_voxels).astype(jnp.int32)

    k1, k2 = jax.random.split(key)
    pri = jax.random.uniform(k1, (n,))
    order = jnp.lexsort((pri, h))  # group by voxel, random order within
    h_sorted = h[order]
    pos = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate([jnp.ones((1,), bool), h_sorted[1:] != h_sorted[:-1]])
    group_start = jax.lax.cummax(jnp.where(is_start, pos, 0))
    rank_sorted = pos - group_start
    rank = jnp.zeros((n,), jnp.int32).at[order].set(rank_sorted)
    keep = valid & (rank < budget)

    # Global cap: uniform re-draw down to 1.2*rate*N when over.
    max_num = jnp.floor(1.2 * sampling_rate * n_valid).astype(jnp.int32)
    pri2 = jnp.where(keep, jax.random.uniform(k2, (n,)), jnp.inf)
    kth = jnp.sort(pri2)[jnp.clip(max_num - 1, 0, n - 1)]
    over = jnp.sum(keep.astype(jnp.int32)) > max_num
    return jnp.where(over, keep & (pri2 <= kth), keep)


def random_sampling_mask(key: jax.Array, valid: jnp.ndarray, num_samples: int) -> jnp.ndarray:
    """Uniform random subset of valid points (mask with ~num_samples True) —
    analogue of `random_sampling` (`frame_cpu.cpp:346-360`)."""
    n = valid.shape[0]
    n_valid = jnp.maximum(jnp.sum(valid.astype(jnp.int32)), 1)
    p = jnp.minimum(num_samples / n_valid, 1.0)
    return valid & (jax.random.uniform(key, (n,)) < p)
