"""Structure-of-arrays point cloud with fixed capacity + validity mask.

Array-native replacement for the reference's SoA container
(`PointCloudProcessor/include/vlcal/common/frame.hpp:63-72`,
`frame_cpu.hpp:13-216`) and for PCL clouds. XLA requires static shapes, so
every filtering stage (crop, cull, SOR, ...) returns the SAME capacity with an
updated ``valid`` mask instead of a compacted buffer; compaction happens only
at host I/O boundaries (see :mod:`pointcloudprocessor_tpu.io.pcd`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import se3


class PointCloud(NamedTuple):
    """A (possibly padded) point cloud.

    Attributes:
        points: (N, 3) float32 positions.
        intensity: (N,) float32. Zeros if the source had none.
        valid: (N,) bool. Padding / filtered-out entries are False.
        rgb: optional (N, 3) float32 colors in [0, 255].
        mask_label: optional (N,) int32 segmentation label channel
            (reference analogue: ``PointXYZRGBMask.segmentMask``,
            `PointCloudProcessor/include/FrameData.hpp:68-87`).
        normals: optional (N, 3) float32.
    """

    points: jnp.ndarray
    intensity: jnp.ndarray
    valid: jnp.ndarray
    rgb: Optional[jnp.ndarray] = None
    mask_label: Optional[jnp.ndarray] = None
    normals: Optional[jnp.ndarray] = None

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def count(self) -> jnp.ndarray:
        """Number of valid points (traced scalar)."""
        return jnp.sum(self.valid.astype(jnp.int32))


def make(
    points,
    intensity=None,
    rgb=None,
    mask_label=None,
    normals=None,
    capacity: Optional[int] = None,
    dtype=jnp.float32,
) -> PointCloud:
    """Build a :class:`PointCloud` from host arrays, padding to ``capacity``.

    Padding points are placed at the origin with ``valid=False``.
    """
    points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    n = points.shape[0]
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} < point count {n}")

    def pad(arr, fill=0):
        arr = np.asarray(arr)
        out = np.full((cap,) + arr.shape[1:], fill, dtype=arr.dtype)
        out[:n] = arr
        return out

    valid = np.zeros((cap,), dtype=bool)
    valid[:n] = True
    return PointCloud(
        points=jnp.asarray(pad(points), dtype=dtype),
        intensity=jnp.asarray(
            pad(np.asarray(intensity, dtype=np.float32)) if intensity is not None else np.zeros((cap,), np.float32),
            dtype=dtype,
        ),
        valid=jnp.asarray(valid),
        rgb=None if rgb is None else jnp.asarray(pad(np.asarray(rgb, np.float32)), dtype=dtype),
        mask_label=None if mask_label is None else jnp.asarray(pad(np.asarray(mask_label, np.int32)), dtype=jnp.int32),
        normals=None if normals is None else jnp.asarray(pad(np.asarray(normals, np.float32)), dtype=dtype),
    )


def transform(cloud: PointCloud, T: se3.SE3) -> PointCloud:
    """Rigidly transform the cloud (points and normals); analogue of
    `pcl::transformPointCloud` at `PointCloudProcessor.cpp:521` and of
    `frame_cpu.cpp:512-621`."""
    new_normals = None if cloud.normals is None else se3.quat_rotate(T.q, cloud.normals)
    return cloud._replace(points=se3.transform_points(T, cloud.points), normals=new_normals)


def and_valid(cloud: PointCloud, mask: jnp.ndarray) -> PointCloud:
    """Narrow the validity mask (the XLA-native version of 'filter')."""
    return cloud._replace(valid=jnp.logical_and(cloud.valid, mask))


def crop_box(cloud: PointCloud, min_pt: jnp.ndarray, max_pt: jnp.ndarray) -> PointCloud:
    """Axis-aligned box crop; analogue of `pcl::CropBox` use at
    `PointCloudProcessor/src/PointCloudProcessor.cpp:120-125`."""
    inside = jnp.all((cloud.points >= min_pt) & (cloud.points <= max_pt), axis=-1)
    return and_valid(cloud, inside)


def trajectory_crop(cloud: PointCloud, traj_positions: jnp.ndarray, padding: float = 2.0) -> PointCloud:
    """Crop to the trajectory bounding box inflated by ``padding`` metres —
    semantics of `PointCloudProcessor/src/PointCloudProcessor.cpp:94-125`."""
    mn = jnp.min(traj_positions, axis=0) - padding
    mx = jnp.max(traj_positions, axis=0) + padding
    return crop_box(cloud, mn, mx)


def normalize_intensity(cloud: PointCloud) -> PointCloud:
    """Min-max normalize intensities of valid points to [0, 1] — semantics of
    `PointCloudProcessor/src/vlcal/common/visual_lidar_data.cpp:87-96`
    (required before NID refinement so intensity bins are well spread)."""
    big = jnp.asarray(jnp.inf, cloud.intensity.dtype)
    mn = jnp.min(jnp.where(cloud.valid, cloud.intensity, big))
    mx = jnp.max(jnp.where(cloud.valid, cloud.intensity, -big))
    rng = jnp.maximum(mx - mn, 1e-12)
    return cloud._replace(intensity=jnp.clip((cloud.intensity - mn) / rng, 0.0, 1.0))


# ---------------------------------------------------------------------------
# Host-side (un)packing
# ---------------------------------------------------------------------------


def compact(cloud: PointCloud) -> PointCloud:
    """Drop invalid rows (host-side; NOT jittable — use at I/O boundaries)."""
    v = np.asarray(cloud.valid)
    idx = np.flatnonzero(v)

    def take(a):
        return None if a is None else jnp.asarray(np.asarray(a)[idx])

    return PointCloud(
        points=take(cloud.points),
        intensity=take(cloud.intensity),
        valid=jnp.ones((len(idx),), dtype=bool),
        rgb=take(cloud.rgb),
        mask_label=take(cloud.mask_label),
        normals=take(cloud.normals),
    )


def pad_to(cloud: PointCloud, capacity: int) -> PointCloud:
    """Pad (host-side) to a fixed capacity for static-shape pipelines."""
    n = cloud.points.shape[0]
    if n == capacity:
        return cloud
    if n > capacity:
        raise ValueError(f"cloud size {n} exceeds capacity {capacity}")

    def pad(a, fill=0):
        if a is None:
            return None
        a = np.asarray(a)
        out = np.full((capacity,) + a.shape[1:], fill, dtype=a.dtype)
        out[:n] = a
        return jnp.asarray(out)

    return PointCloud(
        points=pad(cloud.points),
        intensity=pad(cloud.intensity),
        valid=pad(cloud.valid, fill=False),
        rgb=pad(cloud.rgb),
        mask_label=pad(cloud.mask_label),
        normals=pad(cloud.normals),
    )
