"""Device mesh construction and sharding helpers.

The reference is single-process: its only parallelism is OpenMP thread teams
(keyframe NID costs `visual_camera_calibration.cpp:110-114`, RANSAC
hypotheses `estimate_pose.cpp:99-131`, color smoothing
`PointCloudProcessor.cpp:647-694`). Here the same work scales across
devices instead:

* axis ``kf`` — keyframes (the OpenMP-over-costs analogue): each device
  evaluates NID for its keyframe shard; residuals/gradients `psum` across
  devices.
* axis ``pt`` — map points (data parallel over the long axis): histograms
  and fusion registers are point-sharded, reduced with `psum` where needed.

The mesh only reshapes the device list: the GPUs of one host are joined
all to all (NVLink), so no device order is better than another and the
mesh shape follows the algorithm alone. Multi-process:
`jax.distributed.initialize()` + the same mesh spanning all processes (no
file round-trips, unlike the reference's ASCII-PCD hand-offs,
`PointCloudProcessor.cpp:213-222`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

KF_AXIS = "kf"
PT_AXIS = "pt"


def make_mesh(
    kf: Optional[int] = None,
    pt: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (kf, pt) mesh over the available devices.

    Defaults: all devices on the ``kf`` axis (keyframe parallelism scales
    first — it is the reference's dominant OpenMP site).
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if kf is None and pt is None:
        kf, pt = n, 1
    elif kf is None:
        kf = n // pt
    elif pt is None:
        pt = n // kf
    if kf * pt != n:
        raise ValueError(f"mesh {kf}x{pt} != {n} devices")
    arr = np.asarray(devices).reshape(kf, pt)
    return Mesh(arr, (KF_AXIS, PT_AXIS))


def keyframe_sharding(mesh: Mesh) -> NamedSharding:
    """Leading axis = keyframes; within a keyframe, points over ``pt``."""
    return NamedSharding(mesh, P(KF_AXIS, PT_AXIS))


def point_sharding(mesh: Mesh) -> NamedSharding:
    """Leading axis = map points, spread over the whole mesh."""
    return NamedSharding(mesh, P((KF_AXIS, PT_AXIS)))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def init_distributed() -> None:
    """Multi-process entry: initialize the jax.distributed runtime (a no-op
    in single-process runs). Call before device queries."""
    try:
        jax.distributed.initialize()
    except (ValueError, RuntimeError):
        pass  # single-process / already initialized
