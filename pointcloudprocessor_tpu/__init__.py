"""pointcloudprocessor_tpu — a LiDAR-camera colorization + photometric
pose-refinement engine (JAX / XLA / Pallas / pjit).

A from-scratch rebuild of the capabilities of ChunLI-666/PointCloudProcessor
(offline LiDAR-camera mapping: map crop, MLS smoothing, keyframe selection,
occlusion culling, NID photometric pose refinement, multi-view scored
colorization and fusion), re-designed as batched array programs:

* all data lives in fixed-capacity sharded arrays with validity masks
  (no ragged shapes, no filesystem hand-offs between stages),
* hot loops are batched XLA/Pallas ops (scatter-min z-buffer culling,
  B-spline joint-histogram NID as one contraction, batched MLS surface fits),
* the pose optimizer is a jittable BFGS on the SE(3) tangent space,
* multi-device scaling uses `jax.sharding.Mesh` + `shard_map` with
  `psum` collectives over keyframe and point shards.

Package layout:
    core/      SE(3)/quaternion math, SoA point-cloud container
    models/    camera projection models (pinhole + plumb_bob, ...)
    ops/       compute kernels (projection, z-buffer, histograms, voxel, MLS)
    opt/       NID objective, BFGS/Gauss-Newton SE(3) solvers, RANSAC
    parallel/  mesh construction, sharded NID / colorization
    pipeline/  ingest, keyframes, culling, colorize, fuse, orchestration
    io/        PCD / odometry / image readers and writers
    utils/     config tree, image balancing, colormaps, logging
"""

__version__ = "0.1.0"
