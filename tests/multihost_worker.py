"""Worker for the multi-process `jax.distributed` test (see
test_multihost.py). Launched twice: `python multihost_worker.py <proc> <port>`.

Each process owns 2 virtual CPU devices; together they form the same
(kf=2, pt=2) mesh a 2-host deployment would, with cross-process collectives
over Gloo standing in for the network. The sharded NID loss must match the
single-process value computed from the identical full arrays.
"""

import os
import sys


def main():
    proc, port = int(sys.argv[1]), sys.argv[2]
    mode = sys.argv[3] if len(sys.argv) > 3 else "normal"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}", num_processes=2, process_id=proc
    )
    if mode == "failover":
        return failover_main(proc)
    import jax.numpy as jnp
    import numpy as np

    from pointcloudprocessor_tpu.core import se3
    from pointcloudprocessor_tpu.opt import nid
    from pointcloudprocessor_tpu.parallel import mesh as mesh_lib
    from pointcloudprocessor_tpu.parallel import nid_shard

    from synthetic import simple_camera
    from test_nid import make_keyframe, nid_scene

    camera = simple_camera()
    pts, inten, img = nid_scene(camera)
    kf = make_keyframe(camera, pts, inten, img)
    k = 2
    full = nid.NIDKeyframe(
        points=np.broadcast_to(np.asarray(kf.points), (k,) + kf.points.shape),
        intensity=np.broadcast_to(np.asarray(kf.intensity), (k,) + kf.intensity.shape),
        valid=np.broadcast_to(np.asarray(kf.valid), (k,) + kf.valid.shape),
        bin_image=np.broadcast_to(np.asarray(kf.bin_image), (k,) + kf.bin_image.shape),
    )

    mesh = mesh_lib.make_mesh(kf=2, pt=2)  # 4 global devices over 2 processes

    def place(arr, sharding):
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx]
        )

    kf_pt = mesh_lib.keyframe_sharding(mesh)
    kf_only = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(mesh_lib.KF_AXIS)
    )
    kfs = nid.NIDKeyframe(
        points=place(full.points, kf_pt),
        intensity=place(full.intensity, kf_pt),
        valid=place(full.valid, kf_pt),
        bin_image=place(full.bin_image, kf_only),
    )

    T = se3.exp(jnp.asarray([0.01, -0.005, 0.002, 0.003, -0.001, 0.002], jnp.float32))
    sharded = float(nid_shard.sharded_multi_nid_loss(camera, T, kfs, mesh))

    # Single-process reference from the identical full arrays (local CPU).
    local = float(
        nid.multi_nid_loss(
            camera,
            T,
            nid.NIDKeyframe(
                jnp.asarray(full.points),
                jnp.asarray(full.intensity),
                jnp.asarray(full.valid),
                jnp.asarray(full.bin_image),
            ),
        )
    )
    ok = abs(sharded - local) < 1e-4

    # Pose-graph smoother across the same 2-process mesh: unary blocks
    # assemble on their home shard, chain solve replicated.
    from pointcloudprocessor_tpu.opt import pose_graph
    from pointcloudprocessor_tpu.parallel import pose_graph_shard

    rng = np.random.default_rng(7)  # same seed on both processes
    kk = 4
    tang = np.cumsum(
        rng.uniform(-0.2, 0.4, size=(kk, 6)).astype(np.float32), axis=0
    )
    c2w = se3.exp(jnp.asarray(tang))
    noise = rng.normal(0, 0.01, size=(kk, 6)).astype(np.float32)
    meas = se3.compose(c2w, se3.exp(jnp.asarray(noise)))
    odo = pose_graph.relative_measurements(c2w)
    repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())

    def place_repl(x):
        arr = np.asarray(x)
        return jax.make_array_from_callback(arr.shape, repl, lambda idx: arr[idx])

    pg_sharded = pose_graph_shard.optimize_sharded(
        mesh,
        se3.SE3(place_repl(c2w.q), place_repl(c2w.t)),
        se3.SE3(place_repl(odo.q), place_repl(odo.t)),
        se3.SE3(place_repl(meas.q), place_repl(meas.t)),
        abs_weight=place_repl(np.ones(kk, np.float32)),
        iterations=4,
    )
    pg_local = pose_graph.optimize(
        c2w, odo, meas, abs_weight=jnp.ones(kk), iterations=4
    )
    pg_err = float(
        jnp.max(jnp.abs(jnp.asarray(pg_sharded.poses.t) - pg_local.poses.t))
    )
    pg_ok = pg_err < 5e-3

    ok = ok and pg_ok
    print(f"proc {proc}: sharded={sharded:.6f} local={local:.6f} "
          f"pose_graph_err={pg_err:.2e} "
          f"{'MULTIHOST_OK' if ok else 'MULTIHOST_MISMATCH'}", flush=True)
    sys.exit(0 if ok else 1)


def failover_main(proc):
    """Failure-detection drill (SURVEY §5: the reference has none): process 1
    dies abruptly (os._exit, no shutdown handshake) between sharded-NID
    iterations; process 0 must NOT hang — the next collective must raise a
    diagnosable error, which a production driver answers by re-running the
    stage from its checkpoint artifacts (pipeline --resume)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pointcloudprocessor_tpu.core import se3
    from pointcloudprocessor_tpu.opt import nid
    from pointcloudprocessor_tpu.parallel import mesh as mesh_lib
    from pointcloudprocessor_tpu.parallel import nid_shard

    from synthetic import simple_camera
    from test_nid import make_keyframe, nid_scene

    camera = simple_camera()
    pts, inten, img = nid_scene(camera)
    kf = make_keyframe(camera, pts, inten, img)
    k = 2
    full = nid.NIDKeyframe(
        points=np.broadcast_to(np.asarray(kf.points), (k,) + kf.points.shape),
        intensity=np.broadcast_to(np.asarray(kf.intensity), (k,) + kf.intensity.shape),
        valid=np.broadcast_to(np.asarray(kf.valid), (k,) + kf.valid.shape),
        bin_image=np.broadcast_to(np.asarray(kf.bin_image), (k,) + kf.bin_image.shape),
    )
    mesh = mesh_lib.make_mesh(kf=2, pt=2)
    kf_pt = mesh_lib.keyframe_sharding(mesh)
    kf_only = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(mesh_lib.KF_AXIS)
    )

    def place(arr, sharding):
        return jax.make_array_from_callback(arr.shape, sharding, lambda idx: arr[idx])

    kfs = nid.NIDKeyframe(
        points=place(full.points, kf_pt),
        intensity=place(full.intensity, kf_pt),
        valid=place(full.valid, kf_pt),
        bin_image=place(full.bin_image, kf_only),
    )
    T = se3.exp(jnp.asarray([0.01, -0.005, 0.002, 0.003, -0.001, 0.002], jnp.float32))

    for it in range(4):
        if proc == 1 and it == 2:
            print("proc 1: dying mid-solve (no handshake)", flush=True)
            sys.stdout.flush()
            os._exit(42)
        try:
            val = float(nid_shard.sharded_multi_nid_loss(camera, T, kfs, mesh))
            print(f"proc {proc}: iter {it} nid={val:.6f}", flush=True)
        except Exception as e:  # the survivor's detection path
            msg = f"{type(e).__name__}: {e}"
            print(f"proc {proc}: FAILURE_DETECTED at iter {it} -> {msg[:300]}",
                  flush=True)
            # os._exit: the normal interpreter exit runs jax.distributed's
            # atexit shutdown BARRIER, which can only fail on a cluster with
            # a dead peer (and kills the process with a fatal log). The drill
            # asserts detection; a real driver would now re-launch the stage
            # from its checkpoint artifacts.
            os._exit(0)
    # Reaching here on proc 0 means the dead peer went unnoticed.
    print(f"proc {proc}: NO_FAILURE_DETECTED", flush=True)
    sys.exit(1 if proc == 0 else 0)


if __name__ == "__main__":
    main()
