"""Multi-device scaling benchmark: sharded NID refine + sharded fusion.

Measures the BASELINE.md scaling targets: throughput at 1 / 2 / N devices
and parallel efficiency. On real GPUs this measures interconnect
scaling; on a single-chip or CPU host, pass ``--virtual N`` to run on N
virtual CPU devices — that validates the SPMD path end-to-end (shardings,
collectives, convergence) but NOT speedup, since virtual devices share the
host's cores (efficiency numbers are only meaningful on real chips).

Prints one JSON object per device count plus a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def run_once(n_devices: int, k: int, n_points: int, width: int, height: int,
             inner: int, outer: int, kf_ax: int | None = None, frozen=False,
             c2f=False) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..core import se3
    from ..models import camera as cam
    from ..opt import nid
    from ..parallel import fusion_shard, mesh as mesh_lib, nid_shard

    devices = jax.devices()[:n_devices]
    if kf_ax is None:
        kf_ax = min(k, n_devices)
        while n_devices % kf_ax:
            kf_ax -= 1
    pt_ax = n_devices // kf_ax
    mesh = mesh_lib.make_mesh(kf=kf_ax, pt=pt_ax, devices=devices)

    camera = cam.PinholeCamera(
        jnp.asarray([width / 2.0, width / 2.0, width / 2.0, height / 2.0], jnp.float32),
        jnp.zeros(5, jnp.float32), width, height,
    )
    f_px, wall_z = width / 2.0, 5.0

    # Key passed as an ARGUMENT: a zero-arg jit is fully constant-folded at
    # compile time.
    @jax.jit
    def make(key):
        k1, k2 = jax.random.split(key)
        u = jax.random.uniform(k1, (n_points,), jnp.float32, 2.0, width - 2.0)
        v = jax.random.uniform(k2, (n_points,), jnp.float32, 2.0, height - 2.0)
        x = (u - width / 2.0) / f_px * wall_z
        y = (v - height / 2.0) / f_px * wall_z
        pts = jnp.stack([x, y, jnp.full_like(x, wall_z)], -1)
        inten = jnp.clip(0.5 + 0.25 * jnp.sin(7 * x) + 0.25 * jnp.cos(9 * y), 0, 1)
        uu = (jnp.arange(width, dtype=jnp.float32) - width / 2.0) / f_px * wall_z
        vv = (jnp.arange(height, dtype=jnp.float32) - height / 2.0) / f_px * wall_z
        gray = jnp.clip(0.5 + 0.25 * jnp.sin(7 * uu[None]) + 0.25 * jnp.cos(9 * vv[:, None]), 0, 1)
        return pts, inten, gray

    pts, inten, gray = jax.block_until_ready(make(jax.random.PRNGKey(0)))
    bin_img = nid.quantize_image(gray, 16)
    images = jnp.broadcast_to((gray[..., None] * 255).astype(jnp.uint8), (k, height, width, 3))

    kf_pt = NamedSharding(mesh, P(mesh_lib.KF_AXIS, mesh_lib.PT_AXIS))
    kf_only = NamedSharding(mesh, P(mesh_lib.KF_AXIS))
    pt_only = NamedSharding(mesh, P(mesh_lib.PT_AXIS))
    kfs = nid.NIDKeyframe(
        points=jax.device_put(jnp.broadcast_to(pts, (k, n_points, 3)), kf_pt),
        intensity=jax.device_put(jnp.broadcast_to(inten, (k, n_points)), kf_pt),
        valid=jax.device_put(jnp.ones((k, n_points), bool), kf_pt),
        bin_image=jax.device_put(jnp.broadcast_to(bin_img, (k, height, width)), kf_only),
    )
    poses = se3.SE3(
        q=jax.device_put(jnp.tile(jnp.asarray([[1.0, 0, 0, 0]], jnp.float32), (k, 1)), kf_only),
        t=jax.device_put(jnp.zeros((k, 3), jnp.float32), kf_only),
    )
    T0 = se3.exp(jnp.asarray([0.02, -0.01, 0.01, 0.004, -0.002, 0.004], jnp.float32))
    map_pts = jax.device_put(pts, pt_only)
    map_valid = jax.device_put(jnp.ones((n_points,), bool), pt_only)

    def step():
        res = nid_shard.refine_pose_sharded(
            camera, kfs, T0, mesh,
            max_inner_iterations=inner, max_outer_iterations=outer,
            frozen_taps=frozen,
            # --c2f: the bench headline's frozen+coarse-to-fine schedule,
            # multi-device twin (VERDICT r3 #3). Stride 2 keeps the
            # subsampled shard divisible at every mesh shape.
            coarse_outer_iterations=1 if c2f else 0,
            coarse_stride=2,
        )
        fused = fusion_shard.fuse_sharded(
            camera, map_pts, map_valid, images, poses, res.T_camera_lidar, mesh,
            downsample_factor=4, depth_epsilon=0.25,
        )
        return res, fused

    res, fused = step()
    jax.block_until_ready((res.T_camera_lidar.t, fused.rgb))  # compile
    t0 = time.perf_counter()
    res, fused = step()
    jax.block_until_ready((res.T_camera_lidar.t, fused.rgb))
    dt = time.perf_counter() - t0
    return {
        "devices": n_devices,
        "mesh": {"kf": kf_ax, "pt": pt_ax},
        "seconds": round(dt, 4),
        "frames_per_s": round(k / dt, 3),
        "nid": round(float(res.nid), 4),
        "colored": int(fused.colored.sum()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-device scaling benchmark")
    ap.add_argument("--virtual", type=int, default=0,
                    help="use N virtual CPU devices (validates SPMD, not speedup)")
    ap.add_argument("--keyframes", type=int, default=8)
    ap.add_argument("--points", type=int, default=65536)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=768)
    ap.add_argument("--inner", type=int, default=10)
    ap.add_argument("--outer", type=int, default=2)
    ap.add_argument("--frozen", action="store_true",
                    help="run the refine with frozen_taps=True (the guarded "
                         "frozen-gather objective; cache shards with the "
                         "points, parallel/nid_shard.make_sharded_frozen)")
    ap.add_argument("--c2f", action="store_true",
                    help="coarse-to-fine schedule (1 coarse outer, stride 2) "
                         "— with --frozen this is the bench headline's "
                         "frozen+c2f config, multi-device")
    ap.add_argument("--sweep-shapes", action="store_true",
                    help="also sweep every (kf x pt) mesh factorization at "
                    "the max device count and assert NID equality")
    args = ap.parse_args(argv)

    if args.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual}"
        )
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax

    avail = len(jax.devices())
    counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= avail]
    results = []
    for c in counts:
        r = run_once(c, args.keyframes, args.points, args.width, args.height,
                     args.inner, args.outer, frozen=args.frozen,
                     c2f=args.c2f)
        results.append(r)
        print(json.dumps(r))
    if len(results) > 1:
        base = results[0]["frames_per_s"]
        last = results[-1]
        eff = last["frames_per_s"] / (base * last["devices"])
        print(json.dumps({
            "metric": "scaling_efficiency",
            "devices": last["devices"],
            "value": round(eff, 3),
            "note": "meaningful only on real chips" if args.virtual else "",
        }))

    if args.sweep_shapes:
        # Mesh-SHAPE sweep at the max device count (VERDICT r2 #6): every
        # (kf x pt) factorization, certifying the point-axis histogram-psum
        # path (`parallel/nid_shard.py`) beyond kf-only sharding. The NID
        # must be IDENTICAL across shapes (same f32 psum tree per keyframe).
        n = counts[-1]
        shape_results = []
        for kf_ax in [d for d in range(1, n + 1) if n % d == 0 and d <= args.keyframes]:
            r = run_once(n, args.keyframes, args.points, args.width,
                         args.height, args.inner, args.outer, kf_ax=kf_ax,
                         frozen=args.frozen, c2f=args.c2f)
            shape_results.append(r)
            print(json.dumps(r))
        nids = [r["nid"] for r in shape_results]
        spread = max(nids) - min(nids)
        ok = spread < 1e-3
        print(json.dumps({
            "metric": "mesh_shape_nid_spread",
            "devices": n,
            "shapes": [f"{r['mesh']['kf']}x{r['mesh']['pt']}" for r in shape_results],
            "value": round(spread, 6),
            "equal": ok,
        }))
        if not ok:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
