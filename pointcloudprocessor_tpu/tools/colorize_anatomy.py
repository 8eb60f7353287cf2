"""Colorize/fusion cost anatomy at reference scale (1M map points,
4096x3000 images): the per-point image sample is a 1M-row `jnp.take` per
keyframe, and the z-buffer cull is a scatter-min. This tool times nested
prefixes of `observe_keyframe` (pipeline/colorize.py) over the bench
scene's keyframe scan:

  project : SE3 transform + projection + score (elementwise)
  cull    : + z-buffer scatter-min visibility (ops/zbuffer.cull_mask_uv)
  pack    : + image pack to one int32/pixel (12.3M-pixel pass / keyframe)
  sample  : + the per-point color gather packed[flat] (1M rows / keyframe)
  fuse    : + top-K register update + final blend (= pipeline's fuse)

Successive differences attribute cost. Protocol: chained reps in one jit,
median of 3, floors.

Usage: python -m pointcloudprocessor_tpu.tools.colorize_anatomy [--quick]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from ..utils import compile_cache

    compile_cache.enable(min_compile_time_secs=10.0)

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from bench import build_bench_scene

    from ..core import se3
    from ..models import camera as cam
    from ..ops import fusion, zbuffer
    from ..pipeline import colorize

    if args.quick:
        width, height, n_map, n_cull, k = 512, 384, 100_000, 32_768, 4
    else:
        width, height, n_map, n_cull, k = 4096, 3000, 1_000_000, 262_144, 8

    camera, poses, points, inten, valid, images, kfs, T0 = build_bench_scene(
        width, height, n_map, n_cull, k
    )
    reps = args.reps

    def stage_fn(points_in, images_in, poses_q, poses_t, stage):
        def step(acc, inputs):
            image, q, t = inputs
            T_w2c = se3.inverse(se3.SE3(q, t))
            x, y, z = se3.transform_xyz(
                T_w2c, points_in[..., 0], points_in[..., 1], points_in[..., 2]
            )
            rng_ = jnp.sqrt(x * x + y * y + z * z)
            u, v = cam.project_xyz(camera, x, y, z)
            score = fusion.final_score_xyz(x, y, z, rng_, t)
            out = jnp.sum(score) + jnp.sum(u) + jnp.sum(v)
            if stage != "project":
                vis = zbuffer.cull_mask_uv(
                    camera, u, v, z, rng_, valid,
                    downsample_factor=14, depth_epsilon=0.05,
                )
                out = out + jnp.sum(vis.astype(jnp.float32))
            if stage in ("pack", "sample"):
                packed = fusion.pack_image_rgb(image)
                out = out + packed[0].astype(jnp.float32)
            if stage == "sample":
                ui = jnp.clip(u.astype(jnp.int32), 0, width - 1)
                vi = jnp.clip(v.astype(jnp.int32), 0, height - 1)
                rgb_packed = packed[vi * width + ui]
                out = out + jnp.sum((rgb_packed & 0xFF).astype(jnp.float32))
            return acc + out, None

        acc, _ = jax.lax.scan(
            step, jnp.float32(0.0), (images_in, poses_q, poses_t)
        )
        return acc

    @functools.partial(jax.jit, static_argnames=("stage", "reps"))
    def chain(points_in, images_in, poses_q, poses_t, stage, reps):
        def body(i, carry):
            p, acc = carry
            if stage == "fuse":
                fz = colorize.fuse(
                    camera, p, valid, images_in, se3.SE3(poses_q, poses_t),
                    se3.identity(),
                )
                out = jnp.sum(fz.rgb) + jnp.sum(fz.colored.astype(jnp.float32))
            else:
                out = stage_fn(p, images_in, poses_q, poses_t, stage)
            eps = 1e-10 * jnp.tanh(out)
            return (p + eps, acc + out)

        _, acc = jax.lax.fori_loop(
            0, reps, body, (points_in, jnp.float32(0.0))
        )
        return acc

    scale = (n_map * k) / 8e6
    floors = {"project": 0.002 * scale, "cull": 0.004 * scale,
              "pack": 0.006 * scale, "sample": 0.008 * scale,
              "fuse": 0.02 * scale}

    results = {}
    for stage in ("project", "cull", "pack", "sample", "fuse"):
        chain(points, images, poses.q, poses.t, stage, reps).block_until_ready()
        print(f"# {stage} compiled", file=sys.stderr)
        walls, tries = [], 0
        while len(walls) < 3 and tries < 6:
            p_in = points + 1e-6 * (tries + 1)
            t0 = time.perf_counter()
            chain(p_in, images, poses.q, poses.t, stage, reps).block_until_ready()
            dt = time.perf_counter() - t0
            tries += 1
            if dt < floors[stage] * reps:
                print(f"# bogus wall for {stage}: {dt*1e3:.1f} ms — retry",
                      file=sys.stderr)
                continue
            walls.append(dt / reps)
        results[stage] = sorted(walls)[len(walls) // 2] if walls else float("nan")
        print(json.dumps({"stage": stage, "s": round(results[stage], 4),
                          "calls": [round(w, 4) for w in walls]}))

    pr, cu, pa, sa, fu = (results[s] for s in
                          ("project", "cull", "pack", "sample", "fuse"))
    print(json.dumps({
        "metric": "colorize_anatomy_ms_per_frame",
        "k": k, "n_map": n_map,
        "project": round(pr / k * 1e3, 2),
        "zbuffer_scatter": round((cu - pr) / k * 1e3, 2),
        "image_pack": round((pa - cu) / k * 1e3, 2),
        "sample_gather": round((sa - pa) / k * 1e3, 2),
        "topk_blend": round((fu - sa) / k * 1e3, 2),
        "full": round(fu / k * 1e3, 2),
    }))


if __name__ == "__main__":
    main()
