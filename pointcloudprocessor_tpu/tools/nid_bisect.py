"""Bisect the NID evaluation cost on the device.

Times stripped-down variants of the forward NID to attribute an
evaluation's device time: projection-only, +gather, gather flavors
(take vs lax.gather sorted-hint), one-hot marginal, full forward, full
value+grad.

Usage: python -m pointcloudprocessor_tpu.tools.nid_bisect [--quick]
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import jax
import jax.numpy as jnp

from ..core import se3
from ..models import camera as cam
from ..opt import nid


def build_scene(width, height, n_pts, k):
    """Synthesize K camera-frame keyframes on device: points back-projected
    from uniform-random pixels (map order == random raster order, matching
    the bench's argsort-culled sets), textured bin images."""
    f_px = 4818.2 * (width / 4096.0)
    camera = cam.PinholeCamera(
        intrinsic=jnp.asarray([f_px, f_px, width / 2.0, height / 2.0], jnp.float32),
        distortion=jnp.zeros(5, jnp.float32),
        width=width,
        height=height,
    )

    @jax.jit
    def make(seed):
        def one(key):
            k1, k2, k3 = jax.random.split(key, 3)
            u = jax.random.uniform(k1, (n_pts,), jnp.float32, 2.0, width - 3.0)
            v = jax.random.uniform(k2, (n_pts,), jnp.float32, 2.0, height - 3.0)
            z = jax.random.uniform(k3, (n_pts,), jnp.float32, 4.0, 8.0)
            x = (u - width / 2.0) / f_px * z
            y = (v - height / 2.0) / f_px * z
            pts = jnp.stack([x, y, z], -1)
            inten = jnp.clip(
                0.5 + 0.25 * jnp.sin(0.01 * u) + 0.25 * jnp.cos(0.013 * v), 0.0, 1.0
            )
            uu = jnp.arange(width, dtype=jnp.float32)[None, :]
            vv = jnp.arange(height, dtype=jnp.float32)[:, None]
            img = jnp.clip(
                0.5 + 0.25 * jnp.sin(0.01 * uu) + 0.25 * jnp.cos(0.013 * vv), 0.0, 1.0
            )
            return pts, inten, nid.quantize_image(img, 16)

        keys = jax.random.split(jax.random.PRNGKey(seed), k)
        pts, inten, bins = jax.lax.map(one, keys)
        return pts, inten, bins

    pts, inten, bins = jax.block_until_ready(make(0))
    kfs = nid.NIDKeyframe(
        points=pts,
        intensity=inten,
        valid=jnp.ones((k, n_pts), bool),
        bin_image=bins,
    )
    return camera, kfs


def _loop(reps, body, init):
    return jax.lax.fori_loop(0, reps, body, init)


def _project_parts(camera, T, p):
    pts_cam = se3.transform_points(T, p)
    proj = cam.project(camera, pts_cam)
    knot = jnp.floor(jax.lax.stop_gradient(proj)).astype(jnp.int32)
    anchor = (
        jnp.clip(knot[:, 1], 0, camera.height - 1) * camera.width
        + jnp.clip(knot[:, 0], 0, camera.width - 1)
    )
    return proj, knot, anchor


def make_variant(name):
    """Each variant: (camera, kfs, xi, reps) -> scalar-chained fori_loop."""

    @functools.partial(jax.jit, static_argnames=("reps",))
    def run(camera, kfs, xi0, reps):
        def eval_once(x):
            T = se3.exp(x)

            def per_kf(p, t_rows, inten):
                proj, knot, anchor = _project_parts(camera, T, p)
                if name == "project":
                    return jnp.sum(proj) + jnp.sum(anchor.astype(jnp.float32))
                if name == "gather_take":
                    taps = jnp.take(t_rows, anchor, axis=0)
                    return jnp.sum(taps.astype(jnp.float32))
                if name == "gather_sorted_hint":
                    taps = jax.lax.gather(
                        t_rows,
                        anchor[:, None],
                        jax.lax.GatherDimensionNumbers(
                            offset_dims=(1,),
                            collapsed_slice_dims=(0,),
                            start_index_map=(0,),
                        ),
                        slice_sizes=(1, 2),
                        indices_are_sorted=True,
                        mode="clip",
                    )
                    return jnp.sum(taps.astype(jnp.float32))
                if name == "onehot_marginal":
                    bins = 16
                    bp = jnp.clip((inten * bins).astype(jnp.int32), 0, bins - 1)
                    hp = jnp.sum(jax.nn.one_hot(bp, bins, dtype=jnp.float32), axis=0)
                    return jnp.sum(hp) + jnp.sum(proj)
                raise ValueError(name)

            return jnp.sum(
                jax.vmap(per_kf)(kfs.points, kfs.tap_rows, kfs.intensity)
            )

        def body(_, carry):
            x, acc = carry
            s = eval_once(x)
            return (x + 1e-12 * s, acc + s)

        return _loop(reps, body, (xi0, jnp.float32(0.0)))

    return run


@functools.partial(jax.jit, static_argnames=("reps",))
def forward_only(camera, kfs, xi0, reps):
    def body(_, carry):
        x, acc = carry
        v = nid.multi_nid_loss(camera, se3.exp(x), kfs)
        return (x + 1e-12 * v, acc + v)

    return _loop(reps, body, (xi0, jnp.float32(0.0)))


def time_case(fn, camera, kfs, reps, label):
    xi0 = jnp.zeros(6, jnp.float32)
    out = jax.block_until_ready(fn(camera, kfs, xi0, reps))
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(camera, kfs, xi0, reps))
        times.append((time.perf_counter() - t0) / reps * 1e3)
    print(f"# {label}: {times[0]:.2f} / {times[1]:.2f} ms per eval", file=sys.stderr)
    return round(min(times), 2)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    from ..utils import compile_cache

    compile_cache.enable(min_compile_time_secs=10.0)

    if args.quick:
        width, height, n_pts, k = 512, 384, 32_768, 4
    else:
        width, height, n_pts, k = 4096, 3000, 262_144, 8

    camera, kfs = build_scene(width, height, n_pts, k)
    kfs_sorted = nid.sort_by_raster(camera, se3.identity(), kfs)
    kfs = nid.prepare_keyframes(kfs)
    kfs_sorted = jax.block_until_ready(nid.prepare_keyframes(kfs_sorted))
    print("# scene built", file=sys.stderr)

    r = args.reps
    res = {}
    res["project"] = time_case(make_variant("project"), camera, kfs, r, "project only")
    res["gather_take"] = time_case(
        make_variant("gather_take"), camera, kfs, r, "project + take (map order)")
    res["gather_take_sorted"] = time_case(
        make_variant("gather_take"), camera, kfs_sorted, r, "project + take (sorted)")
    res["gather_hint_sorted"] = time_case(
        make_variant("gather_sorted_hint"), camera, kfs_sorted, r,
        "project + lax.gather sorted-hint (sorted)")
    res["onehot_marginal"] = time_case(
        make_variant("onehot_marginal"), camera, kfs, r, "project + hist_points one-hot")
    res["forward"] = time_case(forward_only, camera, kfs, r, "full forward")
    res["forward_sorted"] = time_case(
        forward_only, camera, kfs_sorted, r, "full forward (sorted)")
    res["backend"] = jax.default_backend()
    res["scale"] = f"{k}x{n_pts}@{width}x{height}"
    print(json.dumps(res))


if __name__ == "__main__":
    main()
