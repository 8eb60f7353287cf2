"""Probe: costs that size the round-5 frozen-cache redesign (wide windows
+ partial refresh), measured on the current backend at bench scale.

Questions this answers (each an assumption the wide-window tap cache rests
on — see opt/nid.py):

1. ROW-WIDTH TAX — does the per-index cost of `jnp.take` of (R, w) int32
   rows stay flat as w grows from 2 (today's nibble-packed 4x4 window) to
   8 (an 8x8 window with +-2 px of anchor margin)? If it does, a margin-2
   window costs the SAME per gather and absorbs +-2 px of drift for free.

2. WIDE-TABLE BUILD — the (H*W, 8) window table is a 64-tap stencil of the
   bin image (8 shifted ORs per word plane). Per-keyframe build cost bounds
   how often a solve can rebuild it (once at entry vs per refresh).

3. PARTIAL-REFRESH REALITY CHECK — the block-granular partial refresh
   (opt/nid._partial_refresh_taps) only wins when drifted points cluster
   into blocks. At sub-pixel uniform motion the >=1 px crossing set is
   FRACTIONAL-PART random (a point crosses iff frac(u) lands in the shift
   band), so dirty-block fractions should be ~1 even at low drift — this
   measures the actual dirty fraction and the partial path's cost so the
   decision is recorded with numbers, not reasoning.

Timing: chained reps inside one jit with an UNFOLDABLE data dependence and
fully-consumed outputs.

Usage:
  python -m pointcloudprocessor_tpu.tools.tap_cache_probe [--quick]
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..core import se3
from ..models import camera as cam
from ..opt import nid
from .nid_bisect import build_scene


@functools.partial(jax.jit, static_argnames=("reps", "width"))
def timed_take_width(table, idx0, reps, width):
    """Chained row takes from an (R, width) table, 2.1M indices.

    The chain perturbs the NEXT iteration's indices by sum(taps) & 1 — not
    constant-foldable, and the whole output is consumed (CLAUDE.md: a
    partially-consumed gather gets sliced, a foldable chain decomposes)."""

    def body(_, carry):
        idx, acc = carry
        taps = jnp.take(table, idx, axis=0)  # (N, width)
        s = jnp.sum(taps, dtype=jnp.int32)
        idx2 = jnp.clip(idx0 + (s & 1), 0, table.shape[0] - 1)
        return (idx2, acc + s)

    return jax.lax.fori_loop(0, reps, body, (idx0, jnp.int32(0)))


def build_wide_planes(bin_image: jnp.ndarray, margin: int):
    """(H, W) bin image -> (rows, H*W) int32 word planes for the wide
    window: word r of pixel p = nibble-packed bins at rows (y + r - 1 -
    margin), columns (x - 1 - margin .. x + 2 + margin) — 8 nibbles/word,
    window (4+2*margin)^2 requires 4+2*margin words of 8 nibbles when
    width <= 8 (margin <= 2)."""
    h, w = bin_image.shape
    rows = 4 + 2 * margin
    assert rows <= 8
    p = jnp.pad(
        bin_image, ((1 + margin, 2 + margin), (1 + margin, 2 + margin)),
        mode="edge",
    ).astype(jnp.uint32)
    planes = []
    for r in range(rows):
        word = jnp.zeros((h, w), jnp.uint32)
        for j in range(rows):
            tap = p[r: r + h, j: j + w]
            word = word | (tap << jnp.uint32(4 * j))
        planes.append(word.reshape(-1).astype(jnp.int32))
    return jnp.stack(planes, axis=0)  # (rows, H*W)


@functools.partial(jax.jit, static_argnames=("reps", "margin"))
def timed_wide_build(bin_images, seed, reps, margin):
    """Chained wide-table builds for K bin images (the per-solve cost)."""

    def body(_, carry):
        img0, acc = carry

        def one(img):
            return jnp.sum(build_wide_planes(img, margin), dtype=jnp.int32)

        s = jnp.sum(jax.vmap(one)(img0), dtype=jnp.int32)
        # Unfoldable chain: flip bit 0 of every bin by the parity of the
        # previous build's sum (build cost is data-independent).
        return (img0 ^ (s & 1), acc + s)

    return jax.lax.fori_loop(0, reps, body, (bin_images, jnp.int32(seed)))


@functools.partial(
    jax.jit, static_argnames=("reps", "partial_frac", "px_step", "refresh")
)
def timed_refresh(camera, kfs, xi0, reps, partial_frac, px_step, refresh=True):
    """Chained cached-loss evaluations with a pose that translates by
    ~px_step pixels per iteration (guard_frac=0 -> every iteration
    refreshes; refresh=False pins allow_refresh off for the pure frozen
    eval cost). partial_frac selects the refresh path. Returns the final
    cache counters so drift fractions and partial counts are observable."""
    cache0 = nid.make_tap_cache(camera, se3.exp(xi0), kfs)
    # ~px_step pixels at the scene's mean depth (6 m) and focal length.
    f_px = camera.intrinsic[0]
    dx = px_step * 6.0 / f_px

    def body(i, carry):
        xi, acc, cache = carry
        T = se3.exp(xi)
        loss, cache = nid.multi_nid_loss_cached(
            camera, T, kfs, cache, guard_frac=0.0,
            allow_refresh=jnp.asarray(refresh),
            partial_frac=partial_frac,
        )
        xi2 = xi.at[0].add(dx + 1e-9 * (loss - jax.lax.stop_gradient(loss)))
        xi2 = xi2.at[1].add(1e-12 * loss)  # unfoldable chain through loss
        return (xi2, acc + loss, cache)

    return jax.lax.fori_loop(0, reps, body, (xi0, jnp.float32(0.0), cache0))


def run(fn, label, reps, floor_ms=0.5):
    """Time fn(attempt) with FRESH inputs per attempt and a physical
    floor."""
    out = jax.block_until_ready(fn(0))
    times = []
    attempt = 1
    while len(times) < 3 and attempt < 9:
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(attempt))
        dt = (time.perf_counter() - t0) / reps * 1e3
        attempt += 1
        if dt < floor_ms:
            print(f"# bogus wall for {label}: {dt:.3f} ms — retry",
                  file=sys.stderr)
            continue
        times.append(dt)
    med = sorted(times)[len(times) // 2] if times else float("nan")
    print(f"# {label}: {'/'.join(f'{t:.3f}' for t in times)} "
          f"-> {med:.3f} ms/rep", file=sys.stderr)
    return med, out


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
    reps = args.reps
    out = {"backend": jax.default_backend(),
           "scale": f"{k}x{n_pts}@{width}x{height}"}

    # --- 1. row-width tax -------------------------------------------------
    r = width * height
    key = jax.random.PRNGKey(0)
    idx0 = jax.random.randint(key, (k * n_pts,), 0, r, jnp.int32)
    idx0 = jax.block_until_ready(jnp.sort(idx0))
    for w in (2, 4, 8):
        table = jax.block_until_ready(
            jax.random.randint(jax.random.PRNGKey(w), (r, w), -(2**31), 2**31 - 1,
                               jnp.int32)
        )
        ms, (_, acc) = run(
            lambda a, t=table, w_=w: timed_take_width(
                t, jnp.minimum(idx0 + a, r - 1), reps, w_
            ),
            f"take (R,{w}) rows, {k * n_pts / 1e6:.1f}M sorted idx", reps,
            floor_ms=2.0,
        )
        out[f"take_w{w}_ms"] = round(ms, 3)
        del table

    # --- 2. wide-table build ----------------------------------------------
    camera, kfs = build_scene(width, height, n_pts, k)
    kfs = jax.jit(nid.prepare_keyframes)(kfs)
    jax.block_until_ready(kfs.tap_rows)
    build_reps = max(reps // 2, 2)
    ms, _ = run(
        lambda a: timed_wide_build(
            kfs.bin_image ^ (a & 1), 0, build_reps, 2
        ),
        f"wide margin-2 table build, {k} keyframes", build_reps,
        floor_ms=1.0,
    )
    out["wide_build_ms"] = round(ms, 3)

    # --- 3. partial refresh reality check -----------------------------------
    xi_base = jnp.asarray([0.01, -0.005, 0.002, 0.001, -0.001, 0.001], jnp.float32)

    def xi_at(a):
        return xi_base.at[1].add(1e-6 * a)

    def refresh_case(kk, pf, px, tag, refresh=True):
        ms, (_, acc, cache) = run(
            lambda a: timed_refresh(camera, kk, xi_at(a), reps, pf, px, refresh),
            tag, reps, floor_ms=1.0,
        )
        return ms, acc, cache

    for px in (0.1, 0.33):
        for pf, tag in ((0.0, "full"), (1.0, "partial")):
            ms, acc, cache = refresh_case(
                kfs, pf, px, f"cached eval + refresh/iter, {px} px/iter, {tag}"
            )
            out[f"refresh_{tag}_{px}px_ms"] = round(ms, 3)
            if pf:
                out[f"refresh_partial_{px}px_count"] = int(cache.partials)
            out[f"refresh_{tag}_{px}px_drift"] = round(
                float(cache.drift_accum) / max(int(cache.refreshes), 1), 4
            )
        # ON-CHIP exactness tripwire at a FIXED input: partial and full
        # refresh paths must produce bitwise-equal chained losses.
        a_full = jax.block_until_ready(
            timed_refresh(camera, kfs, xi_at(99), reps, 0.0, px)
        )[1]
        a_part = jax.block_until_ready(
            timed_refresh(camera, kfs, xi_at(99), reps, 1.0, px)
        )[1]
        assert float(a_full) == float(a_part), (px, a_full, a_part)

    # Pure frozen-eval cost, margin 0 (allow_refresh False): the comparator
    # for the wide select penalty below.
    ms, _, _ = refresh_case(
        kfs, 0.0, 0.33, "frozen eval m=0, NO refresh", refresh=False
    )
    out["frozen_eval_m0_ms"] = round(ms, 3)

    # --- 4. WIDE margin-2 cache -------------------------------------------
    # (a) pure select-eval cost (no refreshes allowed);
    # (b) sub-margin motion with the guard live (margin absorbs refreshes);
    # (c) super-margin motion: the wide full-refresh cost per eval.
    kfs_wide = jax.jit(
        functools.partial(nid.prepare_keyframes, wide_margin=2)
    )(kfs)
    jax.block_until_ready(kfs_wide.tap_wide)
    for px, tag, refresh in (
        (0.33, "noref", False), (0.33, "inmargin", True), (3.5, "refresh", True)
    ):
        ms, _, cache = refresh_case(
            kfs_wide, 0.0, px, f"WIDE m=2 cached eval, {px} px/iter, {tag}",
            refresh=refresh,
        )
        out[f"wide_{tag}_ms"] = round(ms, 3)
        out[f"wide_{tag}_refreshes"] = int(cache.refreshes)
        # (Exactness of the wide select vs fresh gathers is asserted
        # bit-level by the CPU tests; chain accumulators here differ
        # legitimately via the inlier gate's refresh timing.)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
