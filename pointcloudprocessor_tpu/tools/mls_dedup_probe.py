"""A/B the dedup candidate fetch on the full MLS pass (VERDICT r4 #2).

Runs `ops/mls.mls_smooth` (moments fit) with and without
``dedup_candidates`` on the hardened bench MLS scene, chained-timed
(CLAUDE.md protocol), and asserts the outputs are BIT-identical — the
dedup path must be a pure cost change.

Usage: python -m pointcloudprocessor_tpu.tools.mls_dedup_probe [--quick]
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
    import numpy as np

    from ..utils import compile_cache

    compile_cache.enable(min_compile_time_secs=10.0)

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from bench import _mls_scene

    from ..ops import mls
    from ..utils.config import MLSConfig

    n = 100_000 if args.quick else 1_000_000
    cfg = MLSConfig()
    pts0 = jax.block_until_ready(jnp.asarray(_mls_scene(n)))
    valid = jnp.ones((n,), bool)
    reps = args.reps

    @functools.partial(jax.jit, static_argnames=("dedup", "reps"))
    def chain(points, dedup, reps):
        def body(i, carry):
            p, acc = carry
            pos, nrm, surf = mls._mls_smooth_jit(
                p, valid,
                search_radius=float(cfg.search_radius),
                max_neighbors=int(cfg.max_neighbors),
                sqr_gauss_param=float(cfg.sqr_gauss_param),
                polynomial_order=int(cfg.polynomial_order),
                bucket_capacity=int(cfg.bucket_capacity),
                table_size=max(n // 2, 1024),
                chunk_size=16384,
                fit_impl="moments",
                dedup_candidates=dedup,
            )
            out = jnp.sum(pos) + jnp.sum(nrm)
            return (p + 1e-12 * jnp.tanh(out), acc + out)

        _, acc = jax.lax.fori_loop(0, reps, body, (points, jnp.float32(0.0)))
        return acc

    floor_s = 0.08 * (n / 1e6) * reps
    out = {"backend": jax.default_backend(), "n_points": n}
    for dedup in (False, True):
        jax.block_until_ready(chain(pts0, dedup, reps))
        print(f"# dedup={dedup} compiled", file=sys.stderr)
        walls = []
        attempt = 0
        while len(walls) < 3 and attempt < 7:
            p_in = pts0 + 1e-7 * (attempt + 1)
            t0 = time.perf_counter()
            jax.block_until_ready(chain(p_in, dedup, reps))
            dt = time.perf_counter() - t0
            attempt += 1
            if dt < floor_s:
                print(f"# bogus wall {dt*1e3:.1f} ms — retry", file=sys.stderr)
                continue
            walls.append(dt / reps)
        med = sorted(walls)[len(walls) // 2] if walls else float("nan")
        tag = "dedup" if dedup else "per_query"
        out[f"{tag}_s"] = round(med, 4)
        out[f"{tag}_mpts_per_s"] = round(n / med / 1e6, 3)
        print(f"# {tag}: {med:.3f} s ({n / med / 1e6:.2f} Mpts/s)",
              file=sys.stderr)

    # Bit-exactness tripwire on-chip (same input, single shot each).
    kw = dict(
        search_radius=float(cfg.search_radius),
        max_neighbors=int(cfg.max_neighbors),
        sqr_gauss_param=float(cfg.sqr_gauss_param),
        polynomial_order=int(cfg.polynomial_order),
        bucket_capacity=int(cfg.bucket_capacity),
        table_size=max(n // 2, 1024),
        chunk_size=16384,
        fit_impl="moments",
    )
    pa, na_, _ = mls._mls_smooth_jit(pts0, valid, dedup_candidates=False, **kw)
    pb, nb_, _ = mls._mls_smooth_jit(pts0, valid, dedup_candidates=True, **kw)
    exact = bool(jnp.all(pa == pb)) and bool(jnp.all(na_ == nb_))
    assert exact, "dedup output diverges from per-query fetch"
    out["exact"] = exact
    out["speedup"] = round(out["per_query_s"] / out["dedup_s"], 3)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
