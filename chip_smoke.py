"""Smoke run of the colorize + NID-refine pipeline on one NVIDIA GPU.

Runs, in one process (a second JAX process on the card would fail for want
of device memory):

1. dataset — the seeded bench scene written as a survey dataset under
   ``artifacts/`` (git-ignored): a 1,000,000-point map, 8 keyframes at
   4096x3000 (PNG), odometry with a planted correction error;
2. e2e — ``cli.main`` (-> ``runner.process``) on that dataset with NID
   refine (tuned schedule, culled capacity 262,144) and MLS on: the
   recovered correction must be within the reference's 1 cm / 1 deg
   convergence bound (`visual_camera_calibration.cpp:53-81`) of the
   planted truth, the NID finite, and some points colored;
3. kernel — the NID value and pose gradient at 8 x 262,144 points from the
   fused histogram kernel (ops/nid_hist, compiled for the card) against the
   plain XLA path, and both against the f64 oracle
   (tests/reference_oracle.nid_cost) on a point subsample;
4. cpu — the same NID value and gradient, and an MLS pass over 200,000
   points of the bench's MLS scene, recomputed by a child process on the
   CPU backend (``JAX_PLATFORMS=cpu``: it never touches the card) and
   compared with the card's results.

``--four-cards`` runs only the four-card phase instead: the sharded NID
refine and the sharded colorize fusion on a (kf=2, pt=2) mesh at the same
scale, compared with the one-card solve and fusion.

Exits non-zero (and prints no result) when JAX finds no GPU or any phase
fails. The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Usage: python chip_smoke.py [--four-cards] [--seed N]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT, N_MAP, N_CULL, K = 4096, 3000, 1_000_000, 262_144, 8
# The reference's outer-loop convergence bound (visual_camera_calibration.cpp:53-81).
POSE_TOL_CM, POSE_TOL_DEG = 1.0, 1.0


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def gpu_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


class CompileClock:
    """Sums JAX's own compile-stage durations (trace, lowering, backend
    compile) reported through ``jax.monitoring`` while it is installed."""

    def __init__(self):
        import jax

        self.seconds = {}
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event.startswith("/jax/core/compile/"):
            key = event.rsplit("/", 1)[-1]
            self.seconds[key] = self.seconds.get(key, 0.0) + duration

    def total(self) -> float:
        return sum(self.seconds.values())


def phase_dataset(seed: int):
    import bench

    t0 = time.perf_counter()
    data_dir = os.path.join(ROOT, "artifacts", f"smoke_data_seed{seed}")
    T0 = bench.write_e2e_dataset(data_dir, WIDTH, HEIGHT, N_MAP, N_CULL, K, seed=seed)
    log(f"dataset: {data_dir} ({time.perf_counter() - t0:.1f} s)")
    return data_dir, T0


def phase_e2e(data_dir: str, T0, clock: CompileClock) -> None:
    import bench
    import numpy as np

    from pointcloudprocessor_tpu import cli
    from pointcloudprocessor_tpu.core import se3

    out_dir = os.path.join(data_dir, "out")
    shutil.rmtree(out_dir, ignore_errors=True)
    cfg = bench.e2e_config(data_dir, out_dir, WIDTH, HEIGHT, N_MAP, N_CULL, K,
                           enable_mls=True)
    cfg_path = os.path.join(data_dir, "smoke_config.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())

    compile_before = dict(clock.seconds)
    captured = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(captured):
        rc = cli.main(["--config", cfg_path])
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli.main returned {rc}")
    summary = json.loads(captured.getvalue())
    compile_s = {k: v - compile_before.get(k, 0.0) for k, v in clock.seconds.items()}

    with open(os.path.join(out_dir, "nid_correction.json")) as f:
        corr = json.load(f)
    T = se3.from_qt(np.asarray(corr["quat_wxyz"], np.float32),
                    np.asarray(corr["translation"], np.float32))
    dt, dr = se3.delta_magnitudes(T, T0)
    err_cm, err_deg = float(dt) * 100.0, float(np.degrees(np.asarray(dr)))
    nid_value = float(summary["nid"])
    colored = int(summary["colored_points"])

    log(f"e2e: wall {wall:.2f} s (cli.main, cold process: compile included)")
    log(f"e2e: stage timings s {json.dumps(summary['timings_s'])}")
    log("e2e: compile s " + json.dumps(
        {k: round(v, 2) for k, v in compile_s.items()}
        | {"total": round(sum(compile_s.values()), 2)}))
    log(f"e2e: keyframes {summary['keyframes']} colored_points {colored} "
        f"nid {nid_value:.6f} outer_iterations {corr['outer_iterations']}")
    log(f"e2e: pose error vs planted truth {err_cm:.4f} cm / {err_deg:.4f} deg "
        f"(bound {POSE_TOL_CM} cm / {POSE_TOL_DEG} deg)")
    check(np.isfinite(nid_value), f"NID not finite: {nid_value}")
    check(colored > 0, "no colored points")
    check(err_cm <= POSE_TOL_CM and err_deg <= POSE_TOL_DEG,
          f"pose error {err_cm:.4f} cm / {err_deg:.4f} deg over the bound")


def _median_time(fn, *args, reps=10):
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


MLS_POINTS = 200_000


def cpu_reference(inputs_path: str, outputs_path: str) -> None:
    """Child-process side of the cpu phase (run with JAX_PLATFORMS=cpu):
    NID value+grad (XLA path) and an MLS pass on the CPU backend."""
    import bench
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pointcloudprocessor_tpu.core import se3
    from pointcloudprocessor_tpu.models import camera as cam
    from pointcloudprocessor_tpu.ops import mls
    from pointcloudprocessor_tpu.opt import nid
    from pointcloudprocessor_tpu.utils.config import MLSConfig

    d = np.load(inputs_path)
    width, height, n_mls = (int(x) for x in d["sizes"])
    camera = cam.PinholeCamera(jnp.asarray(d["intrinsic"]), jnp.zeros(5, jnp.float32),
                               width, height)
    kfs = nid.prepare_keyframes(nid.NIDKeyframe(
        jnp.asarray(d["points"]), jnp.asarray(d["intensity"]),
        jnp.asarray(d["valid"]), jnp.asarray(d["bin_image"].astype(np.int32)),
    ))
    T0 = se3.SE3(jnp.asarray(d["T0_q"]), jnp.asarray(d["T0_t"]))
    v, g = jax.jit(jax.value_and_grad(
        lambda x: nid.multi_nid_loss(camera, se3.compose(T0, se3.exp(x)), kfs)
    ))(jnp.zeros(6, jnp.float32))
    pts = jnp.asarray(bench._mls_scene(n_mls))
    pos, _, ok, _ = mls.mls_smooth(pts, jnp.ones((n_mls,), bool), MLSConfig())
    np.savez(outputs_path, nid=np.asarray(v), grad=np.asarray(g),
             mls_pos=np.asarray(pos), mls_ok=np.asarray(ok))


def phase_cpu(camera, kfs, T0, nid_gpu, grad_gpu) -> None:
    """The card's NID (fused kernel) and MLS against the CPU backend."""
    import bench
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pointcloudprocessor_tpu.ops import mls
    from pointcloudprocessor_tpu.utils.config import MLSConfig

    pts = jnp.asarray(bench._mls_scene(MLS_POINTS))
    pos, _, ok, _ = mls.mls_smooth(pts, jnp.ones((MLS_POINTS,), bool), MLSConfig())
    pos, ok = np.asarray(pos), np.asarray(ok)

    work = os.path.join(ROOT, "artifacts", "smoke_cpu")
    os.makedirs(work, exist_ok=True)
    inputs, outputs = os.path.join(work, "in.npz"), os.path.join(work, "out.npz")
    np.savez(inputs, sizes=np.asarray([WIDTH, HEIGHT, MLS_POINTS]),
             intrinsic=np.asarray(camera.intrinsic),
             points=np.asarray(kfs.points), intensity=np.asarray(kfs.intensity),
             valid=np.asarray(kfs.valid),
             bin_image=np.asarray(kfs.bin_image).astype(np.uint8),
             T0_q=np.asarray(T0.q), T0_t=np.asarray(T0.t))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.cpu_reference({inputs!r}, {outputs!r})"],
        cwd=ROOT, env=env, check=True, timeout=900,
    )
    ref = np.load(outputs)
    v_rel = abs(float(nid_gpu) - float(ref["nid"])) / abs(float(ref["nid"]))
    g_rel = float(np.linalg.norm(np.asarray(grad_gpu) - ref["grad"])
                  / np.linalg.norm(ref["grad"]))
    log(f"cpu: CPU backend ({time.perf_counter() - t0:.1f} s in a child process) | "
        f"NID card kernel {float(nid_gpu):.7f} vs CPU XLA {float(ref['nid']):.7f} "
        f"rel {v_rel:.2e} (tol 1e-5) | grad rel L2 {g_rel:.2e} (tol 1e-4)")
    # Same f32 math; the card sums in another order (and through the kernel).
    check(v_rel <= 1e-5, f"card vs CPU NID rel {v_rel:.2e}")
    check(g_rel <= 1e-4, f"card vs CPU gradient rel {g_rel:.2e}")

    both = ok & ref["mls_ok"]
    ok_agree = float(np.mean(ok == ref["mls_ok"]))
    dev = np.max(np.abs(pos - ref["mls_pos"]), axis=1)[both]
    far = float(np.mean(dev > 1e-5))
    log(f"cpu: MLS {MLS_POINTS} points | ok masks agree {ok_agree:.6f} "
        f"(tol >= 0.999) | max |dpos| {float(dev.max()):.3e} m, share over "
        f"1e-5 m {far:.2e} (tol <= 1e-3) | f32, moments fit (reductions, "
        "no dot)")
    # f32 moment sums in another order; a candidate within rounding of the
    # search radius may flip a neighbourhood at the margin.
    check(ok_agree >= 0.999, f"MLS ok masks agree on {ok_agree:.6f}")
    check(far <= 1e-3, f"MLS positions: {far:.2e} of points moved > 1e-5 m")


def phase_kernel(seed: int) -> None:
    """Kernel vs XLA vs f64 oracle at 8 x 262,144 points, then the cpu
    phase on the same keyframes."""
    import bench
    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import reference_oracle as oracle

    from pointcloudprocessor_tpu.core import se3
    from pointcloudprocessor_tpu.opt import nid

    camera, poses, points, inten, valid, images, kfs, T0 = bench.build_bench_scene(
        WIDTH, HEIGHT, N_MAP, N_CULL, K, seed=seed
    )
    gray = np.asarray(images[..., 0]).astype(np.float64) / 255.0  # (K, H, W)
    del images, points, inten
    kfs = jax.jit(nid.prepare_keyframes)(kfs)

    def value_and_grad(use_pallas):
        @jax.jit
        def f(xi, k):
            return jax.value_and_grad(
                lambda x: nid.multi_nid_loss(
                    camera, se3.compose(T0, se3.exp(x)), k, use_pallas=use_pallas
                )
            )(xi)
        return f

    kernel_vg, xla_vg = value_and_grad(True), value_and_grad(False)
    xi0 = jnp.zeros(6, jnp.float32)
    vk, gk = (np.asarray(a, np.float64) for a in kernel_vg(xi0, kfs))
    vx, gx = (np.asarray(a, np.float64) for a in xla_vg(xi0, kfs))
    v_rel = abs(vk - vx) / abs(vx)
    g_rel = np.linalg.norm(gk - gx) / np.linalg.norm(gx)
    log(f"kernel: {K} x {N_CULL} points at the planted start pose | "
        f"NID kernel {float(vk):.7f} xla {float(vx):.7f} rel {v_rel:.2e} "
        f"(tol 1e-5) | grad rel L2 {g_rel:.2e} (tol 1e-4) | both f32, "
        "histogram contraction at full f32 (Precision.HIGHEST / Triton ieee)")
    # Same f32 inputs, same math; only the summation order differs.
    check(v_rel <= 1e-5, f"kernel vs XLA NID rel {v_rel:.2e}")
    check(g_rel <= 1e-4, f"kernel vs XLA gradient rel {g_rel:.2e}")

    t_kernel = _median_time(kernel_vg, xi0, kfs)
    t_xla = _median_time(xla_vg, xi0, kfs)
    log(f"kernel: value+grad per evaluation, median of 10: kernel "
        f"{t_kernel * 1e3:.3f} ms, xla {t_xla * 1e3:.3f} ms")

    # f64 oracle on every 4th point of every keyframe (the oracle's
    # np.add.at histogram is single-threaded host code).
    stride = 4
    sub = kfs._replace(
        points=kfs.points[:, ::stride], intensity=kfs.intensity[:, ::stride],
        valid=kfs.valid[:, ::stride],
    )
    pts = np.asarray(sub.points, np.float64)
    its = np.asarray(sub.intensity, np.float64)
    cam_o = oracle.OracleCamera(*np.asarray(camera.intrinsic, np.float64),
                                np.zeros(5), WIDTH, HEIGHT)
    T0_m = np.asarray(se3.matrix(T0), np.float64)

    def oracle_nid(xi):
        T = T0_m @ oracle.exp_se3(xi)
        return sum(oracle.nid_cost(T, pts[i], its[i], gray[i], cam_o)
                   for i in range(K))

    want = oracle_nid(np.zeros(6))
    vk_s, gk_s = (np.asarray(a, np.float64) for a in kernel_vg(xi0, sub))
    vx_s, gx_s = (np.asarray(a, np.float64) for a in xla_vg(xi0, sub))
    # Central differences of the f64 oracle: the cubic B-spline histogram
    # is C2 in the projection, so the NID is smooth away from the image
    # border; steps move projections by < 0.1 px.
    eps = np.asarray([1e-4] * 3 + [1e-5] * 3)
    g_fd = np.zeros(6)
    for j in range(6):
        e = np.zeros(6)
        e[j] = eps[j]
        g_fd[j] = (oracle_nid(e) - oracle_nid(-e)) / (2 * eps[j])
    for name, v, g in (("kernel", vk_s, gk_s), ("xla", vx_s, gx_s)):
        v_rel = abs(v - want) / abs(want)
        g_rel = np.linalg.norm(g - g_fd) / np.linalg.norm(g_fd)
        log(f"oracle: {name} vs f64 oracle on {K} x {N_CULL // stride} points | "
            f"NID {float(v):.7f} vs {want:.7f} rel {v_rel:.2e} (tol 1e-4) | "
            f"grad vs oracle central differences rel L2 {g_rel:.2e} (tol 1e-2)")
        # f32 projection of 4096-px images (~2e-4 px) and f32 histogram
        # sums against f64; the gradient bound also covers the FD step's
        # truncation and the few points that cross the image border.
        check(v_rel <= 1e-4, f"{name} vs oracle NID rel {v_rel:.2e}")
        check(g_rel <= 1e-2, f"{name} vs oracle gradient rel {g_rel:.2e}")

    phase_cpu(camera, kfs, T0, vk, gk)


def phase_four_cards(seed: int) -> int:
    """Sharded refine + fusion on a (kf=2, pt=2) mesh vs one card."""
    import bench
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pointcloudprocessor_tpu.core import se3
    from pointcloudprocessor_tpu.opt import nid, refine
    from pointcloudprocessor_tpu.parallel import fusion_shard, nid_shard
    from pointcloudprocessor_tpu.parallel import mesh as mesh_lib
    from pointcloudprocessor_tpu.pipeline import colorize

    devices = jax.devices()
    check(len(devices) >= 4, f"--four-cards needs 4 GPUs, found {len(devices)}")
    mesh = mesh_lib.make_mesh(kf=2, pt=2, devices=devices[:4])
    camera, poses, points, inten, valid, images, kfs, T0 = bench.build_bench_scene(
        WIDTH, HEIGHT, N_MAP, N_CULL, K, seed=seed
    )

    t0 = time.perf_counter()
    single = refine.refine_pose(camera, kfs, T0, **bench.TUNED_SCHEDULE)
    single.T_camera_lidar.t.block_until_ready()
    t_single = time.perf_counter() - t0

    kf_pt = NamedSharding(mesh, P(mesh_lib.KF_AXIS, mesh_lib.PT_AXIS))
    kf_only = NamedSharding(mesh, P(mesh_lib.KF_AXIS))
    pt_only = NamedSharding(mesh, P((mesh_lib.KF_AXIS, mesh_lib.PT_AXIS)))
    kfs_sh = nid.NIDKeyframe(
        points=jax.device_put(kfs.points, kf_pt),
        intensity=jax.device_put(kfs.intensity, kf_pt),
        valid=jax.device_put(kfs.valid, kf_pt),
        bin_image=jax.device_put(kfs.bin_image, kf_only),
    )
    t0 = time.perf_counter()
    sharded = nid_shard.refine_pose_sharded(
        camera, kfs_sh, T0, mesh, **bench.TUNED_SCHEDULE
    )
    sharded.T_camera_lidar.t.block_until_ready()
    t_sharded = time.perf_counter() - t0

    gap = abs(float(sharded.nid) - float(single.nid))
    err = [se3.delta_magnitudes(r.T_camera_lidar, se3.identity()) for r in (single, sharded)]
    log(f"four-cards: refine NID one card {float(single.nid):.6f} "
        f"({int(single.evaluations)} evals, {t_single:.2f} s incl. compile) | "
        f"4 cards {float(sharded.nid):.6f} ({int(sharded.evaluations)} evals, "
        f"{t_sharded:.2f} s incl. compile) | gap {gap:.2e} (tol 1e-3)")
    log("four-cards: pose error vs truth one card "
        f"{float(err[0][0]) * 100:.4f} cm / {float(np.degrees(err[0][1])):.4f} deg, "
        f"4 cards {float(err[1][0]) * 100:.4f} cm / "
        f"{float(np.degrees(err[1][1])):.4f} deg")
    check(gap <= 1e-3, f"sharded vs one-card NID gap {gap:.2e}")

    T = single.T_camera_lidar
    want = colorize.fuse(camera, points, valid, images, poses, T)
    got = fusion_shard.fuse_sharded(
        camera,
        jax.device_put(points, pt_only),
        jax.device_put(valid, pt_only),
        jax.device_put(images, kf_only),
        se3.SE3(jax.device_put(poses.q, kf_only), jax.device_put(poses.t, kf_only)),
        T,
        mesh,
    )
    col_w, col_g = np.asarray(want.colored), np.asarray(got.colored)
    both = col_w & col_g
    rgb_diff = np.abs(np.asarray(got.rgb)[both] - np.asarray(want.rgb)[both])
    max_diff = float(rgb_diff.max()) if both.any() else 0.0
    log(f"four-cards: fusion colored one card {int(col_w.sum())} 4 cards "
        f"{int(col_g.sum())} mismatched {int((col_w != col_g).sum())} | "
        f"max |rgb diff| {max_diff:.3e} (tol 1e-3, same top-K selection)")
    # Identical per-point selections (z-buffer minima and top-K scores are
    # exact comparisons); only the blend's f32 summation order may differ.
    check(np.array_equal(col_w, col_g), "colored masks differ")
    check(max_diff <= 1e-3, f"fused colors differ by {max_diff:.3e}")
    return 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found {device.platform!r}",
              file=sys.stderr)
        return 1
    log(f"card: {gpu_name_and_power_limit()}")
    log(f"device_kind: {device.device_kind} (x{len(jax.devices())})")

    sys.path.insert(0, ROOT)
    from pointcloudprocessor_tpu.utils import compile_cache

    log(f"compile cache: {compile_cache.enable()}")
    clock = CompileClock()
    t_start = time.perf_counter()
    if args.four_cards:
        count = phase_four_cards(args.seed)
    else:
        data_dir, T0 = phase_dataset(args.seed)
        phase_e2e(data_dir, T0, clock)
        phase_kernel(args.seed)
        count = 1
    log(f"smoke: {time.perf_counter() - t_start:.1f} s wall; compile events "
        f"sum to {clock.total():.1f} s (they may overlap)")
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind, "count": count,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
