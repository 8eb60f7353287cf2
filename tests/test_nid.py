import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pointcloudprocessor_tpu.core import se3
from pointcloudprocessor_tpu.models import camera as cam
from pointcloudprocessor_tpu.opt import bfgs, nid, refine

from synthetic import simple_camera


def intensity_field(x, y):
    """Smooth spatial intensity pattern in [0, 1]."""
    return 0.5 + 0.25 * np.sin(2.0 * np.pi * x / 2.0) + 0.25 * np.cos(2.0 * np.pi * y / 1.5)


def nid_scene(c, wall_z=5.0, n_side=60, seed=0):
    """Wall of intensity-textured points + the image that observes them."""
    rng = np.random.default_rng(seed)
    fx = float(c.intrinsic[0])
    cx, cy = float(c.intrinsic[2]), float(c.intrinsic[3])
    w, h = c.width, c.height

    us = np.linspace(2, w - 2, n_side) + rng.uniform(-0.5, 0.5, n_side)
    vs = np.linspace(2, h - 2, n_side) + rng.uniform(-0.5, 0.5, n_side)
    uu, vv = np.meshgrid(us, vs)
    x = (uu - cx) / fx * wall_z
    y = (vv - cy) / fx * wall_z
    pts = np.stack([x, y, np.full_like(x, wall_z)], -1).reshape(-1, 3).astype(np.float32)
    inten = intensity_field(pts[:, 0], pts[:, 1]).astype(np.float32)

    # Render the image: each pixel unprojects to the wall.
    ui = np.arange(w)
    vi = np.arange(h)
    uu2, vv2 = np.meshgrid(ui, vi)
    wx = (uu2 - cx) / fx * wall_z
    wy = (vv2 - cy) / fx * wall_z
    img = intensity_field(wx, wy).astype(np.float32)
    return pts, np.clip(inten, 0, 1), np.clip(img, 0, 1)


def make_keyframe(c, pts, inten, img, bins=16):
    return nid.NIDKeyframe(
        points=jnp.asarray(pts),
        intensity=jnp.asarray(inten),
        valid=jnp.ones(len(pts), bool),
        bin_image=nid.quantize_image(jnp.asarray(img), bins),
    )


def test_spline_partition_of_unity():
    s = jnp.linspace(0.0, 0.999, 64)
    w = np.asarray(nid.spline_weights(s))
    np.testing.assert_allclose(w.sum(-1), 1.0, atol=1e-5)
    assert (w >= -1e-6).all()


def test_nid_lower_at_true_pose():
    c = simple_camera()
    pts, inten, img = nid_scene(c)
    kf = make_keyframe(c, pts, inten, img)
    v_true = float(nid.nid_loss(c, se3.identity(), kf))
    xi = jnp.asarray([0.05, -0.03, 0.02, 0.01, -0.01, 0.02], jnp.float32)
    v_pert = float(nid.nid_loss(c, se3.exp(xi), kf))
    assert 0.0 <= v_true <= 1.0
    assert v_true < v_pert


def test_nid_gradient_finite_and_descends():
    c = simple_camera()
    pts, inten, img = nid_scene(c)
    kf = make_keyframe(c, pts, inten, img)

    def f(xi):
        return nid.nid_loss(c, se3.exp(xi), kf)

    xi0 = jnp.asarray([0.04, 0.0, 0.0, 0.0, 0.0, 0.01], jnp.float32)
    val, g = jax.value_and_grad(f)(xi0)
    assert np.isfinite(float(val))
    assert np.isfinite(np.asarray(g)).all()
    # One small gradient step decreases the loss.
    val2 = f(xi0 - 1e-3 * g / np.linalg.norm(np.asarray(g)))
    assert float(val2) < float(val)


def test_nid_gradient_matches_finite_difference():
    c = simple_camera()
    pts, inten, img = nid_scene(c)
    kf = make_keyframe(c, pts, inten, img)

    def f(xi):
        return nid.nid_loss(c, se3.exp(xi), kf)

    xi0 = jnp.asarray([0.02, -0.01, 0.0, 0.005, 0.0, -0.005], jnp.float32)
    g = np.asarray(jax.grad(f)(xi0))
    eps = 1e-3
    for i in [0, 4]:
        e = np.zeros(6, np.float32)
        e[i] = eps
        fd = (float(f(xi0 + e)) - float(f(xi0 - e))) / (2 * eps)
        # Loose: histogram binning adds stepwise structure, but the smooth
        # B-spline part dominates.
        assert np.sign(fd) == np.sign(g[i]) or abs(fd - g[i]) < 0.3 * max(abs(fd), abs(g[i]), 1e-3)


def test_bfgs_on_rosenbrock():
    def rosen(x):
        return (1 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2

    res = bfgs.minimize(rosen, jnp.asarray([-1.2, 1.0], jnp.float32), max_iterations=200)
    np.testing.assert_allclose(np.asarray(res.x), [1.0, 1.0], atol=1e-2)


def test_bfgs_respects_inf_regions():
    # Quadratic with a hard wall: minimizer of the quadratic is outside, so
    # BFGS must stay inside the feasible region.
    def f(x):
        val = jnp.sum((x - 3.0) ** 2)
        return jnp.where(jnp.linalg.norm(x) > 1.0, jnp.inf, val)

    res = bfgs.minimize(f, jnp.zeros(2, jnp.float32), max_iterations=50)
    assert float(jnp.linalg.norm(res.x)) <= 1.0 + 1e-5
    assert float(res.value) < float(jnp.sum((jnp.zeros(2) - 3.0) ** 2))


def test_refine_recovers_perturbation():
    c = simple_camera()
    pts, inten, img = nid_scene(c)
    kf = make_keyframe(c, pts, inten, img)
    kfs = nid.NIDKeyframe(
        points=kf.points[None],
        intensity=kf.intensity[None],
        valid=kf.valid[None],
        bin_image=kf.bin_image[None],
    )
    # True correction is identity; start from a perturbed pose within the
    # trust region (2 cm, ~0.6 deg).
    xi = jnp.asarray([0.02, -0.015, 0.01, 0.006, -0.004, 0.008], jnp.float32)
    T0 = se3.exp(xi)
    res = refine.refine_pose(c, kfs, T0, max_inner_iterations=60, max_outer_iterations=5)
    dt, dr = se3.delta_magnitudes(res.T_camera_lidar, se3.identity())
    # Recover within the reference's convergence thresholds (1 cm / 1 deg).
    assert float(dt) < 0.01, f"translation error {float(dt)}"
    assert float(dr) < 0.017453, f"rotation error {float(dr)}"


def test_multi_nid_sums_keyframes():
    c = simple_camera()
    pts, inten, img = nid_scene(c)
    kf = make_keyframe(c, pts, inten, img)
    kfs = nid.NIDKeyframe(
        points=jnp.stack([kf.points, kf.points]),
        intensity=jnp.stack([kf.intensity, kf.intensity]),
        valid=jnp.stack([kf.valid, kf.valid]),
        bin_image=jnp.stack([kf.bin_image, kf.bin_image]),
    )
    single = float(nid.nid_loss(c, se3.identity(), kf))
    double = float(nid.multi_nid_loss(c, se3.identity(), kfs))
    np.testing.assert_allclose(double, 2 * single, rtol=1e-5)


def _random_kernel_inputs(n, seed=0, masked_frac=0.2):
    rng = np.random.default_rng(seed)
    taps = nid.pack_tap_nibbles(jnp.asarray(rng.integers(0, 16, (n, 16))))
    s = jnp.asarray(rng.uniform(0, 1, (n, 2)).astype(np.float32))
    bp = jnp.asarray(rng.integers(0, 16, (n,)).astype(np.int32))
    il = jnp.asarray((rng.uniform(size=n) >= masked_frac).astype(np.float32))
    return taps, s, bp, il


class TestPallasHistogram:
    """Fused joint-histogram kernel (ops/nid_hist.py, Pallas through
    Triton) vs the XLA path, run by the Pallas interpreter on CPU (compiled
    for the card on CUDA devices; chip_smoke.py compares it there)."""

    def _patch_interpret(self, monkeypatch):
        from pointcloudprocessor_tpu.ops import nid_hist

        orig = nid_hist.joint_histogram

        def interp(taps, s, bin_pts, inlier, bins=16, interpret=False):
            return orig(taps, s, bin_pts, inlier, bins, True)

        monkeypatch.setattr(nid_hist, "joint_histogram", interp)

    def test_matches_xla_path(self, monkeypatch):
        self._patch_interpret(monkeypatch)
        c = simple_camera()
        pts, inten, img = nid_scene(c)
        kf = make_keyframe(c, pts, inten, img)
        T = se3.exp(jnp.asarray([0.01, -0.005, 0.002, 0.003, -0.001, 0.002], jnp.float32))
        hx = nid.nid_histograms(c, T, kf, 16, use_pallas=False)
        hp = nid.nid_histograms(c, T, kf, 16, use_pallas=True)
        np.testing.assert_allclose(np.asarray(hx[0]), np.asarray(hp[0]), atol=2e-3)
        np.testing.assert_allclose(np.asarray(hx[1]), np.asarray(hp[1]), atol=2e-3)
        np.testing.assert_allclose(np.asarray(hx[2]), np.asarray(hp[2]), atol=1e-5)
        assert float(hx[3]) == float(hp[3])

    def test_gradient_matches_xla_path(self, monkeypatch):
        self._patch_interpret(monkeypatch)
        c = simple_camera()
        pts, inten, img = nid_scene(c)
        kf = make_keyframe(c, pts, inten, img)
        T = se3.exp(jnp.asarray([0.01, -0.005, 0.002, 0.003, -0.001, 0.002], jnp.float32))

        def loss(xi, up):
            return nid.nid_loss(c, se3.compose(T, se3.exp(xi)), kf, 16, use_pallas=up)

        xi = jnp.zeros(6)
        g_x = np.asarray(jax.grad(lambda z: loss(z, False))(xi))
        g_p = np.asarray(jax.grad(lambda z: loss(z, True))(xi))
        np.testing.assert_allclose(g_p, g_x, rtol=2e-3, atol=1e-6)

    def test_padding_does_not_leak(self, monkeypatch):
        """Sizes that are not a multiple of the block: the masked tail
        must contribute zero."""
        self._patch_interpret(monkeypatch)
        from pointcloudprocessor_tpu.ops import nid_hist

        n = 1000  # not a multiple of the 512-point block
        taps, s, bp, _ = _random_kernel_inputs(n)
        il = jnp.ones((n,), jnp.float32)
        h = nid_hist.joint_histogram(taps, s, bp, il, 16)
        np.testing.assert_allclose(float(jnp.sum(h)), n, rtol=1e-5)

    def test_per_program_partials(self):
        """Each program writes the joint histogram of exactly its own block
        of points (the last one masked past N); the sum is the XLA joint."""
        from pointcloudprocessor_tpu.ops import nid_hist

        n = 3 * nid_hist.BLOCK + 17
        taps, s, bp, il = _random_kernel_inputs(n, seed=1)
        parts = np.asarray(nid_hist.partial_histograms(taps, s, bp, il, interpret=True))
        assert parts.shape == (nid_hist.num_programs(n), 16, 16) == (4, 16, 16)
        for i in range(parts.shape[0]):
            blk = slice(i * nid_hist.BLOCK, min((i + 1) * nid_hist.BLOCK, n))
            want = nid._joint_histogram_xla(taps[blk], s[blk], bp[blk], il[blk], 16)
            np.testing.assert_allclose(parts[i], np.asarray(want), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("bins", [8, 16])
    def test_value_and_gradient_match_xla_by_bins(self, bins):
        """Fewer than 16 bins slice the kernel's 16x16 histogram; value and the
        custom-VJP gradient through s match the XLA path, under vmap."""
        from pointcloudprocessor_tpu.ops import nid_hist

        n = 1537
        taps, s, _, il = _random_kernel_inputs(n, seed=2)
        rng = np.random.default_rng(3)
        bp = jnp.asarray(rng.integers(0, bins, (n,)).astype(np.int32))
        # Image bins < `bins` too, as a quantized image guarantees.
        taps = nid.pack_tap_nibbles(jnp.asarray(rng.integers(0, bins, (n, 16))))
        wgt = jnp.asarray(rng.normal(size=(bins, bins)).astype(np.float32))

        def f_kernel(s_):
            return jnp.sum(nid_hist.joint_histogram(taps, s_, bp, il, bins, True) * wgt)

        def f_xla(s_):
            return jnp.sum(nid._joint_histogram_xla(taps, s_, bp, il, bins) * wgt)

        np.testing.assert_allclose(float(f_kernel(s)), float(f_xla(s)), rtol=1e-5)
        np.testing.assert_allclose(
            np.asarray(jax.grad(f_kernel)(s)), np.asarray(jax.grad(f_xla)(s)),
            rtol=1e-4, atol=1e-5,
        )
        batched = jax.vmap(
            lambda s_: nid_hist.joint_histogram(taps, s_, bp, il, bins, True)
        )(jnp.stack([s, 1.0 - s]))
        np.testing.assert_allclose(
            np.asarray(batched[1]),
            np.asarray(nid._joint_histogram_xla(taps, 1.0 - s, bp, il, bins)),
            rtol=1e-5, atol=1e-5,
        )


def test_default_histogram_is_xla_on_cpu():
    """use_pallas=None picks the implementation when the program is lowered
    (jax.lax.platform_dependent): the CPU program holds no Pallas kernel,
    and matches the explicit XLA path exactly."""
    c = simple_camera()
    pts, inten, img = nid_scene(c)
    kf = make_keyframe(c, pts, inten, img)
    T = se3.exp(jnp.asarray([0.01, -0.005, 0.002, 0.003, -0.001, 0.002], jnp.float32))
    auto = jax.jit(lambda k: nid.nid_loss(c, T, k))
    hlo = auto.lower(kf).as_text()
    assert "nid_joint_hist" not in hlo and "triton" not in hlo.lower()
    xla = jax.jit(lambda k: nid.nid_loss(c, T, k, use_pallas=False))
    assert float(auto(kf)) == float(xla(kf))


@pytest.mark.gpu
def test_kernel_compiled_for_gpu_matches_xla(gpu_device):
    """The fused kernel compiled for the card (no interpreter) against the
    XLA path; chip_smoke.py repeats this at 8 x 262,144 points."""
    from pointcloudprocessor_tpu.ops import nid_hist

    args = [jax.device_put(a, gpu_device) for a in _random_kernel_inputs(5000)]
    hk = jax.jit(lambda *a: nid_hist.joint_histogram(*a, 16))(*args)
    hx = jax.jit(lambda *a: nid._joint_histogram_xla(*a, 16))(*args)
    np.testing.assert_allclose(np.asarray(hk), np.asarray(hx), rtol=1e-5, atol=1e-3)


def test_sort_by_raster_preserves_objective_and_gradient():
    """opt/nid.sort_by_raster permutes per-keyframe point arrays; the NID
    objective and its pose gradient are sums over points, so the sorted
    keyframes must produce the same loss/gradient (f32 summation-order
    floor). Also: sorted anchors are monotone over the valid prefix."""
    c = simple_camera()
    pts, inten, img = nid_scene(c)
    kf0 = make_keyframe(c, pts, inten, img)
    kfs = nid.NIDKeyframe(  # batch of 2 identical keyframes
        points=jnp.stack([kf0.points, kf0.points]),
        intensity=jnp.stack([kf0.intensity, kf0.intensity]),
        valid=jnp.stack([kf0.valid, kf0.valid]),
        bin_image=jnp.stack([kf0.bin_image, kf0.bin_image]),
    )
    T = se3.exp(jnp.asarray([0.02, -0.01, 0.005, 0.004, -0.002, 0.003], jnp.float32))
    kfs_sorted = nid.sort_by_raster(c, se3.identity(), kfs)

    def loss(xi, k):
        return nid.multi_nid_loss(c, se3.compose(T, se3.exp(xi)),
                                  nid.prepare_keyframes(k))

    xi = jnp.zeros(6)
    l0, g0 = jax.value_and_grad(loss)(xi, kfs)
    l1, g1 = jax.value_and_grad(loss)(xi, kfs_sorted)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g0), rtol=1e-3, atol=1e-7)

    # Monotone anchors at the sort pose for the in-view prefix.
    from pointcloudprocessor_tpu.models import camera as cam_mod
    p = np.asarray(kfs_sorted.points[0])
    uv = np.asarray(cam_mod.project(c, jnp.asarray(p)))
    ku, kv = np.floor(uv[:, 0]).astype(int), np.floor(uv[:, 1]).astype(int)
    inb = (ku >= 0) & (ku < c.width) & (kv >= 0) & (kv < c.height) & (p[:, 2] > 0)
    anchors = kv[inb] * c.width + ku[inb]
    n_in = int(inb.sum())
    assert (inb[:n_in]).all(), "in-view points must form a prefix after sort"
    assert (np.diff(anchors) >= 0).all(), "anchors must be raster-monotone"


def test_refine_coarse_to_fine_matches_full():
    """Coarse-to-fine schedule (opt/refine.py, no reference analogue): with
    early outer solves on a 4x point subsample and the final solves at full
    resolution, the solve must recover the perturbation to the same
    convergence thresholds, and the final NID must be as deep as the
    all-full-resolution solve within the plateau tolerance (objective-level
    comparison per CLAUDE.md — never tight pose-space deltas)."""
    c = simple_camera()
    pts, inten, img = nid_scene(c)
    kf = make_keyframe(c, pts, inten, img)
    kfs = nid.NIDKeyframe(
        points=kf.points[None],
        intensity=kf.intensity[None],
        valid=kf.valid[None],
        bin_image=kf.bin_image[None],
    )
    xi = jnp.asarray([0.02, -0.015, 0.01, 0.006, -0.004, 0.008], jnp.float32)
    T0 = se3.exp(xi)
    full = refine.refine_pose(
        c, kfs, T0, max_inner_iterations=60, max_outer_iterations=5)
    c2f = refine.refine_pose(
        c, kfs, T0, max_inner_iterations=60, max_outer_iterations=4,
        coarse_outer_iterations=2, coarse_stride=4)
    dt, dr = se3.delta_magnitudes(c2f.T_camera_lidar, se3.identity())
    assert float(dt) < 0.01, f"translation error {float(dt)}"
    assert float(dr) < 0.017453, f"rotation error {float(dr)}"
    assert float(c2f.nid) < float(full.nid) + 1e-3, (float(c2f.nid), float(full.nid))


def _single_kf_batch(c):
    pts, inten, img = nid_scene(c)
    kf = make_keyframe(c, pts, inten, img)
    return nid.prepare_keyframes(nid.NIDKeyframe(
        points=kf.points[None],
        intensity=kf.intensity[None],
        valid=kf.valid[None],
        bin_image=kf.bin_image[None],
    ))


def test_frozen_taps_exact_at_gather_pose():
    """multi_nid_loss_cached with a cache gathered at the SAME pose must be
    bit-identical to multi_nid_loss (value and gradient): the frozen taps,
    knots and inlier gate are exactly what the direct path would compute."""
    c = simple_camera()
    kfs = _single_kf_batch(c)
    T0 = se3.exp(jnp.asarray([0.02, -0.01, 0.01, 0.004, -0.002, 0.004], jnp.float32))
    cache = nid.make_tap_cache(c, T0, kfs)

    l_fresh, g_fresh = jax.value_and_grad(
        lambda xi: nid.multi_nid_loss(c, se3.compose(T0, se3.exp(xi)), kfs)
    )(jnp.zeros(6, jnp.float32))

    def frozen(xi, cache):
        loss, cache2 = nid.multi_nid_loss_cached(
            c, se3.compose(T0, se3.exp(xi)), kfs, cache
        )
        return loss, cache2

    (l_frz, cache2), g_frz = jax.value_and_grad(frozen, has_aux=True)(
        jnp.zeros(6, jnp.float32), cache
    )
    assert float(l_frz) == float(l_fresh)
    np.testing.assert_array_equal(np.asarray(g_frz), np.asarray(g_fresh))
    assert int(cache2.refreshes) == 1  # no re-gather at the gather pose


def test_frozen_taps_subpixel_step_stays_frozen_and_close():
    """A sub-pixel pose step must NOT trigger a re-gather, and the frozen
    value must track the exact objective closely (the extrapolation error of
    the few boundary-crossing points is far below the NID's meaningful
    scale)."""
    c = simple_camera()
    kfs = _single_kf_batch(c)
    T0 = se3.exp(jnp.asarray([0.02, -0.01, 0.01, 0.004, -0.002, 0.004], jnp.float32))
    cache = nid.make_tap_cache(c, T0, kfs)
    # ~0.1 px of image motion at the test camera's focal length.
    fx = float(c.intrinsic[0])
    wall_z = 5.0
    xi = jnp.asarray([0.1 * wall_z / fx, 0.0, 0.0, 0.0, 0.0, 0.0], jnp.float32)
    T1 = se3.compose(T0, se3.exp(xi))
    l_frz, cache2 = nid.multi_nid_loss_cached(c, T1, kfs, cache)
    l_fresh = nid.multi_nid_loss(c, T1, kfs)
    assert int(cache2.refreshes) == 1, "sub-pixel step must stay frozen"
    np.testing.assert_allclose(float(l_frz), float(l_fresh), atol=2e-3)


def test_frozen_taps_large_step_refreshes_to_exact():
    """A multi-pixel pose step must trip the guard; after the refresh the
    cached loss is exactly the direct loss at the new pose."""
    c = simple_camera()
    kfs = _single_kf_batch(c)
    T0 = se3.exp(jnp.asarray([0.02, -0.01, 0.01, 0.004, -0.002, 0.004], jnp.float32))
    cache = nid.make_tap_cache(c, T0, kfs)
    fx = float(c.intrinsic[0])
    wall_z = 5.0
    xi = jnp.asarray([8.0 * wall_z / fx, 0.0, 0.0, 0.0, 0.0, 0.0], jnp.float32)
    T1 = se3.compose(T0, se3.exp(xi))
    l_frz, cache2 = nid.multi_nid_loss_cached(c, T1, kfs, cache)
    assert int(cache2.refreshes) == 2, "multi-pixel step must re-gather"
    assert float(l_frz) == float(nid.multi_nid_loss(c, T1, kfs))


def _partial_ready_batch(c):
    """Single-keyframe batch with N divisible by the 128-point partial
    block (nid_scene's default 60x60 = 3600 is not)."""
    pts, inten, img = nid_scene(c, n_side=64)
    kf = make_keyframe(c, pts, inten, img)
    return nid.prepare_keyframes(nid.NIDKeyframe(
        points=kf.points[None],
        intensity=kf.intensity[None],
        valid=kf.valid[None],
        bin_image=kf.bin_image[None],
    ))


def test_partial_refresh_bit_exact_vs_full():
    """A refresh served by the partial (drifted-blocks-only) path must
    produce a cache bit-identical to the full re-gather for every live
    point, and the identical loss: an int32 anchor that moved <1 px did
    not move, so clean blocks' cached rows equal a fresh gather's."""
    c = simple_camera()
    kfs = _partial_ready_batch(c)
    T0 = se3.exp(jnp.asarray([0.02, -0.01, 0.01, 0.004, -0.002, 0.004], jnp.float32))
    fx = float(c.intrinsic[0])
    # ~0.5 px shift: roughly half the anchors cross a pixel boundary.
    T1 = se3.compose(
        T0, se3.exp(jnp.asarray([0.5 * 5.0 / fx, 0, 0, 0, 0, 0], jnp.float32))
    )

    def run(partial_frac):
        cache = nid.make_tap_cache(c, T0, kfs)
        return nid.multi_nid_loss_cached(
            c, T1, kfs, cache, guard_frac=0.0, partial_frac=partial_frac
        )

    l_full, c_full = run(0.0)
    l_part, c_part = run(1.0)
    assert int(c_full.partials) == 0 and int(c_part.partials) == 1
    assert int(c_part.refreshes) == 2
    assert float(l_part) == float(l_full)
    live = np.asarray(c_full.inlier) > 0
    np.testing.assert_array_equal(
        np.asarray(c_part.taps)[live], np.asarray(c_full.taps)[live]
    )
    np.testing.assert_array_equal(np.asarray(c_part.knot), np.asarray(c_full.knot))
    np.testing.assert_array_equal(
        np.asarray(c_part.inlier), np.asarray(c_full.inlier)
    )
    assert float(c_part.drift_accum) > 0.2  # ~half the anchors crossed


def test_partial_refresh_capacity_fallback_is_full():
    """When the dirty-block count exceeds the partial capacity, the refresh
    takes the full gather — same cache, partials counter untouched."""
    c = simple_camera()
    kfs = _partial_ready_batch(c)
    T0 = se3.exp(jnp.asarray([0.02, -0.01, 0.01, 0.004, -0.002, 0.004], jnp.float32))
    fx = float(c.intrinsic[0])
    T1 = se3.compose(
        T0, se3.exp(jnp.asarray([1.5 * 5.0 / fx, 0, 0, 0, 0, 0], jnp.float32))
    )
    cache = nid.make_tap_cache(c, T0, kfs)
    # A 1.5 px uniform shift drifts EVERY anchor -> every block dirty ->
    # count > cap at any partial_frac < 1.
    l_cap, c_cap = nid.multi_nid_loss_cached(
        c, T1, kfs, cache, guard_frac=0.0, partial_frac=0.25
    )
    assert int(c_cap.refreshes) == 2 and int(c_cap.partials) == 0
    assert float(l_cap) == float(nid.multi_nid_loss(c, T1, kfs))


def test_refine_partial_refresh_solve_is_bit_identical():
    """frozen_taps with partial_frac=1.0 (every refresh through the partial
    path) must reproduce the frozen solve BIT-IDENTICALLY: same pose, same
    NID, same evaluation count — the partial refresh is not a surrogate,
    it is the same cache computed cheaper."""
    c = simple_camera()
    kfs = _partial_ready_batch(c)
    T0 = se3.exp(jnp.asarray([0.02, -0.015, 0.01, 0.006, -0.004, 0.008], jnp.float32))
    # sort_points pinned equal: the partial default enables the raster sort
    # (block coherence), which only changes f32 summation order — pin it
    # off so the comparison isolates the refresh path.
    kw = dict(max_inner_iterations=60, max_outer_iterations=5,
              frozen_taps=True, sort_points=False)
    frozen = refine.refine_pose(c, kfs, T0, **kw)
    partial = refine.refine_pose(c, kfs, T0, frozen_partial_frac=1.0, **kw)
    np.testing.assert_array_equal(
        np.asarray(frozen.T_camera_lidar.q), np.asarray(partial.T_camera_lidar.q)
    )
    np.testing.assert_array_equal(
        np.asarray(frozen.T_camera_lidar.t), np.asarray(partial.T_camera_lidar.t)
    )
    assert float(frozen.nid) == float(partial.nid)
    assert int(frozen.evaluations) == int(partial.evaluations)
    assert int(partial.partial_gathers) >= 1
    assert int(frozen.partial_gathers) == 0


def _wide_batch(c, margin=2):
    pts, inten, img = nid_scene(c, n_side=64)
    kf = make_keyframe(c, pts, inten, img)
    return nid.prepare_keyframes(
        nid.NIDKeyframe(
            points=kf.points[None],
            intensity=kf.intensity[None],
            valid=kf.valid[None],
            bin_image=kf.bin_image[None],
        ),
        wide_margin=margin,
    )


def _px_shift(c, px, wall_z=5.0):
    fx = float(c.intrinsic[0])
    return se3.exp(jnp.asarray([px * wall_z / fx, 0, 0, 0, 0, 0], jnp.float32))


def test_wide_cache_exact_within_margin_no_refresh():
    """With a margin-2 wide window cache, a 1.5 px anchor drift must (a)
    fire NO refresh and (b) still evaluate the EXACT objective bit-for-bit
    (value and gradient): the elementwise sub-window select reproduces the fresh
    4x4 tap row for every in-margin point."""
    c = simple_camera()
    kfs = _wide_batch(c, margin=2)
    T0 = se3.exp(jnp.asarray([0.02, -0.01, 0.01, 0.004, -0.002, 0.004], jnp.float32))
    cache = nid.make_tap_cache(c, T0, kfs)
    T1 = se3.compose(T0, _px_shift(c, 1.5))

    def frozen(xi, cache):
        return nid.multi_nid_loss_cached(
            c, se3.compose(T1, se3.exp(xi)), kfs, cache
        )

    (l_frz, cache2), g_frz = jax.value_and_grad(frozen, has_aux=True)(
        jnp.zeros(6, jnp.float32), cache
    )
    l_fresh, g_fresh = jax.value_and_grad(
        lambda xi: nid.multi_nid_loss(c, se3.compose(T1, se3.exp(xi)), kfs)
    )(jnp.zeros(6, jnp.float32))
    assert int(cache2.refreshes) == 1, "1.5 px must stay within margin 2"
    assert float(l_frz) == float(l_fresh)
    np.testing.assert_array_equal(np.asarray(g_frz), np.asarray(g_fresh))


def test_wide_cache_beyond_margin_refreshes_to_exact():
    c = simple_camera()
    kfs = _wide_batch(c, margin=2)
    T0 = se3.exp(jnp.asarray([0.02, -0.01, 0.01, 0.004, -0.002, 0.004], jnp.float32))
    cache = nid.make_tap_cache(c, T0, kfs)
    T1 = se3.compose(T0, _px_shift(c, 4.5))
    l_frz, cache2 = nid.multi_nid_loss_cached(c, T1, kfs, cache)
    assert int(cache2.refreshes) == 2, "4.5 px must trip the margin-2 guard"
    assert float(l_frz) == float(nid.multi_nid_loss(c, T1, kfs))


def test_wide_partial_refresh_loss_matches_full():
    """Wide mode + partial refresh: the refreshed evaluation must equal the
    full-refresh evaluation exactly (clean points' sub-window selects and
    dirty blocks' recentred windows read the same image bins)."""
    c = simple_camera()
    kfs = _wide_batch(c, margin=1)
    T0 = se3.exp(jnp.asarray([0.02, -0.01, 0.01, 0.004, -0.002, 0.004], jnp.float32))
    T1 = se3.compose(T0, _px_shift(c, 2.5))  # beyond margin 1 -> refresh

    def run(pf):
        cache = nid.make_tap_cache(c, T0, kfs)
        return nid.multi_nid_loss_cached(
            c, T1, kfs, cache, guard_frac=0.0, partial_frac=pf
        )

    l_full, c_full = run(0.0)
    l_part, c_part = run(1.0)
    assert int(c_part.partials) == 1 and int(c_full.partials) == 0
    assert float(l_part) == float(l_full)
    assert float(l_part) == float(nid.multi_nid_loss(c, T1, kfs))


def test_refine_wide_margin_solve_parity_and_fewer_gathers():
    """frozen_taps + frozen_margin=2: same convergence quality as the exact
    solve, with no more gathers than the margin-0 frozen solve (the wide
    window absorbs the sub-margin refreshes)."""
    c = simple_camera()
    kfs = _wide_batch(c, margin=0)._replace(tap_wide=None)
    xi = jnp.asarray([0.02, -0.015, 0.01, 0.006, -0.004, 0.008], jnp.float32)
    T0 = se3.exp(xi)
    kw = dict(max_inner_iterations=60, max_outer_iterations=5, frozen_taps=True)
    frozen0 = refine.refine_pose(c, kfs, T0, **kw)
    wide = refine.refine_pose(c, kfs, T0, frozen_margin=2, **kw)
    dt, dr = se3.delta_magnitudes(wide.T_camera_lidar, se3.identity())
    assert float(dt) < 0.01 and float(dr) < 0.017453
    assert float(wide.nid) < float(frozen0.nid) + 1e-3
    assert int(wide.gathers) <= int(frozen0.gathers), (
        int(wide.gathers), int(frozen0.gathers))


def test_bfgs_warm_hessian_and_ftol():
    """H0 warm start on a quadratic whose true inverse Hessian is supplied
    converges in ~one iteration; ftol stops a slowly-improving solve early
    at a near-optimal value."""
    A = jnp.asarray([[4.0, 1.0], [1.0, 3.0]], jnp.float32)

    def f(x):
        return 0.5 * jnp.dot(x, A @ x)

    x0 = jnp.asarray([2.0, -1.5], jnp.float32)
    cold = bfgs.minimize(f, x0, max_iterations=50)
    warm = bfgs.minimize(
        f, x0, max_iterations=50, H0=jnp.linalg.inv(A), scale_initial=False
    )
    assert float(jnp.linalg.norm(warm.x)) < 1e-4
    assert int(warm.evaluations) < int(cold.evaluations)

    def rosen_offset(x):
        # +10 offset: like the NID sum, the objective converges to a
        # nonzero value, so late plateau drops are small RELATIVE to it —
        # the regime the relative-decrease exit is for.
        return 10.0 + (1 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2

    tight = bfgs.minimize(rosen_offset, jnp.asarray([-1.2, 1.0], jnp.float32),
                          max_iterations=200)
    loose = bfgs.minimize(rosen_offset, jnp.asarray([-1.2, 1.0], jnp.float32),
                          max_iterations=200, ftol=1e-3)
    assert int(loose.evaluations) < int(tight.evaluations)
    # Stops mid-valley (that's the tradeoff the knob buys); the NID use
    # case sweeps ftol at full scale with pose-error checks (bench.py).
    assert float(loose.value) < 25.0  # real progress from f(x0) = 34.2


def test_refine_frozen_taps_matches_exact_solve():
    """frozen_taps solve: recovers the planted perturbation to the reference
    thresholds and lands at an objective value at parity with the exact
    solve (objective-level comparison per CLAUDE.md), with measurably fewer
    gathers than evaluations (the entire point of the mode)."""
    c = simple_camera()
    kfs = _single_kf_batch(c)
    xi = jnp.asarray([0.02, -0.015, 0.01, 0.006, -0.004, 0.008], jnp.float32)
    T0 = se3.exp(xi)
    exact = refine.refine_pose(
        c, kfs, T0, max_inner_iterations=60, max_outer_iterations=5)
    frozen = refine.refine_pose(
        c, kfs, T0, max_inner_iterations=60, max_outer_iterations=5,
        frozen_taps=True)
    dt, dr = se3.delta_magnitudes(frozen.T_camera_lidar, se3.identity())
    assert float(dt) < 0.01, f"translation error {float(dt)}"
    assert float(dr) < 0.017453, f"rotation error {float(dr)}"
    assert float(frozen.nid) < float(exact.nid) + 1e-3, (
        float(frozen.nid), float(exact.nid))
    assert int(frozen.gathers) < int(frozen.evaluations), (
        int(frozen.gathers), int(frozen.evaluations))
