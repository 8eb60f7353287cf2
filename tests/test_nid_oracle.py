"""The XLA NID path against the f64 oracle (tests/reference_oracle.py).

Histograms at the level of `nid_cost.hpp:42-92` — bins, point counts that
are not a power of two, all-masked inputs, windows clamped at the image
edge — and the pose gradient against central differences of the oracle's
f64 NID. These pin the plain path that the fused GPU kernel
(ops/nid_hist.py) is compared with on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import reference_oracle as oracle
from synthetic import simple_camera
from test_nid import nid_scene

from pointcloudprocessor_tpu.core import se3
from pointcloudprocessor_tpu.opt import nid

W, H, F = 128, 96, 120.0
DEPTH = 5.0


def _oracle_camera():
    return oracle.OracleCamera(F, F, W / 2.0, H / 2.0, np.zeros(5), W, H)


def _gray(seed=0):
    """Smooth random image on the uint8/255 grid (what an image file holds)."""
    rng = np.random.default_rng(seed)
    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    a, b, c = rng.uniform(0.05, 0.3, 3)
    g = 0.5 + 0.25 * np.sin(a * uu + c) + 0.25 * np.cos(b * vv)
    return np.round(np.clip(g, 0, 1) * 255.0) / 255.0


def _points_at_pixels(u, v, rng):
    """Camera-frame points at depth DEPTH that project to (u, v), with
    f32-exact intensities (what a PCD file holds)."""
    x = (u - W / 2.0) / F * DEPTH
    y = (v - H / 2.0) / F * DEPTH
    pts = np.stack([x, y, np.full_like(x, DEPTH)], -1)
    inten = rng.uniform(0, 1, len(u)).astype(np.float32).astype(np.float64)
    return pts, inten


def _compare(pts, inten, gray, bins, xi=np.zeros(6)):
    kf = nid.NIDKeyframe(
        points=jnp.asarray(pts, jnp.float32),
        intensity=jnp.asarray(inten, jnp.float32),
        valid=jnp.ones(len(pts), bool),
        bin_image=nid.quantize_image(jnp.asarray(gray, jnp.float32), bins),
    )
    hj, hi, hp, num = nid.nid_histograms(
        simple_camera(), se3.exp(jnp.asarray(xi, jnp.float32)), kf, bins,
        use_pallas=False,
    )
    want_j, want_i, want_p = oracle.nid_histograms(
        oracle.exp_se3(xi), pts, inten, gray, _oracle_camera(), bins
    )
    # Engine joint is [point_bin, image_bin]; the oracle's [image_bin, point_bin].
    np.testing.assert_allclose(np.asarray(hj).T, want_j, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(hi), want_i, rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(hp), want_p)
    assert float(num) == want_p.sum()
    return hj, hi, hp, num


@pytest.mark.parametrize("bins", [8, 12, 16])
@pytest.mark.parametrize("n", [1000, 2999])
def test_xla_histograms_match_oracle(bins, n):
    rng = np.random.default_rng(n + bins)
    u = rng.uniform(0.0, W, n)
    v = rng.uniform(0.0, H, n)
    pts, inten = _points_at_pixels(u, v, rng)
    _compare(pts, inten, _gray(bins), bins,
             xi=np.asarray([0.01, -0.02, 0.0, 0.003, 0.0, -0.002]))


@pytest.mark.parametrize("bins", [8, 16])
def test_xla_histograms_match_oracle_at_edge_pixels(bins):
    """Anchors on the first/last two pixel rows and columns: the 4x4
    window reaches past the image and clamps (nid_cost.hpp:78-81)."""
    rng = np.random.default_rng(7)
    n = 777
    edge_u = np.concatenate([rng.uniform(0, 2, n), rng.uniform(W - 2, W, n),
                             rng.uniform(0, W, 2 * n)])
    edge_v = np.concatenate([rng.uniform(0, H, 2 * n), rng.uniform(0, 2, n),
                             rng.uniform(H - 2, H, n)])
    # Stay strictly inside [0, W) x [0, H) after the f32 round trip.
    edge_u = np.clip(edge_u, 1e-3, W - 1e-3)
    edge_v = np.clip(edge_v, 1e-3, H - 1e-3)
    pts, inten = _points_at_pixels(edge_u, edge_v, rng)
    _compare(pts, inten, _gray(3), bins)


def test_xla_histograms_all_masked_match_oracle():
    """Every point outside the image: all histograms empty in both, and the
    engine's NID stays finite."""
    rng = np.random.default_rng(11)
    n = 513
    pts, inten = _points_at_pixels(rng.uniform(-60, -5, n), rng.uniform(0, H, n), rng)
    hj, hi, hp, num = _compare(pts, inten, _gray(5), 16)
    assert float(num) == 0.0 and float(jnp.abs(hj).sum()) == 0.0
    assert np.isfinite(float(nid.nid_from_histograms(hj, hi, hp, num)))


@pytest.mark.parametrize(
    "xi0",
    [
        [0.02, -0.01, 0.0, 0.005, 0.0, -0.005],
        [-0.03, 0.02, 0.01, -0.004, 0.006, 0.003],
    ],
)
def test_nid_gradient_matches_oracle_central_differences(xi0):
    """Engine pose gradient (f32, XLA path, jax.grad) vs central
    differences of the oracle's f64 NID. The cubic B-spline histogram is
    C2 in the projection, so the NID is smooth away from the image border
    and the steps (~2e-4 px) leave every anchor's window well defined."""
    c = simple_camera()
    pts, inten, img = nid_scene(c)
    gray = np.round(img.astype(np.float64) * 255.0) / 255.0
    kf = nid.NIDKeyframe(
        points=jnp.asarray(pts),
        intensity=jnp.asarray(inten),
        valid=jnp.ones(len(pts), bool),
        bin_image=nid.quantize_image(jnp.asarray(gray, jnp.float32), 16),
    )
    T0 = se3.exp(jnp.asarray(xi0, jnp.float32))
    g = np.asarray(jax.grad(
        lambda x: nid.nid_loss(c, se3.compose(T0, se3.exp(x)), kf, use_pallas=False)
    )(jnp.zeros(6, jnp.float32)), np.float64)

    T0_m = np.asarray(se3.matrix(T0), np.float64)
    p64 = np.asarray(pts, np.float64)
    i64 = np.asarray(inten, np.float32).astype(np.float64)

    def f(x):
        return oracle.nid_cost(T0_m @ oracle.exp_se3(x), p64, i64, gray,
                               _oracle_camera())

    eps = 1e-6
    g_fd = np.zeros(6)
    for j in range(6):
        e = np.zeros(6)
        e[j] = eps
        g_fd[j] = (f(e) - f(-e)) / (2 * eps)
    rel = np.linalg.norm(g - g_fd) / np.linalg.norm(g_fd)
    assert rel < 1e-3, (g, g_fd, rel)
