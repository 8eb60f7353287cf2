"""Golden behavioral-parity tests: JAX engine vs the f64 NumPy reference
oracle (tests/reference_oracle.py — a transliteration of the reference C++,
see its module docstring for the file:line map).

These are the tests that EARN the "matches the reference" claim: the same
on-disk dataset is run through (a) the engine's full pipeline and (b) the
oracle's qhull-HPR + scipy-BFGS + top-5-fusion transliteration, and the
refined correction transforms and fused per-point colors are compared
directly.
"""

import os

import numpy as np
import pytest

import reference_oracle as oracle
from pointcloudprocessor_tpu.io import pcd
from test_pipeline_e2e import F, H, W, small_config, write_dataset


def _oracle_camera():
    return oracle.OracleCamera(F, F, W / 2.0, H / 2.0, np.zeros(5), W, H)


def _read_odom(root):
    positions, quats = [], []
    for line in (root / "odom.txt").read_text().splitlines():
        v = [float(t) for t in line.split()]
        positions.append(v[1:4])
        quats.append(v[4:8])
    return np.asarray(positions), np.asarray(quats)


def _gray01(path):
    from pointcloudprocessor_tpu.io import images as img_io

    return img_io.load_gray_normalized(str(path)).astype(np.float64)


# ---------------------------------------------------------------------------
# Unit-level: the engine NID objective equals the oracle's f64 transliteration
# ---------------------------------------------------------------------------


def test_engine_nid_matches_oracle_f64():
    """Engine multi_nid_loss (f32, XLA) vs oracle nid_cost (f64 NumPy
    transliteration of nid_cost.hpp) on identical inputs: relative
    agreement to ~1e-5 (f32 floor)."""
    import jax.numpy as jnp

    from pointcloudprocessor_tpu.core import se3
    from pointcloudprocessor_tpu.opt import nid as nid_mod
    from synthetic import simple_camera
    from test_nid import intensity_field

    rng = np.random.default_rng(3)
    n = 4000
    cm = simple_camera()
    x = rng.uniform(-2.0, 2.0, n)
    y = rng.uniform(-1.5, 1.5, n)
    pts = np.stack([x, y, np.full(n, 5.0)], -1)
    # Quantize to the uint8/255 grid (what a real image file holds) and round
    # intensities through f32 (what a PCD file holds): the raw synthetic field
    # hits bin boundaries (0.25, 0.5, ...) EXACTLY, where f32-vs-f64
    # truncation in `intensity * bins` flips bins — an artifact no real input
    # can produce (u8*16/255 is never within 1/255 of an integer).
    inten = np.clip(intensity_field(x, y), 0, 1).astype(np.float32).astype(np.float64)
    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    gray = np.clip(intensity_field((uu - W / 2) / F * 5.0, (vv - H / 2) / F * 5.0), 0, 1)
    gray = np.round(gray * 255.0) / 255.0

    for xi in (np.zeros(6), np.array([0.03, -0.02, 0.01, 0.004, -0.003, 0.002])):
        T = oracle.exp_se3(xi)
        want = oracle.nid_cost(T, pts, inten, gray, _oracle_camera())

        kf = nid_mod.NIDKeyframe(
            points=jnp.asarray(pts, jnp.float32)[None],
            intensity=jnp.asarray(inten, jnp.float32)[None],
            valid=jnp.ones((1, n), bool),
            bin_image=nid_mod.quantize_image(jnp.asarray(gray, jnp.float32), 16)[None],
        )
        got = float(
            nid_mod.multi_nid_loss(
                cm, se3.exp(jnp.asarray(xi, jnp.float32)), kf, 16
            )
        )
        assert abs(got - want) < 2e-4 * max(abs(want), 1e-3), (xi, got, want)


# ---------------------------------------------------------------------------
# End-to-end golden test
# ---------------------------------------------------------------------------


def sharp_field(x, y):
    """High-frequency wall texture (0.5 m / 0.4 m periods vs the default's
    2 m): sharpens the NID basin so the minimum is localized well inside
    1 cm and pose-space parity assertions are meaningful (the default field
    leaves a broad plateau — see CLAUDE.md invariants)."""
    return 0.5 + 0.25 * np.sin(2.0 * np.pi * x / 0.5) + 0.25 * np.cos(2.0 * np.pi * y / 0.4)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """Run engine + oracle once on the planted-offset dataset; share results."""
    root = tmp_path_factory.mktemp("golden")
    offset = (0.04, -0.02, 0.0)
    # Rotational plant ~0.62 deg about a skew axis (VERDICT r2 missing #3:
    # the parity chain must cover the harder half of SE(3), not only
    # translation). Ground truth correction = (exp(rot_offset), +offset),
    # see write_dataset's docstring.
    rot_offset = (0.004, -0.006, 0.008)
    # wall_slope gives the scene depth variation: on a constant-depth wall,
    # ry/rx are degenerate with tx/ty (see write_dataset docstring) and the
    # two solvers drift apart along the flat valley — pose-space parity
    # under a rotation plant is only meaningful with parallax.
    write_dataset(root, odom_offset=offset, odom_rot_offset=rot_offset,
                  field=sharp_field, wall_slope=0.25)

    # --- Engine: full pipeline, reference-faithful knobs.
    from pointcloudprocessor_tpu.core import se3
    from pointcloudprocessor_tpu.pipeline import runner

    cfg = small_config(root, enable_nid_optimize=True)
    cfg.culling.method = "hpr"
    cfg.fusion.reference_compat_orientation = True
    cfg.nid.max_inner_iterations = 30
    cfg.nid.max_outer_iterations = 5
    res = runner.process(cfg)
    T_engine = np.asarray(se3.matrix(res.T_correction), np.float64)

    # --- Oracle: transliterated pipeline on the same files.
    cam = _oracle_camera()
    data = pcd.read(str(root / "map.pcd"))
    pts = data.points.astype(np.float64)
    inten = data.fields["intensity"].astype(np.float64)
    # Min-max normalization (visual_lidar_data.cpp:87-96 semantics; see
    # reference_oracle module docstring on the raw-intensity divergence).
    inten = (inten - inten.min()) / max(inten.max() - inten.min(), 1e-12)
    positions, quats = _read_odom(root)
    images = [
        np.asarray(
            __import__("cv2").imread(str(root / "images" / f"{100.0 + 0.5 * i:.6f}.jpg"))
        )[:, :, ::-1]
        for i in range(3)
    ]

    keyframes = []
    for k in range(3):
        T_c2w = oracle.make_T(positions[k], quats[k])
        T_w2c = np.linalg.inv(T_c2w)
        pc = pts @ T_w2c[:3, :3].T + T_w2c[:3, 3]
        vis = oracle.hidden_points_removal(pc, cam)
        keyframes.append(
            (pc[vis], inten[vis], _gray01(root / "images" / f"{100.0 + 0.5 * k:.6f}.jpg"))
        )
    T_oracle = oracle.refine_pose(cam, keyframes, max_outer_iterations=5)

    # Colorize the oracle with the ENGINE's correction: the fused-colors test
    # isolates colorize+fusion semantics; solver agreement is asserted
    # separately (test_golden_correction_parity). With a shared pose, any
    # color mismatch is a genuine projection/scoring/blending divergence —
    # with independently-converged poses, sub-mm pose gaps flip sampled
    # pixels on the high-frequency texture and drown the signal.
    rgb_o, colored_o = oracle.colorize_and_fuse(
        pts, images, positions, quats, cam, T_correction=T_engine
    )
    return dict(
        root=root,
        offset=np.asarray(offset),
        rot_offset=np.asarray(rot_offset),
        res=res,
        T_engine=T_engine,
        T_oracle=T_oracle,
        pts=pts,
        rgb_oracle=rgb_o,
        colored_oracle=colored_o,
    )


def test_golden_correction_parity(golden):
    """Engine and oracle recover the SAME correction (within 1 cm / 1 deg),
    and both recover the planted ground truth — a full SE(3) plant,
    (exp(rot_offset), +offset): reported-camera-frame points need the
    rotation AND the +offset to land at the true camera pose, see
    write_dataset's docstring."""
    T_true = np.eye(4)
    T_true[:3, :3] = oracle.exp_se3(
        np.concatenate([np.zeros(3), golden["rot_offset"]])
    )[:3, :3]
    T_true[:3, 3] = golden["offset"]

    dt_eo, dr_eo = oracle.delta_magnitudes(golden["T_engine"], golden["T_oracle"])
    assert dt_eo < 0.01, f"engine vs oracle translation gap {dt_eo * 100:.2f} cm"
    assert np.degrees(dr_eo) < 1.0, f"engine vs oracle rotation gap {np.degrees(dr_eo):.3f} deg"

    for name, T in (("engine", golden["T_engine"]), ("oracle", golden["T_oracle"])):
        dt, dr = oracle.delta_magnitudes(T, T_true)
        assert dt < 0.02, f"{name} misses planted truth by {dt * 100:.2f} cm"
        assert np.degrees(dr) < 1.0, f"{name} rotation off truth {np.degrees(dr):.3f} deg"


def test_golden_fused_colors_parity(golden):
    """Fused per-point colors match the oracle within quantization on the
    (near-total) intersection of colored sets."""
    out = pcd.read(golden["res"].colored_cloud_path)
    # Associate output rows back to map indices by exact position (write
    # compacts but preserves order; positions are unique f32 values).
    key = {tuple(np.float32(p)): i for i, p in enumerate(golden["pts"])}
    idx = np.array([key[tuple(p)] for p in out.points.astype(np.float32)])

    colored_e = np.zeros(len(golden["pts"]), bool)
    colored_e[idx] = True
    colored_o = golden["colored_oracle"]
    both = colored_e & colored_o
    union = colored_e | colored_o
    assert both.sum() / union.sum() > 0.98, (
        f"colored-set overlap {both.sum()}/{union.sum()}"
    )

    rgb_e = np.zeros((len(golden["pts"]), 3))
    rgb_e[idx] = out.rgb
    diff = np.abs(rgb_e[both] - golden["rgb_oracle"][both].astype(np.float64))
    frac_close = (diff.max(axis=1) <= 2.0).mean()
    assert frac_close > 0.97, f"only {frac_close:.3f} of points within 2 LSB"
    assert np.median(diff.max(axis=1)) <= 1.0
