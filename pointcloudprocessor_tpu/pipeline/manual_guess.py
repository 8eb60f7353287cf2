"""Headless manual initial guess: per-keyframe pose from picked 2D-3D pairs.

The reference's `InitialGuessManual`
(`PointCloudProcessor/include/vlcal/initial_guess_manual.hpp:29-355`) is an
interactive Iridescence/ImGui viewer: the user right-clicks >= 3
pixel<->3D-point correspondences per keyframe, presses "Estimate"
(RANSAC + reprojection LSQ, :61-72) and "Save" (stores the pose into the
keyframe, :232-250, consumed by colorization at
`PointCloudProcessor.cpp:510-519`).

A GUI cannot run on a headless accelerator host, so the rebuild splits the feature at the
estimation seam: correspondences arrive in a JSON file (picked with any
external tool, e.g. the reference GUI itself or an image annotator) and the
estimation + save steps run batch. Schema — keys are the keyframe timestamp
strings used in filenames (C++ ``std::to_string`` 6-decimals):

    {
      "100.500000": {
        "pixels": [[u, v], ...],          # >= 3 picked image pixels
        "points": [[x, y, z], ...]        # matching 3D points, in the
      },                                  # keyframe CAMERA frame (the
      ...                                 # filtered_pcd/<ts>_beforeNID.pcd
    }                                     # frame the GUI picks from)

The estimated transform for each keyframe plays the role of that keyframe's
``T_correction`` in fusion (`T_c2w * T`), exactly like the saved manual pose
in the reference.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import jax
import numpy as np

from ..core import se3
from ..models import camera as cam
from ..opt import pnp
from ..utils.config import PnPConfig
from . import ingest


def load_correspondences(path: str) -> Dict[str, dict]:
    with open(path) as f:
        raw = json.load(f)
    out = {}
    for ts, entry in raw.items():
        px = np.asarray(entry["pixels"], np.float32).reshape(-1, 2)
        pt = np.asarray(entry["points"], np.float32).reshape(-1, 3)
        if px.shape[0] != pt.shape[0]:
            raise ValueError(
                f"correspondence count mismatch for {ts}: "
                f"{px.shape[0]} pixels vs {pt.shape[0]} points"
            )
        out[ts] = {"pixels": px, "points": pt}
    return out


def estimate_keyframe_corrections(
    camera: cam.PinholeCamera,
    frames: Sequence[ingest.FrameRecord],
    kf_idx: Sequence[int],
    correspondences_path: str,
    cfg: Optional[PnPConfig] = None,
) -> tuple[se3.SE3, List[bool]]:
    """Batched (K,) per-keyframe corrections from the correspondence file.

    Keyframes without an entry (or with < 3 pairs, the GUI's own gate at
    `initial_guess_manual.hpp:61-66`) get the identity. Returns the batched
    SE3 and a per-keyframe "was estimated" flag list.
    """
    cfg = cfg or PnPConfig()
    table = load_correspondences(correspondences_path)
    qs, ts_, have = [], [], []
    for j, i in enumerate(kf_idx):
        key_str = ingest.cpp_timestamp(frames[i].timestamp)
        entry = table.get(key_str)
        if entry is None or entry["pixels"].shape[0] < 3:
            qs.append(np.array([1.0, 0, 0, 0], np.float32))
            ts_.append(np.zeros(3, np.float32))
            have.append(False)
            continue
        res = pnp.estimate_pose(
            camera,
            entry["pixels"],
            entry["points"],
            key=jax.random.PRNGKey(cfg.seed + j),
            num_ransac_iterations=cfg.ransac_iterations,
            error_thresh_px=cfg.error_thresh_px,
            cauchy_kernel=cfg.cauchy_kernel_px,
            lsq_iterations=cfg.lsq_iterations,
        )
        qs.append(np.asarray(res.T_camera_target.q))
        ts_.append(np.asarray(res.T_camera_target.t))
        have.append(True)
    import jax.numpy as jnp

    return (
        se3.SE3(jnp.asarray(np.stack(qs)), jnp.asarray(np.stack(ts_))),
        have,
    )


def save_corrections_json(path: str, frames, kf_idx, corrections: se3.SE3, have) -> None:
    """Persist estimated poses (the GUI's intended calib.json save,
    `initial_guess_manual.hpp:96-113` — vestigial there, first-class here)."""
    q = np.asarray(corrections.q)
    t = np.asarray(corrections.t)
    out = {}
    for j, i in enumerate(kf_idx):
        if not have[j]:
            continue
        out[ingest.cpp_timestamp(frames[i].timestamp)] = {
            "quat_wxyz": q[j].tolist(),
            "translation": t[j].tolist(),
        }
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
