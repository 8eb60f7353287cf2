"""Reference-faithful f64 NumPy oracle of the full reference pipeline.

Single-threaded, float64, no JAX: a direct transliteration of the reference
C++ so behavioral parity of the JAX engine can be ASSERTED, not inferred from
synthetic proxies. Every function cites the reference source it transliterates
(paths relative to /root/reference/PointCloudProcessor).

Pipeline coverage (stage order of `src/PointCloudProcessor.cpp:1007-1032`):

* qhull hidden-point removal  — `src/vlcal/calib/view_culling.cpp:266-334`
  via `scipy.spatial.ConvexHull` (exact hull, not the engine's support test).
* NID cost                    — `include/vlcal/costs/nid_cost.hpp:42-116`
  (4x4 cubic B-spline joint histogram, identical clamps/truncations).
* Outer loop + BFGS refine    — `src/vlcal/calib/visual_camera_calibration.cpp:49-129`
  (trust-region guard at :102; scipy BFGS plays Ceres' LBFGS/BFGS role).
* Colorize + top-5 fusion     — `src/PointCloudProcessor.cpp:474-631`
  (projection truncation, frame-mixing orientation score quirk at
  hpp:205-220 replicated exactly, final uint8 truncation at :626-628).

Two deliberate divergences from literal C++ behavior, both documented where
the engine makes the same choice:

* NID image: the reference feeds a 3-channel CV_64F mat into a 1-channel
  `at<double>` accessor (`visual_camera_calibration.cpp:173` +
  `nid_cost.hpp:89`) — a latent indexing bug that reads channel ``x % 3`` of
  pixel ``x / 3``. The oracle uses the intended normalized grayscale
  (`io/images.py:load_gray_normalized` makes the same correction).
* NID point intensities: the reference bins RAW intensities
  (`nid_cost.hpp:58`), which is only meaningful when the map's intensity
  field is already in [0, 1]; the oracle min-max normalizes like the
  reference's own GUI path (`visual_lidar_data.cpp:87-96`), matching
  `core/cloud.normalize_intensity`.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import ConvexHull

# ---------------------------------------------------------------------------
# SE(3) in f64 (Sophus-equivalent; the reference uses Sophus::SE3d / Eigen)
# ---------------------------------------------------------------------------


def quat_wxyz_to_R(q):
    """Quaternion (w,x,y,z) -> rotation matrix (Eigen::Quaterniond semantics)."""
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float64,
    )


def make_T(position, quat_wxyz):
    """4x4 camera-to-world from odometry line — `PointCloudProcessor.cpp:495-499`
    (translate then rotate on an identity Isometry3d)."""
    T = np.eye(4)
    T[:3, :3] = quat_wxyz_to_R(quat_wxyz)
    T[:3, 3] = np.asarray(position, np.float64)
    return T


def exp_se3(xi):
    """SE(3) exponential, xi = [rho(3), omega(3)] (Sophus tangent order)."""
    rho, om = np.asarray(xi[:3], np.float64), np.asarray(xi[3:], np.float64)
    th = np.linalg.norm(om)
    K = np.array(
        [[0, -om[2], om[1]], [om[2], 0, -om[0]], [-om[1], om[0], 0]], np.float64
    )
    if th < 1e-8:
        R = np.eye(3) + K
        V = np.eye(3) + 0.5 * K
    else:
        A = np.sin(th) / th
        B = (1 - np.cos(th)) / th**2
        C = (1 - A) / th**2
        R = np.eye(3) + A * K + B * (K @ K)
        V = np.eye(3) + B * K + C * (K @ K)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ rho
    return T


def delta_magnitudes(Ta, Tb):
    """(|dt|, |dr|) of Tb^-1 ∘ Ta — convergence metric of
    `visual_camera_calibration.cpp:67-71` (delta = new^-1 * old)."""
    d = np.linalg.inv(Tb) @ Ta
    dt = np.linalg.norm(d[:3, 3])
    c = np.clip((np.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
    return dt, float(np.arccos(c))


# ---------------------------------------------------------------------------
# Camera (pinhole + plumb_bob) — include/camera/pinhole.hpp:13-51 and the
# bespoke duplicate in include/PointCloudProcessor.hpp:100-123
# ---------------------------------------------------------------------------


class OracleCamera:
    def __init__(self, fx, fy, cx, cy, dist, width, height):
        self.fx, self.fy, self.cx, self.cy = (float(v) for v in (fx, fy, cx, cy))
        self.D = np.asarray(dist, np.float64)  # (k1, k2, p1, p2, k3)
        self.width, self.height = int(width), int(height)

    def distort(self, pts2d):
        """plumb_bob distortion of normalized coords (pinhole.hpp:13-38 /
        PointCloudProcessor.hpp:100-123 — identical formulas)."""
        k1, k2, p1, p2, k3 = self.D
        x, y = pts2d[..., 0], pts2d[..., 1]
        x2, y2 = x * x, y * y
        r2 = x2 + y2
        r4 = r2 * r2
        r6 = r2 * r4
        rc = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
        t1 = 2.0 * x * y
        t2 = r2 + 2.0 * x2
        t3 = r2 + 2.0 * y2
        return np.stack([rc * x + p1 * t1 + p2 * t2, rc * y + p1 * t3 + p2 * t1], -1)

    def project(self, pts_cam):
        """Continuous (u, v) — pinhole.hpp:40-51 (divide, distort, K)."""
        xy = pts_cam[..., :2] / pts_cam[..., 2:3]
        d = self.distort(xy)
        return np.stack(
            [self.fx * d[..., 0] + self.cx, self.fy * d[..., 1] + self.cy], -1
        )


# ---------------------------------------------------------------------------
# qhull hidden-point removal — src/vlcal/calib/view_culling.cpp:266-334
# ---------------------------------------------------------------------------

HPR_RADIUS = 90000.0  # view_culling.hpp:14


def hidden_points_removal(points_cam, camera, radius=HPR_RADIUS):
    """Visible indices into ``points_cam`` via spherical flip + exact convex
    hull (the reference's ACTIVE culling path, called from `cull` at :46).

    Filter (:277-289): behind-camera points out; projected (int-truncated)
    pixel must lie in [0, size). Flip (:292): pt * (2R - |pt|)/|pt|.
    Hull vertices = visible (:304-330); the appended origin (:298) is
    excluded by the index bound check (:326-327).
    """
    pts = np.asarray(points_cam, np.float64)
    r = np.linalg.norm(pts, axis=1)
    front = pts[:, 2] > 0.0  # pt.normalized().z() < 0 rejected (:278)
    uv = np.full((len(pts), 2), -1.0)
    uv[front] = camera.project(pts[front])
    ui = uv.astype(np.int64)  # .cast<int>() truncation (:284)
    inb = (
        front
        & (ui[:, 0] >= 0)
        & (ui[:, 1] >= 0)
        & (ui[:, 0] < camera.width)
        & (ui[:, 1] < camera.height)
        & (r > 0)
    )
    filtered = np.flatnonzero(inb)
    if len(filtered) == 0:
        return np.zeros(0, np.int64)
    f = pts[filtered] * ((2.0 * radius - r[filtered]) / r[filtered])[:, None]
    f = np.concatenate([f, np.zeros((1, 3))], axis=0)  # extra origin point (:298)
    hull = ConvexHull(f)
    verts = hull.vertices
    verts = verts[verts < len(filtered)]  # drop the origin (:326)
    return np.sort(filtered[verts])


# ---------------------------------------------------------------------------
# NID cost — include/vlcal/costs/nid_cost.hpp:24-116
# ---------------------------------------------------------------------------

SPLINE = (
    np.array(
        [[1, -3, 3, -1], [4, 0, -6, 3], [1, 3, 3, -3], [0, 0, 0, 1]], np.float64
    )
    / 6.0
)  # nid_cost.hpp:34-39


def nid_cost(T_camera_lidar, points, intensities, gray01, camera, bins=16):
    """NID between LiDAR intensities and image intensities at a pose.

    Vectorised but numerically identical transliteration of
    `NIDCost::operator()` (nid_cost.hpp:42-116): same truncation-based
    binning, same knot clamping, same +1e-6 entropy regulariser. The
    histogram scatter uses `np.add.at` (f64 accumulation; the C++ sums in
    a different order — differences are ~1e-15 relative).
    """
    hist, hist_image, hist_points = nid_histograms(
        T_camera_lidar, points, intensities, gray01, camera, bins
    )
    ssum = hist_points.sum()  # :95
    if ssum == 0:
        return 1.0
    pj = hist / ssum
    pi_ = hist_image / ssum
    pp = hist_points / ssum
    Hi = -(pi_ * np.log(pi_ + 1e-6)).sum()  # :101
    Hp = -(pp * np.log(pp + 1e-6)).sum()
    Hj = -(pj * np.log(pj + 1e-6)).sum()
    MI = Hi + Hp - Hj
    return (Hj - MI) / Hj  # :105


def nid_histograms(T_camera_lidar, points, intensities, gray01, camera, bins=16):
    """The unnormalized histograms of :func:`nid_cost` (nid_cost.hpp:42-92):
    joint [image_bin, point_bin], image marginal, point marginal (f64)."""
    T = np.asarray(T_camera_lidar, np.float64)
    pc = points @ T[:3, :3].T + T[:3, 3]
    H, W = gray01.shape
    uv = camera.project(pc)
    ku = np.floor(uv[:, 0]).astype(np.int64)
    kv = np.floor(uv[:, 1]).astype(np.int64)
    inb = (ku >= 0) & (kv >= 0) & (ku < W) & (kv < H)  # :63-66

    bin_pts = np.clip((intensities * bins).astype(np.int64), 0, bins - 1)  # :58
    hist_points = np.bincount(bin_pts[inb], minlength=bins).astype(np.float64)

    bin_map = np.minimum((gray01 * bins).astype(np.int64), bins - 1)  # :88

    s = uv - np.stack([ku, kv], -1)  # :61-62
    su = np.stack([np.ones_like(s[:, 0]), s[:, 0], s[:, 0] ** 2, s[:, 0] ** 3], -1)
    sv = np.stack([np.ones_like(s[:, 1]), s[:, 1], s[:, 1] ** 2, s[:, 1] ** 3], -1)
    bu = su @ SPLINE.T  # beta(:,0) — :69-75
    bv = sv @ SPLINE.T  # beta(:,1)

    hist = np.zeros((bins, bins))
    hist_image = np.zeros(bins)
    sel = np.flatnonzero(inb)
    kus, kvs = ku[sel], kv[sel]
    bps = bin_pts[sel]
    for i in range(4):
        kx = np.clip(kus + i - 1, 0, W - 1)  # :78-81
        for j in range(4):
            ky = np.clip(kvs + j - 1, 0, H - 1)
            w = bu[sel, i] * bv[sel, j]  # :85
            bi = bin_map[ky, kx]
            np.add.at(hist, (bi, bps), w)  # :87-89
            np.add.at(hist_image, bi, w)
    return hist, hist_image, hist_points


# ---------------------------------------------------------------------------
# Outer loop + BFGS — src/vlcal/calib/visual_camera_calibration.cpp:49-129
# ---------------------------------------------------------------------------


def refine_pose(
    camera,
    keyframes,  # list of (points_cam(N,3), intensity(N,), gray01(H,W))
    T_init=None,
    bins=16,
    max_outer_iterations=10,
    delta_trans_thresh=0.01,  # hpp:23
    delta_rot_thresh=np.radians(1.0),  # hpp:24
    trust_trans=0.2,  # :102
    trust_rot=np.radians(2.0),
):
    """`VisualCameraCalibration::calibrate` (:49-81): outer re-solves until
    Δt/Δr below thresholds; inner solve = BFGS over the SE(3) tangent at the
    iteration start (Sophus manifold at :205 ≙ right-perturbation
    ``T ∘ exp(xi)``), trust-region rejection as in `MultiNIDCost` (:102)."""
    from scipy.optimize import minimize

    T = np.eye(4) if T_init is None else np.asarray(T_init, np.float64)

    def multi_nid(T_try, T_start):
        d = np.linalg.inv(T_start) @ T_try
        dt = np.linalg.norm(d[:3, 3])
        c = np.clip((np.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        if dt > trust_trans or np.arccos(c) > trust_rot:
            return 1e3  # MultiNIDCost returns false (rejected step, :102-105)
        return sum(
            nid_cost(T_try, p, it, g, camera, bins=bins) for (p, it, g) in keyframes
        )

    for _ in range(max_outer_iterations):
        T_start = T.copy()
        res = minimize(
            lambda xi: multi_nid(T_start @ exp_se3(xi), T_start),
            np.zeros(6),
            method="BFGS",
            options={"gtol": 1e-7, "maxiter": 60},
        )
        T_new = T_start @ exp_se3(res.x)
        dt, dr = delta_magnitudes(T_start, T_new)
        T = T_new
        if dt < delta_trans_thresh and dr < delta_rot_thresh:  # :70-75
            break
    return T


# ---------------------------------------------------------------------------
# Colorize + top-5 fusion — src/PointCloudProcessor.cpp:474-631
# ---------------------------------------------------------------------------


def orientation_score(pt_cam, cam_pos_world):
    """hpp:205-220 — NB the reference subtracts the WORLD camera position
    from the CAMERA-frame point (frame mix-up), replicated verbatim."""
    view = pt_cam - cam_pos_world
    cos = view[2] / np.linalg.norm(view)
    return 0.2 + 0.8 * (cos + 1.0) / 2.0


def distance_score(pt_cam, optimal=2.0):
    """hpp:222-236."""
    d = np.linalg.norm(pt_cam)
    nd = min(abs(d - optimal) / optimal, 1.0)
    return 0.2 + 0.8 * (1.0 - nd)


def colorize_and_fuse(
    map_points,  # (N, 3) world
    images_rgb,  # list of (H, W, 3) uint8 RGB
    positions,  # (K, 3) odometry positions
    quats_wxyz,  # (K, 4)
    camera,
    T_correction=None,  # applied as t_c2w * T_correction (:507) when not None
):
    """`pcdColorizationAndSmooth` (:474-631) minus mask branch: per keyframe
    transform → qhull cull → generateColorMap (project/truncate/sample,
    :743-766) → score (:557-591, kd-tree ≙ identity association since
    points round-trip exactly) → top-5 blend (:604-631) → uint8 truncation.

    Returns (rgb_uint8 (N,3), colored (N,) bool). ``colored`` follows
    `removePointsWithNoColor` (hpp:238-252): at least one observation AND
    final color != (0,0,0) — the reference drops genuinely-black points too.
    """
    N = len(map_points)
    obs_scores = [[] for _ in range(N)]
    obs_rgb = [[] for _ in range(N)]
    for k in range(len(images_rgb)):
        T_c2w = make_T(positions[k], quats_wxyz[k])
        T_opt = T_c2w if T_correction is None else T_c2w @ T_correction  # :507
        T_w2c = np.linalg.inv(T_opt)
        pc = map_points @ T_w2c[:3, :3].T + T_w2c[:3, 3]  # :521
        vis = hidden_points_removal(pc, camera)  # :522-527
        img = images_rgb[k]
        H, W = img.shape[:2]
        for i in vis:
            x, y, z = pc[i]
            if z <= 0:  # :748
                continue
            d = camera.distort(np.array([[x / z, y / z]]))[0]  # :750-751
            u = int(camera.fx * d[0] + camera.cx)  # :752 static_cast<int>
            v = int(camera.fy * d[1] + camera.cy)  # :753
            if 0 <= u < W and 0 <= v < H:  # :754
                o = orientation_score(pc[i], np.asarray(positions[k]))  # :586
                ds = distance_score(pc[i])  # :587
                s = (o + ds) / 2.0  # :588
                obs_scores[i].append(s)
                obs_rgb[i].append(img[v, u].astype(np.float64))

    rgb = np.zeros((N, 3), np.uint8)
    colored = np.zeros(N, bool)
    for i in range(N):
        if not obs_scores[i]:
            continue  # NaN/0 in the reference; dropped by hpp:238-252
        order = np.argsort(-np.asarray(obs_scores[i]), kind="stable")[:5]  # :612-615
        sc = np.asarray(obs_scores[i])[order]
        cs = np.asarray(obs_rgb[i])[order]
        blended = (cs * sc[:, None]).sum(0) / sc.sum()  # :617-625
        rgb[i] = blended.astype(np.uint8)  # :626-628 static_cast<uint8_t>
        colored[i] = bool(rgb[i].any())  # removePointsWithNoColor, hpp:241
    return rgb, colored
