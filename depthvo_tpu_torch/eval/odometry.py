"""KITTI odometry evaluation: trajectory composition + devkit metrics + ATE
(the port's own copy of ``depthvo_tpu/eval/odometry.py``, numpy only;
``plot_trajectory`` imports matplotlib when it is called).

Reference parity (SURVEY.md §3.3): the reference runs the odometry net
over consecutive frame pairs, converts each 6-dim se(3) output to a 4x4
transform, composes the global trajectory, writes KITTI-format pose
files, and evaluates with the devkit's per-length translation/rotation
errors; ATE over seq 09/10 is the BASELINE gate metric.

Pose conventions (SURVEY.md §7 hard parts — locked by a synthetic test):
* The network predicts the twist of T_ts: TARGET(t)-cam -> SOURCE(t+1)-cam
  coordinate transform (points map from frame t's camera to frame t+1's).
* KITTI ground-truth pose files store cam-to-world matrices T_w<-c per
  frame. The relative cam-to-world motion between consecutive frames is
  M_t = T_w<-t^-1 @ T_w<-(t+1); composing T_w<-t = T_w<-(t-1) @ M_{t-1}.
* The coordinate transform T_ts relates to the motion by inversion:
  M = T_ts^-1. ``compose_trajectory`` accepts coordinate transforms (what
  the net predicts) and inverts internally.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def compose_trajectory(rel_transforms: np.ndarray) -> np.ndarray:
    """Integrate per-pair coordinate transforms into global poses.

    Args:
      rel_transforms: (N, 4, 4), element i maps points from frame i's
        camera coords to frame i+1's camera coords (the network's output
        convention, se3.exp(twist)).

    Returns:
      (N+1, 4, 4) cam-to-world poses with frame 0 as the world origin.
    """
    rel = np.asarray(rel_transforms, np.float64)
    n = rel.shape[0]
    poses = np.empty((n + 1, 4, 4))
    poses[0] = np.eye(4)
    for i in range(n):
        motion = np.linalg.inv(rel[i])  # cam-to-world relative motion
        poses[i + 1] = poses[i] @ motion
    return poses


def align_scale(pred_poses: np.ndarray, gt_poses: np.ndarray) -> float:
    """Optimal global scale aligning predicted to gt translations
    (monocular VO is scale-ambiguous; the reference's stereo-trained
    odometry is metric, but scale alignment is standard for ATE)."""
    p = pred_poses[:, :3, 3]
    g = gt_poses[: len(p), :3, 3]
    denom = float((p * p).sum())
    if denom < 1e-12:
        return 1.0
    return float((p * g).sum() / denom)


def ate(pred_poses: np.ndarray, gt_poses: np.ndarray, scale_align: bool = True) -> float:
    """Absolute trajectory error (RMSE of translation) after rigid (+scale)
    alignment via Umeyama — the BASELINE.json gate metric."""
    n = min(len(pred_poses), len(gt_poses))
    p = np.asarray(pred_poses[:n, :3, 3], np.float64)
    g = np.asarray(gt_poses[:n, :3, 3], np.float64)
    mu_p, mu_g = p.mean(0), g.mean(0)
    pc, gc = p - mu_p, g - mu_g
    W = gc.T @ pc / n
    U, D, Vt = np.linalg.svd(W)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if scale_align:
        var_p = (pc * pc).sum() / n
        s = float(np.trace(np.diag(D) @ S) / (var_p + 1e-12))
    else:
        s = 1.0
    t = mu_g - s * R @ mu_p
    aligned = (s * (R @ p.T)).T + t
    err = aligned - g
    return float(np.sqrt((err * err).sum(axis=1).mean()))


def _sfmlearner_compute_ate(gt_xyz: np.ndarray, pred_xyz: np.ndarray) -> float:
    """SfMLearner's exact compute_ate: offset pred to gt at frame 0,
    least-squares scale (no rotation alignment), then sqrt(sum(err^2))/N.

    Note this is NOT an RMSE (it divides the root by N, not the sum by N
    inside the root) — kept verbatim so numbers are comparable to the
    published seq 09/10 snippet-ATE baselines."""
    pred = pred_xyz + (gt_xyz[0] - pred_xyz[0])[None, :]
    scale = float(np.sum(gt_xyz * pred) / (np.sum(pred**2) + 1e-12))
    err = pred * scale - gt_xyz
    return float(np.sqrt(np.sum(err**2)) / gt_xyz.shape[0])


def snippet_ate(
    pred_poses: np.ndarray, gt_poses: np.ndarray, snippet_len: int = 5
) -> Dict[str, float]:
    """SfMLearner-protocol ATE: mean/std of :func:`_sfmlearner_compute_ate`
    over all ``snippet_len``-frame sub-trajectories (the protocol
    BASELINE.md names for the seq 09/10 gate; 5-frame snippets in the
    original). Alignment is first-frame offset + global scale ONLY — no
    rotation — matching SfMLearner's kitti_eval/eval_pose.py."""
    n = min(len(pred_poses), len(gt_poses))
    errs = []
    for start in range(0, n - snippet_len + 1):
        p = np.asarray(pred_poses[start : start + snippet_len, :3, 3], np.float64)
        g = np.asarray(gt_poses[start : start + snippet_len, :3, 3], np.float64)
        errs.append(_sfmlearner_compute_ate(g, p))
    arr = np.asarray(errs)
    return {
        "snippet_ate_mean": float(arr.mean()),
        "snippet_ate_std": float(arr.std()),
        "snippets": int(arr.size),
    }


def snippet_ate_umeyama(
    pred_poses: np.ndarray, gt_poses: np.ndarray, snippet_len: int = 5
) -> Dict[str, float]:
    """Umeyama-aligned (rotation + scale) snippet RMSE — a stricter,
    rotation-invariant variant. NOT the SfMLearner protocol; not
    comparable to published snippet-ATE tables (use :func:`snippet_ate`
    for those)."""
    n = min(len(pred_poses), len(gt_poses))
    errs = []
    for start in range(0, n - snippet_len + 1):
        p = pred_poses[start : start + snippet_len]
        g = gt_poses[start : start + snippet_len]
        # Re-anchor both snippets at their first frame.
        p = np.linalg.inv(p[0])[None] @ p
        g = np.linalg.inv(g[0])[None] @ g
        errs.append(ate(p, g, scale_align=True))
    arr = np.asarray(errs)
    return {
        "snippet_ate_umeyama_mean": float(arr.mean()),
        "snippet_ate_umeyama_std": float(arr.std()),
        "snippets": int(arr.size),
    }


def _trajectory_distances(poses: np.ndarray) -> np.ndarray:
    d = np.zeros(len(poses))
    steps = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    d[1:] = np.cumsum(steps)
    return d


def _rotation_error(R: np.ndarray) -> float:
    c = (np.trace(R) - 1.0) * 0.5
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def kitti_odometry_errors(
    pred_poses: np.ndarray,
    gt_poses: np.ndarray,
    lengths: Sequence[float] = (100, 200, 300, 400, 500, 600, 700, 800),
    step: int = 10,
) -> Dict[str, float]:
    """KITTI devkit metric: average translation error (%) and rotation
    error (deg/100m) over all subsequences of the given lengths.

    Mirrors the devkit's evaluate_odometry logic: for each start frame
    (every ``step`` frames) and each length, find the end frame by gt
    path distance, compare relative motions.
    """
    gt = np.asarray(gt_poses, np.float64)
    pred = np.asarray(pred_poses, np.float64)
    n = min(len(gt), len(pred))
    gt, pred = gt[:n], pred[:n]
    dist = _trajectory_distances(gt)

    t_errs, r_errs = [], []
    for first in range(0, n, step):
        for length in lengths:
            target = dist[first] + length
            last = int(np.searchsorted(dist, target))
            if last >= n:
                continue
            gt_rel = np.linalg.inv(gt[first]) @ gt[last]
            pred_rel = np.linalg.inv(pred[first]) @ pred[last]
            err = np.linalg.inv(gt_rel) @ pred_rel
            t_errs.append(np.linalg.norm(err[:3, 3]) / length)
            r_errs.append(_rotation_error(err[:3, :3]) / length)
    if not t_errs:
        return {"t_err_pct": float("nan"), "r_err_deg_per_100m": float("nan")}
    return {
        "t_err_pct": float(np.mean(t_errs)) * 100.0,
        "r_err_deg_per_100m": float(np.mean(r_errs)) * (180.0 / np.pi) * 100.0,
    }


def write_kitti_poses(poses: np.ndarray, path: str) -> None:
    """Write cam-to-world poses in KITTI odometry format (12 floats/row)."""
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{x:.9e}" for x in T[:3, :4].reshape(-1)) + "\n")


def read_kitti_poses(path: str) -> np.ndarray:
    """Inverse of :func:`write_kitti_poses`: KITTI odometry pose file
    (12 floats per row, the devkit / ground-truth format) -> (N, 4, 4)
    cam-to-world homogeneous transforms."""
    raw = np.loadtxt(path, dtype=np.float64)
    if raw.ndim == 1:
        raw = raw[None]
    if raw.shape[1] != 12:
        raise ValueError(
            f"{path}: expected 12 values per row (KITTI pose format), "
            f"got {raw.shape[1]}"
        )
    raw = raw.reshape(-1, 3, 4)
    bottom = np.tile(np.array([[0.0, 0.0, 0.0, 1.0]]), (raw.shape[0], 1, 1))
    return np.concatenate([raw, bottom], axis=1)


def plot_trajectory(
    pred_poses: np.ndarray,
    gt_poses: np.ndarray | None,
    path: str,
    title: str = "",
) -> None:
    """Bird's-eye (x-z) trajectory plot — the reference eval's matplotlib
    output (SURVEY.md §3.3 'trajectory plots')."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    p = np.asarray(pred_poses)[:, :3, 3]
    ax.plot(p[:, 0], p[:, 2], label="prediction")
    if gt_poses is not None:
        g = np.asarray(gt_poses)[:, :3, 3]
        ax.plot(g[:, 0], g[:, 2], label="ground truth", linestyle="--")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("z (m)")
    ax.set_aspect("equal")
    ax.legend()
    if title:
        ax.set_title(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
