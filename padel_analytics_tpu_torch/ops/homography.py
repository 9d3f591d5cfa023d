"""Homography estimation and point projection in float64 numpy, on the host.

Counterpart of ``padel_analytics_tpu/ops/homography.py``: Hartley
normalisation, a DLT from the eigenvector of the smallest eigenvalue of the
9x9 normal matrix, then Gauss-Newton steps on the 8-parameter reprojection
residual with 1e-9 I damping, and `project_points`. The Jacobian is written
out (the JAX op takes it with `jacfwd`).

The court homography takes 12, 18 or 22 points, once a clip for a fixed
court, so it stays on the host in float64, as the polygon gate does. The
JAX package runs it on the device in float32; the two agree to 1e-9 under
float64 (tests/test_torch_homography.py), where the float32 bound is
stated. Should it ever move to the device, pin TF32 off (`ops/_fp32.py`).
"""

from __future__ import annotations

import numpy as np


def _normalization(points: np.ndarray) -> np.ndarray:
    """Hartley normalization: centroid to the origin, mean distance to
    sqrt(2). points (N, 2) -> (3, 3)."""
    mean = np.mean(points, axis=0)
    d = np.sqrt(np.sum((points - mean) ** 2, axis=1))
    mean_d = np.mean(d)
    s = np.sqrt(2.0) / mean_d if mean_d > 0 else 1.0
    return np.array([[s, 0.0, -s * mean[0]], [0.0, s, -s * mean[1]], [0.0, 0.0, 1.0]])


def _apply_h(h: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply a 3x3 homography to (..., 2) points."""
    p = np.concatenate([pts, np.ones((*pts.shape[:-1], 1))], axis=-1)
    q = p @ np.swapaxes(h, -1, -2)
    return q[..., :2] / q[..., 2:3]


def _dlt(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """DLT: the smallest right singular vector of the 2N x 9 design matrix,
    as the eigenvector of its normal matrix with the smallest eigenvalue."""
    x, y = src[:, 0], src[:, 1]
    u, v = dst[:, 0], dst[:, 1]
    zeros, ones = np.zeros_like(x), np.ones_like(x)
    ax = np.stack([-x, -y, -ones, zeros, zeros, zeros, u * x, u * y, u], axis=1)
    ay = np.stack([zeros, zeros, zeros, -x, -y, -ones, v * x, v * y, v], axis=1)
    a = np.concatenate([ax, ay], axis=0)
    _, vecs = np.linalg.eigh(a.T @ a)
    h = vecs[:, 0].reshape(3, 3)
    return h / h[2, 2]


def _residual_and_jacobian(h8: np.ndarray, src: np.ndarray, dst: np.ndarray):
    """The reprojection residual (2N,), interleaved (u0, v0, u1, ...), and
    its Jacobian (2N, 8) in the homography's first 8 entries (h22 = 1)."""
    x, y = src[:, 0], src[:, 1]
    w = h8[6] * x + h8[7] * y + 1.0
    u = (h8[0] * x + h8[1] * y + h8[2]) / w
    v = (h8[3] * x + h8[4] * y + h8[5]) / w
    r = np.stack([u - dst[:, 0], v - dst[:, 1]], axis=1).reshape(-1)
    zeros = np.zeros_like(x)
    ju = np.stack([x / w, y / w, 1.0 / w, zeros, zeros, zeros, -u * x / w, -u * y / w], axis=1)
    jv = np.stack([zeros, zeros, zeros, x / w, y / w, 1.0 / w, -v * x / w, -v * y / w], axis=1)
    return r, np.stack([ju, jv], axis=1).reshape(-1, 8)


def _gauss_newton_refine(h: np.ndarray, src: np.ndarray, dst: np.ndarray,
                         iters: int = 10) -> np.ndarray:
    """Refine H by minimising the reprojection error (cv2 runs
    Levenberg-Marquardt after its DLT)."""
    h8 = (h / h[2, 2]).reshape(-1)[:8]
    damping = 1e-9 * np.eye(8)
    for _ in range(iters):
        r, j = _residual_and_jacobian(h8, src, dst)
        h8 = h8 - np.linalg.solve(j.T @ j + damping, j.T @ r)
    return np.concatenate([h8, [1.0]]).reshape(3, 3)


def find_homography(src_points, dst_points, refine_iters: int = 10) -> np.ndarray:
    """Least-squares homography (3, 3) float64 from (N >= 4, 2)
    correspondences: cv2.findHomography(src, dst)[0] with method 0."""
    src = np.asarray(src_points, dtype=np.float64)
    dst = np.asarray(dst_points, dtype=np.float64)
    t_src, t_dst = _normalization(src), _normalization(dst)
    h_n = _dlt(_apply_h(t_src, src), _apply_h(t_dst, dst))
    if refine_iters:
        h_n = _gauss_newton_refine(h_n / h_n[2, 2], _apply_h(t_src, src),
                                   _apply_h(t_dst, dst), refine_iters)
    h = np.linalg.inv(t_dst) @ h_n @ t_src
    return h / h[2, 2]


def project_points(h, points) -> np.ndarray:
    """Project (..., 2) points through a 3x3 homography, or (F, N, 2) points
    through (F, 3, 3) homographies, frame by frame."""
    return _apply_h(np.asarray(h, dtype=np.float64), np.asarray(points, dtype=np.float64))
