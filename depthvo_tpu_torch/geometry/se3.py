"""se(3) / SE(3) operations in PyTorch (counterpart of
``depthvo_tpu/geometry/se3.py``).

Conventions are the reference's: a twist ``xi`` is ``[v, w]``
(translation first), ``exp(xi)`` is ``[[R, V v], [0, 1]]`` with
``R = exp_so3(w)`` and ``V`` the left Jacobian of SO(3). Everything runs
in float32 and is shape-polymorphic over leading batch dims.

Precision: the reference pins ``Precision.HIGHEST`` on its einsums. The
3x3 products here are written as broadcast multiply + sum, which is full
float32 on every device whatever the TF32 switches say.

Taylor guards: for ``t = ||w||`` below ``_EPS`` the ``sin(t)/t``-style
factors switch to their Taylor expansions, with both branches fed safe
inputs (the double-where trick) so gradients never see 0/0.
"""

from __future__ import annotations

import torch

_EPS = 1e-4  # ||w|| below this uses the Taylor branch (f32-safe)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).float()


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., i, j) @ (..., j, k) in full float32."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _matvec(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., i, j) @ (..., j) in full float32."""
    return (a * x[..., None, :]).sum(-1)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    w = _f32(w)
    zeros = torch.zeros_like(w[..., 0])
    row0 = torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1)
    row1 = torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1)
    row2 = torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    W = _f32(W)
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _guarded(t2: torch.Tensor):
    small = t2 < _EPS**2
    t2_safe = torch.where(small, torch.ones_like(t2), t2)
    return small, t2_safe, torch.sqrt(t2_safe)


def _sin_t_over_t(t2: torch.Tensor) -> torch.Tensor:
    small, _, t = _guarded(t2)
    taylor = 1.0 - t2 / 6.0 + t2 * t2 / 120.0
    return torch.where(small, taylor, torch.sin(t) / t)


def _one_minus_cos_over_t2(t2: torch.Tensor) -> torch.Tensor:
    small, t2_safe, t = _guarded(t2)
    taylor = 0.5 - t2 / 24.0 + t2 * t2 / 720.0
    return torch.where(small, taylor, (1.0 - torch.cos(t)) / t2_safe)


def _t_minus_sin_over_t3(t2: torch.Tensor) -> torch.Tensor:
    small, t2_safe, t = _guarded(t2)
    taylor = 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0
    return torch.where(small, taylor, (t - torch.sin(t)) / (t2_safe * t))


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=torch.float32, device=W.device).expand(W.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential map (Rodrigues): (..., 3) -> (..., 3, 3)."""
    w = _f32(w)
    t2 = torch.sum(w * w, dim=-1)
    A = _sin_t_over_t(t2)[..., None, None]
    B = _one_minus_cos_over_t2(t2)[..., None, None]
    W = hat(w)
    return _eye_like(W) + A * W + B * _matmul(W, W)


def left_jacobian_so3(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V of SO(3): exp(xi) translation is V @ v."""
    w = _f32(w)
    t2 = torch.sum(w * w, dim=-1)
    B = _one_minus_cos_over_t2(t2)[..., None, None]
    C = _t_minus_sin_over_t3(t2)[..., None, None]
    W = hat(w)
    return _eye_like(W) + B * W + C * _matmul(W, W)


def _rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 3, 3) + (..., 3) -> (..., 4, 4) homogeneous matrix."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=R.device)
    bottom = bottom.expand(R.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential map: twist (..., 6) [v, w] -> transform (..., 4, 4)."""
    xi = _f32(xi)
    v, w = xi[..., :3], xi[..., 3:]
    return _rt_to_mat(exp_so3(w), _matvec(left_jacobian_so3(w), v))


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """SO(3) logarithm: (..., 3, 3) -> (..., 3). Valid for angle < pi."""
    R = _f32(R)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    t = torch.arccos(torch.clip((trace - 1.0) * 0.5, -1.0, 1.0))
    t2 = t * t
    small = t2 < _EPS**2
    t_safe = torch.where(small, torch.ones_like(t), t)
    factor_exact = t_safe / (2.0 * torch.sin(t_safe))
    factor_taylor = 0.5 + t2 / 12.0 + 7.0 * t2 * t2 / 720.0
    factor = torch.where(small, factor_taylor, factor_exact)
    return vee((R - R.transpose(-1, -2)) * factor[..., None, None])


def log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm: (..., 4, 4) -> twist (..., 6) [v, w]."""
    T = _f32(T)
    w = log_so3(T[..., :3, :3])
    V = left_jacobian_so3(w)
    v = torch.linalg.solve(V, T[..., :3, 3:4])[..., 0]
    return torch.cat([v, w], dim=-1)


def compose(T_a: torch.Tensor, T_b: torch.Tensor) -> torch.Tensor:
    """Compose two transforms: returns T_a @ T_b."""
    return _matmul(_f32(T_a), _f32(T_b))


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse: [[R^T, -R^T t], [0, 1]]."""
    T = _f32(T)
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _rt_to_mat(Rt, -_matvec(Rt, T[..., :3, 3]))
