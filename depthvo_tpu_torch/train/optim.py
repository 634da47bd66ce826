"""The solver chain as plain tensor code that mirrors optax (the port
imports no optax; counterpart of the transforms that
``depthvo_tpu/train/state.py::make_optimizer`` chains).

A :class:`Transform` is optax's ``GradientTransformation``:
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``, over flat dicts ``{"net.param": tensor}``. Updates are added to
the parameters by :func:`apply_updates`. Each transform repeats optax's
arithmetic, in float32, on the leaves in a fixed order with PyTorch's
multi-tensor (``torch._foreach_*``) ops, so a step launches a handful of
kernels rather than a few per parameter. Where optax and ``torch.optim``
differ, this follows optax:

* adagrad's accumulator starts at 0.1 and ``eps`` sits inside the rsqrt;
* rmsprop puts ``eps`` inside the square root;
* adadelta is scaled by the learning-rate schedule;
* the global-norm clip has no epsilon;
* bias corrections ``1 - b**t`` and the schedule are float32 numbers, as
  optax evaluates them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]


class Transform(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Tree], Tuple[Tree, Any]]


def _f32(x) -> np.float32:
    return np.float32(x)


def _zeros(params: Tree) -> List[torch.Tensor]:
    return [torch.zeros_like(p, memory_format=torch.contiguous_format)
            for p in params.values()]


def _full(params: Tree, value: float) -> List[torch.Tensor]:
    return [torch.full_like(p, value, memory_format=torch.contiguous_format)
            for p in params.values()]


def _tree(keys: Sequence[str], values: Sequence[torch.Tensor]) -> Tree:
    return dict(zip(keys, values))


def bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it."""
    return float(_f32(1.0) - _f32(decay) ** _f32(count))


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return Transform(init, update)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf (a 0-dim float32 tensor)."""
    norms = torch._foreach_norm([t.float() for t in tree.values()])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(max_norm: float) -> Transform:
    """``optax.clip_by_global_norm``: t stays where the global norm is
    below ``max_norm``, else t / norm * max_norm (no epsilon). The choice
    stays on the device."""

    def update(grads, state, params):
        norm = global_norm(grads)
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        return _tree(grads, torch._foreach_mul(list(grads.values()), scale)), state

    return Transform(lambda params: (), update)


def scale_by_adam(b1: float, b2: float, eps: float) -> Transform:
    """``optax.scale_by_adam`` (eps_root 0): mu/nu moments, bias-corrected."""

    def init(params):
        return (0, _zeros(params), _zeros(params))

    def update(grads, state, params):
        count, mu, nu = state
        g = list(grads.values())
        mu = torch._foreach_mul(mu, b1)
        torch._foreach_add_(mu, g, alpha=1.0 - b1)
        nu = torch._foreach_mul(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
        count += 1
        mu_hat = torch._foreach_div(mu, bias_correction(b1, count))
        den = torch._foreach_sqrt(torch._foreach_div(nu, bias_correction(b2, count)))
        torch._foreach_add_(den, eps)
        return _tree(grads, torch._foreach_div(mu_hat, den)), (count, mu, nu)

    return Transform(init, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    """``optax.add_decayed_weights``: updates + weight_decay * params."""

    def update(grads, state, params):
        out = torch._foreach_add(list(grads.values()),
                                 [params[k] for k in grads], alpha=weight_decay)
        return _tree(grads, out), state

    return Transform(lambda params: (), update)


def scale_by_schedule(step_size: Callable[[int], float]) -> Transform:
    """Multiply by ``step_size(count)``; ``count`` counts the updates made."""

    def update(grads, count, params):
        out = torch._foreach_mul(list(grads.values()), step_size(count))
        return _tree(grads, out), count + 1

    return Transform(lambda params: 0, update)


def scale_by_learning_rate(schedule: Callable[[int], float]) -> Transform:
    return scale_by_schedule(lambda count: -schedule(count))


def trace(decay: float, nesterov: bool) -> Transform:
    """``optax.trace``: t = g + decay * t; nesterov returns g + decay * t."""

    def update(grads, tr, params):
        g = list(grads.values())
        tr = torch._foreach_mul(tr, decay)
        torch._foreach_add_(tr, g)
        out = torch._foreach_add(g, tr, alpha=decay) if nesterov else tr
        return _tree(grads, out), tr

    return Transform(_zeros, update)


def scale_by_rss(initial_accumulator_value: float, eps: float) -> Transform:
    """``optax.scale_by_rss`` (adagrad): s += g^2; g * rsqrt(s + eps).
    optax guards with ``where(s > 0, ..., 0)``; s >= the initial 0.1
    here, so the guard never fires."""

    def update(grads, sos, params):
        g = list(grads.values())
        sos = torch._foreach_addcmul(sos, g, g)
        inv = torch._foreach_rsqrt(torch._foreach_add(sos, eps))
        return _tree(grads, torch._foreach_mul(inv, g)), sos

    return Transform(lambda params: _full(params, initial_accumulator_value), update)


def scale_by_rms(decay: float, eps: float) -> Transform:
    """``optax.scale_by_rms`` (rmsprop; initial scale 0, eps in the sqrt)."""

    def update(grads, nu, params):
        g = list(grads.values())
        nu = torch._foreach_mul(nu, decay)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - decay)
        scale = torch._foreach_rsqrt(torch._foreach_add(nu, eps))
        return _tree(grads, torch._foreach_mul(scale, g)), nu

    return Transform(_zeros, update)


def scale_by_adadelta(rho: float, eps: float) -> Transform:
    """``optax.scale_by_adadelta``: sqrt(e_x + eps) / sqrt(e_g + eps) * g."""

    def init(params):
        return (_zeros(params), _zeros(params))

    def update(grads, state, params):
        e_g, e_x = state
        g = list(grads.values())
        e_g = torch._foreach_mul(e_g, rho)
        torch._foreach_addcmul_(e_g, g, g, value=1.0 - rho)
        num = torch._foreach_sqrt(torch._foreach_add(e_x, eps))
        den = torch._foreach_sqrt(torch._foreach_add(e_g, eps))
        upd = torch._foreach_mul(torch._foreach_div(num, den), g)
        e_x = torch._foreach_mul(e_x, rho)
        torch._foreach_addcmul_(e_x, upd, upd, value=1.0 - rho)
        return _tree(grads, upd), (e_g, e_x)

    return Transform(init, update)


def masked(inner: Transform, trainable: Callable[[str], bool]) -> Transform:
    """``optax.multi_transform({"train": inner, "freeze": set_to_zero()})``:
    ``inner`` sees only the trainable leaves (so a global norm covers only
    them); frozen leaves get no update (a zero update)."""

    def pick(tree):
        return {k: v for k, v in tree.items() if trainable(k)}

    def init(params):
        return inner.init(pick(params))

    def update(grads, state, params):
        return inner.update(pick(grads), state, pick(params))

    return Transform(init, update)


def multi_steps(inner: Transform, every_k: int) -> Transform:
    """``optax.MultiSteps(inner, every_k)``: average (Welford) the
    gradients of ``every_k`` micro-steps and update on the last; the
    micro-steps before it return no update and leave ``inner``'s state
    as it was."""

    def init(params):
        return (0, _zeros(params), inner.init(params))

    def update(grads, state, params):
        mini_step, acc, inner_state = state
        g = list(grads.values())
        diff = torch._foreach_sub(g, acc)
        torch._foreach_div_(diff, float(mini_step + 1))
        acc = torch._foreach_add(acc, diff)
        if mini_step < every_k - 1:
            return {}, (mini_step + 1, acc, inner_state)
        updates, inner_state = inner.update(_tree(grads, acc), inner_state, params)
        return updates, (0, _zeros(params), inner_state)

    return Transform(init, update)


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> None:
    """params += updates, in place; keys without an update stay as they
    are (a zero update)."""
    if updates:
        torch._foreach_add_([params[k] for k in updates], list(updates.values()))
