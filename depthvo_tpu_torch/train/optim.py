"""The solver chain as plain tensor code that mirrors optax (the port
imports no optax; counterpart of the transforms that
``depthvo_tpu/train/state.py::make_optimizer`` chains).

A :class:`Transform` is optax's ``GradientTransformation`` split in two,
so that a CUDA graph of the train step can replay its device half:

* ``plan(state) -> (hyper, next_state)`` runs on the host. It advances
  the Python-int counts (adam's count, the schedule's, ``multi_steps``'
  micro-step) and yields this step's float32 numbers (bias corrections,
  the learning rate, the Welford divisor) as ``hyper``, a nested tuple of
  ``np.float32`` leaves. Its structure (:func:`hyper_key`) says which
  branch the step takes (``multi_steps``: accumulate only, or accumulate
  and update).
* ``apply(grads, state, params, hyper) -> updates`` runs on the device.
  ``hyper`` holds 0-dim float32 tensors where the plan had numbers
  (:func:`hyper_fill`), so a captured graph reads them from a tensor the
  host refills before each replay, and the eager step reads them the same
  way. It updates every tensor of ``state`` in place: the state keeps its
  storage from step to step, which a graph needs, and the host tuples
  that hold it are rebuilt by ``plan`` only for their counts.

``update(grads, state, params) -> (updates, state)`` is the two in a row,
optax's signature. Everything works over flat dicts ``{"net.param":
tensor}``; updates are added to the parameters by :func:`apply_updates`.
Each transform repeats optax's arithmetic, in float32, on the leaves in
a fixed order with PyTorch's multi-tensor (``torch._foreach_*``) ops, so
a step launches a handful of kernels rather than a few per parameter.
Where optax and ``torch.optim`` differ, this follows optax:

* adagrad's accumulator starts at 0.1 and ``eps`` sits inside the rsqrt;
* rmsprop puts ``eps`` inside the square root;
* adadelta is scaled by the learning-rate schedule;
* the global-norm clip has no epsilon;
* bias corrections ``1 - b**t`` and the schedule are float32 numbers, as
  optax evaluates them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

Tree = Dict[str, torch.Tensor]


class Transform(NamedTuple):
    init: Callable[[Tree], Any]
    plan: Callable[[Any], Tuple[Any, Any]]
    apply: Callable[[Tree, Any, Tree, Any], Tree]

    def update(self, grads: Tree, state: Any, params: Tree) -> Tuple[Tree, Any]:
        """optax's ``update``: this step's plan, then its apply with the
        plan's numbers on the gradients' device."""
        hyper, next_state = self.plan(state)
        device = next(iter(grads.values())).device
        values = torch.tensor(hyper_leaves(hyper), dtype=torch.float32).to(device)
        return self.apply(grads, state, params, hyper_fill(hyper, values)), next_state


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


def _stateless(params: Tree):
    return ()


def _no_plan(state):
    return (), state


# --------------------------------------------------------------------------
# The plan's numbers: nested tuples of np.float32 leaves (and None).
# --------------------------------------------------------------------------


def hyper_leaves(hyper: Any) -> List[np.float32]:
    """The plan's numbers in order."""
    if isinstance(hyper, tuple):
        return [x for h in hyper for x in hyper_leaves(h)]
    return [] if hyper is None else [hyper]


def hyper_key(hyper: Any) -> Any:
    """The plan's structure: equal keys take the same device ops."""
    if isinstance(hyper, tuple):
        return tuple(hyper_key(h) for h in hyper)
    return None if hyper is None else 0


def hyper_fill(hyper: Any, values: torch.Tensor) -> Any:
    """The plan with its i-th number replaced by ``values[i]`` (a 0-dim
    view of the 1-D float32 ``values``)."""

    def fill(h, it: Iterator[int]):
        if isinstance(h, tuple):
            return tuple(fill(x, it) for x in h)
        return None if h is None else values[next(it)]

    return fill(hyper, iter(range(values.numel())))


def bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it."""
    return float(_f32(1.0) - _f32(decay) ** _f32(count))


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def plan(state):
        pairs = [t.plan(s) for t, s in zip(transforms, state)]
        return tuple(h for h, _ in pairs), tuple(s for _, s in pairs)

    def apply(grads, state, params, hyper):
        for t, s, h in zip(transforms, state, hyper):
            grads = t.apply(grads, s, params, h)
        return grads

    return Transform(init, plan, apply)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf (a 0-dim float32 tensor)."""
    norms = torch._foreach_norm([t.float() for t in tree.values()])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(max_norm: float) -> Transform:
    """``optax.clip_by_global_norm``: t stays where the global norm is
    below ``max_norm``, else t / norm * max_norm (no epsilon). The choice
    stays on the device. The clipped updates are new tensors, never the
    gradients themselves (``multi_steps`` relies on that)."""

    def apply(grads, state, params, hyper):
        norm = global_norm(grads)
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        return _tree(grads, torch._foreach_mul(list(grads.values()), scale))

    return Transform(_stateless, _no_plan, apply)


def scale_by_adam(b1: float, b2: float, eps: float) -> Transform:
    """``optax.scale_by_adam`` (eps_root 0): mu/nu moments, bias-corrected."""

    def init(params):
        return (0, _zeros(params), _zeros(params))

    def plan(state):
        count, mu, nu = state
        count += 1
        return ((_f32(bias_correction(b1, count)), _f32(bias_correction(b2, count))),
                (count, mu, nu))

    def apply(grads, state, params, hyper):
        _, mu, nu = state
        bc1, bc2 = hyper
        g = list(grads.values())
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
        mu_hat = torch._foreach_div(mu, bc1)
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, eps)
        return _tree(grads, torch._foreach_div(mu_hat, den))

    return Transform(init, plan, apply)


def add_decayed_weights(weight_decay: float) -> Transform:
    """``optax.add_decayed_weights``: updates + weight_decay * params."""

    def apply(grads, state, params, hyper):
        return _tree(grads, torch._foreach_add(list(grads.values()),
                                               [params[k] for k in grads], alpha=weight_decay))

    return Transform(_stateless, _no_plan, apply)


def scale_by_schedule(step_size: Callable[[int], float]) -> Transform:
    """Multiply by ``step_size(count)``; ``count`` counts the updates made."""

    def plan(count):
        return (_f32(step_size(count)),), count + 1

    def apply(grads, count, params, hyper):
        (size,) = hyper
        return _tree(grads, torch._foreach_mul(list(grads.values()), size))

    return Transform(lambda params: 0, plan, apply)


def scale_by_learning_rate(schedule: Callable[[int], float]) -> Transform:
    return scale_by_schedule(lambda count: -schedule(count))


def trace(decay: float, nesterov: bool) -> Transform:
    """``optax.trace``: t = g + decay * t; nesterov returns g + decay * t."""

    def apply(grads, tr, params, hyper):
        g = list(grads.values())
        torch._foreach_mul_(tr, decay)
        torch._foreach_add_(tr, g)
        out = torch._foreach_add(g, tr, alpha=decay) if nesterov else tr
        return _tree(grads, out)

    return Transform(_zeros, _no_plan, apply)


def scale_by_rss(initial_accumulator_value: float, eps: float) -> Transform:
    """``optax.scale_by_rss`` (adagrad): s += g^2; g * rsqrt(s + eps).
    optax guards with ``where(s > 0, ..., 0)``; s >= the initial 0.1
    here, so the guard never fires."""

    def apply(grads, sos, params, hyper):
        g = list(grads.values())
        torch._foreach_addcmul_(sos, g, g)
        inv = torch._foreach_rsqrt(torch._foreach_add(sos, eps))
        return _tree(grads, torch._foreach_mul(inv, g))

    return Transform(lambda params: _full(params, initial_accumulator_value), _no_plan, apply)


def scale_by_rms(decay: float, eps: float) -> Transform:
    """``optax.scale_by_rms`` (rmsprop; initial scale 0, eps in the sqrt)."""

    def apply(grads, nu, params, hyper):
        g = list(grads.values())
        torch._foreach_mul_(nu, decay)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - decay)
        scale = torch._foreach_rsqrt(torch._foreach_add(nu, eps))
        return _tree(grads, torch._foreach_mul(scale, g))

    return Transform(_zeros, _no_plan, apply)


def scale_by_adadelta(rho: float, eps: float) -> Transform:
    """``optax.scale_by_adadelta``: sqrt(e_x + eps) / sqrt(e_g + eps) * g."""

    def init(params):
        return (_zeros(params), _zeros(params))

    def apply(grads, state, params, hyper):
        e_g, e_x = state
        g = list(grads.values())
        torch._foreach_mul_(e_g, rho)
        torch._foreach_addcmul_(e_g, g, g, value=1.0 - rho)
        num = torch._foreach_sqrt(torch._foreach_add(e_x, eps))
        den = torch._foreach_sqrt(torch._foreach_add(e_g, eps))
        upd = torch._foreach_mul(torch._foreach_div(num, den), g)
        torch._foreach_mul_(e_x, rho)
        torch._foreach_addcmul_(e_x, upd, upd, value=1.0 - rho)
        return _tree(grads, upd)

    return Transform(init, _no_plan, apply)


def masked(inner: Transform, trainable: Callable[[str], bool]) -> Transform:
    """``optax.multi_transform({"train": inner, "freeze": set_to_zero()})``:
    ``inner`` sees only the trainable leaves (so a global norm covers only
    them); frozen leaves get no update (a zero update)."""

    def pick(tree):
        return {k: v for k, v in tree.items() if trainable(k)}

    def init(params):
        return inner.init(pick(params))

    def apply(grads, state, params, hyper):
        return inner.apply(pick(grads), state, pick(params), hyper)

    return Transform(init, inner.plan, apply)


def multi_steps(inner: Transform, every_k: int) -> Transform:
    """``optax.MultiSteps(inner, every_k)``: average (Welford) the
    gradients of ``every_k`` micro-steps and update on the last; the
    micro-steps before it return no update and leave ``inner``'s state
    as it was. The plan's structure tells the two apart: ``(divisor,
    None)`` accumulates only, ``(divisor, inner plan)`` also updates."""

    def init(params):
        return (0, _zeros(params), inner.init(params))

    def plan(state):
        mini_step, acc, inner_state = state
        divisor = _f32(mini_step + 1)
        if mini_step < every_k - 1:
            return (divisor, None), (mini_step + 1, acc, inner_state)
        inner_hyper, inner_state = inner.plan(inner_state)
        return (divisor, inner_hyper), (0, acc, inner_state)

    def apply(grads, state, params, hyper):
        _, acc, inner_state = state
        divisor, inner_hyper = hyper
        diff = torch._foreach_sub(list(grads.values()), acc)
        torch._foreach_div_(diff, divisor)
        torch._foreach_add_(acc, diff)
        if inner_hyper is None:
            return {}
        # The inner chain's clip returns new tensors, so zeroing the
        # average after it leaves the updates as they are.
        updates = inner.apply(_tree(grads, acc), inner_state, params, inner_hyper)
        torch._foreach_zero_(acc)
        return updates

    return Transform(init, plan, apply)


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> None:
    """params += updates, in place; keys without an update stay as they
    are (a zero update)."""
    if updates:
        torch._foreach_add_([params[k] for k in updates], list(updates.values()))
