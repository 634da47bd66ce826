"""The global BatchNorm of data-parallel training (``ops/batch_norm.py``:
``GlobalBatchNorm`` and the plain versions of its four kernels) held
against flax on the CPU.

On one process (a gloo group of one, so the all-reduces run and change
nothing) the global batch is the local one, and the reference's sharded
step computes flax ``nn.BatchNorm(use_running_average=False,
momentum=0.95, epsilon=1e-5)`` on it:

* y, the new ``batch_stats`` and the VJP (dx, dscale, dbias) against flax
  within 1e-5 relative L2 (another order of float32 sums; the VJP's closed
  form against JAX's autodiff through the fast variance);
* the same against the composed autograd formula the port used before
  (kept below as ``_old_formula``) within 1e-6 (the same sums, the
  gradient's closed form against autograd through ``Q/n - mean^2`` and the
  clamp);
* each with a constant channel, where the float32 variance comes out
  negative in both packages and the clamp is on: its xhat term is dropped,
  as autograd through ``clamp`` drops it;
* a remat recompute moves no running average, so a block under
  ``layers.remat`` equals the plain block bit for bit, running averages
  and gradients; one forward and backward makes two all-reduces;
* the CUDA wrappers refuse what the kernels do not take (dtype,
  non-contiguous, non-NCHW, mismatched cotangent, a CPU tensor) before
  launching, and the CPU path counts no launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from flax import linen as nn

from depthvo_tpu_torch.models import layers
from depthvo_tpu_torch.ops import batch_norm as bn
from depthvo_tpu_torch.ops import _build
from depthvo_tpu_torch.parallel import distributed as pdist

torch.set_num_threads(2)
torch.exp(torch.zeros(1))  # MKL's first call on one thread (test_torch_models.py)

FLAX_RTOL = 1e-5
FORMULA_RTOL = 1e-6
MOMENTUM, EPS = 0.05, 1e-5  # torch's momentum: flax's 0.95
SHAPE = (4, 6, 5, 7)


@pytest.fixture(scope="module")
def group():
    """A gloo group of one process, torn down after the module, so that
    later tests in the same worker see no process group."""
    assert not dist.is_initialized()
    pdist.init_rank(0, 1, f"tcp://127.0.0.1:{pdist.free_port()}", torch.device("cpu"),
                    timeout=60)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _inputs(seed: int, constant_channel: bool):
    """x (N, C, H, W), scale, bias, running mean and var, cotangent, all
    float32 numpy from ``seed``; channel 1 constant if asked, at a value
    whose float32 mean is exact and whose variance (Q/n - mean^2) is
    negative in both packages (elsewhere both are sum-order noise, and
    1/sqrt(var + eps) and xhat with them)."""
    rng = np.random.default_rng(seed)
    n, c = SHAPE[0], SHAPE[1]
    x = (rng.normal(size=SHAPE) * rng.uniform(0.5, 3.0, (1, c, 1, 1))
         + rng.uniform(-2.0, 2.0, (1, c, 1, 1))).astype(np.float32)
    if constant_channel:
        for v in rng.uniform(0.1, 3.0, 5000).astype(np.float32):
            x[:, 1] = v
            (mean, live), (f_mean, f_var) = _port_stats(x), _flax_stats(x)
            if live[1] == 0 and f_var[1] < 0 and mean[1] == v == f_mean[1]:
                break
        else:
            raise AssertionError("no constant gives a negative float32 variance")
    return {"x": x, "scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": rng.normal(size=c).astype(np.float32),
            "mean": rng.normal(size=c).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, c).astype(np.float32),
            "g": rng.normal(size=SHAPE).astype(np.float32)}


def _port_stats(x: np.ndarray) -> tuple:
    """The plain stages' mean and, per channel, 1 where the variance Q/n -
    mean^2 is not negative, 0 where the clamp is on."""
    xt = torch.from_numpy(x)
    c = xt.shape[1]
    _, save = bn.bn_normalize_plain(xt, bn.bn_stats_plain(xt), torch.ones(c), torch.zeros(c),
                                    torch.zeros(c), torch.ones(c), MOMENTUM, EPS, update=False)
    return save[:c].numpy(), save[2 * c:3 * c].numpy()


def _flax_stats(x: np.ndarray) -> tuple:
    """flax's mean and fast variance before its clamp (``_compute_stats``:
    E[x^2] - E[x]^2 over the NHWC batch)."""
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    mu = xj.mean((0, 1, 2))
    return np.asarray(mu), np.asarray((xj * xj).mean((0, 1, 2)) - mu * mu)


def _flax(d):
    """y, new mean and var, dx, dscale, dbias of flax's BatchNorm (NHWC
    inside, NCHW out)."""
    mod = nn.BatchNorm(use_running_average=False, momentum=0.95, epsilon=1e-5)
    stats = {"mean": jnp.asarray(d["mean"]), "var": jnp.asarray(d["var"])}

    def fn(x, params):
        y, upd = mod.apply({"params": params, "batch_stats": stats}, x,
                           mutable=["batch_stats"])
        return y, upd["batch_stats"]

    x = jnp.asarray(d["x"].transpose(0, 2, 3, 1))
    params = {"scale": jnp.asarray(d["scale"]), "bias": jnp.asarray(d["bias"])}
    y, vjp, new = jax.vjp(fn, x, params, has_aux=True)
    dx, dp = vjp(jnp.asarray(d["g"].transpose(0, 2, 3, 1)))
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    return {"y": nchw(y), "mean": np.asarray(new["mean"]), "var": np.asarray(new["var"]),
            "dx": nchw(dx), "dscale": np.asarray(dp["scale"]), "dbias": np.asarray(dp["bias"])}


def _old_formula(x, weight, bias, running_mean, running_var, group):
    """The port's global BatchNorm before the kernels: composed torch ops
    under a differentiable all-reduce, autograd for the backward."""
    xf = x.float()
    c = xf.shape[1]
    stats = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                       xf.new_full((1,), xf.numel() // c)])
    stats = pdist.all_reduce_sum(stats, group)
    n = stats[2 * c]
    mean = stats[:c] / n
    var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)
    with torch.no_grad():
        running_mean.mul_(1.0 - MOMENTUM).add_(mean, alpha=MOMENTUM)
        running_var.mul_(1.0 - MOMENTUM).add_(var, alpha=MOMENTUM)
    shape = (1, c, 1, 1)
    mul = torch.rsqrt(var + EPS) * weight
    y = (xf - mean.view(shape)) * mul.view(shape) + bias.view(shape)
    return y.to(x.dtype)


def _port(d, group, fn=None):
    """The same outputs through ``fn`` (default: ``bn.GlobalBatchNorm``)."""
    x = torch.tensor(d["x"], requires_grad=True)
    weight = torch.tensor(d["scale"], requires_grad=True)
    bias = torch.tensor(d["bias"], requires_grad=True)
    rm, rv = torch.tensor(d["mean"]), torch.tensor(d["var"])
    if fn is None:
        y = bn.GlobalBatchNorm.apply(x, weight, bias, rm, rv, group, MOMENTUM, EPS, True)
    else:
        y = fn(x, weight, bias, rm, rv, group)
    y.backward(torch.tensor(d["g"]))
    return {"y": y.detach().numpy(), "mean": rm.numpy(), "var": rv.numpy(),
            "dx": x.grad.numpy(), "dscale": weight.grad.numpy(), "dbias": bias.grad.numpy()}


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("constant_channel", [False, True], ids=["random", "clamp"])
@pytest.mark.parametrize("reference,tol", [("flax", FLAX_RTOL), ("old_formula", FORMULA_RTOL)])
def test_global_batch_norm_matches_the_reference(group, reference, tol, constant_channel):
    d = _inputs(7, constant_channel)
    got = _port(d, group)
    want = _flax(d) if reference == "flax" else _port(d, group, _old_formula)
    errs = {k: _rel_l2(got[k], want[k]) for k in want}
    assert max(errs.values()) <= tol, errs
    assert list(_port_stats(d["x"])[1]) == [1, 0 if constant_channel else 1, 1, 1, 1, 1]


def test_the_plain_stages_compose_the_closed_form(group):
    """The four stages by hand equal the Function's outputs bit for bit,
    and the backward's layout: [SG | SGX] all-reduced, then dbias, dscale."""
    d = _inputs(3, False)
    got = _port(d, group)
    x, g = torch.from_numpy(d["x"]), torch.from_numpy(d["g"])
    w, b = torch.from_numpy(d["scale"]), torch.from_numpy(d["bias"])
    rm, rv = torch.tensor(d["mean"]), torch.tensor(d["var"])
    stats = bn.bn_stats(x)
    y, save = bn.bn_normalize(x, stats, w, b, rm, rv, MOMENTUM, EPS)
    sums = bn.bn_bwd_reduce(g, x, save)
    c = SHAPE[1]
    assert torch.equal(sums[:2 * c], sums[2 * c:])
    dx = bn.bn_bwd_elemt(g, x, w, save, sums)
    for k, v in (("y", y), ("mean", rm), ("var", rv), ("dx", dx),
                 ("dscale", sums[3 * c:]), ("dbias", sums[2 * c:3 * c])):
        assert np.array_equal(v.numpy(), got[k]), k


def test_remat_recompute_moves_no_running_average(group, monkeypatch):
    """A ConvBlock under ``global_statistics``: through ``layers.remat`` it
    equals the plain block bit for bit (output, running averages, every
    gradient); the recompute alone moves nothing; one forward and backward
    makes two all-reduces without remat, three with (the recompute's
    statistics)."""
    torch.manual_seed(0)
    blocks = [layers.ConvBlock(3, 6, 3) for _ in range(2)]
    blocks[1].load_state_dict(blocks[0].state_dict())
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 3, 9, 11)).astype(np.float32))
    calls = []
    real = dist.all_reduce
    monkeypatch.setattr(dist, "all_reduce", lambda t, **kw: (calls.append(t.numel()),
                                                             real(t, **kw))[1])
    outs = []
    for block, use_remat in zip(blocks, (False, True)):
        block.train()
        calls.clear()
        with layers.global_statistics([block], group):
            y = layers.remat(block, x) if use_remat else block(x)
            y.backward(torch.ones_like(y))
        outs.append((y.detach(), dict(block.named_buffers()),
                     {k: p.grad for k, p in block.named_parameters()}, list(calls)))
    (y0, b0, g0, c0), (y1, b1, g1, c1) = outs
    assert torch.equal(y0, y1)
    assert all(torch.equal(b0[k], b1[k]) for k in b0)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert c0 == [2 * 6 + 1, 2 * 6] and c1 == [2 * 6 + 1, 2 * 6 + 1, 2 * 6]
    norm = blocks[0].BatchNorm_0
    before = (norm.running_mean.clone(), norm.running_var.clone())
    with layers.global_statistics([blocks[0]], group), layers._recomputing():
        blocks[0](x)
    assert torch.equal(norm.running_mean, before[0]) and torch.equal(norm.running_var, before[1])


def test_cpu_path_launches_no_kernel(group):
    _build.reset_launches()
    _port(_inputs(1, False), group)
    assert all(_build.launch_count(k) == 0 for k in bn.KERNELS)


_X = torch.zeros(SHAPE)
_C = SHAPE[1]


@pytest.mark.parametrize("call,match", [
    (lambda: bn.bn_stats_cuda(_X.half()), "float32 or bfloat16"),
    (lambda: bn.bn_stats_cuda(_X.double()), "float32 or bfloat16"),
    (lambda: bn.bn_stats_cuda(_X.transpose(2, 3)), "contiguous"),
    (lambda: bn.bn_stats_cuda(_X.contiguous(memory_format=torch.channels_last)), "contiguous"),
    (lambda: bn.bn_stats_cuda(_X[0]), r"\(N, C, H, W\)"),
    (lambda: bn.bn_stats_cuda(_X), "CUDA tensor"),
    (lambda: bn.bn_normalize_cuda(_X, torch.zeros(2 * _C), torch.ones(_C), torch.zeros(_C),
                                  torch.zeros(_C), torch.ones(_C), MOMENTUM, EPS),
     r"stats must be .*\(13,\)"),
    (lambda: bn.bn_normalize_cuda(_X, torch.zeros(2 * _C + 1), torch.ones(_C).double(),
                                  torch.zeros(_C), torch.zeros(_C), torch.ones(_C), MOMENTUM,
                                  EPS), "weight must be a contiguous float32"),
    (lambda: bn.bn_bwd_reduce_cuda(_X.bfloat16(), _X, torch.zeros(3 * _C + 1)), "g must be"),
    (lambda: bn.bn_bwd_reduce_cuda(_X[:, :, :4], _X[:, :, :4].contiguous(),
                                   torch.zeros(3 * _C + 1)), "g must be contiguous"),
    (lambda: bn.bn_bwd_elemt_cuda(_X, _X, torch.ones(_C), torch.zeros(3 * _C + 1),
                                  torch.zeros(2 * _C - 1)), "sums must be"),
    (lambda: bn.bn_bwd_elemt_cuda(_X, _X, torch.ones(_C), torch.zeros(3 * _C + 1),
                                  torch.zeros(4 * _C)), "CUDA tensor"),
], ids=["half", "double", "strided", "channels_last", "3d", "cpu", "stats_size",
        "weight_dtype", "g_dtype", "g_strided", "sums_size", "elemt_cpu"])
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(call, match):
    _build.reset_launches()
    with pytest.raises(ValueError, match=match):
        call()
    assert all(_build.launch_count(k) == 0 for k in bn.KERNELS)
