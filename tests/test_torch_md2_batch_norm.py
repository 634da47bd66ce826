"""Monodepth2's encoder BatchNorm (``ops/md2_batch_norm.py``: the plain
versions of its four kernels and ``Md2BatchNorm``; ``EncoderBatchNorm`` in
``models/monodepth2.py``) on the CPU. Monodepth2 is the port's alone:
nothing here is held against JAX.

* The plain versions, through ``Md2BatchNorm``, against ``F.batch_norm``
  followed by ``F.relu`` (with and without the ReLU, float32 and bfloat16):
  y, dx, dweight and dbias, and the running averages against the biased
  fold ``prev * (1 - m) + stat * m`` of float64 statistics. Tolerances:
  float32 1e-5 relative L2 (another order of float32 sums and the
  normalisation's ops in another grouping); bfloat16 values one bf16
  rounding apart at most (both sides compute in float32 from the same bf16
  inputs and round once), so 2^-8 relative L2; dweight and dbias are
  float32 sums of the same float32 products, 1e-5.
* A channel whose mean is 10^3 times its standard deviation: the variance
  within 1e-5 of float64's (no cancellation), y within the same bars.
* The backward's ReLU mask is the forward's: where y is 0 the cotangent
  does not pass, elsewhere it does.
* ``EncoderBatchNorm``: train mode on one process goes through
  ``Md2BatchNorm``, eval mode and a mesh's group through the parent with
  ``F.relu`` after; a remat recompute moves no running average; the nets
  put the ReLU after the stem's and each block's ``bn1`` only, and a train
  step runs 60 of them forward and backward.
* The CUDA wrappers refuse what the kernels do not take before launching,
  and the CPU path counts no launch.
"""

import pytest
import torch
import torch.nn.functional as F

from depthvo_tpu_torch import configs as tconfigs
from depthvo_tpu_torch.models import layers, monodepth2 as md2
from depthvo_tpu_torch.ops import _build, md2_batch_norm as mbn

torch.set_num_threads(2)

F32_RTOL = 1e-5
BF16_RTOL = 2.0 ** -8
SUM_RTOL = 1e-5
MOMENTUM, EPS = 0.1, 1e-5
SHAPE = (3, 5, 6, 7)


def _rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _inputs(dtype, seed=0, far_channel=False):
    g = torch.Generator().manual_seed(seed)
    n, c, h, w = SHAPE
    x = (torch.randn(SHAPE, generator=g) * (0.5 + 2 * torch.rand(1, c, 1, 1, generator=g))
         + torch.randn(1, c, 1, 1, generator=g))
    if far_channel:  # a mean 10^3 times the standard deviation
        x[:, 2] = 1e3 + torch.randn(n, h, w, generator=g)
    return {"x": x.to(dtype), "g": torch.randn(SHAPE, generator=g).to(dtype),
            "w": 1.0 + 0.2 * torch.randn(c, generator=g), "b": 0.3 * torch.randn(c, generator=g),
            "rm": torch.randn(c, generator=g), "rv": 0.5 + torch.rand(c, generator=g)}


def _port(d, relu, update=True):
    x = d["x"].clone().requires_grad_(True)
    w, b = d["w"].clone().requires_grad_(True), d["b"].clone().requires_grad_(True)
    rm, rv = d["rm"].clone(), d["rv"].clone()
    y = mbn.Md2BatchNorm.apply(x, w, b, rm, rv, MOMENTUM, EPS, relu, update)
    y.backward(d["g"])
    return y.detach(), x.grad, w.grad, b.grad, rm, rv


def _library(d, relu):
    """F.batch_norm then F.relu in float32 on the same inputs, cast to x's
    dtype, with autograd's gradients."""
    x = d["x"].float().requires_grad_(True)
    w, b = d["w"].clone().requires_grad_(True), d["b"].clone().requires_grad_(True)
    y = F.batch_norm(x, None, None, w, b, True, 0.0, EPS)
    if relu:
        y = F.relu(y)
    y.backward(d["g"].float())
    return y.detach().to(d["x"].dtype), x.grad.to(d["x"].dtype), w.grad, b.grad


def _running(d):
    """The running averages after one step: the biased fold of float64
    statistics."""
    x = d["x"].double()
    mean = x.mean((0, 2, 3))
    var = ((x - mean.view(1, -1, 1, 1)) ** 2).mean((0, 2, 3))
    return (d["rm"].double() * (1 - MOMENTUM) + mean * MOMENTUM,
            d["rv"].double() * (1 - MOMENTUM) + var * MOMENTUM)


@pytest.mark.parametrize("far_channel", [False, True], ids=["plain", "far_mean"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "none"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_versions_equal_batch_norm_then_relu(dtype, relu, far_channel):
    d = _inputs(dtype, seed=1, far_channel=far_channel)
    y, dx, dw, db, rm, rv = _port(d, relu)
    y_l, dx_l, dw_l, db_l = _library(d, relu)
    tol = F32_RTOL if dtype == torch.float32 else BF16_RTOL
    assert y.dtype == dx.dtype == dtype
    assert _rel(y, y_l) < tol and _rel(dx, dx_l) < tol
    assert _rel(dw, dw_l) < SUM_RTOL and _rel(db, db_l) < SUM_RTOL
    want_rm, want_rv = _running(d)
    assert _rel(rm, want_rm) < F32_RTOL and _rel(rv, want_rv) < F32_RTOL
    if far_channel:  # the far channel's own variance, not lost to cancellation
        assert abs(float(rv[2]) - float(want_rv[2])) < F32_RTOL * float(want_rv[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_the_backward_masks_where_the_forward_clips(dtype):
    d = _inputs(dtype, seed=2)
    y, *_ = _port(d, True)
    save = mbn.forward_plain(d["x"], d["w"], d["b"], d["rm"].clone(), d["rv"].clone(), MOMENTUM,
                             EPS, True)[1]
    ones = torch.ones_like(d["x"])
    gp, _ = mbn._grad_in(ones, d["x"], save, d["w"], d["b"], True)
    assert 0.2 < float((y == 0).float().mean()) < 0.8
    assert torch.equal(gp != 0, y > 0)
    # The sum of g' is the sum of g where y > 0.
    dwb = mbn.bwd_reduce_plain(d["g"], d["x"], save, d["w"], d["b"], True)
    want = torch.where(y > 0, d["g"].float(), torch.zeros(())).sum((0, 2, 3))
    assert torch.allclose(dwb[SHAPE[1]:], want, rtol=1e-6, atol=1e-6)


def test_the_elementwise_stages_compose_the_closed_form():
    """On the same statistics, normalize_plain is the pre-activation's
    float32 ops and bwd_elemt_plain the closed form of dx."""
    d = _inputs(torch.float64, seed=3)
    x, g, w, b = d["x"], d["g"], d["w"].double(), d["b"].double()
    mean, var, rstd = mbn.stats_plain(x, EPS)
    save = torch.cat([mean, rstd]).double()
    shape = (1, -1, 1, 1)
    xhat = (x - mean.double().view(shape)) * rstd.double().view(shape)
    pre = xhat * w.view(shape) + b.view(shape)
    assert torch.allclose(mbn.normalize_plain(x, save, w, b, True).double(), pre.clamp_min(0),
                          rtol=1e-6, atol=1e-6)
    gp = torch.where(pre > 0, g, torch.zeros(()))
    n = x.numel() // x.shape[1]
    dwb = mbn.bwd_reduce_plain(g, x, save, w, b, True).double()
    want_dx = (w * rstd.double()).view(shape) / n * (
        n * gp - gp.sum((0, 2, 3)).view(shape) - xhat * (gp * xhat).sum((0, 2, 3)).view(shape))
    got = mbn.bwd_elemt_plain(g, x, save, w, b, dwb, True).double()
    assert _rel(got, want_dx) < 1e-5


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "none"])
def test_encoder_batch_norm_equals_the_parent_and_relu(relu):
    d = _inputs(torch.float32, seed=4)
    mine, parent = md2.EncoderBatchNorm(SHAPE[1], relu), layers.BatchNorm(SHAPE[1],
                                                                           momentum=MOMENTUM)
    for m in (mine, parent):
        with torch.no_grad():
            m.weight.copy_(d["w"])
            m.bias.copy_(d["b"])
            m.running_mean.copy_(d["rm"])
            m.running_var.copy_(d["rv"])
    for train in (True, False):
        mine.train(train)
        parent.train(train)
        x1 = d["x"].clone().requires_grad_(True)
        x2 = d["x"].clone().requires_grad_(True)
        y1 = mine(x1)
        y2 = parent(x2)
        y2 = F.relu(y2) if relu else y2
        (y1 * d["g"]).sum().backward()
        (y2 * d["g"]).sum().backward()
        assert _rel(y1, y2) < F32_RTOL and _rel(x1.grad, x2.grad) < F32_RTOL
        for a, b in ((mine.weight.grad, parent.weight.grad), (mine.bias.grad, parent.bias.grad),
                     (mine.running_mean, parent.running_mean),
                     (mine.running_var, parent.running_var)):
            assert _rel(a, b) < F32_RTOL
        mine.zero_grad()
        parent.zero_grad()


def test_encoder_batch_norm_takes_the_kernels_path_only_in_train_mode_on_one_process(
        monkeypatch):
    calls = []
    real = mbn.Md2BatchNorm.apply
    monkeypatch.setattr(mbn.Md2BatchNorm, "apply",
                        lambda *a: calls.append(a[-2:]) or real(*a))
    bn = md2.EncoderBatchNorm(SHAPE[1], relu=True)
    x = _inputs(torch.float32)["x"]
    bn.train()(x)
    bn.eval()(x)
    assert calls == [(True, True)]
    # A mesh's group: the parent's global statistics, the ReLU after them.
    globals_ = []
    monkeypatch.setattr(layers.GlobalBatchNorm, "apply",
                        lambda x, *a: globals_.append(a) or x - 1.0)
    bn.train().group = object()
    assert torch.equal(bn(x), F.relu(x - 1.0))
    assert len(globals_) == 1 and calls == [(True, True)]


def test_a_remat_recompute_moves_no_running_average():
    bn = md2.EncoderBatchNorm(SHAPE[1], relu=True).train()
    x = _inputs(torch.float32, seed=5)["x"]
    before = (bn.running_mean.clone(), bn.running_var.clone())
    layers._RECOMPUTE.on = True
    try:
        y = bn(x)
    finally:
        layers._RECOMPUTE.on = False
    assert torch.equal(bn.running_mean, before[0]) and torch.equal(bn.running_var, before[1])
    assert torch.equal(y, bn(x))  # the same output; now they move
    assert not torch.equal(bn.running_mean, before[0])


def test_the_nets_fuse_the_relu_after_each_bn1_only():
    for net in (md2.Monodepth2DepthNet(), md2.Monodepth2PoseNet()):
        bns = {n: m for n, m in net.named_modules() if isinstance(m, layers.BatchNorm)}
        assert all(type(m) is md2.EncoderBatchNorm for m in bns.values())
        fused = sorted(n for n, m in bns.items() if m.relu)
        assert len(bns) == 20 and len(fused) == 9
        assert all(n.endswith("bn1") for n in fused)
        assert all(m.momentum == md2.BN_MOMENTUM and m.eps == 1e-5 for m in bns.values())


def test_a_step_runs_sixty_encoder_batch_norms_each_way(monkeypatch):
    """The depth encoder once and the pose encoder twice: 20 BatchNorms
    each, 27 with the ReLU, forward and backward (the kernels' wrappers
    count on the card; here the plain versions' calls are counted)."""
    from depthvo_tpu_torch.train import loop as tloop, state as tstate
    from depthvo_tpu_torch.data.synthetic import SyntheticScenes

    model = tconfigs.ModelConfig(height=64, width=192, num_scales=4, max_disp=9.99,
                                 min_disp=0.01, s2d_finest=False, compute_dtype="float32")
    cfg = tconfigs.monodepth2_ms(batch_size=2, model=model)
    calls = {"fwd": [], "bwd": []}
    fwd, bwd = mbn.forward_plain, mbn.backward_plain
    monkeypatch.setattr(mbn, "forward_plain",
                        lambda *a, **k: calls["fwd"].append(a[7]) or fwd(*a, **k))
    monkeypatch.setattr(mbn, "backward_plain",
                        lambda *a: calls["bwd"].append(a[5]) or bwd(*a))
    torch.manual_seed(0)
    models = tstate.build_models(cfg)
    state = tstate.TrainState(0, models.train(), tstate.make_optimizer(cfg).init(
        tstate.param_tree(models)))
    batch = {k: torch.from_numpy(v)
             for k, v in SyntheticScenes(cfg, seed=5, u8=True).fixed_batch(2).items()}
    tloop.make_train_step(cfg, device="cpu")(state, batch)
    assert len(calls["fwd"]) == len(calls["bwd"]) == 60
    assert sum(calls["fwd"]) == sum(calls["bwd"]) == 27


@pytest.mark.parametrize("call, match", [
    (lambda: mbn.stats_cuda(torch.zeros(2, 3, 4, 4)), "CUDA tensor"),
    (lambda: mbn.stats_cuda(torch.zeros(2, 3, 4, 4, dtype=torch.float16)), "float32 or bfloat16"),
    (lambda: mbn.stats_cuda(torch.zeros(2, 3, 4)), r"\(N, C, H, W\)"),
    (lambda: mbn.stats_cuda(torch.zeros(2, 4, 4, 3).permute(0, 3, 1, 2)), "contiguous"),
    (lambda: mbn.normalize_cuda(torch.zeros(2, 3, 4, 4), torch.zeros(9), torch.ones(3),
                                torch.zeros(3), torch.zeros(3), torch.ones(2), 0.1, 1e-5, True),
     "running_var"),
    (lambda: mbn.bwd_reduce_cuda(torch.zeros(2, 3, 4, 5), torch.zeros(2, 3, 4, 4),
                                 torch.zeros(6), torch.ones(3), torch.zeros(3), True), "g must"),
    (lambda: mbn.bwd_elemt_cuda(torch.zeros(2, 3, 4, 4), torch.zeros(2, 3, 4, 4), torch.zeros(6),
                                torch.ones(3), torch.zeros(3), torch.zeros(5), True), "partial"),
])
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(call, match):
    before = sum(_build.LAUNCHES.values())
    with pytest.raises(ValueError, match=match):
        call()
    assert sum(_build.LAUNCHES.values()) == before


def test_cpu_path_launches_no_kernel():
    before = sum(_build.LAUNCHES.values())
    _port(_inputs(torch.float32, seed=6), True)
    assert sum(_build.LAUNCHES.values()) == before


@pytest.mark.parametrize("shape, chunks", [
    ((12, 64, 160, 512), 8), ((12, 64, 80, 256), 8), ((12, 128, 40, 128), 4),
    ((12, 256, 20, 64), 2), ((12, 512, 10, 32), 1), ((2, 700, 3, 5), 1), ((1, 1, 1, 1), 1),
])
def test_the_grid_fills_the_card_once(shape, chunks):
    N, C, H, W = shape
    got = mbn.chunks_of(N, C, H * W, 2)
    assert got == chunks
    assert got * C <= max(mbn.TARGET_BLOCKS, C)
