"""w8a8 int8 serving of the port (``layers.QuantConv``, ``ops/int8_conv.py``,
``DepthVO.calibrate_int8``) held against the flax reference on the CPU.

* One ``QuantConv`` with the weights, input and ``a_max`` of the
  reference's: within 1e-6 (bit for bit expected: the same f32 divisions,
  round half to even, an exact int32 sum, the same dequantisation).
* The int8 convolution (im2col + ``torch._int_mm``) against its plain
  version (float64 ``F.conv2d`` on the codes): equal, over strides 1/2,
  kernels 1/3/7, a K that needs padding to a multiple of 8, chunks of the
  batch and outputs of fewer than 17 pixels.
* ``calibrate_int8`` on the same weights and frames: every ``a_max``
  within 2e-5 relative of the reference's.
* The int8 depth with the reference's ``quant`` carried over by
  ``quant_from_jax``: rtol 2e-3 / atol 2e-3, the reference's own int8 bar
  (tests/test_serving.py); a code can flip where an activation sits on a
  rounding edge.
* The guards: NaN when uncalibrated, ``uncalibrate`` bit for bit, the
  zero-scale ``ValueError``, ``s2d_finest`` with a quant mode, the same
  state dict in every mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthvo_tpu import api as japi, configs as jconfigs
from depthvo_tpu.models import layers as jlayers
from depthvo_tpu_torch import DepthVO, configs as tconfigs
from depthvo_tpu_torch.io.from_jax import quant_from_jax
from depthvo_tpu_torch.models import layers as tlayers
from depthvo_tpu_torch.models.depth_net import DepthNet
from depthvo_tpu_torch.ops import int8_conv
from depthvo_tpu_torch.train import state as tstate
from test_torch_checkpoint import _to_flax
from test_torch_models import _perturb_bn

torch.set_num_threads(2)
torch.exp(torch.zeros(1))  # MKL's first call on one thread (test_torch_models.py)

CPU = torch.device("cpu")
CONV_TOL = 1e-6
A_MAX_RTOL = 2e-5
INT8_RTOL = INT8_ATOL = 2e-3


def _flax_conv(x, kernel, bias, a_max, stride):
    mod = jlayers.QuantConv(kernel.shape[-1], kernel=kernel.shape[0], stride=stride,
                            use_bias=bias is not None)
    params = {"kernel": kernel} | ({"bias": bias} if bias is not None else {})
    return np.asarray(mod.apply({"params": params, "quant": {"a_max": a_max}}, x))


def _port_conv(x, kernel, bias, a_max, stride):
    conv = tlayers.QuantConv(kernel.shape[2], kernel.shape[3], kernel.shape[0], stride,
                             bias=bias is not None, mode="int8")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        if bias is not None:
            conv.bias.copy_(torch.from_numpy(bias))
        conv.a_max.fill_(float(a_max))
        conv.quantize()
        y = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("kernel,stride,bias,cin", [
    (3, 1, True, 4), (3, 2, False, 6), (7, 2, False, 3), (1, 1, False, 8), (1, 2, True, 5)])
def test_quant_conv_matches_flax(kernel, stride, bias, cin):
    rng = np.random.default_rng(kernel * 10 + stride)
    x = rng.normal(size=(2, 11, 14, cin)).astype(np.float32)
    k = (rng.normal(size=(kernel, kernel, cin, 8)) / np.sqrt(cin * kernel ** 2)).astype(np.float32)
    b = rng.normal(size=8).astype(np.float32) if bias else None
    a_max = np.float32(np.abs(x).max() * 0.9)  # some activations clip
    want = _flax_conv(x, k, b, a_max, stride)
    got = _port_conv(x, k, b, a_max, stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=CONV_TOL)


@pytest.mark.parametrize("cin,kernel,stride,hw", [
    (8, 1, 1, (9, 13)), (16, 1, 2, (9, 13)), (4, 3, 1, (10, 7)), (6, 3, 2, (11, 9)),
    (3, 7, 2, (12, 20)),  # the stem: K = 147 pads to 152
    (5, 3, 1, (3, 4)),  # 12 output pixels: the GEMM gets 17 zero rows
])
def test_int8_conv_equals_its_plain_version(cin, kernel, stride, hw, monkeypatch):
    gen = torch.Generator().manual_seed(cin + kernel)
    x = torch.randint(-127, 128, (5, cin, *hw), dtype=torch.int8, generator=gen)
    w = torch.randint(-127, 128, (16, cin, kernel, kernel), dtype=torch.int8, generator=gen)
    ph = tlayers.same_pads(hw[0], kernel, stride)
    pw = tlayers.same_pads(hw[1], kernel, stride)
    pads = (pw[0], pw[1], ph[0], ph[1])
    want = int8_conv.int8_conv2d_plain(x, w, stride, 1, pads)
    for budget in (int8_conv.IM2COL_BUDGET_BYTES, 1):  # one chunk; one image per chunk
        monkeypatch.setattr(int8_conv, "IM2COL_BUDGET_BYTES", budget)
        got = int8_conv.int8_conv2d(x, int8_conv.weight_matrix(w), kernel, stride, 1, pads)
        assert got.dtype == torch.int32 and torch.equal(got, want)
    assert int8_conv.weight_matrix(w).shape[1] % 8 == 0


def test_int8_conv_is_exact_at_the_extremes():
    """All codes at +-127: the largest sums, still exact in the plain
    version's float64."""
    x = torch.full((2, 32, 6, 6), 127, dtype=torch.int8)
    w = torch.full((8, 32, 3, 3), -127, dtype=torch.int8)
    got = int8_conv.int8_conv2d(x, int8_conv.weight_matrix(w), 3, 1, 1, (1, 1, 1, 1))
    want = int8_conv.int8_conv2d_plain(x, w, 1, 1, (1, 1, 1, 1))
    assert torch.equal(got, want) and int(got.min()) == -127 * 127 * 32 * 9


@pytest.fixture(scope="module")
def models():
    """The same tiny_test weights in both packages (BatchNorm perturbed),
    and uint8 frames."""
    tcfg = tconfigs.tiny_test()
    state = tstate.create_state(tcfg, CPU, torch.Generator().manual_seed(5))
    params, stats = _to_flax(state.models)
    rng = np.random.default_rng(6)
    params["depth"] = _perturb_bn(params["depth"], rng)
    stats = _perturb_bn(stats, rng)
    frames = rng.integers(0, 256, size=(2, 32, 96, 3), dtype=np.uint8)
    jmodel = japi.DepthVO(jconfigs.tiny_test(), params, stats)
    tmodel = DepthVO.from_jax_params(tcfg, params, stats, device="cpu")
    return dict(jmodel=jmodel, tmodel=tmodel, frames=frames, params=params, stats=stats,
                tcfg=tcfg)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = float(np.asarray(v))
    return out


@pytest.fixture(scope="module")
def calibrated(models):
    jm, tm, frames = models["jmodel"], models["tmodel"], models["frames"]
    f32 = tm.depth(frames)
    jm.calibrate_int8(frames)
    tm.calibrate_int8(frames)
    return dict(models, f32=f32, jquant=jax.device_get(jm.quant))


def test_calibration_matches_jax(calibrated):
    want = _flat(calibrated["jquant"])
    got = _flat(calibrated["tmodel"].quant)
    assert set(got) == set(want) and len(want) == 63
    rel = {k: abs(got[k] - want[k]) / want[k] for k in want}
    assert max(rel.values()) <= A_MAX_RTOL, max(rel.items(), key=lambda kv: kv[1])


def test_int8_depth_matches_jax_with_its_quant(calibrated):
    """The reference's scales seated with ``set_quant`` (``quant_from_jax``):
    the int8 depth within the reference's int8 bar, and not the float
    depth."""
    jm, frames = calibrated["jmodel"], calibrated["frames"]
    tm = DepthVO.from_jax_params(calibrated["tcfg"], calibrated["params"], calibrated["stats"],
                                 device="cpu")
    tm.set_quant(calibrated["jquant"])
    want = jm.depth(frames)
    got = tm.depth(frames)
    np.testing.assert_allclose(got, want, rtol=INT8_RTOL, atol=INT8_ATOL)
    assert not np.allclose(got, calibrated["f32"], rtol=1e-4)
    assert _flat(tm.quant) == _flat(calibrated["jquant"])


def test_quant_from_jax_consumes_every_leaf(calibrated):
    sd = quant_from_jax(calibrated["jquant"])
    assert len(sd) == 63 and "ResNetStage_3.Bottleneck_0.ConvBlock_3.Conv_0" in sd
    assert "ConvBlock_0.Conv_0" in sd and not any(k.startswith("Conv_") for k in sd)
    bad = {"ConvBlock_0": {"Conv_0": {"scale": np.float32(1.0)}}}
    with pytest.raises(ValueError, match="unexpected quant leaf"):
        quant_from_jax(bad)
    tm = DepthVO.from_jax_params(calibrated["tcfg"], calibrated["params"], calibrated["stats"],
                                 device="cpu")
    partial = dict(calibrated["jquant"])
    partial.pop("UpConv_0")
    with pytest.raises(KeyError, match="missing"):
        tm.set_quant(partial)


def test_repeated_calibration_keeps_the_running_max(models):
    tm = DepthVO.from_jax_params(models["tcfg"], models["params"], models["stats"],
                                 device="cpu")
    frames = models["frames"]
    tm.calibrate_int8(frames[:1])
    first = _flat(tm.quant)
    tm.calibrate_int8(frames[1:])
    second = _flat(tm.quant)
    tm.calibrate_int8(frames[:1])
    assert _flat(tm.quant) == second
    assert all(second[k] >= first[k] for k in first) and second != first


def test_uncalibrate_restores_the_float_forward(calibrated):
    tm, frames = calibrated["tmodel"], calibrated["frames"]
    q = tm.depth(frames)
    assert np.isfinite(q).all() and not np.array_equal(q, calibrated["f32"])
    tm.uncalibrate()
    assert tm.quant is None
    np.testing.assert_array_equal(tm.depth(frames), calibrated["f32"])
    tm.calibrate_int8(frames)  # the module fixture's state again
    np.testing.assert_array_equal(tm.depth(frames), q)


def test_uncalibrated_int8_is_nan():
    conv = tlayers.QuantConv(4, 6, 3, mode="int8")
    conv.quantize()  # a_max stays 0
    with torch.no_grad():
        y = conv(torch.randn(1, 4, 8, 12))
    assert torch.isnan(y).all()
    with pytest.raises(RuntimeError, match="quantize"):
        tlayers.QuantConv(4, 6, 3, mode="int8")(torch.randn(1, 4, 8, 12))


def test_zero_scales_raise(models):
    """Float frames of zeros give the stem a zero scale: the reference's
    ValueError names it, and depth stays on the float forward."""
    tm = DepthVO.from_jax_params(models["tcfg"], models["params"], models["stats"],
                                 device="cpu")
    zeros = np.zeros((1, 32, 96, 3), np.float32)
    f32 = tm.depth(zeros)
    with pytest.raises(ValueError, match=r"zero activation scales at \['ConvBlock_0/Conv_0/a_max'"):
        tm.calibrate_int8(zeros)
    np.testing.assert_array_equal(tm.depth(zeros), f32)


def test_modes_keep_the_state_dict_and_refuse_s2d():
    """Every quant mode has the float net's state dict (names, shapes):
    checkpoints and ``from_jax`` load unchanged; the heads stay float.
    ``s2d_finest`` with a quant mode raises, and ``build_models`` turns it
    off for quantized serving, as the reference does."""
    cfg = tconfigs.tiny_test()
    shapes = {}
    for mode in ("off", "calibrate", "int8"):
        net = tstate.build_models(cfg, depth_quant=mode).depth
        shapes[mode] = {k: tuple(v.shape) for k, v in net.state_dict().items()}
        convs = net.quant_convs()
        assert len(convs) == (0 if mode == "off" else 63)
        assert not any(k.startswith("Conv_") for k in convs)
    assert shapes["off"] == shapes["calibrate"] == shapes["int8"]
    with pytest.raises(ValueError, match="s2d_finest is a training-graph lever"):
        DepthNet(s2d_finest=True, quant_mode="int8")
    s2d = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, s2d_finest=True))
    assert tstate.build_models(s2d, depth_quant="calibrate").depth.quant_mode == "calibrate"
    assert tstate.build_models(cfg).depth.quant_mode == "off"


def test_bfloat16_int8_runs_outside_autocast(models):
    """With compute_dtype bfloat16 the int path leaves autocast and casts
    explicitly: finite depth close to the bfloat16 float forward."""
    cfg = dataclasses.replace(models["tcfg"], model=dataclasses.replace(
        models["tcfg"].model, compute_dtype="bfloat16"))
    tm = DepthVO.from_jax_params(cfg, models["params"], models["stats"], device="cpu")
    frames = models["frames"]
    f = tm.depth(frames)
    q = tm.calibrate_int8(frames).depth(frames)
    assert np.isfinite(q).all()
    assert np.median(np.abs(q - f) / f) < 0.08


def test_device_independent_float_parts():
    """The int8 forward's float parts divide and normalise in separate,
    correctly rounded ops, so every device gives the CPU's bits:
    ``BatchNorm.eval_ieee`` agrees with eval-mode BatchNorm to the last
    bits, and ``to_unit`` is the loaders' ``x / 127.5 - 1`` exactly."""
    from depthvo_tpu_torch.utils.images import to_unit

    rng = np.random.default_rng(11)
    bn = tlayers.BatchNorm(6).eval()
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.from_numpy(rng.normal(size=6).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, 6).astype(np.float32)))
        x = torch.from_numpy(rng.normal(size=(2, 6, 5, 7)).astype(np.float32))
        np.testing.assert_allclose(bn.eval_ieee(x).numpy(), bn(x).numpy(), rtol=1e-6,
                                   atol=1e-6)
        assert bn.eval_ieee(x.bfloat16()).dtype == torch.bfloat16
    codes = torch.arange(256, dtype=torch.uint8)
    assert torch.equal(to_unit(codes), codes.float() / 127.5 - 1.0)
