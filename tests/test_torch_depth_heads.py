"""The rest of DepthNet (the subpixel and fast-final heads, ``remat``) held
against the flax reference on the CPU, at ``tiny_test``'s size.

* Parameter trees: for each head the port's networks carry exactly the
  leaves, names and shapes of the reference's ``init`` (flax's
  auto-naming: the subpixel conv is the ``Conv_k`` after the coarse
  heads; the fast-final net has no ``UpConv_4``, ``ConvBlock_5`` or
  finest ``Conv``), so ``io/from_jax.py`` consumes every leaf.
* Same weights (the port's initial draw carried to flax, BatchNorm
  perturbed, a real odometry motion) and same inputs: every scale's
  inverse depth within 2e-5 of its largest magnitude, the eval-mode
  gradients of the depth net within 2e-4 relative L2 per leaf
  (ROADMAP's bars), and a train step's loss terms within 1e-5 relative.
* ``remat`` against no ``remat``: one train step, bit for bit
  (parameters, BatchNorm statistics, every solver tensor, the losses),
  for the standard stage in float32 and bfloat16 and for both heads.
* The reference's refusal of two finest-stage modes at once, in both
  packages; ``depth_to_space2``'s channel order; a checkpoint of a remat
  net moving to a non-remat net and back.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from depthvo_tpu import configs as jconfigs
from depthvo_tpu.models import layers as jlayers
from depthvo_tpu.train import loop as jloop, state as jstate
from depthvo_tpu_torch import configs as tconfigs
from depthvo_tpu_torch.data.synthetic import SyntheticScenes
from depthvo_tpu_torch.io import checkpoint as ckpt
from depthvo_tpu_torch.io.from_jax import load_jax_params, params_from_jax
from depthvo_tpu_torch.models import layers as tlayers
from depthvo_tpu_torch.train import loop as tloop, state as tstate
from test_torch_checkpoint import _to_flax
from test_torch_models import _perturb_bn

torch.set_num_threads(2)
torch.exp(torch.zeros(1))  # MKL's first call on one thread (test_torch_models.py)

CPU = torch.device("cpu")
RTOL = 2e-5
GRAD_RTOL = 2e-4
LOSS_RTOL = 1e-5
MOTION_BIAS = np.array([2.0, -1.0, -30.0, 0.2, -0.3, 0.1], np.float32)
HEADS = {
    "standard": {},
    "subpixel": {"s2d_finest": False, "subpixel_head": True},
    "fast_final": {"s2d_finest": False, "fast_final_upsample": True},
}


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, deleted at teardown (checkpoints)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _model_cfg(config_mod, **model):
    cfg = config_mod.tiny_test()
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model))


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


@pytest.fixture(scope="module", params=["subpixel", "fast_final"])
def head(request):
    """One head's networks in both packages with the same weights."""
    name = request.param
    tcfg, jcfg = _model_cfg(tconfigs, **HEADS[name]), _model_cfg(jconfigs, **HEADS[name])
    state = tstate.create_state(tcfg, CPU, torch.Generator().manual_seed(3))
    params, stats = _to_flax(state.models)
    rng = np.random.default_rng(4)
    params["depth"] = _perturb_bn(params["depth"], rng)
    stats = _perturb_bn(stats, rng)
    params["odom"]["Dense_2"]["bias"] = MOTION_BIAS
    models = load_jax_params(tstate.build_models(tcfg), params, stats)
    return dict(name=name, tcfg=tcfg, jcfg=jcfg, jnets=jstate.build_models(jcfg),
                params=params, stats=stats, models=models)


def _shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = tuple(v.shape)
    return out


def test_parameter_trees_are_the_references(head):
    """The reference's ``init`` (shapes only, no compile) names the leaves
    the port's networks carry. Neither head has the full-resolution
    ``UpConv_4`` / ``ConvBlock_5``; the subpixel conv (4 channels) is
    ``Conv_{num_scales - 1}``, and fast-final has no finest ``Conv``."""
    dn = head["jnets"][0]
    img = jnp.zeros((1, 32, 96, 3))
    ref = jax.eval_shape(lambda k: dn.init(k, img), jax.random.PRNGKey(0))
    assert _shapes(head["params"]["depth"]) == _shapes(ref["params"])
    assert _shapes(head["stats"]) == _shapes(ref["batch_stats"])
    names = set(ref["params"])
    assert not names & {"UpConv_4", "ConvBlock_5"}
    if head["name"] == "subpixel":
        assert ref["params"]["Conv_1"]["kernel"].shape == (3, 3, 32, 4)
    else:
        assert "Conv_1" not in names
        assert ref["params"]["Conv_0"]["kernel"].shape == (3, 3, 32, 1)
    extra = {**head["params"], "depth": {**head["params"]["depth"], "Conv_7":
                                         head["params"]["depth"]["Conv_0"]}}
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_params(tstate.build_models(head["tcfg"]), extra, head["stats"])


def test_depth_and_gradients_match_the_reference(head):
    """Eval mode (BatchNorm on its running averages): every scale's output,
    and the gradients of sum_s <w_s, disp_s> with respect to every depth
    net parameter."""
    dn = head["jnets"][0]
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (2, 32, 96, 3)).astype(np.float32)
    ws = [rng.normal(size=(2, 16, 48, 1)).astype(np.float32),
          rng.normal(size=(2, 32, 96, 1)).astype(np.float32)]

    def loss(p):
        disps = dn.apply({"params": p, "batch_stats": head["stats"]}, x)
        return sum(jnp.sum(w * d) for w, d in zip(ws, disps)), disps

    (_, ref), ref_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, head["params"]["depth"]))
    net = head["models"].depth.eval()
    got = net(torch.from_numpy(x))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape
        assert np.abs(g.detach().numpy() - r).max() <= RTOL * np.abs(r).max()
    net.zero_grad()
    sum((torch.from_numpy(w) * d).sum() for w, d in zip(ws, got)).backward()
    ref_grads = params_from_jax({"depth": jax.device_get(ref_grads)}, {})["depth"]
    grads = dict(net.named_parameters())
    assert set(grads) == set(ref_grads)
    for k, r in ref_grads.items():
        assert _rel_l2(grads[k].grad, r) <= GRAD_RTOL, k


def test_train_step_losses_match_the_reference(head):
    """The staged loss graph in train mode (batch statistics) on the same
    batch: each loss term within 1e-5 relative."""
    jcfg = head["jcfg"]
    batch = SyntheticScenes(head["tcfg"], seed=6, num_scenes=2).fixed_batch(2)
    ref = jax.jit(lambda p, b: jloop.compute_losses(
        jcfg, head["jnets"], p, head["stats"], b, train=True)[1][0])(head["params"], batch)
    state = tstate.TrainState(0, head["models"], tstate.make_optimizer(head["tcfg"]).init(
        tstate.param_tree(head["models"])))
    _, got = tloop.make_train_step(head["tcfg"], "cpu")(state, batch)
    assert {k for k in got if k.startswith("loss/")} == {k for k in ref if k.startswith("loss/")}
    for k, r in jax.device_get(ref).items():
        assert abs(float(got[k]) - float(r)) <= LOSS_RTOL * abs(float(r)), (k, float(got[k]), r)


def _tensors(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _tensors(t)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tensors(tree[k])]
    return []


@pytest.mark.parametrize("mode", ["standard", "standard-bf16", "subpixel", "fast_final"])
def test_remat_is_bit_for_bit(mode):
    """One train step with ``remat`` and one without, from the same state
    and batch: equal parameters, BatchNorm statistics (moved once: the
    recompute writes none), solver tensors and losses. In bfloat16 the
    recompute runs under the forward's autocast."""
    head_kw = HEADS[mode.split("-")[0]]
    dtype = "bfloat16" if mode.endswith("bf16") else "float32"
    batch = SyntheticScenes(tconfigs.tiny_test(), seed=7, num_scenes=2, u8=True).fixed_batch(2)
    out = []
    for remat in (False, True):
        cfg = _model_cfg(tconfigs, remat=remat, compute_dtype=dtype, **head_kw)
        state = tstate.create_state(cfg, CPU, torch.Generator().manual_seed(8))
        before = {k: v.clone() for k, v in state.models.depth.state_dict().items()}
        state, metrics = tloop.make_train_step(cfg, "cpu")(state, batch)
        out.append((tstate.state_dict(state), metrics, before))
    (a, ma, before), (b, mb, _) = out
    assert set(ma) == set(mb)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for name in a["nets"]:
        assert list(a["nets"][name]) == list(b["nets"][name])
        for k in a["nets"][name]:
            assert torch.equal(a["nets"][name][k], b["nets"][name][k]), (name, k)
    ta, tb = _tensors(a["opt_state"]), _tensors(b["opt_state"])
    assert len(ta) == len(tb) > 0
    assert all(torch.equal(x, y) for x, y in zip(ta, tb))
    stats = [k for k in before if k.endswith("running_mean")]
    assert stats and all(not torch.equal(before[k], a["nets"]["depth"][k]) for k in stats)


@pytest.mark.parametrize("modes", [
    ("fast_final_upsample", "subpixel_head"), ("fast_final_upsample", "s2d_finest"),
    ("subpixel_head", "s2d_finest"), ("fast_final_upsample", "subpixel_head", "s2d_finest"),
])
def test_conflicting_finest_modes_raise(modes):
    """Both packages refuse two finest-stage modes. The port runs the
    standard stage for ``s2d_finest`` but counts it, as the reference
    does: a config that wants a head sets ``s2d_finest=False``."""
    kw = {"s2d_finest": False, **{m: True for m in modes}}
    with pytest.raises(ValueError, match="mutually exclusive"):
        tstate.build_models(_model_cfg(tconfigs, **kw))
    dn = jstate.build_models(_model_cfg(jconfigs, **kw))[0]
    with pytest.raises(ValueError, match="mutually exclusive"):
        jax.eval_shape(lambda k: dn.init(k, jnp.zeros((1, 32, 96, 3))), jax.random.PRNGKey(0))


@pytest.mark.parametrize("channels", [1, 3])
def test_depth_to_space2_matches_the_reference(channels):
    x = np.random.default_rng(9).normal(size=(2, 3, 5, 4 * channels)).astype(np.float32)
    got = tlayers.depth_to_space2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jlayers.depth_to_space2(x)))
    if channels == 1:  # pixel_shuffle's order, c = 2 dy + dx, is the same for one channel
        shuffled = F.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
        np.testing.assert_array_equal(shuffled.permute(0, 2, 3, 1).numpy(), got)


def test_remat_checkpoint_moves_to_a_plain_net_and_back(tmp_path):
    """A checkpoint of a remat subpixel net (the stereo stage: the depth
    net alone) restores into the same net without remat, and that one's
    checkpoint back into a remat net, every tensor equal."""
    def cfg(remat):
        c = _model_cfg(tconfigs, remat=remat, **HEADS["subpixel"])
        return dataclasses.replace(c, use_temporal=False, use_feature=False)

    src = tstate.create_state(cfg(True), CPU, torch.Generator().manual_seed(10))
    ckpt.save(ckpt.make_manager(str(tmp_path / "remat")), src)
    plain = ckpt.restore_weights(str(tmp_path / "remat"), tstate.create_state(cfg(False), CPU))
    assert not plain.models.depth.remat
    ckpt.save(ckpt.make_manager(str(tmp_path / "plain")), plain)
    back = ckpt.restore_weights(str(tmp_path / "plain"), tstate.create_state(cfg(True), CPU))
    want = src.models.depth.state_dict()
    for net in (plain, back):
        got = net.models.depth.state_dict()
        assert list(got) == list(want)
        assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("head", ["subpixel", "fast_final"])
def test_cli_train_config_with_a_head(head, tmp_path, capsys):
    """``cli train --config`` (the reference's flag: a whole experiment
    config from JSON) trains a net with a head; the step logs finite
    losses."""
    from depthvo_tpu_torch import cli
    from depthvo_tpu_torch.configs import base as tbase

    path = str(tmp_path / "exp.json")
    tbase.save_json(_model_cfg(tconfigs, remat=True, **HEADS[head]), path)
    assert cli.main(["train", "--config", path, "--device", "cpu", "--steps", "1",
                     "--log-every", "1"]) == 0
    line = next(ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step 0:"))
    terms = dict(kv.split("=") for kv in line.split(": ", 1)[1].split())
    assert np.isfinite(float(terms["loss/total"]))
