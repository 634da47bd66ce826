"""Several train steps per call (``make_scan_train_step``,
``fit(steps_per_call=K)``, ``cli train --steps-per-call``), held against
the eager step and the JAX package on the CPU.

* K steps per call equal K calls of ``make_train_step`` bit for bit
  (parameters, BatchNorm statistics, every solver tensor and count, the
  last metrics) for every solver and for ``iter_size`` 1 and 3: on the CPU
  the same step body runs K times.
* K = 1 against the reference's ``make_scan_train_step`` from the same
  weights, at the tolerances of tests/test_torch_train.py's
  ``test_train_step_matches_jax_grad`` (loss terms 1e-4 relative,
  BatchNorm statistics 2e-4 of their largest magnitude, each stable
  leaf's update 2e-4 relative L2, the chaotic depth-net leaves as one
  vector within 4x the reference's own spread under 1e-6 image noise).
* Every tensor of the state keeps its storage across steps and across a
  checkpoint load: the CPU-visible guard for a CUDA graph, which updates
  the tensors it was captured on.
* ``fit``'s chunk schedule, its log/eval/snapshot steps (the reference's
  rule, worked out here), bit-exact resume, and checkpoints that move
  between K = 4 and K = 1.
* The fused 19-channel payload is built contiguous with ``torch.cat``'s
  values.
"""

import dataclasses
import inspect
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthvo_tpu import configs as jconfigs
from depthvo_tpu.configs import base as jbase
from depthvo_tpu.train import loop as jloop, state as jstate
from depthvo_tpu.utils.images import to_unit as jto_unit
from depthvo_tpu_torch import cli, configs as tconfigs, ops as tops
from depthvo_tpu_torch.configs import base as tbase
from depthvo_tpu_torch.data.synthetic import SyntheticScenes
from depthvo_tpu_torch.io import checkpoint as ckpt
from depthvo_tpu_torch.io.from_jax import load_jax_params, params_from_jax, state_dict_from_jax
from depthvo_tpu_torch.train import loop as tloop, state as tstate
from test_torch_models import jax_state

torch.set_num_threads(2)
torch.exp(torch.zeros(1))  # MKL's first call on one thread (test_torch_models.py)

CPU = torch.device("cpu")
MOTION_BIAS = np.array([2.0, -1.0, -30.0, 0.2, -0.3, 0.1], np.float32)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, deleted at teardown: the checkpoints written
    here are about 150 MB each, and pytest keeps its last three runs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _cfg(**optim):
    base = tconfigs.tiny_test()
    return dataclasses.replace(base, optim=dataclasses.replace(base.optim, **optim))


def _state(cfg, seed=0):
    return tstate.create_state(cfg, CPU, torch.Generator().manual_seed(seed))


def _batches(cfg, n, seed=3):
    scenes = SyntheticScenes(cfg, seed=seed, num_scenes=4, u8=True)
    return [scenes.batch(cfg.batch_size) for _ in range(n)]


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _assert_same_state(a, b):
    """Bit for bit: the step, every network tensor, the solver's tensors
    and counts."""
    da, db = tstate.state_dict(a), tstate.state_dict(b)
    assert da["step"] == db["step"]
    for name in da["nets"]:
        for k, v in da["nets"][name].items():
            assert torch.equal(v, db["nets"][name][k]), f"{name}.{k}"
    la, lb = _leaves(da["opt_state"]), _leaves(db["opt_state"])
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert type(x) is type(y)
        assert torch.equal(x, y) if torch.is_tensor(x) else x == y


def _storage(state):
    return [t.data_ptr() for t in tloop._state_tensors(state)]


# --------------------------------------------------------------------------
# K steps per call = K eager steps.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("iter_size", [1, 3])
@pytest.mark.parametrize("solver", tstate.OPTIMIZERS)
def test_scan_equals_eager_steps(solver, iter_size):
    """Two calls of K = 3 against six eager steps, with Caffe's L2 (or
    adamw's decay) and a warmed-up step schedule, so the plan's numbers
    change every step; with iter_size 3 both of multi_steps' branches
    run."""
    cfg = _cfg(optimizer=solver, iter_size=iter_size, weight_decay=1e-2, warmup_steps=2,
               lr_policy="step", lr_decay_steps=2, lr_decay_factor=0.5)
    batches = _batches(cfg, 6)
    scan, eager = _state(cfg), _state(cfg)
    fn = tloop.make_scan_train_step(cfg, device="cpu")
    for call in range(2):
        scan, scan_metrics = fn(scan, tloop.stack_batches(batches[3 * call:3 * call + 3]))
    step = tloop.make_train_step(cfg, "cpu")
    for b in batches:
        eager, eager_metrics = step(eager, b)
    assert scan.step == eager.step == 6
    _assert_same_state(scan, eager)
    assert set(scan_metrics) == set(eager_metrics)
    for k, v in eager_metrics.items():
        assert torch.equal(scan_metrics[k], v), k


# --------------------------------------------------------------------------
# K = 1 against the reference's scan step.
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scan_pair():
    """One sgd step (no momentum, no decay, lr 1: the update is the
    clipped gradient) of both packages' scan steps from the same weights
    and batch, and the reference's gradients on two noisy copies of the
    batch (its own float32 spread)."""
    oc = dict(optimizer="sgd", beta1=0.0, learning_rate=1.0, weight_decay=0.0,
              warmup_steps=0, lr_policy="fixed")
    jcfg = jconfigs.tiny_test(optim=jbase.OptimConfig(**oc))
    tcfg = tconfigs.tiny_test(optim=tbase.OptimConfig(**oc))
    (dn, on, fn), params, batch_stats = jax_state(jcfg, np.random.default_rng(5))
    params["odom"]["Dense_2"]["bias"] = MOTION_BIAS
    batch = SyntheticScenes(tcfg, seed=11, num_scenes=2, u8=True).fixed_batch(2)
    fbatch = {k: np.asarray(jto_unit(v)) if v.dtype == np.uint8 else v for k, v in batch.items()}

    jtx = jstate.make_optimizer(jcfg)
    jst = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                            batch_stats=batch_stats, opt_state=jtx.init(params))
    jst, jmetrics = jloop.make_scan_train_step(jcfg)(jst, jloop.stack_batches([fbatch]))
    ref_params = params_from_jax(jax.device_get(jst.params), {})
    ref_stats = state_dict_from_jax({}, jax.device_get(jst.batch_stats))

    def loss_fn(p, b):
        return jloop.compute_losses(jcfg, (dn, on, fn), p, batch_stats, b, train=True)[0]

    grad = jax.jit(jax.grad(loss_fn))
    spread = []
    for seed in (1, 2):
        noise = np.random.default_rng(seed)
        noisy = {k: (v + 1e-6 * noise.normal(size=v.shape)).astype(np.float32)
                 if k.startswith("image") else v for k, v in fbatch.items()}
        spread.append(params_from_jax(jax.device_get(grad(params, noisy)), {}))
    ref_grads = params_from_jax(jax.device_get(grad(params, fbatch)), {})

    models = load_jax_params(tstate.build_models(tcfg), params, batch_stats)
    before = {k: p.detach().clone() for k, p in tstate.param_tree(models).items()}
    state = tstate.TrainState(0, models, tstate.make_optimizer(tcfg).init(
        tstate.param_tree(models)))
    state, metrics = tloop.make_scan_train_step(tcfg, device="cpu")(
        state, tloop.stack_batches([batch]))
    return dict(ref_metrics=jax.device_get(jmetrics), ref_params=ref_params,
                ref_stats=ref_stats, ref_grads=ref_grads, spread=spread,
                before=before, start={"params": params}, state=state, metrics=metrics)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("part", ["metrics", "updates", "bn_stats"])
def test_scan_step_matches_the_reference_scan(scan_pair, part):
    got_state, got = scan_pair["state"], scan_pair["metrics"]
    assert got_state.step == 1
    if part == "metrics":
        ref = scan_pair["ref_metrics"]
        assert set(got) == set(ref)
        for k, r in ref.items():
            if k != "grad/global_norm":
                assert abs(float(got[k]) - float(r)) <= 1e-4 * abs(float(r)), k
        return
    if part == "bn_stats":
        sd = got_state.models.depth.state_dict()
        for k, r in scan_pair["ref_stats"].items():
            assert float((sd[k] - r).abs().max() / r.abs().max()) <= 2e-4, k
        return
    # The update (new minus old parameters): lr 1 times the clipped
    # gradient, held leaf by leaf where the reference's gradient is
    # stable under 1e-6 image noise, elsewhere as one vector.
    before, spread = scan_pair["before"], scan_pair["spread"]
    stable, unstable = 0, []
    for key, p in tstate.param_tree(got_state.models).items():
        net, name = key.split(".", 1)
        ref_new = scan_pair["ref_params"][net][name]
        if net == "feat":  # frozen in both
            assert torch.equal(p.detach(), before[key]) and torch.equal(ref_new, before[key])
            continue
        d_got, d_ref = p.detach() - before[key], ref_new - before[key]
        r = scan_pair["ref_grads"][net][name]
        own = max(_rel(s[net][name], r) for s in spread)
        if own <= 1e-5:
            assert _rel(d_got, d_ref) <= 2e-4, key
            stable += 1
        else:
            unstable.append((key, d_got, d_ref, [s[net][name] for s in spread], r))
    assert stable >= 20  # the odometry net and the disparity heads
    assert all(key.startswith("depth.") for key, *_ in unstable)
    got_u = torch.cat([d.flatten() for _, d, _, _, _ in unstable])
    ref_u = torch.cat([d.flatten() for _, _, d, _, _ in unstable])
    ref_g = torch.cat([r.flatten() for *_, r in unstable])
    own_u = max(_rel(torch.cat([s[i].flatten() for _, _, _, s, _ in unstable]), ref_g)
                for i in range(2))
    assert _rel(got_u, ref_u) <= 4 * own_u, (_rel(got_u, ref_u), own_u)


# --------------------------------------------------------------------------
# The state keeps its storage.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("solver", tstate.OPTIMIZERS)
def test_state_tensors_keep_their_storage(solver, tmp_path):
    """Across scan calls, eager steps (iter_size 3: through both of
    multi_steps' branches and its reset) and a checkpoint load: every
    parameter, BatchNorm statistic and solver tensor is the same storage,
    so a graph captured on the state goes on updating the state."""
    cfg = _cfg(optimizer=solver, iter_size=3)
    batches = _batches(cfg, 4)
    state = _state(cfg)
    ptrs = _storage(state)
    assert len(ptrs) == len(set(ptrs))
    state, _ = tloop.make_scan_train_step(cfg, device="cpu")(
        state, tloop.stack_batches(batches[:3]))
    state, _ = tloop.make_train_step(cfg, "cpu")(state, batches[3])
    assert state.step == 4 and _storage(state) == ptrs
    mgr = ckpt.make_manager(str(tmp_path))
    ckpt.save(mgr, state)
    other = _state(cfg, seed=7)
    other_ptrs = _storage(other)
    other = ckpt.maybe_restore(mgr, other)
    assert _storage(other) == other_ptrs  # the load copies in place
    _assert_same_state(other, state)


# --------------------------------------------------------------------------
# fit with K steps per call.
# --------------------------------------------------------------------------


def _counting(batches):
    seen = []

    def it():
        for b in batches:
            seen.append(1)
            yield b

    return it(), seen


def _reference_schedule(start, num_steps, K, log_every, eval_every, ckpt_every):
    """The reference's rule (depthvo_tpu/train/loop.py fit), written out:
    chunks of min(K, steps left); after the call whose last step is
    ``last``: log if last % log_every < K, validate if (last + 1) %
    eval_every < K, snapshot if (last + 1) % ckpt_every < K, each also
    after the final step."""
    chunks, logs, evals, snaps = [], [], [], []
    i = start
    while i < num_steps:
        k = min(K, num_steps - i)
        chunks.append(k)
        i += k
        last, final = i - 1, i >= num_steps
        if last % log_every < K or final:
            logs.append(last)
        if (last + 1) % eval_every < K or final:
            evals.append(last)
        if (last + 1) % ckpt_every < K or final:
            snaps.append(i)
    return chunks, logs, evals, snaps


@pytest.mark.parametrize("prefetch", [0, 2])
def test_fit_steps_per_call_schedule(monkeypatch, tmp_path, prefetch):
    cfg = dataclasses.replace(_cfg(), log_every=8, checkpoint_every=5)
    eval_every = 6
    want = _reference_schedule(0, 10, 4, 8, eval_every, 5)
    assert want == ([4, 4, 2], [3, 9], [7, 9], [8, 10])
    data, seen = _counting(_batches(cfg, 12))
    calls = []
    real = tloop.make_scan_train_step

    def spy(*args, **kwargs):
        fn = real(*args, **kwargs)

        def wrapped(state, stacked):
            calls.append(len(stacked["image_t"]))
            return fn(state, stacked)

        return wrapped

    monkeypatch.setattr(tloop, "make_scan_train_step", spy)
    logged = []
    state = tloop.fit(cfg, data, 10, checkpoint_dir=str(tmp_path / "ck"),
                      log_fn=lambda s, m: logged.append((s, m)), steps_per_call=4,
                      prefetch=prefetch, eval_iter=iter(_batches(cfg, 2) * 10),
                      eval_every=eval_every, eval_steps=1, device="cpu")
    assert state.step == 10 and len(seen) == 10 and calls == want[0]
    assert [s for s, m in logged if "loss/total" in m] == want[1]
    assert [s for s, m in logged if "val/loss/total" in m] == want[2]
    assert ckpt.make_manager(str(tmp_path / "ck")).all_steps() == want[3]


def _fit(cfg, batches, steps, K, ckdir=None, prefetch=0):
    return tloop.fit(cfg, iter(batches), steps, checkpoint_dir=ckdir, steps_per_call=K,
                     prefetch=prefetch, device="cpu")


@pytest.mark.parametrize("prefetch", [0, 2])
def test_fit_steps_per_call_resumes_bit_for_bit(tmp_path, prefetch):
    """K = 4 over 10 steps, against 4 steps, a checkpoint, then the rest
    (chunks 4 | 4, 2 against 4, 4, 2), the data going on where it
    stopped."""
    cfg = _cfg(iter_size=3)
    batches = _batches(cfg, 10)
    whole = _fit(cfg, batches, 10, 4, prefetch=prefetch)
    ckdir = str(tmp_path / "ck")
    first = _fit(cfg, batches[:4], 4, 4, ckdir, prefetch)
    assert first.step == 4 and ckpt.make_manager(ckdir).all_steps() == [4]
    resumed = _fit(cfg, batches[4:], 10, 4, ckdir, prefetch)
    assert ckpt.make_manager(ckdir).all_steps() == [4, 10]
    _assert_same_state(resumed, whole)


@pytest.mark.parametrize("first_K,then_K", [(4, 1), (1, 4)])
def test_checkpoints_move_between_steps_per_call(tmp_path, first_K, then_K):
    """The checkpoint format does not depend on K: a run of one K resumes
    under the other and ends where a K = 1 run ends, bit for bit."""
    cfg = _cfg()
    batches = _batches(cfg, 10)
    ckdir = str(tmp_path / "ck")
    _fit(cfg, batches[:4], 4, first_K, ckdir)
    resumed = _fit(cfg, batches[4:], 10, then_K, ckdir)
    _assert_same_state(resumed, _fit(cfg, batches, 10, 1))


def test_cli_train_steps_per_call_on_cpu(capsys):
    assert cli.main(["train", "--variant", "tiny_test", "--device", "cpu", "--steps", "5",
                     "--steps-per-call", "2", "--batch-size", "2", "--log-every", "1"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step ")]
    # calls of 2, 2 and 1 steps; log_every 1 < K logs each call's last step
    assert [int(ln.split(":")[0].split()[1]) for ln in lines] == [1, 3, 4]
    for ln in lines:
        terms = dict(kv.split("=") for kv in ln.split(": ", 1)[1].split())
        assert {"loss/total", "loss/feature", "grad/global_norm"} <= set(terms)
        assert all(np.isfinite(float(v)) for v in terms.values())


# --------------------------------------------------------------------------
# The entry points, and the reference's surface.
# --------------------------------------------------------------------------


def test_scan_step_has_the_reference_signature_then_device():
    ref = list(inspect.signature(jloop.make_scan_train_step).parameters.values())
    mine = list(inspect.signature(tloop.make_scan_train_step).parameters.values())
    assert [p.name for p in mine] == [p.name for p in ref] + ["device"]
    for r, m in zip(ref, mine):
        assert m.default == r.default and m.kind == r.kind, m.name
    cfg = tconfigs.tiny_test()
    with pytest.raises(NotImplementedError, match="mesh"):
        tloop.make_scan_train_step(cfg, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="unroll"):
        tloop.make_scan_train_step(cfg, unroll=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tloop.make_scan_train_step(cfg)
    with pytest.raises(ValueError, match="leading dimension"):
        tloop.make_scan_train_step(cfg, device="cpu")(
            _state(cfg), {"image_t": np.zeros((2, 1)), "K": np.zeros((3, 1))})


def test_stack_batches_matches_the_reference():
    cfg = tconfigs.tiny_test()
    batches = _batches(cfg, 3)
    mine, ref = tloop.stack_batches(batches), jloop.stack_batches(batches)
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert mine[k].dtype == ref[k].dtype and np.array_equal(mine[k], ref[k]), k


# --------------------------------------------------------------------------
# The fused payload.
# --------------------------------------------------------------------------


def test_fused_payload_is_contiguous_with_the_values_of_cat(monkeypatch):
    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.normal(size=(2, 5, 7, 3)).astype(np.float32)).permute(0, 3, 1, 2)
    feat = torch.from_numpy(rng.normal(size=(2, 5, 7, 16)).astype(np.float32)).permute(0, 3, 1, 2)
    cat = torch.cat([image, feat], dim=1)
    assert not cat.is_contiguous()  # NHWC strides, as the loss graph's inputs have
    out = tloop.fused_payload(image, feat)
    assert out.is_contiguous() and torch.equal(out, cat)

    # In the loss graph: the general warp gets the contiguous payload,
    # so its own .contiguous() copies nothing.
    srcs = []
    real = tops.frozen_warp_pyramid_chw
    monkeypatch.setattr(tops, "frozen_warp_pyramid_chw",
                        lambda s, *a, **k: srcs.append(list(s)) or real(s, *a, **k))
    cfg = tconfigs.tiny_test()
    state = _state(cfg)
    tloop.make_train_step(cfg, "cpu")(state, _batches(cfg, 1)[0])
    payload = srcs[0][-1]
    assert payload.shape[1] == 3 + cfg.model.feat_channels and payload.is_contiguous()
