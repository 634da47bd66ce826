"""Resuming, in the port, the whole train state of a checkpoint that the
JAX package wrote (orbax): parameters, BatchNorm statistics, the solver's
moments, counts and accumulators, and the step.

* The mapping is exact: for each of the 6 solvers with iter_size 1 and 3,
  the reference's optimizer takes seeded random gradients (2 updates, or
  4 micro-steps with iter_size 3, so that the state is mid-accumulation),
  the reference's ``io/checkpoint.save`` writes it, and a fresh port
  state of the same config restores it: every moment and accumulator
  equals the reference's bit for bit after its parameter's layout
  transform (HWIO -> OIHW, transposed dense kernels), and the counts and
  the step are equal.
* A resumed run continues the reference's run: the reference's ``fit``
  runs k steps into a checkpoint directory, the port's ``fit`` continues
  from it to k + 3, against the reference's uninterrupted k + 3 steps on
  the same batches. The first resumed step's losses (the same state)
  within 1e-4 relative (the eval step's bar); after an update train-mode
  float32 is chaotic (ROADMAP C), the reference's own losses move by more
  than 1e-4 under 1e-6 image noise, so the later steps' losses are held to
  the larger of 1e-4 and 4x that spread (the largest over four noise
  seeds), as tests/test_torch_learning.py holds them; the parameters'
  change over the resumed steps by the repo's stable/unstable rule
  (tests/test_torch_train.py): 2e-4 relative L2 for each leaf whose change
  the reference's own spread leaves stable (<= 1e-5), the rest as one
  vector within 4x that spread (at this size none is stable);
  the learning rate at the first resumed update is the reference
  schedule's at that count (the warmup does not restart).
* Another optimizer, iter_size or train_feat raises ``ValueError`` naming
  the path; ``cli train --checkpoint-dir`` resumes from a reference
  directory and leaves its snapshots beside the reference's step.
"""

import contextlib
import dataclasses
import io
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from depthvo_tpu import configs as jconfigs
from depthvo_tpu.io import checkpoint as jckpt
from depthvo_tpu.train import loop as jloop, state as jstate
from depthvo_tpu_torch import cli, configs as tconfigs
from depthvo_tpu_torch.data.synthetic import SyntheticScenes
from depthvo_tpu_torch.io import checkpoint as ckpt, orbax_reader
from depthvo_tpu_torch.train import loop as tloop, state as tstate
from test_torch_checkpoint import _to_flax

torch.set_num_threads(2)
torch.exp(torch.zeros(1))  # MKL's first call on one thread (test_torch_models.py)

CPU = torch.device("cpu")
LOSS_RTOL = 1e-4
STABLE = 1e-5
STABLE_RTOL = 2e-4
NETS = ("depth", "odom", "feat")
NOISE_SEEDS = (1, 2, 3, 4)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, deleted at teardown (checkpoints are large)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _configs(optimizer="adam", iter_size=1, **optim):
    """The same config in both packages: tiny_test with these solver fields."""
    kw = dict(optimizer=optimizer, iter_size=iter_size, **optim)
    j, t = jconfigs.tiny_test(log_every=1), tconfigs.tiny_test(log_every=1)
    return (dataclasses.replace(j, optim=dataclasses.replace(j.optim, **kw)),
            dataclasses.replace(t, optim=dataclasses.replace(t.optim, **kw)))


@pytest.fixture(scope="module")
def init():
    """The reference's trees of one tiny_test initialisation (made by the
    port and carried over, so no flax initialisation is compiled)."""
    return _to_flax(tstate.create_state(tconfigs.tiny_test(), CPU,
                                        torch.Generator().manual_seed(5)).models)


def _ref_state(jcfg, params, stats, step=0, opt_state=None):
    as_jnp = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    params = as_jnp(params)
    if opt_state is None:
        opt_state = jstate.make_optimizer(jcfg).init(params)
    return jstate.TrainState(step=jnp.asarray(step, jnp.int32), params=params,
                             batch_stats=as_jnp(stats), opt_state=opt_state)


def _save(state, directory):
    mgr = jckpt.make_manager(directory)
    jckpt.save(mgr, state)
    mgr.wait_until_finished()
    return directory


# --------------------------------------------------------------------------
# The expected port state, read off the reference's optax state with jax's
# own flattening (independent of io/from_jax.py).
# --------------------------------------------------------------------------


def _port_key(net, path):
    """The port's name and layout of the reference's leaf ``net/path``."""
    *mods, leaf = path
    if leaf == "kernel":
        return ".".join([net, *mods, "weight"]), (lambda x: x.transpose(3, 2, 0, 1)
                                                  if x.ndim == 4 else x.T)
    if leaf == "scale":
        return ".".join([net, *mods, "weight"]), (lambda x: x)
    return ".".join([net, *mods, leaf]), (lambda x: x)


def _groups(tree, keys):
    """The leaves of an optax state in flattening order: a count as an int,
    each per-parameter tree as a list over ``keys`` in the port's layout."""
    out, current, prefix = [], None, None
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [getattr(p, "key", getattr(p, "name", getattr(p, "idx", None))) for p in path]
        at = next((i for i, n in enumerate(names) if n in NETS), None)
        if at is None:
            out.append(int(x))
            current = prefix = None
            continue
        if names[:at] != prefix:
            prefix, current = names[:at], {}
            out.append(current)
        key, layout = _port_key(names[at], [str(n) for n in names[at + 1:]])
        current[key] = np.ascontiguousarray(layout(np.asarray(x)))
    return [g if isinstance(g, int) else [torch.from_numpy(g[k].copy()) for k in keys]
            for g in out]


def _expected(opt_state, all_keys, trained):
    if isinstance(opt_state, optax.MultiStepsState):
        inner = opt_state.inner_opt_state.inner_states["train"].inner_state
        return ([int(opt_state.mini_step)] + _groups(opt_state.acc_grads, all_keys)
                + _groups(inner, trained))
    return _groups(opt_state.inner_states["train"].inner_state, trained)


def _port_leaves(state):
    if type(state) in (int, list):
        return [state]
    return [x for s in state for x in _port_leaves(s)]


# --------------------------------------------------------------------------
# (a) The mapping is exact, for every solver and iter_size 1 and 3.
# --------------------------------------------------------------------------

CASES = [(opt, k) for opt in tstate.OPTIMIZERS for k in (1, 3)]


@pytest.fixture(scope="module")
def saved(init, tmp_path_factory):
    """One reference checkpoint per (solver, iter_size) after seeded random
    gradients, with its reference state."""
    params, stats = init
    root = tmp_path_factory.mktemp("orbax_solvers")
    out = {}
    for i, (opt, k) in enumerate(CASES):
        jcfg, _ = _configs(opt, k, weight_decay=1e-4, warmup_steps=3, learning_rate=1e-2)
        state = _ref_state(jcfg, params, stats)
        update = jax.jit(jstate.make_optimizer(jcfg).update)  # eager optax is slower
        rng = np.random.default_rng(100 + i)
        p, opt_state = state.params, state.opt_state
        n = 2 if k == 1 else 4  # iter_size 3: one update, then one micro-step
        for _ in range(n):
            g = jax.tree.map(lambda x: jnp.asarray(
                rng.normal(size=x.shape).astype(np.float32)), p)
            updates, opt_state = update(g, opt_state, p)
            p = optax.apply_updates(p, updates)
        state = state.replace(step=jnp.asarray(n, jnp.int32), params=p, opt_state=opt_state)
        out[opt, k] = _save(state, str(root / f"{opt}_{k}")), jax.device_get(state)
    yield out
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("optimizer,iter_size", CASES)
def test_reference_solver_state_is_restored_bit_for_bit(saved, optimizer, iter_size):
    directory, ref = saved[optimizer, iter_size]
    _, tcfg = _configs(optimizer, iter_size, weight_decay=1e-4, warmup_steps=3,
                       learning_rate=1e-2)
    state = tstate.create_state(tcfg, CPU, torch.Generator().manual_seed(9))
    state = ckpt.maybe_restore(ckpt.CheckpointManager(directory), state, tcfg)
    assert state.step == int(ref.step) == (2 if iter_size == 1 else 4)
    keys = list(tstate.param_tree(state.models))
    trained = [k for k in keys if not k.startswith("feat.")]
    got, want = _port_leaves(state.opt_state), _expected(ref.opt_state, keys, trained)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g) is type(w)
        if isinstance(w, int):
            assert g == w
        else:
            assert len(g) == len(w) and all(torch.equal(a, b) for a, b in zip(g, w))
    if iter_size == 3:  # mid-accumulation after one update
        assert got[0] == 1 and int(ref.opt_state.gradient_step) == 1
    weights = dict(tstate.param_tree(state.models))
    for net in NETS:
        for path, x in jax.tree_util.tree_flatten_with_path(ref.params[net])[0]:
            key, layout = _port_key(net, [p.key for p in path])
            assert torch.equal(weights[key].detach(),
                               torch.from_numpy(np.array(layout(np.asarray(x)), order="C"))), key


# --------------------------------------------------------------------------
# (c) Another optimizer, iter_size or train_feat raises, naming the path.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("saved_as,resumed_as,path", [
    (("sgd", 1), dict(optimizer="adam"), "opt_state/inner_states/train/inner_state/2/0/trace"),
    (("adam", 1), dict(optimizer="rmsprop"), "opt_state/inner_states/train/inner_state/1/0/count"),
    (("adam", 3), dict(optimizer="adam"), "opt_state:"),
    (("adam", 1), dict(optimizer="adam", iter_size=3), "opt_state:"),
    (("adam", 1), dict(optimizer="adam", train_feat=True),
     "opt_state/inner_states/train/inner_state/1/0/mu"),
])
def test_a_different_solver_raises_naming_the_path(saved, saved_as, resumed_as, path):
    directory, _ = saved[saved_as]
    resumed_as = dict(resumed_as)
    train_feat = resumed_as.pop("train_feat", False)
    _, tcfg = _configs(**resumed_as, weight_decay=1e-4, warmup_steps=3, learning_rate=1e-2)
    tcfg = dataclasses.replace(tcfg, train_feat=train_feat)
    state = tstate.create_state(tcfg, CPU, torch.Generator().manual_seed(9))
    with pytest.raises(ValueError) as info:
        ckpt.maybe_restore(ckpt.CheckpointManager(directory), state, tcfg)
    assert str(info.value).startswith(path), str(info.value)
    with pytest.raises(ValueError, match="needs the run's config"):
        ckpt.maybe_restore(ckpt.CheckpointManager(directory), state)


# --------------------------------------------------------------------------
# (b) A resumed run continues the reference's run; (d) the CLI resumes.
# --------------------------------------------------------------------------

RESUMED = 3


def _batches(cfg, n):
    scenes = SyntheticScenes(cfg, seed=4, num_scenes=4)
    return [scenes.batch(cfg.batch_size) for _ in range(n)]


def _noisy(batches, seed):
    rng = np.random.default_rng(seed)
    return [{k: (v + 1e-6 * rng.normal(size=v.shape)).astype(np.float32)
             if k.startswith("image") else v for k, v in b.items()} for b in batches]


@pytest.fixture(scope="module")
def reference_runs(init, tmp_path_factory):
    """Per iter_size (k = 2 and 4): the reference's ``fit`` of k steps into
    a checkpoint directory, its uninterrupted k + 3 steps (logged), and four
    more whose last 3 batches carry 1e-6 image noise (its own spread). One
    compiled step serves each config's runs."""
    params, stats = init
    root = tmp_path_factory.mktemp("orbax_runs")
    out = {}
    make_step = jloop.make_train_step
    with pytest.MonkeyPatch.context() as mp:
        for iter_size, k in ((1, 2), (3, 4)):
            jcfg, tcfg = _configs("adam", iter_size, learning_rate=1e-3, warmup_steps=10)
            step = make_step(jcfg, None)
            mp.setattr(jloop, "make_train_step", lambda *a, _s=step, **kw: _s)
            batches = _batches(tcfg, k + RESUMED)
            directory = str(root / f"iter{iter_size}")
            at_k = jloop.fit(jcfg, iter(batches[:k]), k, checkpoint_dir=directory,
                             state=_ref_state(jcfg, params, stats), prefetch=0)

            def run(bs):
                log = {}
                end = jloop.fit(jcfg, iter(bs), k + RESUMED, state=_ref_state(jcfg, params, stats),
                                log_fn=lambda s, m: log.__setitem__(s, m), prefetch=0)
                return log, jax.device_get(end)

            whole = run(batches)
            noisy = [run(batches[:k] + _noisy(batches[k:], seed)) for seed in NOISE_SEEDS]
            out[iter_size] = dict(k=k, dir=directory, cfgs=(jcfg, tcfg), batches=batches,
                                  at_k=jax.device_get(at_k), whole=whole, noisy=noisy)
    yield out
    shutil.rmtree(root, ignore_errors=True)


def _flat_params(params, keys):
    flat = {}
    for net in NETS:
        for path, x in jax.tree_util.tree_flatten_with_path(params[net])[0]:
            key, layout = _port_key(net, [p.key for p in path])
            flat[key] = torch.from_numpy(np.array(layout(np.asarray(x)), order="C"))
    return [flat[k] for k in keys]


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("iter_size", [1, 3])
def test_port_continues_a_reference_run(reference_runs, tmp_path, iter_size):
    run = reference_runs[iter_size]
    k, (jcfg, tcfg) = run["k"], run["cfgs"]
    directory = str(tmp_path / "ck")
    shutil.copytree(run["dir"], directory)
    # The learning rate of the first resumed update: the saved schedule
    # count through the port's schedule against the reference's.
    probe = ckpt.maybe_restore(ckpt.CheckpointManager(directory), tstate.create_state(
        tcfg, CPU, torch.Generator().manual_seed(9)), tcfg)
    counts = [c for c in _port_leaves(probe.opt_state) if isinstance(c, int)]
    updates = k // iter_size
    assert probe.step == k and counts == ([k % iter_size] if iter_size > 1 else []) + [updates] * 2
    oc = jcfg.optim
    ref_schedule = optax.join_schedules(
        [optax.linear_schedule(0.0, oc.learning_rate, oc.warmup_steps), jstate.lr_schedule(oc)],
        [oc.warmup_steps])
    lr = tstate.warmup_schedule(tcfg.optim)(updates)
    assert lr == float(np.float32(ref_schedule(updates))) and lr > 0.0

    log = {}
    state = tloop.fit(tcfg, iter(run["batches"][k:]), k + RESUMED, checkpoint_dir=directory,
                      log_fn=lambda s, m: log.__setitem__(s, m), state=tstate.create_state(
                          tcfg, CPU, torch.Generator().manual_seed(9)), prefetch=0, device="cpu")
    (whole_log, whole), noisy = run["whole"], run["noisy"]
    assert sorted(log) == list(range(k, k + RESUMED)) and state.step == k + RESUMED
    for s in log:
        for name, v in whole_log[s].items():
            if name.startswith("loss/"):
                ref = float(v)
                own = max(abs(float(n[0][s][name]) - ref) for n in noisy) / abs(ref)
                bar = LOSS_RTOL if s == k else max(LOSS_RTOL, 4 * own)
                assert abs(log[s][name] - ref) <= bar * abs(ref), (s, name, log[s][name], ref, own)
    assert ckpt.CheckpointManager(directory).all_steps() == [k, k + RESUMED]
    assert orbax_reader.is_reference_step(os.path.join(directory, str(k)))

    keys = list(tstate.param_tree(state.models))
    trained = [key for key in keys if not key.startswith("feat.")]
    start = dict(zip(keys, _flat_params(run["at_k"].params, keys)))
    ref_end = dict(zip(keys, _flat_params(whole.params, keys)))
    own_end = [dict(zip(keys, _flat_params(n[1].params, keys))) for n in noisy]
    got_end = {key: p.detach() for key, p in tstate.param_tree(state.models).items()}
    stable, unstable = [], []
    for key in trained:
        ref = ref_end[key] - start[key]
        own = max(_rel(o[key] - start[key], ref) for o in own_end)
        (stable if own <= STABLE else unstable).append(key)
        if own <= STABLE:
            assert _rel(got_end[key] - start[key], ref) <= STABLE_RTOL, key
    for key in keys:
        if key.startswith("feat."):
            assert torch.equal(got_end[key], ref_end[key]), key
    if unstable:
        cat = lambda d: torch.cat([(d[key] - start[key]).flatten() for key in unstable])  # noqa: E731
        own = max(_rel(cat(o), cat(ref_end)) for o in own_end)
        assert _rel(cat(got_end), cat(ref_end)) <= 4 * own, (_rel(cat(got_end), cat(ref_end)), own)


def test_cli_train_resumes_a_reference_directory(reference_runs, tmp_path):
    run = reference_runs[1]
    k = run["k"]
    directory = str(tmp_path / "ck")
    shutil.copytree(run["dir"], directory)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(["train", "--variant", "tiny_test", "--device", "cpu", "--steps",
                       str(k + 2), "--log-every", "1", "--checkpoint-dir", directory])
    assert rc == 0
    steps = [int(line.split(":")[0].split()[1]) for line in printed.getvalue().splitlines()
             if line.startswith("step ")]
    assert steps == [k, k + 1]
    mgr = ckpt.CheckpointManager(directory)
    assert mgr.all_steps() == [k, k + 2]
    assert orbax_reader.is_reference_step(mgr.step_dir(k))
    assert os.path.isfile(os.path.join(mgr.step_dir(k + 2), ckpt.STATE_FILE))
