"""The port's checkpoints, resume and staged init, held against the JAX
package, and the three repairs that came with them.

* A checkpoint that the JAX package writes (orbax, ``io/checkpoint.save``
  of a ``tiny_test`` state with perturbed BatchNorm and a real odometry
  motion) loads into the port with every weight equal to the
  reference's, and ``DepthVO.from_checkpoint`` gives the reference's
  depth, pose and features within 2e-5 of the reference's largest
  magnitude (the models' bar, tests/test_torch_models.py).
* ``restore_weights`` / ``restore_param_subtree`` seat the same tensors
  from a reference directory and from a port directory.
* A 4-step ``fit`` against 2 steps, a resume and 2 more: losses,
  parameters and solver tensors within 1e-6 relative (they are equal on
  the CPU: the same arithmetic in the same order).
* Snapshots on SIGHUP and on SIGINT's stop (as tests/test_train.py).
* The repairs: ``remat`` is honoured, ``fit`` has the reference's signature,
  and ``resolve_device("cpu")`` makes the first MKL call on one element.
"""

import copy
import dataclasses
import inspect
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depthvo_tpu import api as japi, configs as jconfigs
from depthvo_tpu.configs import base as jbase
from depthvo_tpu.io import checkpoint as jckpt
from depthvo_tpu.train import loop as jloop
from depthvo_tpu.train import state as jstate
from depthvo_tpu_torch import api as tapi, configs as tconfigs
from depthvo_tpu_torch.data.synthetic import SyntheticScenes
from depthvo_tpu_torch.io import checkpoint as ckpt, orbax_reader
from depthvo_tpu_torch.io.from_jax import params_from_jax
from depthvo_tpu_torch.train import loop as tloop, state as tstate
from depthvo_tpu_torch.parallel import mesh as pmesh
from depthvo_tpu_torch.utils import device as device_mod
from test_torch_models import _perturb_bn

torch.set_num_threads(2)
torch.exp(torch.zeros(1))  # MKL's first call on one thread (test_torch_models.py)

RTOL = 2e-5
RESUME_RTOL = 1e-6
CPU = torch.device("cpu")


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, deleted at teardown: the checkpoints written
    here are about 150 MB each, and pytest keeps its last three runs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _to_flax(models):
    """The port's networks as the reference's trees (the inverse of
    ``io/from_jax.py``): ``params`` per network and the depth net's
    ``batch_stats``. Made this way, the reference's tree needs no flax
    initialisation (which takes tens of seconds to compile on the CPU)."""
    params, stats = {}, {}
    for name, net in zip(tstate.Models._fields, models):
        tree = params.setdefault(name, {})
        for key, v in net.state_dict().items():
            *mods, leaf = key.split(".")
            x = v.numpy()
            if leaf == "num_batches_tracked":
                continue
            if leaf in ("running_mean", "running_var"):
                node, leaf = stats, leaf[len("running_"):]
            else:
                node = tree
                if leaf == "weight" and x.ndim == 4:
                    leaf, x = "kernel", x.transpose(2, 3, 1, 0)
                elif leaf == "weight" and x.ndim == 2:
                    leaf, x = "kernel", x.T
                elif leaf == "weight":
                    leaf = "scale"
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = np.ascontiguousarray(x)
    return params, stats


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    """One reference checkpoint directory (orbax, step 0; the JAX
    package's own ``save`` of a whole ``TrainState`` with its optax state)
    with the reference's config.json beside it, and the trees it holds."""
    cfg = jconfigs.tiny_test()
    rng = np.random.default_rng(7)
    params, stats = _to_flax(tstate.create_state(tconfigs.tiny_test(), CPU).models)
    params["depth"] = _perturb_bn(params["depth"], rng)
    stats = _perturb_bn(stats, rng)
    # A real motion, so that the poses differ from the identity.
    params["odom"]["Dense_2"]["bias"] = np.array([1.0, -0.5, 2.0, 3.0, -1.0, 5.0], np.float32)
    as_jnp = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=as_jnp(params),
                              batch_stats=as_jnp(stats),
                              opt_state=jstate.make_optimizer(cfg).init(as_jnp(params)))
    d = str(tmp_path_factory.mktemp("ref_ckpt"))
    mgr = jckpt.make_manager(d)
    jckpt.save(mgr, state)
    mgr.wait_until_finished()
    jbase.save_json(cfg, os.path.join(d, "config.json"))
    yield d, params, stats
    shutil.rmtree(d, ignore_errors=True)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


# --------------------------------------------------------------------------
# Reading the reference's checkpoints.
# --------------------------------------------------------------------------


def test_reference_checkpoint_weights_are_seated_exactly(ref_dir):
    d, params, stats = ref_dir
    model = tapi.DepthVO.from_checkpoint(d, device="cpu")
    assert model.config == tconfigs.tiny_test()  # from the saved config.json
    want = params_from_jax(params, stats)
    for name in ("depth", "odom", "feat"):
        got = getattr(model.models, name).state_dict()
        keys = [k for k in got if not k.endswith("num_batches_tracked")]
        assert sorted(keys) == sorted(want[name])
        for k in keys:
            assert torch.equal(got[k], want[name][k]), f"{name}.{k}"


@pytest.fixture(scope="module")
def both_models(ref_dir):
    """The reference's ``DepthVO.from_checkpoint`` and the port's. The
    reference's ``create_state`` gives it only a template for the tree's
    structure, so it is handed zeros of the saved trees' shapes (a flax
    initialisation would compile for tens of seconds); the weights come
    from the reference's own ``restore_weights``."""
    d, params, stats = ref_dir
    zeros = lambda t: jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), t)  # noqa: E731
    template = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=zeros(params),
                                 batch_stats=zeros(stats), opt_state=None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(japi, "create_state", lambda config, rng: template)
        jmodel = japi.DepthVO.from_checkpoint(d)
    return jmodel, tapi.DepthVO.from_checkpoint(d, device="cpu")


@pytest.mark.parametrize("output", ["depth", "pose", "features", "pose_sequence"])
def test_from_checkpoint_matches_the_reference(both_models, output):
    jmodel, tmodel = both_models
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (5, 32, 96, 3), dtype=np.uint8)
    if output == "pose":
        arg = np.concatenate([frames[:-1], frames[1:]], axis=-1)
        got, ref = tmodel.pose(arg), jmodel.pose(arg)
    elif output == "pose_sequence":  # 4 pairs in chunks of 3: one padded chunk
        got, ref = tmodel.pose_sequence(frames, chunk=3), jmodel.pose_sequence(frames, chunk=3)
        np.testing.assert_allclose(got, tmodel.pose(
            np.concatenate([frames[:-1], frames[1:]], axis=-1)), rtol=0, atol=1e-6)
    else:
        got, ref = getattr(tmodel, output)(frames), getattr(jmodel, output)(frames)
    if output.startswith("pose"):  # the motion, not the identity around it
        got, ref = got - np.eye(4), np.asarray(ref) - np.eye(4)
        assert np.abs(ref).max() > 1e-2
    assert _rel(got, ref) <= RTOL


def test_functional_aliases(both_models):
    _, tmodel = both_models
    rng = np.random.default_rng(12)
    a, b = (rng.uniform(-1, 1, (2, 32, 96, 3)).astype(np.float32) for _ in range(2))
    np.testing.assert_array_equal(tapi.predict_depth(tmodel, a), tmodel.depth(a))
    np.testing.assert_array_equal(tapi.predict_pose(tmodel, a[0], b[0]),
                                  tmodel.pose(np.concatenate([a[:1], b[:1]], -1)))


_FRESH = {}


def _fresh(cfg=None, seed=5):
    """A new state with initial weights drawn from ``seed`` (a copy of one
    made once: drawing them takes ~1 s)."""
    cfg = cfg or tconfigs.tiny_test()
    if (cfg, seed) not in _FRESH:
        _FRESH[cfg, seed] = tstate.create_state(cfg, CPU, torch.Generator().manual_seed(seed))
    return copy.deepcopy(_FRESH[cfg, seed])


def _weights(state):
    return {f"{name}.{k}": v.clone()
            for name, net in zip(tstate.Models._fields, state.models) if net is not None
            for k, v in net.state_dict().items() if not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("verb", ["restore_weights", "restore_param_subtree"])
def test_reference_and_port_directories_seat_the_same_tensors(ref_dir, tmp_path, verb):
    d, _, _ = ref_dir
    port_dir = str(tmp_path / "port")
    src = ckpt.restore_weights(d, _fresh(seed=1))
    ckpt.save(ckpt.make_manager(port_dir), src)
    fresh = _weights(_fresh())
    seated = []
    for directory in (d, port_dir):
        state = _fresh()
        if verb == "restore_weights":
            state = ckpt.restore_weights(directory, state)
        else:
            state = ckpt.restore_param_subtree(directory, state, "feat")
        assert state.step == 0
        seated.append(_weights(state))
    want = _weights(src)
    for k in want:
        assert torch.equal(seated[0][k], seated[1][k]), k
        moved = verb == "restore_weights" or k.startswith("feat.")
        assert torch.equal(seated[0][k], want[k] if moved else fresh[k]), k


def test_staged_init_matches_networks_by_name(ref_dir):
    """Stage 1 (stereo) takes only the depth net of a full checkpoint;
    a subtree the checkpoint lacks is an error."""
    d, params, stats = ref_dir
    state = ckpt.restore_weights(d, _fresh(tconfigs.tiny_test(use_temporal=False,
                                                              use_feature=False)))
    assert state.models.odom is None and state.models.feat is None
    want = params_from_jax(params, stats)["depth"]
    got = state.models.depth.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())
    with pytest.raises(KeyError, match="feat"):
        ckpt.restore_param_subtree(d, state, "feat")


def test_reference_directory_resumes_and_needs_tensorstore(ref_dir, monkeypatch):
    """The whole state resumes (every solver and iter_size:
    tests/test_torch_orbax_resume.py): here the weights, step 0 and the
    fresh solver state the reference saved."""
    d, params, stats = ref_dir
    state = ckpt.maybe_restore(ckpt.make_manager(d), _fresh(seed=9), tconfigs.tiny_test())
    assert state.step == 0
    want = params_from_jax(params, stats)
    got = _weights(state)
    for name, sd in want.items():
        for k, v in sd.items():
            assert torch.equal(got[f"{name}.{k}"], v), f"{name}.{k}"
    count, mu, nu = state.opt_state[1]
    assert count == 0 and state.opt_state[-1] == 0
    assert all(float(t.abs().max()) == 0.0 for t in mu + nu)
    monkeypatch.setitem(__import__("sys").modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        orbax_reader.read_weights(os.path.join(d, "0"))


# --------------------------------------------------------------------------
# The port's own format.
# --------------------------------------------------------------------------


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def test_state_dict_round_trip_is_exact(tmp_path):
    cfg = tconfigs.tiny_test(optim=dataclasses.replace(tconfigs.tiny_test().optim, iter_size=2))
    batch = SyntheticScenes(cfg, seed=3, num_scenes=2, u8=True).fixed_batch(cfg.batch_size)
    state = _fresh(cfg)
    step = tloop.make_train_step(cfg, device="cpu")
    for _ in range(3):  # mid-accumulation: multi_steps' mini_step is 1
        state, _ = step(state, batch)
    mgr = ckpt.make_manager(str(tmp_path))
    path = ckpt.save(mgr, state)
    d = torch.load(os.path.join(path, ckpt.STATE_FILE), weights_only=True)
    assert d["step"] == 3 and d["opt_state"][0] == 1
    restored = ckpt.maybe_restore(mgr, _fresh(cfg, seed=9))
    assert restored.step == 3
    a, b = tstate.state_dict(state), tstate.state_dict(restored)
    for name in a["nets"]:
        for k in a["nets"][name]:
            assert torch.equal(a["nets"][name][k], b["nets"][name][k]), k
    la, lb = _leaves(a["opt_state"]), _leaves(b["opt_state"])
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert type(x) is type(y)
        assert torch.equal(x, y) if torch.is_tensor(x) else x == y


def test_save_is_atomic_keeps_three_and_refuses_a_saved_step(tmp_path):
    mgr = ckpt.make_manager(str(tmp_path))
    assert ckpt.maybe_restore(mgr, _fresh()).step == 0  # an empty directory
    state = _fresh()
    for s in range(5):
        state.step = s
        ckpt.save(mgr, state)
    assert mgr.all_steps() == [2, 3, 4]
    assert sorted(os.listdir(tmp_path)) == ["2", "3", "4"]  # no temporary left
    with pytest.raises(FileExistsError):
        ckpt.save(mgr, state)


def _run_fit(cfg, batch, steps, ckdir=None, state=None, prefetch=0):
    logged = {}

    def log(step, metrics):
        logged[step] = metrics

    state = tloop.fit(cfg, iter([batch] * steps), steps, checkpoint_dir=ckdir,
                      log_fn=log, state=state, prefetch=prefetch, device="cpu")
    return state, logged


@pytest.mark.parametrize("iter_size,prefetch", [(1, 0), (3, 2)])
def test_resumed_fit_matches_an_uninterrupted_one(tmp_path, iter_size, prefetch):
    cfg = tconfigs.tiny_test(log_every=1, checkpoint_every=3,
                             optim=dataclasses.replace(tconfigs.tiny_test().optim,
                                                       iter_size=iter_size))
    batch = SyntheticScenes(cfg, seed=4, num_scenes=2, u8=True).fixed_batch(cfg.batch_size)
    whole, whole_log = _run_fit(cfg, batch, 4, prefetch=prefetch)
    ckdir = str(tmp_path / "ck")
    _, first = _run_fit(cfg, batch, 2, ckdir, prefetch=prefetch)
    assert ckpt.make_manager(ckdir).all_steps() == [2]
    resumed, second = _run_fit(cfg, batch, 4, ckdir, prefetch=prefetch)
    assert sorted(first) == [0, 1] and sorted(second) == [2, 3]
    assert ckpt.make_manager(ckdir).all_steps() == [2, 3, 4]
    for step, metrics in {**first, **second}.items():
        for k, v in metrics.items():
            if k.startswith(("loss/", "grad/")):
                assert abs(v - whole_log[step][k]) <= RESUME_RTOL * abs(whole_log[step][k]), k
    a, b = tstate.state_dict(whole), tstate.state_dict(resumed)
    assert a["step"] == b["step"] == 4
    pairs = [(a["nets"][n][k], b["nets"][n][k]) for n in a["nets"] for k in a["nets"][n]]
    pairs += list(zip(_leaves(a["opt_state"]), _leaves(b["opt_state"])))
    for x, y in pairs:
        if torch.is_tensor(x):
            scale = x.abs().max().clamp_min(1e-30)
            assert float((x - y).abs().max() / scale) <= RESUME_RTOL
        else:
            assert x == y


def test_staged_fit_starts_from_the_previous_stage(ref_dir, monkeypatch):
    """config.init_from (all shared networks) then init_feat_from (feat)."""
    d, params, stats = ref_dir
    cfg = tconfigs.tiny_test(init_from=d, init_feat_from=d)
    batch = SyntheticScenes(cfg, seed=4, num_scenes=2, u8=True).fixed_batch(cfg.batch_size)
    seen = {}

    def spy(state, b, _step=tloop.make_train_step(cfg, device="cpu")):
        seen.setdefault("w", _weights(state))
        return _step(state, b)

    monkeypatch.setattr(tloop, "make_train_step", lambda *a, **k: spy)
    tloop.fit(cfg, iter([batch]), 1, prefetch=0, device="cpu")
    want = params_from_jax(params, stats)
    for name, sd in want.items():
        for k, v in sd.items():
            assert torch.equal(seen["w"][f"{name}.{k}"], v), f"{name}.{k}"


# --------------------------------------------------------------------------
# Snapshots on signals (tests/test_train.py's cases, on the port).
# --------------------------------------------------------------------------


def _signalling(cfg, signum, at):
    batch = SyntheticScenes(cfg, seed=11, num_scenes=2, u8=True).fixed_batch(cfg.batch_size)
    for n in range(1000):
        if n == at:
            os.kill(os.getpid(), signum)
        yield batch


def test_fit_sigint_stops_early_with_snapshot(tmp_path):
    cfg = tconfigs.tiny_test()
    state = tloop.fit(cfg, _signalling(cfg, signal.SIGINT, 3), 50,
                      checkpoint_dir=str(tmp_path / "ck"), prefetch=0,
                      sigint_effect="stop", device="cpu")
    assert 3 <= state.step < 50
    assert ckpt.make_manager(str(tmp_path / "ck")).latest_step() == state.step


def test_fit_sighup_snapshots_and_continues(tmp_path):
    cfg = tconfigs.tiny_test()
    state = tloop.fit(cfg, _signalling(cfg, signal.SIGHUP, 3), 6,
                      checkpoint_dir=str(tmp_path / "ck"), prefetch=0,
                      sighup_effect="snapshot", device="cpu")
    assert state.step == 6
    steps = ckpt.make_manager(str(tmp_path / "ck")).all_steps()
    assert 6 in steps and any(0 < s < 6 for s in steps), steps


# --------------------------------------------------------------------------
# The repairs.
# --------------------------------------------------------------------------


def test_remat_raises_until_it_is_ported():
    """``model.remat`` was once accepted and ignored, then raised until it
    was ported. Now it builds the same networks (the same names,
    so checkpoints move between the modes) and is honoured: a train-mode
    forward keeps fewer tensors for the backward. Its values are held bit
    for bit against ``remat=False`` in tests/test_torch_depth_heads.py."""
    cfg = tconfigs.tiny_test()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat=True))
    models = tstate.build_models(cfg)
    assert models.depth.remat
    plain = tstate.build_models(tconfigs.tiny_test())
    for name in tstate.Models._fields:
        assert list(getattr(models, name).state_dict()) == list(getattr(plain, name).state_dict())
    x = torch.zeros(2, 32, 96, 3)
    held = []
    for net in (plain.depth, models.depth):
        net.train()
        n = [0]
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: n.__setitem__(0, n[0] + 1) or t, lambda t: t):
            net(x)
        held.append(n[0])
    assert held[1] < held[0], held


def test_fit_has_the_reference_signature_then_device():
    ref = list(inspect.signature(jloop.fit).parameters.values())
    mine = list(inspect.signature(tloop.fit).parameters.values())
    # The reference's parameters in order, then the port's own keywords:
    # the device and the per-call finiteness check of `--debug-nans`.
    assert [p.name for p in mine] == [p.name for p in ref] + ["device", "debug_nans"]
    for r, m in zip(ref, mine):
        assert m.default == r.default and m.kind == r.kind, m.name
    assert mine[-2].default is None and mine[-1].default is False
    # A mesh is ported (tests/test_torch_parallel.py); what is not a mesh
    # of ranks is refused before anything runs.
    with pytest.raises(TypeError, match="Mesh"):
        tloop.fit(tconfigs.tiny_test(), iter([]), 1, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="device="):
        tloop.fit(tconfigs.tiny_test(), iter([]), 1, "cpu")
    with pytest.raises(ValueError, match="one process per device"):
        tloop.fit(tconfigs.tiny_test(), iter([]), 1, mesh=pmesh.make_mesh(2, device="cpu"),
                  device="cpu")


def test_resolve_device_makes_the_first_vector_call_on_one_element(monkeypatch):
    calls = []
    real_exp = torch.exp
    monkeypatch.setattr(device_mod, "_cpu_warmed", False)
    monkeypatch.setattr(torch, "exp", lambda x: calls.append(x.numel()) or real_exp(x))
    assert device_mod.resolve_device("cpu") == CPU
    assert device_mod.resolve_device("cpu") == CPU
    assert calls == [1]


def test_batch_to_device_passes_device_tensors_through():
    t = torch.zeros(2, 3, dtype=torch.uint8)
    out = tloop.batch_to_device({"x": t, "y": np.ones(2, np.float32)}, CPU)
    assert out["x"] is t and out["y"].dtype == torch.float32
