"""The ``cli train`` flags the reference's parser has and the port's gained:
``--iter-size``, ``--remat``, ``--tensorboard`` and ``--debug-nans``.

All on the CPU at tiny_test's size (32x96, batch 2). ``--iter-size 2`` must
give the state of ``fit`` with ``config.optim.iter_size=2`` bit for bit;
``--debug-nans`` is the port's own check (per call of K steps, the metrics
and every parameter and BatchNorm statistic), held here to the step at
which a learning rate made infinite on purpose spoils the state.
"""

import contextlib
import dataclasses
import io
import shutil

import pytest
import torch

from depthvo_tpu_torch import cli, configs
from depthvo_tpu_torch.configs import base as config_base
from depthvo_tpu_torch.data.synthetic import SyntheticScenes
from depthvo_tpu_torch.io import checkpoint as ckpt_io
from depthvo_tpu_torch.train import loop
from depthvo_tpu_torch.train.state import param_tree
from depthvo_tpu_torch.utils.logging import MetricLogger

torch.set_num_threads(2)
torch.exp(torch.zeros(1))  # MKL's first call on one thread (test_torch_models.py)

TRAIN = ["train", "--variant", "tiny_test", "--device", "cpu", "--batch-size", "2"]


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, deleted at teardown (checkpoints)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def fit_calls(monkeypatch):
    """Records each ``fit`` that ``cli train`` makes: its config and the
    state it returns."""
    calls = []
    real = loop.fit

    def fit(config, *args, **kw):
        state = real(config, *args, **kw)
        calls.append((config, state))
        return state

    monkeypatch.setattr(cli.train_loop, "fit", fit)
    return calls


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def _state_tensors(state):
    out = {k: p.detach().clone() for k, p in param_tree(state.models).items()}
    out.update({f"{i}.{k}": b.clone() for i, net in enumerate(state.models) if net is not None
                for k, b in net.named_buffers()})
    return out


def test_iter_size_flag_is_fit_with_iter_size_2_bit_for_bit(fit_calls):
    rc, _ = _run(TRAIN + ["--steps", "4", "--iter-size", "2"])
    assert rc == 0
    (cfg, got), = fit_calls
    assert cfg.optim.iter_size == 2 and cfg.model.remat is False

    want_cfg = configs.tiny_test(batch_size=2)
    want_cfg = dataclasses.replace(want_cfg, optim=dataclasses.replace(want_cfg.optim, iter_size=2))
    assert want_cfg == cfg
    it = SyntheticScenes(want_cfg, seed=want_cfg.seed, u8=True).iterator(2)
    want = loop.fit(want_cfg, it, 4, device="cpu")
    assert got.step == want.step == 4
    a, b = _state_tensors(got), _state_tensors(want)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_iter_size_flag_wins_over_the_config_and_one_keeps_it(fit_calls, tmp_path):
    cfg = configs.tiny_test(batch_size=2)
    path = str(tmp_path / "cfg.json")
    config_base.save_json(dataclasses.replace(
        cfg, optim=dataclasses.replace(cfg.optim, iter_size=3)), path)
    for flag, want in (("3", 3), ("2", 2), ("1", 3)):
        assert _run(["train", "--config", path, "--device", "cpu", "--steps", "1",
                     "--iter-size", flag])[0] == 0
        assert fit_calls[-1][0].optim.iter_size == want


def test_remat_flag_sets_model_remat(fit_calls):
    rc, _ = _run(TRAIN + ["--steps", "1", "--remat"])
    assert rc == 0
    (cfg, state), = fit_calls
    assert cfg.model.remat is True and state.models.depth.remat is True


def test_tensorboard_flag_writes_events_read_back(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    tb = str(tmp_path / "tb")
    rc, out = _run(TRAIN + ["--steps", "3", "--log-every", "1", "--tensorboard", tb])
    assert rc == 0
    logged = [ln for ln in out.splitlines() if ln.startswith("step ")]
    acc = EventAccumulator(tb)
    acc.Reload()
    assert {"loss/total", "loss/stereo", "steps_per_sec"} <= set(acc.Tags()["scalars"])
    values = [(e.step, e.value) for e in acc.Scalars("loss/total")]
    assert [s for s, _ in values] == [0, 1, 2]
    for (step, value), line in zip(values, logged):
        printed = float(dict(kv.split("=") for kv in line.split(": ", 1)[1].split())["loss/total"])
        assert abs(value - printed) <= 1e-5 * abs(printed)


def test_metric_logger_without_tensorboard_raises_the_references_error(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kw):
        if name.startswith(("torch.utils.tensorboard", "tensorboard")):
            raise ModuleNotFoundError(f"No module named {name!r}")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    with pytest.raises(ModuleNotFoundError, match=r"--tensorboard needs torch \+ tensorboard"):
        MetricLogger(stream=io.StringIO(), tensorboard_dir="unused")


def _inf_lr_config(path):
    """tiny_test whose learning rate is finite for updates 0 and 1 and
    infinite from update 2 on (multistep, gamma = inf), checkpointing
    every step."""
    cfg = configs.tiny_test(batch_size=2)
    cfg = dataclasses.replace(cfg, checkpoint_every=1, optim=dataclasses.replace(
        cfg.optim, lr_policy="multistep", lr_step_values=(2,), lr_decay_factor=float("inf"),
        warmup_steps=0))
    config_base.save_json(cfg, path)


@pytest.mark.parametrize("k,step,saved", [(1, 2, [1, 2]), (2, 3, [2])])
def test_debug_nans_raises_at_the_spoiled_step_and_saves_nothing_after(tmp_path, k, step, saved):
    """Update 2 makes the parameters non-finite: with one step per call
    the check after step 2 sees them (its metrics were computed before the
    update); with two, the call of steps 2 and 3 ends with non-finite
    metrics. Either way no checkpoint of the spoiled state is written."""
    path, ckpt = str(tmp_path / "cfg.json"), str(tmp_path / "ckpt")
    _inf_lr_config(path)
    argv = ["train", "--config", path, "--device", "cpu", "--steps", "4",
            "--steps-per-call", str(k), "--checkpoint-dir", ckpt]
    with pytest.raises(FloatingPointError, match=f"after step {step}") as e:
        _run(argv + ["--debug-nans"])
    assert ("non-finite metric" if k == 2 else "non-finite state tensor") in str(e.value)
    assert ckpt_io.make_manager(ckpt).all_steps() == saved

    # Without the flag the same run goes on to the end, non-finite.
    shutil.rmtree(ckpt)
    assert _run(argv)[0] == 0
    weights = ckpt_io.read_weights(ckpt)
    assert not all(torch.isfinite(v).all() for v in weights["depth"].values())


def test_debug_nans_names_the_first_non_finite_metric():
    cfg = configs.tiny_test(batch_size=2)
    scenes = SyntheticScenes(cfg, seed=0)

    def batches():
        for i in range(3):
            b = scenes.batch(2)
            if i == 1:
                b["image_t"] = b["image_t"].copy()
                b["image_t"][0, 0, 0, 0] = float("nan")
            yield b

    with pytest.raises(FloatingPointError, match=r"metric '[^']+' after step 1"):
        loop.fit(cfg, batches(), 3, device="cpu", debug_nans=True)
