"""The port learns as the reference does, on the CPU at tiny_test size.

* ``test_train_trajectory_matches_the_reference``: 20 steps of the
  reference's ``fit`` and of the port's ``fit(device="cpu")`` from the
  same weights (the reference's trees carried into the port through
  ``io/from_jax.py``) on the same fixed synthetic batches, logging every
  step. Train-mode float32 is chaotic (ROADMAP C): from the first update
  on, the reference's own loss terms move by up to ~1e-1 relative when
  its images move by 1e-6. So at every step each ``loss/*`` term of the
  port is held to the larger of 1e-4 relative (the eval step's bar) and
  4x the reference's own spread at that step, the largest over four
  noise seeds (measured worst: 3.4x of that spread over several weight
  and scene seeds, 3.2x on these). Both runs end below their start. This
  answers, at small size, whether the chaotic gradients matter for
  training: the port's trajectory stays inside the reference's own.
* ``test_scene_metrics_match_feat_ab``: ``eval.synthetic`` (the protocol
  of ``benchmarks/feat_ab.py``, the port's copy) against the reference's
  ``depth_abs_rel`` and ``pose_err`` on the same weights and scenes.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import feat_ab
from depthvo_tpu import configs as jconfigs
from depthvo_tpu.data.synthetic import SyntheticScenes as JScenes
from depthvo_tpu.train import loop as jloop, state as jstate
from depthvo_tpu_torch import configs as tconfigs
from depthvo_tpu_torch.data.synthetic import SyntheticScenes
from depthvo_tpu_torch.eval import synthetic
from depthvo_tpu_torch.io.from_jax import load_jax_params
from depthvo_tpu_torch.train import loop as tloop, state as tstate
from test_torch_checkpoint import _to_flax

torch.set_num_threads(2)
torch.exp(torch.zeros(1))  # MKL's first call on one thread (test_torch_models.py)

CPU = torch.device("cpu")
STEPS = 20
LOSS_RTOL = 1e-4
NOISE_SEEDS = (1, 2, 3, 4)
MOTION_BIAS = np.array([2.0, -1.0, -30.0, 0.2, -0.3, 0.1], np.float32)  # test_torch_train.py


def _port_state(cfg, params, stats):
    models = load_jax_params(tstate.build_models(cfg), params, stats).train()
    return tstate.TrainState(0, models, tstate.make_optimizer(cfg).init(tstate.param_tree(models)))


def test_train_trajectory_matches_the_reference(monkeypatch):
    jcfg, tcfg = jconfigs.tiny_test(log_every=1), tconfigs.tiny_test(log_every=1)
    params, stats = _to_flax(tstate.create_state(tcfg, CPU, torch.Generator().manual_seed(5)).models)
    scenes = SyntheticScenes(tcfg, seed=3, num_scenes=4)
    batches = [scenes.batch(tcfg.batch_size) for _ in range(STEPS)]

    def noisy(seed):
        rng = np.random.default_rng(seed)
        return [{k: (v + 1e-6 * rng.normal(size=v.shape)).astype(np.float32)
                 if k.startswith("image") else v for k, v in b.items()} for b in batches]

    # One compiled reference step serves its five runs (the same config).
    step = jloop.make_train_step(jcfg, None)
    monkeypatch.setattr(jloop, "make_train_step", lambda *a, **k: step)

    def reference(bs):
        as_jnp = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
        p = as_jnp(params)
        state = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=p,
                                  batch_stats=as_jnp(stats),
                                  opt_state=jstate.make_optimizer(jcfg).init(p))
        log = {}
        jloop.fit(jcfg, iter(bs), STEPS, state=state, prefetch=0,
                  log_fn=lambda s, m: log.__setitem__(s, {k: float(v) for k, v in m.items()}))
        return log

    ref = reference(batches)
    spread = [reference(noisy(seed)) for seed in NOISE_SEEDS]
    got = {}
    tloop.fit(tcfg, iter(batches), STEPS, state=_port_state(tcfg, params, stats), prefetch=0,
              log_fn=lambda s, m: got.__setitem__(s, m), device="cpu")

    assert sorted(got) == sorted(ref) == list(range(STEPS))
    terms = [k for k in ref[0] if k.startswith("loss/")]
    assert len(terms) == 5
    for s in range(STEPS):
        for k in terms:
            r = ref[s][k]
            own = max(abs(run[s][k] - r) for run in spread) / abs(r)
            bar = max(LOSS_RTOL, 4 * own)
            assert abs(got[s][k] - r) <= bar * abs(r), (s, k, got[s][k], r, own)
    for log in (ref, got):
        assert log[STEPS - 1]["loss/total"] < log[0]["loss/total"]


def test_scene_metrics_match_feat_ab():
    jcfg, tcfg = jconfigs.tiny_test(), tconfigs.tiny_test()
    params, stats = _to_flax(tstate.create_state(tcfg, CPU, torch.Generator().manual_seed(6)).models)
    params["odom"]["Dense_2"]["bias"] = MOTION_BIAS
    scenes = SyntheticScenes(tcfg, seed=3, num_scenes=4)
    jscenes = JScenes(jcfg, seed=3, num_scenes=4)
    np.testing.assert_array_equal(scenes.fixed_batch(2)["image_t"], jscenes.fixed_batch(2)["image_t"])
    jstate_ = types.SimpleNamespace(params=jax.tree.map(jnp.asarray, params),
                                    batch_stats=jax.tree.map(jnp.asarray, stats))
    models = load_jax_params(tstate.build_models(tcfg), params, stats)
    depth = synthetic.depth_metrics(models, scenes, tcfg.batch_size)
    pose = synthetic.pose_metrics(models, scenes, tcfg.batch_size)
    ref_abs_rel = feat_ab.depth_abs_rel(jstate_, jscenes, jcfg)
    ref_t, ref_r = feat_ab.pose_err(jstate_, jscenes, jcfg)
    # The depth and odometry nets agree to 2e-5 (tests/test_torch_models.py).
    assert depth["abs_rel"] == pytest.approx(ref_abs_rel, rel=1e-4)
    assert pose["t_err_m"] == pytest.approx(ref_t, rel=1e-4)
    # A rotation of ~0.2 degrees through arccos of a float32 trace: the
    # reference's rounding of cos (~2e-7) moves the angle by ~3e-3 degrees.
    assert pose["r_err_deg"] == pytest.approx(ref_r, abs=1e-2)
    assert 0.1 < ref_r < 1.0 and -1.0 <= depth["log_corr"] <= 1.0
    assert len(pose["t_err_rel"]) == tcfg.batch_size
    assert pose["t_err_rel_max"] == max(pose["t_err_rel"])
    assert models.depth.training is False  # the mode it was given, restored
    models.depth.train()
    synthetic.depth_metrics(models, scenes, tcfg.batch_size)
    assert models.depth.training is True
