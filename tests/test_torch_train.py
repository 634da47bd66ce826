"""The port's train step, solver chain and training loop, held against the
JAX package.

* Solver chain: the port's ``make_optimizer`` and optax's (the reference's
  ``make_optimizer``) on the same parameters and the same gradients, step
  by step. Tolerance: each leaf's update within 1e-6 of that update's
  largest magnitude, and the parameters within 1e-6 of theirs (float32
  arithmetic in the same order up to fused multiply-adds).
* Train step: one ``tiny_test`` step from the same weights and batch
  against ``jax.value_and_grad`` of the reference's ``compute_losses(
  train=True)``. Tolerances: loss terms 1e-4 relative (as the eval step,
  tests/test_torch_slice.py); each parameter's gradient 2e-4 relative L2
  error (ROADMAP's gradient bar); the new BatchNorm statistics 2e-4 of
  each statistic's largest magnitude (the whole-network bar of
  tests/test_torch_models.py and its reason). On the CPU the reference
  takes its plain warps, whose ``valid`` has no window term; the test
  asserts that the window drops no pixel of these inputs.
* Overfit one batch per stage (as tests/test_train.py), the CLI on the
  CPU, and the entry points refusing to run without a GPU.
"""

import collections
import dataclasses
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from depthvo_tpu import configs as jconfigs
from depthvo_tpu.configs import base as jbase
from depthvo_tpu.data.synthetic import SyntheticScenes as JScenes
from depthvo_tpu.geometry import camera as jcam, se3 as jse3, warp as jwarp
from depthvo_tpu.ops import warp_pallas
from depthvo_tpu.train import loop as jloop, state as jstate
from depthvo_tpu.utils.images import to_unit as jto_unit
from depthvo_tpu_torch import cli, configs as tconfigs, ops as tops
from depthvo_tpu_torch.configs import base as tbase
from depthvo_tpu_torch.data.synthetic import SyntheticScenes
from depthvo_tpu_torch.io.from_jax import load_jax_params, params_from_jax, state_dict_from_jax
from depthvo_tpu_torch.ops import warp_kernels
from depthvo_tpu_torch.train import loop as tloop, optim, state as tstate
from test_torch_models import jax_state

torch.set_num_threads(2)
torch.exp(torch.zeros(1))  # MKL's first call on one thread (test_torch_models.py)

UPDATE_RTOL = 1e-6


# --------------------------------------------------------------------------
# Solver chain against optax.
# --------------------------------------------------------------------------

SHAPES = {"depth": {"a": (3, 4), "b": (5,)}, "odom": {"c": (2, 3)}, "feat": {"d": (4,)}}


def _tree(rng, scale=1.0):
    return {net: {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in leaves.items()}
            for net, leaves in SHAPES.items()}


def _flat(tree):
    return {f"{net}.{k}": torch.from_numpy(np.array(v)) for net, leaves in tree.items()
            for k, v in leaves.items()}


def _run_both(optim_kwargs, steps=7, train_feat=False):
    """Apply both chains to the same gradients; check every step."""
    rng = np.random.default_rng(0)
    oc_kw = dict(learning_rate=1e-2, warmup_steps=0, lr_policy="fixed")
    oc_kw.update(optim_kwargs)
    jcfg = jconfigs.tiny_test(optim=jbase.OptimConfig(**oc_kw), train_feat=train_feat)
    tcfg = tconfigs.tiny_test(optim=tbase.OptimConfig(**oc_kw), train_feat=train_feat)
    params = _tree(rng)
    jtx, ttx = jstate.make_optimizer(jcfg), tstate.make_optimizer(tcfg)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = _flat(params)
    jst, tst = jtx.init(jparams), ttx.init(tparams)
    moved = set()
    for step in range(steps):
        # Gradient norms from ~1 to ~40, so the clip at 10 acts on some steps.
        grads = _tree(rng, scale=float(rng.choice([0.3, 3.0, 12.0])))
        jup, jst = jtx.update(jax.tree.map(jnp.asarray, grads), jst, jparams)
        jparams = optax.apply_updates(jparams, jup)
        tup, tst = ttx.update(_flat(grads), tst, tparams)
        optim.apply_updates(tparams, tup)
        for key, ref in _flat(jax.device_get(jup)).items():
            got = tup.get(key, torch.zeros_like(ref))
            scale = max(float(ref.abs().max()), 1e-30)
            assert float((got - ref).abs().max()) <= UPDATE_RTOL * scale, (step, key)
            if float(ref.abs().max()) > 0:
                moved.add(key)
        for key, ref in _flat(jax.device_get(jparams)).items():
            err = float((tparams[key] - ref).abs().max() / ref.abs().max())
            assert err <= UPDATE_RTOL, (step, key, err)
    return moved


@pytest.mark.parametrize("solver", tstate.OPTIMIZERS)
def test_solvers_match_optax(solver):
    """Each solver with Caffe's L2 (adamw's decoupled decay for adam),
    the global-norm clip and the frozen feature net."""
    moved = _run_both({"optimizer": solver, "weight_decay": 1e-2})
    assert moved == {"depth.a", "depth.b", "odom.c"}  # feat frozen


@pytest.mark.parametrize("policy", ["fixed", "step", "exp", "inv", "multistep", "poly", "sigmoid"])
def test_lr_policies_and_warmup_match_optax(policy):
    """sgd without momentum, so each update is -lr(t) * clipped grad; a
    3-step warmup joined to each policy (update 0 gets lr 0)."""
    _run_both({"optimizer": "sgd", "beta1": 0.0, "lr_policy": policy,
               "warmup_steps": 3, "lr_decay_steps": 2, "lr_decay_factor": 0.7,
               "lr_power": 1.5, "lr_step_values": (1, 3), "total_steps": 6},
              steps=9)
    oc = tbase.OptimConfig(lr_policy=policy, warmup_steps=3, lr_step_values=(1,))
    assert tstate.warmup_schedule(oc)(0) == 0.0


def test_iter_size_and_train_feat_match_optax():
    moved = _run_both({"optimizer": "adam", "iter_size": 3}, steps=7, train_feat=True)
    assert moved == {"depth.a", "depth.b", "odom.c", "feat.d"}


def test_unknown_solver_and_policy_raise():
    with pytest.raises(ValueError, match="optimizer"):
        tstate.make_optimizer(tconfigs.tiny_test(optim=tbase.OptimConfig(optimizer="lbfgs")))
    with pytest.raises(ValueError, match="lr_policy"):
        tstate.lr_schedule(tbase.OptimConfig(lr_policy="cosine"))


# --------------------------------------------------------------------------
# One train step against jax.value_and_grad of the reference.
# --------------------------------------------------------------------------


# A real camera motion for the random odometry net (its last bias; the
# twist is 0.01 x the Dense output): with the near-zero twist of random
# weights every temporal sample sits within ~1e-4 px of a pixel centre,
# where the bilinear gradient jumps, and the gradients of two float32
# implementations differ there by one-sided slopes.
MOTION_BIAS = np.array([2.0, -1.0, -30.0, 0.2, -0.3, 0.1], np.float32)


@pytest.fixture(scope="module")
def step_pair():
    cfg = jconfigs.tiny_test()
    (dn, on, fn), params, batch_stats = jax_state(cfg, np.random.default_rng(5))
    params["odom"]["Dense_2"]["bias"] = MOTION_BIAS
    batch = next(JScenes(cfg, seed=11, u8=True).iterator(cfg.batch_size))
    fbatch = {k: np.asarray(jto_unit(v)) if v.dtype == np.uint8 else v for k, v in batch.items()}
    noisy = []
    for seed in (1, 2):  # the images plus float32 noise of 1e-6
        noise = np.random.default_rng(seed)
        noisy.append({k: (v + 1e-6 * noise.normal(size=v.shape)).astype(np.float32)
                      if k.startswith("image") else v for k, v in fbatch.items()})

    def grads_fn(train):
        def loss_fn(p, b):
            return jloop.compute_losses(cfg, (dn, on, fn), p, batch_stats, b, train=train)

        return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    train_grad = grads_fn(True)
    (_, (ref_metrics, ref_bs)), ref_grads = train_grad(params, fbatch)
    spread = [params_from_jax(jax.device_get(train_grad(params, b)[1]), {}) for b in noisy]
    (_, (eval_metrics, _)), eval_grads = grads_fn(False)(params, fbatch)

    tcfg = tconfigs.tiny_test()
    models = load_jax_params(tstate.build_models(tcfg), params, batch_stats)
    # The eval-mode graph, differentiated (BatchNorm on running averages).
    total, tm = tloop.compute_losses(tcfg, models, tloop.batch_to_device(fbatch, "cpu"))
    total.backward()
    eval_got = {k: None if p.grad is None else p.grad.clone()
                for k, p in tstate.param_tree(models).items()}
    # The train step itself.
    state = tstate.TrainState(0, models, tstate.make_optimizer(tcfg).init(
        tstate.param_tree(models)))
    state, metrics = tloop.make_train_step(tcfg, device="cpu")(state, fbatch)
    return dict(cfg=cfg, nets=(dn, on, fn), params=params, batch_stats=batch_stats,
                batch=fbatch, ref_metrics=jax.device_get(ref_metrics),
                ref_bs=jax.device_get(ref_bs),
                ref_grads=params_from_jax(jax.device_get(ref_grads), {}), spread=spread,
                eval_ref=(jax.device_get(eval_metrics),
                          params_from_jax(jax.device_get(eval_grads), {})),
                eval_got=({k: v.detach() for k, v in tm.items()}, eval_got),
                state=state, metrics=metrics)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_window_drops_no_pixel_of_the_train_inputs(step_pair):
    """Train-mode disparities (batch statistics) through the kernel path's
    window and the plain warp's mask: identical, so the reference's CPU
    path and the port compute the same function here."""
    cfg, (dn, on, _), params = step_pair["cfg"], step_pair["nets"], step_pair["params"]
    batch = step_pair["batch"]
    disps, _ = jax.jit(lambda v, x: dn.apply(v, x, train=True, mutable=["batch_stats"]))(
        {"params": params["depth"], "batch_stats": step_pair["batch_stats"]}, batch["image_t"])
    T = jse3.exp(jax.jit(on.apply)({"params": params["odom"]},
                                   jnp.concatenate([batch["image_t"], batch["image_s"]], -1)))
    H, W = cfg.model.height, cfg.model.width
    checked = 0
    for disp in disps:
        h, w = disp.shape[1:3]
        pad_v = tops.kernel_pad_v(h, cfg.warp_pad_v)
        if pad_v is None:
            continue
        Ks = jcam.scale_intrinsics(batch["K"], w / W, h / H)
        depth = 1.0 / disp[..., 0]
        kernel_valid = warp_pallas._gen_warp_prep(depth, T, Ks, h, w, pad_v)[2]
        plain_valid = jwarp.inverse_warp(jnp.zeros((2, h, w, 1)), depth, T, Ks)[1]
        np.testing.assert_array_equal(np.asarray(kernel_valid), np.asarray(plain_valid))
        assert np.asarray(plain_valid).mean() > 0.5
        checked += 1
    assert checked >= 1


def test_loss_graph_gradients_match_jax_grad(step_pair):
    """The whole loss graph differentiated with BatchNorm on its running
    averages (warps, geometry, losses, the three nets): every leaf to
    2e-4 relative L2 (measured <= 6.2e-5)."""
    (ref_m, ref_g), (got_m, got_g) = step_pair["eval_ref"], step_pair["eval_got"]
    for k, r in ref_m.items():
        assert abs(float(got_m[k]) - float(r)) <= 1e-4 * abs(float(r)), k
    for key, g in got_g.items():
        net, name = key.split(".", 1)
        if net == "feat":
            assert g is None
            continue
        assert _rel(g, ref_g[net][name]) <= 2e-4, key


def test_train_step_matches_jax_grad(step_pair):
    """The train step: loss terms and every gradient whose reference
    value is stable (it moves by <= 1e-5 when the images move by 1e-6:
    the odometry net and the disparity heads) to the bars above. Below
    its heads the depth net's train-mode gradients are not stable at this
    size: batch-statistics BatchNorm makes them chaotic in float32, and
    the reference's own move by ~1e-2 under that 1e-6 noise (measured; a
    1e-7 change of the port's input moves the port's by as much). There
    they are held, as one vector, to 4x the reference's own spread, and
    grad/global_norm to the same bar."""
    ref, got = step_pair["ref_metrics"], step_pair["metrics"]
    assert set(got) == set(ref) | {"grad/global_norm"}
    for k, r in ref.items():
        assert abs(float(got[k]) - float(r)) <= 1e-4 * abs(float(r)), (k, float(got[k]), float(r))

    ref_grads, spread = step_pair["ref_grads"], step_pair["spread"]
    params = tstate.param_tree(step_pair["state"].models)
    assert {k.split(".")[0] for k in params} == {"depth", "odom", "feat"}
    stable, unstable = [], []
    for key, p in params.items():
        net, name = key.split(".", 1)
        r = ref_grads[net][name]
        if net == "feat":  # frozen: no gradient in the port, zeros in JAX
            assert p.grad is None and float(r.abs().max()) == 0.0
            continue
        own = max(_rel(s[net][name], r) for s in spread)
        (stable if own <= 1e-5 else unstable).append((key, p.grad, r, [s[net][name] for s in spread]))
    assert len(stable) >= 20  # the odometry net and the disparity heads
    for key, g, r, _ in stable:
        assert _rel(g, r) <= 2e-4, key
    assert all(key.startswith("depth.") for key, *_ in unstable)
    got_u = torch.cat([g.flatten() for _, g, _, _ in unstable])
    ref_u = torch.cat([r.flatten() for _, _, r, _ in unstable])
    own_u = max(_rel(torch.cat([s[i].flatten() for *_, s in unstable]), ref_u) for i in range(2))
    assert _rel(got_u, ref_u) <= 4 * own_u, (_rel(got_u, ref_u), own_u)
    norm = float(got["grad/global_norm"])
    ref_norm = float(torch.cat([r.flatten() for sd in ref_grads.values() for r in sd.values()]).norm())
    assert abs(norm - ref_norm) <= max(1e-4, 4 * own_u) * ref_norm

    new_stats = state_dict_from_jax({}, step_pair["ref_bs"])
    sd = step_pair["state"].models.depth.state_dict()
    for k, r in new_stats.items():
        assert float((sd[k] - r).abs().max() / r.abs().max()) <= 2e-4, k


def test_train_step_updates_every_trainable_parameter(step_pair):
    """tiny_test has no warmup: the first update moves the depth and
    odometry nets and leaves the frozen feature net as it was."""
    params = tstate.param_tree(step_pair["state"].models)
    ref = {f"{net}.{k}": v for net, sd in params_from_jax(
        step_pair["params"], step_pair["batch_stats"]).items() for k, v in sd.items()}
    assert step_pair["state"].step == 1
    for key, p in params.items():
        same = torch.equal(p.detach(), ref[key])
        assert same == key.startswith("feat."), key


# --------------------------------------------------------------------------
# The training loop and the CLI.
# --------------------------------------------------------------------------


def _overfit(config, steps=12):
    scenes = SyntheticScenes(config, seed=1, num_scenes=2)
    losses = []
    config = dataclasses.replace(config, log_every=1)
    tloop.fit(config, scenes.iterator(config.batch_size, fixed=True), steps, device="cpu",
              log_fn=lambda step, m: losses.append(m["loss/total"]))
    return losses


@pytest.mark.parametrize("variant", ["stereo", "temporal", "full"])
def test_overfit_loss_decreases(variant):
    base = tconfigs.tiny_test()
    cfg = {
        "stereo": dataclasses.replace(base, use_temporal=False, use_feature=False),
        "temporal": dataclasses.replace(base, use_feature=False),
        "full": base,
    }[variant]
    losses = _overfit(cfg)
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


@pytest.mark.parametrize("mode", ["eval", "train", "train_feat"])
def test_loss_graph_runs_one_grouped_forward_per_warp_kernel(monkeypatch, mode):
    """``compute_losses`` warps the whole pyramid with one grouped stereo
    and one grouped general sample per call; a train step's backward then
    runs K2 twice (the finest scale, then the coarse scales together) and
    gen_bwd_uv once per general segment (one fewer with ``train_feat``,
    whose fused finest warp is the plain differentiable one), and never
    K3."""
    calls = collections.Counter()
    for name in ("stereo_sample_pyramid", "gen_sample_pyramid", "stereo_bwd_u_grouped",
                 "stereo_bwd_src", "gen_bwd_uv"):
        real = getattr(warp_kernels, name)
        monkeypatch.setattr(warp_kernels, name,
                            lambda *a, _n=name, _f=real: calls.update([_n]) or _f(*a))
    cfg = tconfigs.tiny_test(train_feat=mode == "train_feat")
    n = cfg.model.num_scales
    state = tstate.create_state(cfg, torch.device("cpu"))
    batch = SyntheticScenes(cfg, seed=3, num_scenes=2).fixed_batch(cfg.batch_size)
    if mode == "eval":
        tloop.make_eval_step(cfg, device="cpu")(state.models, batch)
        assert calls == {"stereo_sample_pyramid": 1, "gen_sample_pyramid": 1}
        return
    _, metrics = tloop.make_train_step(cfg, device="cpu")(state, batch)
    assert np.isfinite(float(metrics["loss/total"]))
    gen_segments = n - 1 if mode == "train_feat" else n
    assert calls == {"stereo_sample_pyramid": 1, "gen_sample_pyramid": 1,
                     "stereo_bwd_u_grouped": min(n, 2), "gen_bwd_uv": gen_segments}


def test_train_feat_trains_the_feature_net():
    """``train_feat=True``: the feature net runs with a graph and the
    fused warp takes the differentiable plain warp, so its parameters get
    gradients and the solver moves them (frozen by default: see
    test_train_step_updates_every_trainable_parameter)."""
    cfg = tconfigs.tiny_test(train_feat=True)
    state = tstate.create_state(cfg, torch.device("cpu"))
    before = {k: p.detach().clone() for k, p in tstate.param_tree(state.models).items()}
    batch = SyntheticScenes(cfg, seed=3, num_scenes=2).fixed_batch(cfg.batch_size)
    state, metrics = tloop.make_train_step(cfg, device="cpu")(state, batch)
    assert np.isfinite(float(metrics["loss/feature"]))
    for key, p in tstate.param_tree(state.models).items():
        assert p.grad is not None and not torch.equal(p.detach(), before[key]), key


def test_fit_validates_and_honours_stop_signals(capsys):
    cfg = dataclasses.replace(tconfigs.tiny_test(), log_every=100)
    scenes = SyntheticScenes(cfg, seed=2, num_scenes=2)
    logged = []
    state = tloop.fit(cfg, scenes.iterator(cfg.batch_size), 3, device="cpu",
                      log_fn=lambda s, m: logged.append((s, m)),
                      eval_iter=scenes.iterator(cfg.batch_size), eval_every=2, eval_steps=1)
    assert state.step == 3
    steps = [s for s, m in logged if "loss/total" in m]
    vals = [s for s, m in logged if "val/loss/total" in m]
    assert steps == [0, 2] and vals == [1, 2]
    # Several steps per call: the last call is cut to the steps left.
    state = tloop.fit(cfg, scenes.iterator(cfg.batch_size), 1, device="cpu", steps_per_call=2)
    assert state.step == 1



def test_solver_signals_stop_outranks_snapshot():
    signals = tloop.SolverSignals(sigint="stop", sighup="snapshot")
    signals._handle(signal.SIGHUP, None)
    assert signals.pending() == "snapshot" and signals.pending() is None
    for signum in (signal.SIGHUP, signal.SIGINT, signal.SIGHUP):
        signals._handle(signum, None)
    assert signals.pending() == "stop"
    with pytest.raises(ValueError, match="sigint_effect"):
        tloop.SolverSignals(sigint="pause")


def test_cli_train_on_cpu(capsys):
    assert cli.main(["train", "--variant", "tiny_test", "--device", "cpu", "--steps", "2",
                     "--batch-size", "2", "--log-every", "1", "--eval-every", "2",
                     "--eval-steps", "1"]) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert len(lines) == 3  # steps 0 and 1, then the validation of step 1
    for ln in lines[:2]:
        terms = dict(kv.split("=") for kv in ln.split(": ", 1)[1].split())
        assert {"loss/total", "loss/stereo", "loss/temporal", "loss/feature",
                "loss/smooth", "grad/global_norm"} <= set(terms)
        assert all(np.isfinite(float(v)) for v in terms.values())
    assert "val/loss/total" in lines[2]


def test_train_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a GPU")
    cfg = tconfigs.tiny_test()
    it = SyntheticScenes(cfg, seed=0, num_scenes=1).iterator(cfg.batch_size)
    for call in (
        lambda: tloop.make_train_step(cfg),
        lambda: tloop.fit(cfg, it, 1),
        lambda: cli.main(["train", "--variant", "tiny_test", "--steps", "1"]),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
