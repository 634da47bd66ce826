"""The ManyDepth cell on the CPU: its entries, the readers on a synthetic
record, the rooflines' byte counts by hand, the runner failing fast on a
program without the architecture, the frozen reference against the
repository's at float32, the FLOP count, the matching number against the
planted faults of ``gpubench/mf_control.py``, and the runner end to end
at a tiny size."""

from __future__ import annotations

import os
import sys
import time

import pytest
import torch

from gpubench import compare, md2_flops, md2_scenes, mf_control, mf_flops, mf_readers
from gpubench import mf_roofline, mf_weights, spec, train_mf_cell, weights
from gpubench.reference import manydepth as mf

CELL = "manydepth_1024x320.train_graph_mf"
MD2_CELL = "monodepth2_ms_1024x320.train_graph_seq3"
H100 = "NVIDIA H100 80GB HBM3"


def tiny_mf():
    """The ManyDepth cell at 64x128, float32, two rows, short calls."""
    c = spec.cell(CELL)
    config = dict(c.config, batch_size=2, model=dict(c.config["model"], height=64, width=128,
                                                     compute_dtype="float32"))
    traffic = dict(c.traffic, pool_batches=2, steps_per_call=2, trace_seconds=0.5)
    return c._replace(config=config, traffic=traffic)


def test_the_new_entries_keep_to_the_contract():
    bench = spec.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells[CELL]["chips"] == 1
    config = next(c for c in bench["configs"] if c["name"] == "manydepth_1024x320")
    assert config["reduced"] == [] and os.path.isfile(os.path.join(spec.ROOT, config["file"]))
    c = spec.cell(CELL)
    assert [m["name"] for m in c.end_to_end] == ["train_frames_per_s", "setup_s"]
    assert {m["name"] for m in c.per_layer} == {
        "device_idle_share.train", "mfu.train", "conv_ms_per_step.train",
        "tail_ms_per_step.train", "cost_volume_roofline.mf", "loss_ms_per_step.mf",
        "border_warp_roofline.mf"}
    assert set(c.limits) == {"loss", "consistency", "match", "grad", "change", "bn"}
    assert c.traffic["kind"] == "train_mf"
    # the configuration is the system's whole
    from depthvo_tpu_torch.configs import base as config_base

    assert config_base.to_dict(config_base.from_dict(spec.experiment(c.config))) == \
        config_base.to_dict(config_base.manydepth())


def test_roofline_count_by_hand():
    full = spec.experiment(spec.cell(CELL).config)
    assert mf_roofline.cost_volume_bytes_per_step(full) == 12 * 80 * 256 * (2 * 64 * 2 + 96 * 4
                                                                           + 8)
    f32 = dict(full, model=dict(full["model"], compute_dtype="float32"))
    assert mf_roofline.cost_volume_bytes_per_step(f32) == 12 * 80 * 256 * (2 * 64 * 4 + 392)
    # two nets x frames -1, +1 x 4 scales; each warp reads the source and
    # writes the output (3 channels) with one geometry map forward, reads
    # the source and the cotangent with one map in and one out backward
    pixels = 12 * 320 * 1024
    assert mf_roofline.warps_per_step(full) == 16
    assert mf_roofline.border_bytes_per_step(full) == 16 * 4 * (7 * pixels + 8 * pixels)


def test_readers_on_a_synthetic_record():
    config = spec.experiment(spec.cell(CELL).config)
    names = {"void (anonymous namespace)::cost_volume_fwd_kernel<__nv_bfloat16>(...)": 0.005,
             "void gen_fwd_border_kernel(float const*)": 0.010,
             "void gen_bwd_uv_border_kernel(float const*)": 0.014,
             "sm90_xmma_fprop_implicit_gemm_bf16": 0.5,
             "void md2_batch_norm_stats_kernel<float>": 0.1,
             "Memcpy DtoD (Device -> Device)": 0.02,
             "void at::native::elementwise_kernel<128, 2>": 0.3,
             "void at::native::reduce_kernel<512, 1>": 0.06}
    run = {"device_name": H100, "config": config, "steps": 10, "window_s": 2.0,
           "trace": {"busy_s": 1.0, "window_s": 2.0, "by_name_s": names}}
    bound = 12 * 80 * 256 * 648 * 10 / 3.35e12
    assert mf_readers.cost_volume_roofline(run) == pytest.approx(100 * bound / 0.005)
    assert mf_readers.loss_ms_per_step(run) == pytest.approx(1e3 * 0.36 / 10)
    assert spec.reader("cost_volume_roofline.mf")(run) == mf_readers.cost_volume_roofline(run)
    assert spec.reader("loss_ms_per_step.mf")(run) == mf_readers.loss_ms_per_step(run)
    border = 16 * 4 * 15 * 12 * 320 * 1024 * 10 / 3.35e12
    assert mf_readers.border_roofline(run) == pytest.approx(100 * border / 0.024)
    assert spec.reader("border_warp_roofline.mf")(run) == mf_readers.border_roofline(run)
    # Nothing to read: no trace, no steps, another card, no cost volume
    # kernel (a program without it, as the parent of this cell).
    without = dict(run, trace=dict(run["trace"], by_name_s={
        k: v for k, v in names.items() if "cost_volume" not in k}))
    for record in ({}, dict(run, steps=0), dict(run, trace=None), without):
        assert mf_readers.loss_ms_per_step(record) is None
        assert mf_readers.cost_volume_roofline(record) is None
    for record in ({}, dict(run, steps=0), dict(run, trace=None)):
        assert mf_readers.border_roofline(record) is None
    assert mf_readers.cost_volume_roofline(dict(run, device_name="CPU")) is None


def test_the_runner_fails_fast_without_the_architecture(monkeypatch, capsys):
    from depthvo_tpu_torch.configs import base as config_base

    def render(*a, **k):
        raise AssertionError("rendered before the architecture check")

    monkeypatch.setattr(md2_scenes, "Pool", render)
    monkeypatch.setattr(config_base, "ARCHITECTURES", ("depthvo_feat", "monodepth2"))
    with pytest.raises(SystemExit) as exit_:
        train_mf_cell.run(tiny_mf(), 3, 1.0, False, torch.device("cpu"), time.perf_counter())
    assert exit_.value.code == 1 and "ManyDepth" in capsys.readouterr().err


def _repo_reference():
    sys.path.insert(0, spec.ROOT)
    from references import manydepth as repo

    return repo


def test_the_frozen_reference_is_the_repositorys_at_float32():
    repo = _repo_reference()
    config = spec.experiment(tiny_mf().config)
    cpu = torch.device("cpu")
    params = mf_weights.make(config, 5, cpu)
    pool = train_mf_cell.Pool(config, dict(tiny_mf().traffic, pool_batches=1), 2, cpu)
    batch = {k: torch.as_tensor(v) for k, v in pool.reference_batch(0).items()}
    assert "image_r" not in batch and batch["aug_u"].shape == (2,)
    names = mf.trainable(config)
    out = []
    for module in (mf, repo):
        trainer = module.Trainer(config, params, noise_seed=1)
        terms = trainer.step(batch)
        out.append((terms, trainer.first_grads, trainer.stats, trainer.trackers))
    (ta, ga, sa, ka), (tb, gb, sb, kb) = out
    assert ta == tb and ka == kb
    assert all(torch.equal(ga[k], gb[k]) for k in names)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_the_flop_count_holds_cell_a_nets():
    """Two depth nets and three pose passes (one without a backward): more
    than cell A's one depth net and two pose passes, less than twice."""
    full = spec.experiment(spec.cell(CELL).config)
    md2 = md2_flops.train_step(spec.experiment(spec.cell(MD2_CELL).config))
    assert md2 < mf_flops.train_step(full) < 2 * md2


def test_the_mf_cell_runs_on_the_cpu():
    cell = tiny_mf()
    torch.manual_seed(0)  # the system's tie-breaking noise (the reference seeds its own)
    out = train_mf_cell.run(cell, 11, 0.5, False, torch.device("cpu"), time.perf_counter())
    assert out["failed"] == 0 and out["attempted"] > 0 and out["rate"] > 0
    assert out["run"]["rows"] == 2 * out["attempted"] and set(out["numbers"]) == set(cell.limits)
    assert set(out["detail"]["loss_by_term_same_weights"]) == {1, 2}
    # Both sides float32 from the same weights: the first gradient and the
    # statistics agree; on the same weights the judged terms agree to the
    # tie-breaking noise, which the two sides draw apart and which decides
    # the teacher's mask at this size's many ties (up to ~3e-3).
    assert out["numbers"]["grad"] < 1e-3 and out["numbers"]["bn"] < 1e-3, out["numbers"]
    assert out["numbers"]["loss"] < 1e-2, out["numbers"]
    assert out["numbers"]["match"] < 1e-4, out["detail"]["match"]
    assert set(out["detail"]["match"]) == {"timed", "step_1"}
    assert all(set(parts) == {"volume", "confidence", "lowest", "lookup_rows", "zero_pose_rows"}
               for parts in out["detail"]["match"].values())
    assert set(out["detail"]["trackers"]) == {"depth.encoder.min_depth_bin",
                                             "depth.encoder.max_depth_bin"}


@pytest.mark.parametrize("fault", [None, *mf_control.FAULTS])
def test_the_matching_number_catches_the_planted_faults(fault, monkeypatch):
    """Sound, the system's matching layer and the reference's agree to
    float32's rounding at this size; with a fault of the matching layer
    planted, ``match`` is over the cell's limit and the run not correct."""
    from depthvo_tpu_torch.configs import base as config_base
    from depthvo_tpu_torch.train import loop
    from depthvo_tpu_torch.train.state import build_models, load_params

    cell = tiny_mf()
    config = spec.experiment(cell.config)
    cfg = config_base.from_dict(config)
    cpu = torch.device("cpu")
    params = mf_weights.make(config, 11, cpu)
    models = load_params(build_models(cfg), weights.state_dicts(params), cpu).train()
    batch = loop.batch_to_device(train_mf_cell.Pool(config, dict(cell.traffic, pool_batches=1),
                                                    11, cpu).reference_batch(0), cpu)
    if fault is not None:
        monkeypatch.setattr(*mf_control.FAULTS[fault]())
    parts = train_mf_cell.matching_number(loop, cfg, models, config, batch)
    numbers = dict.fromkeys(cell.limits, 0.0)
    numbers["match"] = max(parts.values())
    if fault is None:
        assert numbers["match"] < 1e-4, parts
        assert compare.judge(numbers, cell.limits)
    else:
        assert numbers["match"] > cell.limits["match"], parts
        assert not compare.judge(numbers, cell.limits)
