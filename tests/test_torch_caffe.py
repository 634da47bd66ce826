"""The Caffe weight tools of the port (``io/caffemodel.py``,
``net_prototxt.py``, ``solver_prototxt.py``, ``import_weights.py``,
``export_weights.py``, ``name_map.py``, ``zoo.py``, ``to_flax_layout.py``
and their CLI commands) held against the reference on the CPU.

* Each module: the same bytes or text through both packages give equal
  trees (paths and arrays bit for bit), reports, configs and text.
* The exporter's round trips (``tests/test_export_weights.py``): an
  exported depth net re-imports into another initialisation exactly.
* A ``.caffemodel`` written by the reference's exporter, imported by the
  port (``cli import-caffemodel``), gives the networks ``from_jax`` makes
  of the reference's tree: every tensor and the depth bit for bit.
* ``export-caffemodel`` -> ``import-caffemodel`` through the port's CLI,
  ``make-name-map``, ``net-info``, ``convert``, ``zoo`` and ``train
  --solver --weights``.

The trees come from the port's initial draw (``to_flax_layout``), so no
flax initialisation is compiled.
"""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from depthvo_tpu import cli as jcli, configs as jconfigs, zoo as jzoo
from depthvo_tpu.io import caffemodel as jcm, export_weights as jexp
from depthvo_tpu.io import import_weights as jimp, name_map as jnm
from depthvo_tpu.io import net_prototxt as jnp_, solver_prototxt as jsp
from depthvo_tpu_torch import DepthVO, cli as tcli, configs as tconfigs, zoo as tzoo
from depthvo_tpu_torch.io import caffemodel as tcm, export_weights as texp
from depthvo_tpu_torch.io import import_weights as timp, name_map as tnm
from depthvo_tpu_torch.io import net_prototxt as tnp, solver_prototxt as tsp
from depthvo_tpu_torch.io.from_jax import load_jax_params
from depthvo_tpu_torch.io.to_flax_layout import to_flax_layout
from depthvo_tpu_torch.train import state as tstate
from test_caffemodel import encode_net
from test_net_prototxt import DEPTH_DEPLOY, FEAT_DEPLOY, ODOM_DEPLOY, TRAIN_GRAPH
from test_solver_prototxt import REALISTIC
from test_torch_models import _perturb_bn

torch.set_num_threads(2)
torch.exp(torch.zeros(1))  # MKL's first call on one thread (test_torch_models.py)

CPU = torch.device("cpu")


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, deleted at teardown (checkpoints)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _trees(seed, cfg=None):
    """A tiny_test state's flax-layout trees, BatchNorm perturbed so that
    no statistic is at its identity."""
    cfg = cfg or tconfigs.tiny_test()
    state = tstate.create_state(cfg, CPU, torch.Generator().manual_seed(seed))
    params, stats = to_flax_layout(state.models)
    rng = np.random.default_rng(seed)
    params["depth"] = _perturb_bn(params["depth"], rng)
    return params, _perturb_bn(stats, rng)


@pytest.fixture(scope="module")
def trees():
    return _trees(0)


def _assert_same_tree(a, b):
    fa, fb = timp._flatten_with_path(a), timp._flatten_with_path(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        np.testing.assert_array_equal(x, y, err_msg="/".join(p))


def test_flatten_walks_the_references_order(trees):
    """The port's tree walk (no jax) is ``jax.tree_util``'s: keys sorted."""
    params, stats = trees
    for tree in (params, params["depth"], stats):
        got = timp._flatten_with_path(tree)
        want = jimp._flatten_with_path(tree)
        assert [p for p, _ in got] == [p for p, _ in want]
        assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(got, want))
    assert timp._rebuild(params, dict(timp._flatten_with_path(params))).keys() == params.keys()


def test_exporters_write_the_same_bytes(trees, tmp_path):
    params, stats = trees
    for net, st in (("depth", stats), ("odom", None), ("feat", None)):
        want = jexp.export_caffemodel(params[net], batch_stats=st, net_name=net)
        got = texp.export_caffemodel(params[net], batch_stats=st, net_name=net,
                                     path=str(tmp_path / f"{net}.caffemodel"))
        assert got == want
        assert open(tmp_path / f"{net}.caffemodel", "rb").read() == want


def test_parsers_read_the_same_layers(trees):
    """``parse_caffemodel`` of an exported file, of a legacy
    (V1LayerParameter, ``num/channels/height/width``) file and the
    conversions (``conv_params``, ``fold_bn_scale``)."""
    params, stats = trees
    raw = jexp.export_caffemodel(params["depth"], batch_stats=stats)
    rng = np.random.default_rng(1)
    legacy = encode_net([("conv1", "Convolution", [rng.normal(size=(4, 3, 3, 3)).astype(
        np.float32), rng.normal(size=(4,)).astype(np.float32)])], legacy=True)
    for data in (raw, legacy):
        a, b = tcm.parse_caffemodel(data), jcm.parse_caffemodel(data)
        assert list(a) == list(b)
        for name in a:
            assert a[name]["type"] == b[name]["type"]
            assert len(a[name]["blobs"]) == len(b[name]["blobs"])
            for x, y in zip(a[name]["blobs"], b[name]["blobs"]):
                np.testing.assert_array_equal(x, y)
    layers = tcm.parse_caffemodel(raw)
    conv = next(n for n, l in layers.items() if l["type"] == "Convolution")
    for flip in (False, True):
        _assert_same_tree(tcm.conv_params(layers[conv], flip_bgr=flip),
                          jcm.conv_params(layers[conv], flip_bgr=flip))
    bn = next(n for n, l in layers.items() if l["type"] == "BatchNorm")
    sc = next(n for n, l in layers.items() if l["type"] == "Scale")
    _assert_same_tree(tcm.fold_bn_scale(layers[bn]["blobs"], layers[sc]["blobs"]),
                      jcm.fold_bn_scale(layers[bn]["blobs"], layers[sc]["blobs"]))


def test_depth_net_export_round_trip_is_exact(trees):
    """The exporter's contract (tests/test_export_weights.py): exported,
    then imported by shape order into another initialisation, the depth
    net's params and batch_stats come back exactly."""
    params, stats = trees
    other, other_stats = _trees(1)
    layers = tcm.parse_caffemodel(texp.export_caffemodel(params["depth"], batch_stats=stats))
    got, report = timp.import_by_shape_order(layers, other["depth"], strict=True)
    got, got_stats, bn_report = timp.import_bn_by_order(layers, got, other_stats)
    assert report and bn_report
    _assert_same_tree(got, params["depth"])
    _assert_same_tree(got_stats, stats)


@pytest.mark.parametrize("net", ["odom", "feat"])
def test_odom_and_feat_round_trip_is_exact(trees, net):
    params, _ = trees
    other, _ = _trees(1)
    layers = tcm.parse_caffemodel(texp.export_caffemodel(params[net]))
    got, report = timp.import_by_shape_order(layers, other[net], strict=True)
    assert len(report) == sum(p[-1] == "kernel" for p, _ in timp._flatten_with_path(params[net]))
    _assert_same_tree(got, params[net])


def _permuted(raw):
    """The file with the input conv's block moved to the end: file order
    no longer follows the model's, so only a name map seats it."""
    entries = [(n, l["type"], l["blobs"]) for n, l in jcm.parse_caffemodel(raw).items()]
    start = next(i for i, (_, _, b) in enumerate(entries)
                 if b and b[0].ndim == 4 and b[0].shape[1] == 3)
    end = start + 1
    while end < len(entries) and entries[end][2][0].ndim == 1:
        end += 1
    return encode_net(entries[:start] + entries[end:] + entries[start:end])


def test_name_maps_and_named_imports_equal_the_references(trees):
    """``generate_name_map`` (map, entries, problems, report text) and
    ``import_net`` through it, with the input transform folded, on a
    permuted file: equal trees and reports in both packages."""
    params, stats = trees
    other, other_stats = _trees(1)
    layers = jcm.parse_caffemodel(_permuted(jexp.export_caffemodel(params["depth"], stats)))
    got = tnm.generate_name_map(layers, other["depth"], other_stats, strict=False)
    want = jnm.generate_name_map(layers, other["depth"], other_stats, strict=False)
    assert got[0] == want[0] and got[2] == want[2] and not got[2]
    assert [dataclasses.asdict(e) for e in got[1]] == [dataclasses.asdict(e) for e in want[1]]
    assert tnm.format_map_report(got[1], got[2]) == jnm.format_map_report(want[1], want[2])
    kw = dict(name_map=got[0]["convs"], bn_name_map=got[0]["bns"],
              input_mean=[104.0, 117.0, 123.0], input_scale=0.5)
    p_t, s_t, r_t = timp.import_net(layers, other["depth"], other_stats, **kw)
    p_j, s_j, r_j = jimp.import_net(layers, other["depth"], other_stats, **kw)
    _assert_same_tree(p_t, p_j)
    _assert_same_tree(s_t, s_j)
    assert r_t == r_j and timp.format_report(r_t) == jimp.format_report(r_j)
    # Without the transform, the permuted file seats the original exactly.
    p_t, s_t, _ = timp.import_net(layers, other["depth"], other_stats,
                                  name_map=got[0]["convs"], bn_name_map=got[0]["bns"])
    _assert_same_tree(p_t, params["depth"])
    _assert_same_tree(s_t, stats)


def test_name_map_prototxt_cross_check_equal(trees):
    params, stats = trees
    layers = jcm.parse_caffemodel(jexp.export_caffemodel(params["depth"], stats))
    facts_t = tnp.extract_facts(tnp.parse_prototxt(DEPTH_DEPLOY))
    facts_j = jnp_.extract_facts(jnp_.parse_prototxt(DEPTH_DEPLOY))
    got = tnm.generate_name_map(layers, params["depth"], stats, proto_facts=facts_t,
                                strict=False)
    want = jnm.generate_name_map(layers, params["depth"], stats, proto_facts=facts_j,
                                 strict=False)
    assert got[0] == want[0] and got[2] == want[2]


@pytest.mark.parametrize("text", [DEPTH_DEPLOY, ODOM_DEPLOY, FEAT_DEPLOY, TRAIN_GRAPH],
                         ids=["depth", "odom", "feat", "train"])
def test_net_prototxt_equal_facts_overrides_and_report(text):
    tree_t, tree_j = tnp.parse_prototxt(text), jnp_.parse_prototxt(text)
    assert tree_t == tree_j
    ft, fj = tnp.extract_facts(tree_t), jnp_.extract_facts(tree_j)
    assert dataclasses.asdict(ft) == dataclasses.asdict(fj)
    assert tnp.config_overrides(ft) == jnp_.config_overrides(fj)
    assert tnp.format_report(ft, tnp.config_overrides(ft)[0]) == jnp_.format_report(
        fj, jnp_.config_overrides(fj)[0])


def test_solver_prototxt_gives_the_same_config():
    assert tsp.parse_solver_prototxt(REALISTIC) == jsp.parse_solver_prototxt(REALISTIC)
    cfg_t, extra_t = tsp.apply_solver_prototxt(REALISTIC, tconfigs.full_feat())
    cfg_j, extra_j = jsp.apply_solver_prototxt(REALISTIC, jconfigs.full_feat())
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    assert extra_t == extra_j and cfg_t.optim.iter_size == 2


def test_fold_input_transform_equal(trees):
    params, stats = trees
    kw = dict(conv_path="ConvBlock_0.Conv_0", mean=[104.0, 117.0, 123.0], scale=0.017,
              bn_path="ConvBlock_0.BatchNorm_0")
    p_t, s_t = timp.fold_input_transform(params["depth"], stats, **kw)
    p_j, s_j = jimp.fold_input_transform(params["depth"], stats, **kw)
    _assert_same_tree(p_t, p_j)
    _assert_same_tree(s_t, s_j)


def test_zoo_equal_but_for_the_cli_name():
    assert tzoo.ZOO == jzoo.ZOO
    assert (tzoo.PARITY_RTOL, tzoo.APPROX_RTOL, tzoo.INT8_EXTRA_RTOL) == (
        jzoo.PARITY_RTOL, jzoo.APPROX_RTOL, jzoo.INT8_EXTRA_RTOL)
    measured = dict(jzoo.ZOO["full_nyuv2"]["depth_metrics"], abs_rel=0.136, quant="int8",
                    split={"canonical": True, "pinned": True, "n_frames": 697})
    for kw in ({}, {"int8": True}, {"rtol": 0.001}):
        assert tzoo.check_parity(measured, **kw) == jzoo.check_parity(measured, **kw)
    odom = {"sequence": "09", "t_err_pct": 12.0, "r_err_deg_per_100m": 3.9}
    assert tzoo.check_odom_parity(odom) == jzoo.check_odom_parity(odom)
    for v in tzoo.ZOO:
        assert [c.replace(tzoo.CLI, "depthvo") for c in tzoo.import_commands(v)] == \
            jzoo.import_commands(v)


# --------------------------------------------------------------------------
# The CLI.
# --------------------------------------------------------------------------


def _export_ref(params, stats, path):
    jexp.export_caffemodel(params["depth"], batch_stats=stats, path=path)


def test_reference_caffemodel_imported_by_the_port(trees, tmp_path, capsys):
    """A file the reference's exporter wrote, through ``cli
    import-caffemodel``: the checkpoint's depth net is ``from_jax`` of the
    reference's tree, every tensor and the depth bit for bit."""
    params, stats = trees
    path = str(tmp_path / "depth.caffemodel")
    _export_ref(params, stats, path)
    ck = str(tmp_path / "ck")
    assert tcli.main(["import-caffemodel", "--variant", "tiny_test", "--caffemodel", path,
                      "--checkpoint-dir", ck]) == 0
    assert "placed" in capsys.readouterr().out
    got = DepthVO.from_checkpoint(ck, device="cpu")
    want = load_jax_params(tstate.build_models(tconfigs.tiny_test()), params, stats)
    sd_got, sd_want = got.models.depth.state_dict(), want.depth.state_dict()
    assert set(sd_got) == set(sd_want)
    for k in sd_want:
        assert torch.equal(sd_got[k], sd_want[k]), k
    x = np.random.default_rng(2).integers(0, 256, (2, 32, 96, 3), dtype=np.uint8)
    ref = DepthVO(got.config, want, CPU)
    np.testing.assert_array_equal(got.depth(x), ref.depth(x))


def test_cli_export_then_import_round_trip(tmp_path, capsys):
    """``export-caffemodel`` of a checkpoint, ``import-caffemodel`` of the
    file: the depth net bit for bit."""
    ck = str(tmp_path / "src")
    state = tstate.create_state(tconfigs.tiny_test(), CPU, torch.Generator().manual_seed(4))
    tcli._write_checkpoint(state, tconfigs.tiny_test(), ck)
    path = str(tmp_path / "d.caffemodel")
    assert tcli.main(["export-caffemodel", "--checkpoint-dir", ck, "--output", path]) == 0
    assert tcli.main(["export-caffemodel", "--checkpoint-dir", ck, "--output", path,
                      "--net", "odom"]) == 0
    dst = str(tmp_path / "dst")
    assert tcli.main(["import-caffemodel", "--variant", "tiny_test", "--net", "odom",
                      "--caffemodel", path, "--checkpoint-dir", dst]) == 0
    a = DepthVO.from_checkpoint(ck, device="cpu").models.odom.state_dict()
    b = DepthVO.from_checkpoint(dst, device="cpu").models.odom.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    capsys.readouterr()


def test_cli_make_name_map_and_net_info(trees, tmp_path, capsys):
    params, stats = trees
    path = str(tmp_path / "p.caffemodel")
    with open(path, "wb") as f:
        f.write(_permuted(jexp.export_caffemodel(params["depth"], stats)))
    out = {}
    for name, mod in (("t", tcli), ("j", jcli)):
        m = str(tmp_path / f"map_{name}.json")
        assert mod.main(["make-name-map", "--variant", "tiny_test", "--caffemodel", path,
                         "--output", m]) == 0
        out[name] = json.load(open(m))
    assert out["t"] == out["j"] and out["t"]["convs"]
    proto = tmp_path / "deploy.prototxt"
    proto.write_text(DEPTH_DEPLOY)
    capsys.readouterr()
    assert tcli.main(["net-info", str(proto), "--json", str(tmp_path / "f.json")]) == 0
    text_t = capsys.readouterr().out
    assert jcli.main(["net-info", str(proto)]) == 0
    assert text_t.split("wrote")[0] == capsys.readouterr().out
    bad = tmp_path / "bad.prototxt"
    bad.write_text('name: "x"')
    assert tcli.main(["net-info", str(bad)]) == 1


def test_cli_convert_end_to_end(trees, tmp_path, capsys):
    """solver + net prototxt + weights -> config.json, the name map and a
    checkpoint whose depth net is the reference's import of the same
    files; the config equals the reference's convert's."""
    params, stats = trees
    (tmp_path / "train.prototxt").write_text(TRAIN_GRAPH)
    (tmp_path / "solver.prototxt").write_text(REALISTIC.replace(
        "experiments/depth_odometry/train.prototxt", "train.prototxt"))
    path = str(tmp_path / "d.caffemodel")
    _export_ref(params, stats, path)
    common = ["convert", "--solver", str(tmp_path / "solver.prototxt"), "--weights", path,
              "--variant", "tiny_test", "--batch-size", "2"]
    assert tcli.main(common + ["--output-dir", str(tmp_path / "t")]) == 0
    assert "next steps" in capsys.readouterr().out
    cfg = json.load(open(tmp_path / "t" / "config.json"))
    assert json.load(open(tmp_path / "t" / "name_map_depth.json"))["convs"]
    got = DepthVO.from_checkpoint(str(tmp_path / "t" / "checkpoint"), device="cpu")
    assert got.config.optim.iter_size == 2 and cfg["name"] == "tiny"
    # The reference's convert of the same files gives the same config.
    jcfg = jsp.apply_solver_prototxt(REALISTIC, _ref_cfg(tmp_path))[0]
    assert dataclasses.asdict(got.config) == dataclasses.asdict(jcfg)


def _ref_cfg(tmp_path):
    """The config the reference's convert starts from for these files."""
    over = jnp_.config_overrides(jnp_.extract_facts(jnp_.parse_prototxt(TRAIN_GRAPH)))[0]
    cfg = jconfigs.tiny_test(batch_size=2)
    h, w = over.get("height") or cfg.model.height, over.get("width") or cfg.model.width
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, height=h, width=w))
    loss = {k: v for k, v in over.items() if k.endswith("_weight")}
    return dataclasses.replace(cfg, **loss)


def test_cli_zoo(tmp_path, capsys):
    assert tcli.main(["zoo"]) == 0
    assert "python -m depthvo_tpu_torch.cli import-caffemodel" in capsys.readouterr().out
    measured = dict(jzoo.ZOO["full_nyuv2"]["depth_metrics"],
                    split={"canonical": True, "pinned": True, "n_frames": 697})
    f = tmp_path / "m.json"
    f.write_text(json.dumps(measured))
    assert tcli.main(["zoo", "--check", str(f)]) == 0
    f.write_text(json.dumps(dict(measured, abs_rel=0.2)))
    assert tcli.main(["zoo", "--check", str(f)]) == 1
    with pytest.raises(ValueError, match="int8 gate requested"):
        tcli.main(["zoo", "--check", str(f), "--int8"])
    capsys.readouterr()


def test_train_weights_seat_the_file(trees, tmp_path, capsys):
    """``_state_with_caffe_weights`` (``train --weights``) on a permuted
    file: the audited name map seats it exactly; the other nets keep the
    fresh state's draw; a bare path means the depth net; an unknown net
    exits."""
    params, stats = trees
    path = str(tmp_path / "p.caffemodel")
    with open(path, "wb") as f:
        f.write(_permuted(jexp.export_caffemodel(params["depth"], stats)))
    cfg = tconfigs.tiny_test()
    st = tcli._state_with_caffe_weights(cfg, [f"depth={path}"], CPU)
    out = capsys.readouterr().out
    assert "audited name map" in out and "falling back" not in out
    got, got_stats = to_flax_layout(st.models)
    _assert_same_tree(got["depth"], params["depth"])
    _assert_same_tree(got_stats, stats)
    fresh = to_flax_layout(tstate.create_state(cfg, CPU).models)[0]
    _assert_same_tree(got["odom"], fresh["odom"])
    st = tcli._state_with_caffe_weights(cfg, [path], CPU)
    _assert_same_tree(to_flax_layout(st.models)[0]["depth"], params["depth"])
    with pytest.raises(SystemExit, match="not in variant"):
        tcli._state_with_caffe_weights(cfg, [f"pose={path}"], CPU)


def test_cli_train_solver_and_weights_fold_the_mean(tmp_path, capsys):
    """``train --solver`` (a net prototxt with transform_param) and
    ``--weights``: the mean folds into the seated input conv and two
    steps run, as the reference's test of the same command."""
    (tmp_path / "train.prototxt").write_text("""
        name: "stereo_train"
        layer {
          name: "data" type: "ImageData" top: "L" top: "R"
          transform_param { mean_value: 104.0 mean_value: 117.0
                            mean_value: 123.0 }
          image_data_param { source: "x.txt" batch_size: 2
                             new_height: 32 new_width: 96 }
        }
        layer { name: "conv1" type: "Convolution" bottom: "L" top: "c"
                convolution_param { num_output: 32 kernel_size: 7 } }
        layer { name: "stereo_loss" type: "L1Loss" bottom: "c"
                loss_weight: 1.0 }
    """)
    (tmp_path / "solver.prototxt").write_text('net: "train.prototxt"\nbase_lr: 0.001\n'
                                              'max_iter: 10\n')
    cfg = tconfigs.stereo(batch_size=2)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, height=32, width=96))
    src = to_flax_layout(tstate.create_state(cfg, CPU, torch.Generator().manual_seed(2))
                         .models)
    texp.export_caffemodel(src[0]["depth"], batch_stats=src[1],
                           path=str(tmp_path / "d.caffemodel"))
    rc = tcli.main(["train", "--solver", str(tmp_path / "solver.prototxt"), "--weights",
                    str(tmp_path / "d.caffemodel"), "--steps", "2", "--device", "cpu",
                    "--log-every", "1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "folding transform_param mean=[104.0, 117.0, 123.0]" in out
    assert "net: -> variant=stereo batch=2 size=32x96" in out
    assert "step 0:" in out and "loss/stereo" in out
    assert tcli.main(["train", "--weights", str(tmp_path / "d.caffemodel"), "--init-from",
                      str(tmp_path), "--device", "cpu", "--steps", "1"]) == 2
