"""The serving export of the port (``io/serving.py``, ``cli export-serving``)
and int8 inference through the CLI, on the CPU at ``tiny_test``'s size.

* The artifact (a ``torch.export`` program with its weights) against
  ``DepthVO.depth`` of the model it was exported from: <= 1e-5 relative
  for float32, the reference's int8 bar (rtol 2e-3 / atol 2e-3) for an
  int8 program; one symbolic-batch artifact at batches 1, 3 and 5.
* The served depth against the reference's served depth on the same
  weights (its ``jax.export`` artifact): <= 2e-5 relative, ROADMAP's bar
  for model outputs.
* The sidecar's contract, the dtype refusal (``TypeError``), the bad
  arguments (``ValueError``), a concrete batch with the disparity head,
  ``load`` refusing CUDA without a GPU.
* ``cli export-serving --int8-calib`` and ``cli infer --int8`` against the
  API calibrated on the same frames.
"""

import json
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from depthvo_tpu import api as japi, configs as jconfigs
from depthvo_tpu.io import serving as jserving
from depthvo_tpu_torch import DepthVO, cli as tcli, configs as tconfigs
from depthvo_tpu_torch.data.kitti import load_images_u8
from depthvo_tpu_torch.io import serving
from depthvo_tpu_torch.train import state as tstate
from test_torch_checkpoint import _to_flax

torch.set_num_threads(2)
torch.exp(torch.zeros(1))  # MKL's first call on one thread (test_torch_models.py)

RTOL = 1e-5
JAX_RTOL = 2e-5
INT8_RTOL = INT8_ATOL = 2e-3


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, deleted at teardown (each artifact holds the
    weights, ~45 MB)."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def tiny_model():
    return DepthVO.from_random(tconfigs.tiny_test(), seed=0, device="cpu")


@pytest.fixture(scope="module")
def artifact(tiny_model, tmp_path_factory):
    d = tmp_path_factory.mktemp("serving")
    path = str(d / "tiny.depthvo.pt2")
    sidecar = serving.export_depth(tiny_model, path)
    yield path, sidecar
    shutil.rmtree(d, ignore_errors=True)


def _frames(seed, b):
    return np.random.default_rng(seed).integers(0, 255, (b, 32, 96, 3), dtype=np.uint8)


def test_sidecar_contract(artifact):
    path, sidecar = artifact
    assert sidecar["input"]["dtype"] == "uint8"
    assert sidecar["input"]["shape"] == ["b", 32, 96, 3]  # symbolic batch
    assert set(sidecar["platforms"]) == {"cpu", "cuda"}
    assert sidecar["checked_on"] == ["cpu"]  # no GPU here
    assert sidecar["output"] == "depth" and sidecar["int8"] is False
    assert sidecar["format"].startswith("torch.export")
    with open(path + ".json") as f:
        assert json.load(f) == sidecar
    assert 0 < sidecar["artifact_bytes"] < 80e6


def test_roundtrip_matches_api_depth(artifact, tiny_model):
    path, _ = artifact
    served = serving.load(path, device="cpu")
    img = _frames(0, 2)
    np.testing.assert_allclose(served(img), tiny_model.depth(img), rtol=RTOL)


def test_symbolic_batch_serves_any_size(artifact, tiny_model):
    path, _ = artifact
    served = serving.load(path, device="cpu")
    for b in (1, 3, 5):
        img = _frames(b, b)
        out = served(img)
        assert out.shape == (b, 32, 96)
        assert np.isfinite(out).all() and (out > 0).all()
        np.testing.assert_allclose(out, tiny_model.depth(img), rtol=RTOL)


def test_served_depth_matches_the_references_artifact(artifact, tiny_model, tmp_path):
    """The reference's artifact of the same weights serves the same depth."""
    params, stats = _to_flax(tiny_model.models)
    jpath = str(tmp_path / "ref.depthvo.bin")
    jserving.export_depth(japi.DepthVO(jconfigs.tiny_test(), params, stats), jpath,
                          platforms=("cpu",))
    img = _frames(7, 3)
    want = jserving.load(jpath)(img)
    got = serving.load(artifact[0], device="cpu")(img)
    np.testing.assert_allclose(got, want, rtol=JAX_RTOL)


def test_wrong_dtype_rejected(artifact):
    served = serving.load(artifact[0], device="cpu")
    with pytest.raises(TypeError, match="expects uint8"):
        served(np.zeros((1, 32, 96, 3), np.float32))


def test_load_needs_a_gpu_unless_cpu_is_asked_for(artifact, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.load(artifact[0])


def test_concrete_batch_and_disparity_head(tiny_model, tmp_path):
    path = str(tmp_path / "b2.pt2")
    sidecar = serving.export_depth(tiny_model, path, batch=2, output="disparity",
                                   input_dtype="float32")
    assert sidecar["input"]["shape"][0] == 2 and sidecar["input"]["range"] == "[-1, 1]"
    x = np.random.default_rng(3).uniform(-1, 1, (2, 32, 96, 3)).astype(np.float32)
    disp = serving.load(path, device="cpu")(x)
    np.testing.assert_allclose(disp, tiny_model.inverse_depth(x), rtol=RTOL)


def test_bad_args_rejected(tiny_model, tmp_path):
    with pytest.raises(ValueError, match="input_dtype"):
        serving.export_depth(tiny_model, str(tmp_path / "x"), input_dtype="int8")
    with pytest.raises(ValueError, match="output"):
        serving.export_depth(tiny_model, str(tmp_path / "x"), output="rgb")
    with pytest.raises(ValueError, match="platforms"):
        serving.export_depth(tiny_model, str(tmp_path / "x"), platforms=("cpu", "tpu"))


@pytest.fixture
def image_dir(tmp_path):
    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.default_rng(9)
    for i in range(5):
        Image.fromarray(rng.integers(0, 255, (40, 128, 3), dtype=np.uint8)).save(
            d / f"f{i:03d}.png")
    return d


def _calibrated(frames):
    return DepthVO.from_random(tconfigs.tiny_test(batch_size=2), device="cpu").calibrate_int8(
        frames)


def test_cli_export_serving_int8(image_dir, tmp_path, capsys):
    """``--int8-calib``: calibrated on every frame of the directory, the
    w8a8 program exported; it serves the int8 depth of the API calibrated
    on the same frames (and not the float depth)."""
    out = str(tmp_path / "int8.pt2")
    assert tcli.main(["export-serving", "--variant", "tiny_test", "--device", "cpu",
                      "--output", out, "--int8-calib", str(image_dir)]) == 0
    text = capsys.readouterr().out
    assert "int8: calibrated on 5 frames" in text
    sidecar = json.loads(text[text.index("{"):text.rindex("}") + 1])
    assert sidecar["int8"] is True and sidecar["input"]["shape"][0] == "b"
    frames = load_images_u8(sorted(str(p) for p in image_dir.glob("*.png")), 32, 96)
    model = _calibrated(frames)
    served = serving.load(out, device="cpu")
    np.testing.assert_allclose(served(frames), model.depth(frames),
                               rtol=INT8_RTOL, atol=INT8_ATOL)
    assert not np.allclose(served(frames), model.uncalibrate().depth(frames), rtol=1e-4)
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tcli.main(["export-serving", "--variant", "tiny_test", "--device", "cpu",
                      "--output", out, "--int8-calib", str(empty)]) == 2


def test_cli_infer_int8(image_dir, tmp_path, capsys):
    """``infer --int8`` calibrates on its inputs and writes their int8 depth."""
    out = tmp_path / "depths"
    assert tcli.main(["infer", "--variant", "tiny_test", "--device", "cpu", "--images",
                      str(image_dir), "--output-dir", str(out), "--batch-size", "2",
                      "--int8"]) == 0
    assert "int8: calibrated" in capsys.readouterr().out
    paths = sorted(image_dir.glob("*.png"))
    frames = load_images_u8([str(p) for p in paths], 32, 96)
    model = _calibrated(frames)
    want = np.concatenate([model.depth(frames[i:i + 2]) for i in range(0, 5, 2)])
    got = np.stack([np.load(out / f"{p.stem}_depth.npy") for p in paths])
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_state_dict_is_the_same_after_int8(tiny_model):
    """Calibration adds no key to any state dict (the scales are
    non-persistent buffers), so checkpoints are unchanged."""
    m = DepthVO.from_random(tconfigs.tiny_test(), seed=0, device="cpu")
    keys = set(m.models.depth.state_dict())
    m.calibrate_int8(_frames(1, 2))
    assert set(m.models.depth.state_dict()) == keys
    assert set(tstate.build_models(m.config).depth.state_dict()) == keys
