"""The port's KITTI readers, native decode ring, sample lists, prefetching
pipeline and the training CLI on KITTI-format data, held against the JAX
package on the same trees.

Trees are built as tests/test_kitti_data.py builds them (PIL-written
random PNGs in the standard KITTI layouts), with the calibration lines a
real tree has (``P_rect_03``, ``S_rect_02``) on one drive and without
them on another. Both packages must give equal sample lists, intrinsics,
baselines and uint8 batches, on the PIL path and on the native path (the
same C++ source; the reference is pointed at the library the port
builds). Everything compared here is exact.
"""

import glob
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from depthvo_tpu import cli as jcli
from depthvo_tpu.data import kitti as jkitti, native_loader as jnative
from depthvo_tpu.data.eigen import EIGEN_TEST_SCENES as J_EIGEN
from depthvo_tpu_torch import cli as tcli
from depthvo_tpu_torch.data import kitti as tkitti, native_loader as tnative
from depthvo_tpu_torch.data.eigen import EIGEN_TEST_SCENES as T_EIGEN
from depthvo_tpu_torch.data.pipeline import batch_iterator, prefetch_to_device
from depthvo_tpu_torch.io import checkpoint as ckpt
from depthvo_tpu_torch.utils import spans

torch.set_num_threads(2)
torch.exp(torch.zeros(1))  # MKL's first call on one thread (test_torch_models.py)

DATE = "2011_09_26"
DRIVES = (f"{DATE}_drive_0001_sync", "2011_09_28_drive_0005_sync")
P2 = "7.2e+02 0.0 6.0e+02 4.5e+01 0.0 7.2e+02 1.8e+02 -3.0e-01 0.0 0.0 1.0 4.9e-03"
P3 = "7.2e+02 0.0 6.0e+02 -3.4e+02 0.0 7.2e+02 1.8e+02 2.2e+00 0.0 0.0 1.0 2.7e-03"


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, deleted at teardown: the checkpoints written
    here are about 150 MB each, and pytest keeps its last three runs."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _write_png(path, h=40, w=128, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)).save(path)


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    """Drive 0001 (5 frames at 128x40): a calibration with P_rect_03 and
    S_rect_02, as a real tree has. Drive 0005 of another date (5 frames at
    120x36): P_rect_02 alone, so the size comes from the PNG header and
    the baseline is the nominal one."""
    root = str(tmp_path_factory.mktemp("kitti_raw"))
    for d, (drive, (h, w)) in enumerate(zip(DRIVES, ((40, 128), (36, 120)))):
        for cam in ("image_02", "image_03"):
            for i in range(5):
                _write_png(os.path.join(root, drive[:10], drive, cam, "data", f"{i:010d}.png"),
                           h, w, seed=100 * d + 10 * (cam == "image_03") + i)
        with open(os.path.join(root, drive[:10], "calib_cam_to_cam.txt"), "w") as f:
            f.write("calib_time: 09-Jan-2012 13:57:47\n")
            f.write(f"P_rect_02: {P2}\n")
            if d == 0:
                f.write(f"S_rect_02: 1.280000e+02 4.000000e+01\nP_rect_03: {P3}\n")
    yield root
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def odom_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_odom"))
    seq, n = "09", 6
    for i in range(n):
        for cam in ("image_2", "image_3"):
            _write_png(os.path.join(root, "sequences", seq, cam, f"{i:06d}.png"),
                       seed=(100 if cam == "image_2" else 500) + i)
    with open(os.path.join(root, "sequences", seq, "calib.txt"), "w") as f:
        f.write("P0: 7.1e+02 0.0 6.0e+02 0.0 0.0 7.1e+02 1.8e+02 0.0 0.0 0.0 1.0 0.0\n")
        f.write("P2: 7.2e+02 0.0 6.1e+02 4.4e+01 0.0 7.3e+02 1.9e+02 0.0 0.0 0.0 1.0 0.0\n")
        f.write("P3: 7.2e+02 0.0 6.1e+02 -3.4e+02 0.0 7.3e+02 1.9e+02 0.0 0.0 0.0 1.0 0.0\n")
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    with open(os.path.join(root, "poses", seq + ".txt"), "w") as f:
        for i in range(n):
            T = np.eye(4)[:3, :4].copy()
            T[2, 3] = 0.8 * i
            f.write(" ".join(str(x) for x in T.reshape(-1)) + "\n")
    yield root, seq
    shutil.rmtree(root, ignore_errors=True)


def _use_native(monkeypatch):
    """Both packages on the native library that the port builds (the
    reference loads the same file: the port's copy of the reference's
    source, whose decode and resize it leaves as they are)."""
    monkeypatch.setenv("DEPTHVO_NATIVE_LIB", str(tnative.build()))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jkitti, "_NATIVE", None)
    monkeypatch.setattr(tkitti, "_NATIVE", None)


@pytest.fixture(params=["pil", "native"])
def decoder(request, monkeypatch):
    """Both packages on one decode path: PIL, or the native library."""
    if request.param == "pil":
        monkeypatch.setattr(jkitti, "_NATIVE", False)
        monkeypatch.setattr(tkitti, "_NATIVE", False)
    else:
        _use_native(monkeypatch)
    return request.param


def _datasets(kind, raw_tree, odom_tree, u8=True):
    if kind == "raw":
        return [m.KittiRawStereo(raw_tree, list(DRIVES) + ["missing_drive_sync"],
                                 height=16, width=48, u8=u8) for m in (jkitti, tkitti)]
    root, seq = odom_tree
    return [m.KittiOdomStereo(root, [seq, "42"], height=16, width=48, u8=u8)
            for m in (jkitti, tkitti)]


def _same_samples(a, b):
    assert len(a.samples) == len(b.samples) > 0
    for sa, sb in zip(a.samples, b.samples):
        assert sa[:3] == sb[:3]
        np.testing.assert_array_equal(sa[3], sb[3])
        assert sa[4] == sb[4]


def _same_batch(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kind", ["raw", "odom"])
def test_both_packages_read_the_same_samples(raw_tree, odom_tree, kind):
    jds, tds = _datasets(kind, raw_tree, odom_tree)
    _same_samples(jds, tds)
    if kind == "raw":
        # The per-drive baseline from P_rect_02/03 and each drive's own size.
        assert tds.samples[0][4] == pytest.approx((45.0 + 340.0) / 720.0)
        assert tds.samples[-1][4] == 0.54
        assert tds.samples[0][3][0, 0] == pytest.approx(720.0 * 48 / 128)
        assert tds.samples[-1][3][0, 0] == pytest.approx(720.0 * 48 / 120)


@pytest.mark.parametrize("kind", ["raw", "odom"])
def test_both_packages_give_the_same_uint8_batches(raw_tree, odom_tree, kind, decoder):
    jds, tds = _datasets(kind, raw_tree, odom_tree)
    for i in (0, len(tds) - 1):
        _same_batch(jds.get(i), tds.get(i))
    jit = jds.iterator(2, seed=3, native_ring=decoder == "native")
    tit = tds.iterator(2, seed=3, native_ring=decoder == "native")
    for _ in range(3):
        b = next(tit)
        assert b["image_t"].dtype == np.uint8 and b["image_t"].shape == (2, 16, 48, 3)
        _same_batch(next(jit), b)
    jit.close()
    tit.close()


def test_native_ring_batches_equal_the_thread_pool_samples(raw_tree, monkeypatch):
    _use_native(monkeypatch)
    _, tds = _datasets("raw", raw_tree, None)
    truth = {tds.get(i)["image_t"].tobytes(): tds.get(i) for i in range(len(tds))}
    ring = tds.iterator(3, seed=1, native_ring=True)
    for _ in range(4):  # 8 samples in batches of 3: wraps around
        b = next(ring)
        for j in range(3):
            s = truth[b["image_t"][j].tobytes()]
            for k in ("image_r", "image_s", "K", "baseline"):
                np.testing.assert_array_equal(b[k][j], s[k], err_msg=k)
    ring.close()


def test_native_ring_adds_its_counters_to_the_spans(raw_tree, monkeypatch):
    _use_native(monkeypatch)
    _, tds = _datasets("raw", raw_tree, None)
    spans.reset()
    spans.enable()
    try:
        ring = tds.iterator(3, seed=1, native_ring=True)
        for _ in range(4):
            next(ring)
        ring.close()
        counters = spans.take()["counters"]
    finally:
        spans.enable(False)
        spans.reset()
    assert set(counters) == {"ring." + name for name in tnative.STATS_FIELDS}
    assert counters["ring.batches"] == 4 and counters["ring.images"] >= 4 * 9
    assert counters["ring.decode_ns"] > 0 and counters["ring.resize_ns"] > 0
    assert 0 < counters["ring.work_cpu_ns"] <= counters["ring.decode_ns"] + counters[
        "ring.resize_ns"]
    assert 0 < counters["ring.inflate_ns"] <= counters["ring.decode_ns"]


def test_native_ring_stats_in_field_order_until_closed(raw_tree):
    paths = sorted(glob.glob(os.path.join(raw_tree, DRIVES[0][:10], DRIVES[0], "image_02",
                                          "data", "*.png")))
    loader = tnative.NativeBatchLoader(paths, batch_size=2, height=16, width=48,
                                       num_threads=2, shuffle=False)
    try:
        for _ in range(3):
            loader.next()
        stats = loader.stats()
    finally:
        loader.close()
    assert tuple(stats) == tnative.STATS_FIELDS
    assert stats["batches"] == 3 and stats["images"] >= 3 * 2
    assert stats["consumer_wait_ns"] >= 0
    assert 0 < stats["inflate_ns"] <= stats["decode_ns"]
    with pytest.raises(ValueError, match="closed"):
        loader.stats()


def test_native_decode_and_header_size(raw_tree):
    path = os.path.join(raw_tree, DRIVES[1][:10], DRIVES[1], "image_02", "data", "0000000000.png")
    with Image.open(path) as im:
        assert tkitti._image_size(path) == im.size == (120, 36)
        np.testing.assert_array_equal(tnative.decode_png(path), np.asarray(im))
    np.testing.assert_array_equal(tnative.load_resized(path, 16, 48),
                                  jnative.load_resized(path, 16, 48))
    lib = tnative.library_path()
    assert lib.parent.name == "build" and lib.parent.parent.name == "data"


def test_odometry_sequence_matches(odom_tree, decoder):
    root, seq = odom_tree
    j, t = (m.KittiOdometrySequence(root, seq, height=16, width=48) for m in (jkitti, tkitti))
    np.testing.assert_array_equal(j.K, t.K)
    np.testing.assert_array_equal(j.gt_poses, t.gt_poses)
    np.testing.assert_array_equal(j.frames_u8(2), t.frames_u8(2))
    for a, b in zip(j.pair_iterator(4), t.pair_iterator(4)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# Sample lists and prep.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["raw", "odom"])
def test_train_lists_cross_packages(raw_tree, odom_tree, tmp_path, kind):
    """Each package writes the list the other's writes, and reads it as
    the other does (v2 with the baseline column, and v1 without)."""
    root = raw_tree if kind == "raw" else odom_tree[0]
    jds, tds = _datasets(kind, raw_tree, odom_tree, u8=False)
    paths = [str(tmp_path / f"{who}.txt") for who in ("ref", "port")]
    assert jkitti.write_train_list(jds, paths[0], root) == len(jds)
    assert tkitti.write_train_list(tds, paths[1], root) == len(tds)
    texts = [open(p).read() for p in paths]
    assert texts[0] == texts[1]
    v1 = str(tmp_path / "v1.txt")
    with open(v1, "w") as f:
        f.writelines(" ".join(ln.split()[:7]) + "\n" for ln in texts[0].splitlines())
    for path in (*paths, v1):
        back = tkitti.load_train_list(root, path, height=16, width=48)
        _same_samples(jkitti.load_train_list(root, path, height=16, width=48), back)
        for sa, sb in zip(tds.samples, back.samples):
            assert sa[:3] == sb[:3]
            np.testing.assert_allclose(sa[3], sb[3], rtol=1e-6)
            assert sb[4] == (0.54 if path == v1 else pytest.approx(sa[4], rel=1e-6))


@pytest.mark.parametrize("case", ["raw", "odom", "eigen-train"])
def test_prep_writes_the_reference_list(raw_tree, odom_tree, tmp_path, case):
    if case == "odom":
        args = ["prep", "--odom-root", odom_tree[0], "--sequences", odom_tree[1]]
    elif case == "raw":
        args = ["prep", "--kitti-root", raw_tree, "--drives", ",".join(DRIVES)]
    else:
        assert T_EIGEN == J_EIGEN
        root = str(tmp_path / "raw")
        drives = (f"{DATE}_drive_0001_sync", f"{DATE}_drive_0002_sync")  # 0002: a test scene
        for drive in drives:
            for cam in ("image_02", "image_03"):
                for i in range(3):
                    _write_png(os.path.join(root, DATE, drive, cam, "data", f"{i:010d}.png"),
                               seed=i)
        with open(os.path.join(root, DATE, "calib_cam_to_cam.txt"), "w") as f:
            f.write(f"P_rect_02: {P2}\n")
        args = ["prep", "--kitti-root", root, "--eigen-train"]
    args += ["--height", "16", "--width", "48"]
    outs = [str(tmp_path / f"{who}.txt") for who in ("ref", "port")]
    assert jcli.main(args + ["--output", outs[0]]) == 0
    assert tcli.main(args + ["--output", outs[1]]) == 0
    ref, port = (open(p).read() for p in outs)
    assert port == ref and port
    if case == "eigen-train":
        assert "drive_0001" in port and "drive_0002" not in port


# --------------------------------------------------------------------------
# The prefetching pipeline on the CPU.
# --------------------------------------------------------------------------


def test_prefetch_yields_tensors_in_order():
    batches = [{"x": np.full((2, 3), i, np.uint8), "K": np.eye(3, dtype=np.float32)}
               for i in range(5)]
    out = list(prefetch_to_device(iter(batches), "cpu", buffer_size=2))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert b["x"].dtype == torch.uint8 and b["x"].device.type == "cpu"
        assert torch.equal(b["x"], torch.full((2, 3), i, dtype=torch.uint8))
    it = batch_iterator(lambda: {"x": np.zeros(1)})
    assert next(it)["x"].shape == (1,)


def test_prefetch_propagates_producer_errors():
    def bad_iter():
        yield {"x": np.ones((2, 2), np.float32)}
        raise RuntimeError("corrupt PNG")

    it = prefetch_to_device(bad_iter(), "cpu")
    next(it)
    with pytest.raises(RuntimeError, match="producer thread failed") as e:
        next(it)
    assert "corrupt PNG" in str(e.value.__cause__)


def test_prefetch_consumer_abandon_stops_producer():
    produced = []

    def slow_iter():
        for i in range(1000):
            produced.append(i)
            yield {"x": np.full((1,), i, np.float32)}

    before = threading.active_count()
    it = prefetch_to_device(slow_iter(), "cpu", buffer_size=1)
    next(it)
    it.close()  # abandon
    time.sleep(1.5)
    assert threading.active_count() <= before + 1
    assert len(produced) < 10


# --------------------------------------------------------------------------
# The training CLI on a KITTI tree, with checkpoints, then `test`.
# --------------------------------------------------------------------------


def test_cli_train_on_kitti_then_test_from_the_checkpoint(raw_tree, tmp_path, capsys):
    ck = str(tmp_path / "ck")
    jsonl = str(tmp_path / "log.jsonl")
    argv = ["train", "--variant", "tiny_test", "--device", "cpu", "--kitti-root", raw_tree,
            "--drives", ",".join(DRIVES), "--native-ring", "1", "--batch-size", "2",
            "--checkpoint-dir", ck, "--log-every", "1", "--log-jsonl", jsonl]
    assert tcli.main(argv + ["--steps", "2"]) == 0
    assert tcli.main(argv + ["--steps", "3"]) == 0  # resumes at 2
    out = capsys.readouterr().out
    steps = [int(ln.split(":")[0].split()[1]) for ln in out.splitlines() if ln.startswith("step ")]
    assert steps == [0, 1, 2] and "KITTI raw: 8 training samples" in out
    assert ckpt.make_manager(ck).all_steps() == [2, 3]
    assert os.path.isfile(os.path.join(ck, "config.json"))
    assert [__import__("json").loads(ln)["step"] for ln in open(jsonl)] == [0, 1, 2]
    assert tcli.main(["test", "--checkpoint-dir", ck, "--device", "cpu",
                      "--iterations", "2"]) == 0
    text = capsys.readouterr().out
    metrics = __import__("json").loads(text[text.index("{"):])
    assert "val/loss/total" in metrics and all(np.isfinite(list(metrics.values())))
