"""KITTI raw + odometry dataset readers (the port's own copy of
``depthvo_tpu/data/kitti.py``, numpy only; the same trees give the same
samples, intrinsics, baselines and uint8 batches in both packages).

Walk KITTI raw drives (Eigen split) and odometry sequences, resize
frames to 608x160, scale the intrinsics, and produce stereo/temporal
training triples. Decoding runs on host threads: the native C++ runtime
(``data/native_loader.py``) when it builds, PIL otherwise; PIL is
optional. Batches go to the device through
``data.pipeline.prefetch_to_device``.

Directory layouts expected (standard KITTI):

raw:      <root>/<date>/<date>_drive_<id>_sync/image_02/data/*.png  (left)
                                               image_03/data/*.png  (right)
          <root>/<date>/calib_cam_to_cam.txt
odometry: <root>/sequences/<seq>/image_2/*.png (left), image_3 (right)
          <root>/sequences/<seq>/calib.txt
          <root>/poses/<seq>.txt (ground truth, eval only)

Images are normalized to [-1, 1] float32 NHWC, or kept as raw uint8
(``u8=True``) for the train step, which normalizes them on the device.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from depthvo_tpu_torch.data import native_loader
from depthvo_tpu_torch.utils import spans


def _pil():
    """PIL's ``Image``, imported at first use: it is optional (the native
    runtime decodes PNGs without it), and the eval modules that import
    this one must not pull it in."""
    try:
        from PIL import Image
    except ImportError:  # pragma: no cover
        raise RuntimeError("PIL not available for image decoding") from None
    return Image


_NATIVE = None  # tri-state: None = unprobed, False = unavailable


def _native():
    """The C++ decode/resize runtime (data/csrc/dataloader.cpp), if buildable."""
    global _NATIVE
    if _NATIVE is None:
        _NATIVE = native_loader if native_loader.available() else False
    return _NATIVE


def load_image(path: str, height: int, width: int) -> np.ndarray:
    """Decode + bilinear-resize to (height, width), scale to [-1, 1].

    Uses the native C++ runtime (PNG decode + PIL-compatible triangle
    resize) when available; PIL otherwise. The two paths are golden-
    tested against each other (tests/test_native_loader.py of the JAX
    package).
    """
    native = _native()
    if native and path.lower().endswith(".png"):
        try:
            return native.load_resized(path, height, width)
        except ValueError:
            pass  # non-8-bit/interlaced PNG: fall through to PIL
    Image = _pil()
    with Image.open(path) as im:
        im = im.convert("RGB").resize((width, height), Image.BILINEAR)
        arr = np.asarray(im, np.float32)
    return arr / 127.5 - 1.0


def load_image_u8(path: str, height: int, width: int) -> np.ndarray:
    """Decode + bilinear-resize to (height, width), kept as uint8.

    Shipping uint8 to the device and normalizing there (train/loop.py)
    moves 4x fewer bytes over the host->device link. Fidelity vs
    ``load_image``: on the PIL path the resize output IS uint8, so the
    two routes are value-identical; the native runtime resizes in float,
    so rounding back to uint8 quantizes by at most half a grid step
    (1/255 in [-1, 1] units) — the same uint8-grid the reference's
    cv2/Caffe pipeline lived on.
    """
    native = _native()
    if native and path.lower().endswith(".png"):
        try:
            # Native u8 output: rounds the float resample to the uint8
            # grid in C++ (round-half-up like PIL; np.round's half-even
            # can differ by one step on exact halves).
            return native.load_resized_u8(path, height, width)
        except ValueError:
            pass
    Image = _pil()
    with Image.open(path) as im:
        return np.asarray(
            im.convert("RGB").resize((width, height), Image.BILINEAR), np.uint8
        )


def load_images_u8(paths: Sequence[str], height: int, width: int,
                   num_workers: int = 8) -> np.ndarray:
    """``load_image_u8`` of every path, stacked to (N, height, width, 3):
    decoded on a thread pool (the native decoder and Pillow release the
    interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(num_workers) as ex:
        return np.stack(list(ex.map(lambda p: load_image_u8(p, height, width), paths)))


def _image_size(path: str) -> Tuple[int, int]:
    """(width, height) of a PNG from its IHDR chunk, so no decoder is
    needed and no pixel is decoded. KITTI native resolutions vary by
    date/sequence (1242x375, 1238x374, 1226x370, 1241x376, ...);
    hardcoding one corrupts the scaled intrinsics by ~1% for the others."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        with _pil().open(path) as im:
            return im.size
    return struct.unpack(">II", head[16:24])


def _scaled_K(K_full: np.ndarray, orig_wh: Tuple[int, int], out_wh: Tuple[int, int]) -> np.ndarray:
    """Rescale intrinsics for the resize to ``out_wh``.

    Same half-pixel-center correction as ``geometry.camera
    .scale_intrinsics`` (the loaders resize with PIL, half-pixel
    convention; the geometry core puts pixel centers at integers):
    ``cx' = sx*(cx+0.5)-0.5``, i.e. row-scale plus ``(s-1)/2``."""
    sx = out_wh[0] / orig_wh[0]
    sy = out_wh[1] / orig_wh[1]
    K = K_full.copy()
    K[0, :] *= sx
    K[1, :] *= sy
    K[0, 2] += (sx - 1.0) / 2.0
    K[1, 2] += (sy - 1.0) / 2.0
    return K


def read_raw_calib(calib_path: str) -> Dict[str, np.ndarray]:
    """Parse KITTI raw calib_cam_to_cam.txt into {key: array}."""
    out: Dict[str, np.ndarray] = {}
    with open(calib_path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, val = line.split(":", 1)
            try:
                out[key.strip()] = np.array(
                    [float(x) for x in val.split()], np.float32
                )
            except ValueError:
                continue
    return out


def _read_odometry_P(calib_path: str, keys: Sequence[str]) -> Dict[str, np.ndarray]:
    mats: Dict[str, np.ndarray] = {}
    with open(calib_path) as f:
        for line in f:
            key = line.split(":", 1)[0].strip()
            if key in keys:
                vals = np.array([float(x) for x in line.split()[1:]], np.float32)
                mats[key] = vals.reshape(3, 4)
    return mats


def read_odometry_calib(calib_path: str) -> np.ndarray:
    """Parse KITTI odometry calib.txt -> left-cam intrinsics K (3,3).

    Prefers P2 (left color camera, the one image_2 frames come from);
    falls back to P0 (left gray) for sequences without color calib.
    """
    mats = _read_odometry_P(calib_path, ("P0", "P2"))
    for key in ("P2", "P0"):
        if key in mats:
            return mats[key][:, :3].copy()
    raise ValueError(f"no projection matrix found in {calib_path}")


def read_odometry_projections(calib_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(P2, P3) full 3x4 rectified projections (left/right color cams) —
    P3's x-offset encodes the stereo baseline used for training."""
    mats = _read_odometry_P(calib_path, ("P2", "P3"))
    if "P2" not in mats or "P3" not in mats:
        raise ValueError(f"need P2 and P3 in {calib_path} for stereo training")
    return mats["P2"], mats["P3"]


# The stream of ManyDepth's per-row draws: the iterator's seed xor this.
AUG_SEED = 0x6D66


class KittiRawStereo:
    """Stereo + temporal triples from KITTI raw drives (training data).

    Produces batches matching the train-loop contract: image_t (left, t),
    image_r (right, t), image_s (left, t+1), K, baseline. With ``prev``
    (Monodepth2's and ManyDepth's frames) also image_p (left, t-1), and a
    frame is a sample only where its drive has both t-1 and t+1. With
    ``aug_draws`` (ManyDepth's) each batch also carries aug_u, one float
    in [0, 1) a row, from a stream of the iterator's seed.
    """

    aug_draws = False  # the readers that share the iterator draw none

    def __init__(
        self,
        root: str,
        drives: Sequence[str],
        height: int = 160,
        width: int = 608,
        orig_size: Tuple[int, int] | None = None,
        u8: bool = False,
        prev: bool = False,
        aug_draws: bool = False,
    ):
        self.root = root
        self.aug_draws = aug_draws
        self.height, self.width = height, width
        # u8=True: batches carry raw uint8 frames (4x fewer host->device
        # bytes; the train step normalizes on-device — train/loop.py).
        self.u8 = u8
        self.samples: List[Tuple[str, str, str, np.ndarray, float]] = []
        # Per sample, the path of frame t-1 (with ``prev``), else None.
        self.prev: List[str] | None = [] if prev else None
        for drive in drives:
            date = drive.split("_drive_")[0]
            ddir = os.path.join(root, date, drive)
            left_dir = os.path.join(ddir, "image_02", "data")
            right_dir = os.path.join(ddir, "image_03", "data")
            # BOTH cameras must exist: image_03 ships as a separate KITTI
            # archive, and silently building samples against a missing
            # right camera would crash mid-training at first touch.
            if not os.path.isdir(left_dir) or not os.path.isdir(right_dir):
                continue
            calib = read_raw_calib(os.path.join(root, date, "calib_cam_to_cam.txt"))
            P = calib["P_rect_02"].reshape(3, 4)
            # Per-drive stereo baseline from the rectified projections:
            # P[0,3] = -fx * t_x relative to cam0, so the cam2->cam3
            # baseline is (P2[0,3] - P3[0,3]) / fx. Real KITTI rigs vary
            # ~0.53-0.54 m per campaign; falling back to the nominal
            # 0.54 m only when the calib lacks P_rect_03.
            if "P_rect_03" in calib and calib["P_rect_03"].size == 12:
                P3 = calib["P_rect_03"].reshape(3, 4)
                baseline = float((P[0, 3] - P3[0, 3]) / P[0, 0])
            else:
                baseline = 0.54
            frames = sorted(os.listdir(left_dir))
            # Per-drive native resolution: calib's rectified size if
            # recorded, else the first frame's header (varies by date).
            if orig_size is not None:
                drive_size = orig_size
            elif "S_rect_02" in calib and calib["S_rect_02"].size == 2:
                drive_size = (int(calib["S_rect_02"][0]), int(calib["S_rect_02"][1]))
            elif frames:
                drive_size = _image_size(os.path.join(left_dir, frames[0]))
            else:
                continue
            K = _scaled_K(P[:, :3], drive_size, (width, height))
            for k, (a, b) in enumerate(zip(frames[:-1], frames[1:])):
                if self.prev is not None:
                    if k == 0:
                        continue  # frame t-1 missing
                    self.prev.append(os.path.join(left_dir, frames[k - 1]))
                self.samples.append(
                    (
                        os.path.join(left_dir, a),
                        os.path.join(right_dir, a),
                        os.path.join(left_dir, b),
                        K,
                        baseline,
                    )
                )

    def __len__(self) -> int:
        return len(self.samples)

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        lt, rt, ls, K, baseline = self.samples[idx]
        h, w = self.height, self.width
        load = load_image_u8 if self.u8 else load_image
        out = {
            "image_t": load(lt, h, w),
            "image_r": load(rt, h, w),
            "image_s": load(ls, h, w),
            "K": K,
            "baseline": np.float32(baseline),
        }
        if self.prev is not None:
            out["image_p"] = load(self.prev[idx], h, w)
        return out

    def iterator(
        self,
        batch_size: int,
        seed: int = 0,
        shuffle: bool = True,
        num_workers: int = 4,
        native_ring: bool | None = None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite epoch-shuffled batch iterator (:meth:`_iterator`), with
        ``aug_draws`` each batch's ``aug_u``."""
        batches = self._iterator(batch_size, seed, shuffle, num_workers, native_ring)
        if not self.aug_draws:
            yield from batches
            return
        draws = np.random.default_rng(seed ^ AUG_SEED)
        for batch in batches:
            batch["aug_u"] = draws.random(batch_size, dtype=np.float32)
            yield batch

    def _iterator(
        self,
        batch_size: int,
        seed: int = 0,
        shuffle: bool = True,
        num_workers: int = 4,
        native_ring: bool | None = None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite epoch-shuffled batch iterator.

        Two host pipelines (both mirror Caffe's multi-threaded
        data_transformer, SURVEY.md §2b(ii)):

        * ``native_ring=True`` — the C++ prefetch ring
          (data/csrc/dataloader.cpp): decode+resize AND batch assembly run
          on C++ threads; Python only copies ready buffers. Composes with ``u8``
          batches — C++ decode plus the 4x smaller uplink is the
          production configuration.
        * default — a Python ThreadPoolExecutor calling ``self.get``
          (native per-image decode when available, PIL otherwise).

        ``native_ring=None`` picks the ring when the native library
        builds and all samples are PNGs; ``native_ring=True`` builds it
        or raises.
        """
        if len(self.samples) < batch_size:
            # A too-small dataset (typo'd root, missing drives) would
            # otherwise spin forever reshuffling and yielding nothing.
            raise ValueError(
                f"dataset has {len(self.samples)} samples < batch_size "
                f"{batch_size} — check the data root / drive list"
            )
        if native_ring is None:
            native_ring = bool(_native()) and all(
                s[0].lower().endswith(".png") for s in self.samples[:8]
            )
        if native_ring:
            yield from self._native_ring_iterator(batch_size, seed, shuffle)
            return
        from concurrent.futures import ThreadPoolExecutor

        rng = np.random.default_rng(seed)
        order = np.arange(len(self.samples))
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            while True:
                if shuffle:
                    rng.shuffle(order)
                for start in range(0, len(order) - batch_size + 1, batch_size):
                    idxs = order[start : start + batch_size]
                    items = list(pool.map(self.get, (int(i) for i in idxs)))
                    yield {
                        k: np.stack([it[k] for it in items]) for k in items[0]
                    }

    def _native_ring_iterator(
        self, batch_size: int, seed: int = 0, shuffle: bool = True
    ) -> Iterator[Dict[str, np.ndarray]]:
        """C++ prefetch-ring pipeline yielding the same batch contract.

        Triple paths are flattened [lt, rt, ls] per sample ([lt, rt, ls,
        lp] with frame t-1) with the SAMPLE order pre-shuffled once; the
        ring runs sequentially (shuffle=False) so each sample's paths stay
        contiguous — the ring's wrap point (a multiple of their count)
        never splits one.
        Falls back to the thread-pool path on any decode failure
        (non-8-bit PNG etc.). While ``utils.spans`` is on, each batch adds
        the ring's counters (``native_loader.STATS_FIELDS``, cumulative in
        the ring) since the last reading to it as ``ring.<field>``; while
        it is off the ring's counters are not read.
        """
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self.samples)) if shuffle else np.arange(
            len(self.samples)
        )
        paths: List[str] = []
        Ks: List[np.ndarray] = []
        baselines: List[float] = []
        n = 3 if self.prev is None else 4  # paths per sample
        for i in order:
            lt, rt, ls, K, baseline = self.samples[int(i)]
            paths.extend((lt, rt, ls) if self.prev is None else (lt, rt, ls, self.prev[int(i)]))
            Ks.append(K)
            baselines.append(baseline)
        ring = native_loader.NativeBatchLoader(
            paths, n * batch_size, self.height, self.width, shuffle=False,
            u8=self.u8,
        )
        seen = dict.fromkeys(native_loader.STATS_FIELDS, 0)
        try:
            while True:
                try:
                    imgs, idx = ring.next()
                except ValueError:
                    # Undecodable image in the set: bail to the PIL path.
                    yield from self._iterator(
                        batch_size, seed=seed, shuffle=shuffle, native_ring=False
                    )
                    return
                if spans.enabled():
                    for name, total in ring.stats().items():
                        spans.count("ring." + name, total - seen[name])
                        seen[name] = total
                sample_rows = idx[0::n] // n
                batch = {
                    "image_t": imgs[0::n],
                    "image_r": imgs[1::n],
                    "image_s": imgs[2::n],
                    "K": np.stack([Ks[int(s)] for s in sample_rows]),
                    "baseline": np.array(
                        [baselines[int(s)] for s in sample_rows], np.float32
                    ),
                }
                if self.prev is not None:
                    batch["image_p"] = imgs[3::n]
                yield batch
        finally:
            ring.close()


def write_train_list(dataset: "KittiRawStereo", path: str, root: str) -> int:
    """Emit a train-list file — the reference's data-prep output
    (SURVEY.md §3.4: image-list files consumed by the data layers).

    Line format (v2): ``left right next_left fx fy cx cy baseline`` with
    paths relative to ``root``, intrinsics pre-scaled to the dataset's
    resolution, and the per-sample stereo baseline in meters (from the
    drive/sequence calib). :func:`load_train_list` also reads the v1
    7-column form (no baseline column) for back-compat.
    """
    n = 0
    with open(path, "w") as f:
        for lt, rt, ls, K, baseline in dataset.samples:
            rel = lambda p: os.path.relpath(p, root)
            f.write(
                f"{rel(lt)} {rel(rt)} {rel(ls)} "
                f"{K[0,0]:.6f} {K[1,1]:.6f} {K[0,2]:.6f} {K[1,2]:.6f} "
                f"{baseline:.6f}\n"
            )
            n += 1
    return n


def load_train_list(root: str, list_path: str, height: int = 160, width: int = 608, u8: bool = False) -> "KittiRawStereo":
    """Build a KittiRawStereo from a prepared train-list file (the
    counterpart of :func:`write_train_list`). Reads both the v2 8-column
    format (with a baseline column) and the v1 7-column one, where the
    baseline falls back to the KITTI nominal 0.54 m."""
    ds = KittiRawStereo.__new__(KittiRawStereo)
    ds.root = root
    ds.height, ds.width = height, width
    ds.u8 = u8
    ds.samples = []
    ds.prev = None
    with open(list_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) not in (7, 8):
                continue
            lt, rt, ls = (os.path.join(root, p) for p in parts[:3])
            fx, fy, cx, cy = (float(x) for x in parts[3:7])
            baseline = float(parts[7]) if len(parts) == 8 else 0.54
            K = np.array(
                [[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32
            )
            ds.samples.append((lt, rt, ls, K, baseline))
    return ds


class KittiOdomStereo(KittiRawStereo):
    """Stereo + temporal training triples from KITTI *odometry* sequences.

    The reference trains VO on odometry sequences 00-08 (SURVEY.md §3.4,
    §6: "read KITTI raw (Eigen split) + KITTI odometry seq 00-08"), whose
    tree layout differs from raw: ``sequences/<seq>/image_2`` (left) and
    ``image_3`` (right), calib in ``calib.txt`` P2/P3 rows. Produces the
    same batch contract as :class:`KittiRawStereo` (image_t/image_r/
    image_s/K/baseline), so training and `prep` work unchanged.

    The stereo baseline comes from the calib itself — the x-offsets of
    the rectified projections, b = (P2[0,3] - P3[0,3]) / fx (KITTI
    odometry rigs are ~0.54 m but vary per sequence) — and rides the
    batch as the per-sample ``baseline`` field consumed by
    ``train.loop.compute_losses``.
    """

    def __init__(
        self,
        root: str,
        sequences: Sequence[str],
        height: int = 160,
        width: int = 608,
        orig_size: Tuple[int, int] | None = None,
        u8: bool = False,
    ):
        self.root = root
        self.height, self.width = height, width
        self.u8 = u8
        self.samples: List[Tuple[str, str, str, np.ndarray, float]] = []
        self.prev = None
        self.baselines: Dict[str, float] = {}
        for seq in sequences:
            seq_dir = os.path.join(root, "sequences", seq)
            left_dir = os.path.join(seq_dir, "image_2")
            right_dir = os.path.join(seq_dir, "image_3")
            if not os.path.isdir(left_dir) or not os.path.isdir(right_dir):
                continue
            P2, P3 = read_odometry_projections(
                os.path.join(seq_dir, "calib.txt")
            )
            frames = sorted(
                f for f in os.listdir(left_dir) if f.endswith(".png")
            )
            if not frames:
                continue
            size = orig_size or _image_size(os.path.join(left_dir, frames[0]))
            K = _scaled_K(P2[:, :3].copy(), size, (width, height))
            # Baseline between the two color cams from the rectified
            # x-offsets (P[0,3] = -fx * t_x): b = (P2[0,3] - P3[0,3])/fx.
            # (P2's own offset is usually ~0 but not exactly, so diff
            # the two rather than trusting P3 alone.)
            baseline = float((P2[0, 3] - P3[0, 3]) / P3[0, 0])
            self.baselines[seq] = baseline
            for a, b in zip(frames[:-1], frames[1:]):
                self.samples.append(
                    (
                        os.path.join(left_dir, a),
                        os.path.join(right_dir, a),
                        os.path.join(left_dir, b),
                        K,
                        baseline,
                    )
                )


class KittiOdometrySequence:
    """Frame access over one KITTI odometry sequence (eval / VO inference)."""

    def __init__(
        self,
        root: str,
        sequence: str,
        height: int = 160,
        width: int = 608,
        camera: str = "image_2",
        orig_size: Tuple[int, int] | None = None,
    ):
        seq_dir = os.path.join(root, "sequences", sequence)
        self.frame_paths = sorted(
            os.path.join(seq_dir, camera, f)
            for f in os.listdir(os.path.join(seq_dir, camera))
            if f.endswith(".png")
        )
        self.height, self.width = height, width
        K_full = read_odometry_calib(os.path.join(seq_dir, "calib.txt"))
        if orig_size is None:
            # Native size varies per sequence (1241x376, 1226x370, ...);
            # read it from the first frame's header.
            orig_size = _image_size(self.frame_paths[0])
        self.K = _scaled_K(K_full, orig_size, (width, height))
        pose_path = os.path.join(root, "poses", sequence + ".txt")
        self.gt_poses = None
        if os.path.isfile(pose_path):
            from depthvo_tpu_torch.eval.odometry import read_kitti_poses

            self.gt_poses = read_kitti_poses(pose_path)

    def __len__(self) -> int:
        return len(self.frame_paths)

    def frame(self, idx: int) -> np.ndarray:
        return load_image(self.frame_paths[idx], self.height, self.width)

    def frames_u8(self, num_workers: int = 8) -> np.ndarray:
        """All frames as one (N, H, W, 3) uint8 array (thread-pool decode).

        The whole-sequence array is what ``api.DepthVO.pose_sequence``
        copies to the device at once; consecutive pairs are then
        formed on-device, so each frame crosses the host->device link
        once as uint8 instead of twice as float32 (8x fewer bytes than
        ``pair_iterator``)."""
        return load_images_u8(self.frame_paths, self.height, self.width, num_workers)

    def pair_iterator(self, batch_size: int = 8) -> Iterator[np.ndarray]:
        """Yield batches of consecutive-frame pairs (B, H, W, 6)."""
        buf = []
        for i in range(len(self) - 1):
            buf.append(
                np.concatenate([self.frame(i), self.frame(i + 1)], axis=-1)
            )
            if len(buf) == batch_size:
                yield np.stack(buf)
                buf = []
        if buf:
            yield np.stack(buf)
