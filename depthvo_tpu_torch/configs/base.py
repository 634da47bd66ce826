"""Config dataclasses for the three staged training variants.

The port's own copy of ``depthvo_tpu/configs/base.py`` (the port imports
nothing of the JAX package). Field names, defaults and the derived
``stereo_dmax`` are the same, so a config saved by either package loads
in the other. Comments that cite TPU measurements describe why the JAX
package chose a default; they are not measurements of this port.

Reference parity (SURVEY.md §0, §2a): training is staged —

1. ``stereo``          : depth net only, stereo photometric loss
                         (reference ``experiments/depth``).
2. ``temporal_stereo`` : + odometry net, temporal photometric loss
                         (reference ``experiments/depth_odometry``).
3. ``full_feat``       : + deep feature reconstruction loss
                         (reference ``experiments/depth_odometry_feat``).

Each stage fine-tunes from the previous stage's weights (the reference
passes ``--weights=<prev>.caffemodel`` to ``caffe train``; here the train
loop's ``init_from`` points at the previous stage's orbax checkpoint).

Solver parity: the reference used an SGD-family solver with step lr decay
(solver.prototxt, [M] confidence); Adam with the paper's lr is the
default here — the gate is metric parity, not solver mimicry (SURVEY §7).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# KITTI stereo rig: right camera is `baseline` meters along +x of the left
# camera (SURVEY.md §0: 0.54 m calibrated stereo baseline).
KITTI_STEREO_BASELINE = 0.54

# KITTI intrinsics scaled to the 608x160 training resolution (approximate
# average over raw sequences; per-sequence K from the loader overrides this).
KITTI_FX_608 = 355.0
KITTI_FY_160 = 376.0 * (160.0 / 376.0)  # fy scaled by H ratio
KITTI_CX_608 = 303.0
KITTI_CY_160 = 79.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    height: int = 160
    width: int = 608
    num_scales: int = 4
    max_disp: float = 0.3
    min_disp: float = 0.00625
    feat_channels: int = 16
    compute_dtype: str = "bfloat16"  # activations; params always f32
    # Predict the finest inverse depth at 1/2 res and upsample the disp
    # map (skips the VPU-bound full-res decoder convs; quality-gated on
    # the synthetic-scene training check — see models/depth_net.py).
    fast_final_upsample: bool = False
    # Subpixel (depth-to-space) final head: per-output-pixel learned
    # upsampling with the same full-res-conv savings (models/depth_net.py).
    subpixel_head: bool = False
    # Exact space-to-depth rewrite of the finest decoder stage: same
    # params and math as the standard stage, but the full-res 3x3 convs
    # run at half resolution with 4x channels (MXU-tileable fwd+bwd).
    # Default ON: measured -11.2% train step at batch 8 (37.65 ->
    # 33.44 ms, benchmarks/conv_levers_2026-08-20.json) at zero quality
    # cost (the function is identical; tests/test_models.py
    # TestS2DFinest). Checkpoints are interchangeable with the standard
    # stage, which int8 serving and the per-layer profiler still use
    # (train/state.py::build_models forces it for quant modes).
    s2d_finest: bool = True
    # Rematerialize DepthNet stages under AD (jax.checkpoint): recompute
    # in-stage activations in the backward instead of holding them in
    # HBM — the FLOPs-for-memory trade that raises the per-chip batch
    # ceiling (models/depth_net.py).
    remat: bool = False
    # DepthNet decoder widths, coarsest->finest. The finest entries are
    # the channel-padding lever for the VPU-bound full-resolution conv
    # backward (benchmarks/conv_levers.py measures the trade): wider
    # tiles fill MXU/VPU lanes better per byte but add FLOPs.
    decoder_features: Tuple[int, ...] = (256, 128, 64, 32, 16)

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return (self.height, self.width, 3)


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    # The Caffe solver family (sgd_solvers.cpp): adam / sgd / nesterov /
    # adagrad / rmsprop / adadelta. Caffe's `momentum` maps onto beta1
    # (sgd/nesterov momentum, adadelta rho), `rms_decay` and `delta`
    # keep their Caffe names; weight_decay is decoupled (adamw) for adam
    # and classic L2 for the others, matching each solver's convention.
    optimizer: str = "adam"
    learning_rate: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    rms_decay: float = 0.99
    delta: float = 1e-8
    weight_decay: float = 0.0
    # The global-norm clip of the gradients; None clips nothing
    # (Monodepth2's solver).
    grad_clip_norm: float | None = 10.0
    # Caffe solver `lr_policy` family (solver.cpp::GetLearningRate,
    # SURVEY §2b(ii) solver row). One of:
    #   fixed     : base_lr
    #   step      : base_lr * gamma^floor(iter / stepsize)
    #   exp       : base_lr * gamma^iter
    #   inv       : base_lr * (1 + gamma*iter)^(-power)
    #   multistep : base_lr * gamma^(#stepvalues passed)
    #   poly      : base_lr * (1 - iter/max_iter)^power
    #   sigmoid   : base_lr / (1 + exp(-gamma * (iter - stepsize)))
    # with stepsize = lr_decay_steps, gamma = lr_decay_factor,
    # power = lr_power, max_iter = total_steps. `iter` counts optimizer
    # updates (micro-batches are folded by iter_size first, like Caffe).
    lr_policy: str = "step"
    lr_decay_steps: int = 80_000
    lr_decay_factor: float = 0.5
    lr_power: float = 1.0
    lr_step_values: Tuple[int, ...] = ()
    total_steps: int = 200_000
    warmup_steps: int = 200
    # Caffe solver `iter_size`: accumulate (average) gradients over this
    # many micro-batches before applying one optimizer update — the
    # effective batch is iter_size * batch_size with unchanged memory.
    # Steps/`fit(steps)` count micro-batches; every iter_size-th one
    # applies the update (BN running stats update every micro-batch,
    # exactly like Caffe's per-forward BN).
    iter_size: int = 1


ARCHITECTURES = ("depthvo_feat", "monodepth2", "manydepth")

# The batch keys each architecture reads besides Depth-VO-Feat's
# ('image_t', 'image_r', 'image_s', 'K', 'baseline'): frame t-1
# ('image_p') and ManyDepth's per-row augmentation draws ('aug_u', one
# float in [0, 1) a row). The one place that says what an architecture's
# batches hold: the data sources, the CLI and the loss graphs read it.
BATCH_EXTRAS = {"depthvo_feat": (), "monodepth2": ("image_p",),
                "manydepth": ("image_p", "aug_u")}


def batch_extras(cfg) -> tuple:
    """:data:`BATCH_EXTRAS` of ``cfg``'s architecture (a config without
    the field is Depth-VO-Feat's)."""
    return BATCH_EXTRAS[getattr(cfg, "architecture", "depthvo_feat")]


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "stereo"
    # The networks and loss graph: "depthvo_feat" (Zhan et al., CVPR 2018:
    # the staged recipe below) or "monodepth2" (Godard et al., ICCV 2019:
    # ResNet18 depth and pose nets, per-pixel minimum reprojection with
    # auto-masking; train/monodepth2.py) or "manydepth" (Watson et al.,
    # CVPR 2021: a plane-sweep cost volume against frame -1 inside the
    # depth encoder, a jointly trained Monodepth2 teacher; train/
    # manydepth.py). Monodepth2 reads the switches as its frames:
    # use_temporal adds frames -1 and +1, use_stereo the stereo view "s".
    architecture: str = "depthvo_feat"
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)

    # Loss graph switches (the staged recipe).
    use_stereo: bool = True
    use_temporal: bool = False
    use_feature: bool = False

    # Loss weights (reference train.prototxt loss_weight analogs; exact
    # values are [L]-confidence — tuned for metric parity, SURVEY §7).
    stereo_weight: float = 1.0
    temporal_weight: float = 1.0
    feature_weight: float = 0.1
    smooth_weight: float = 0.05
    ssim_weight: float = 0.0  # 0 == reference-faithful pure L1

    edge_aware_smoothness: bool = True
    stereo_baseline: float = KITTI_STEREO_BASELINE

    # Dtype of the photometric loss REGION (image pyramids and the
    # L1/SSIM/smoothness elementwise work). The geometry core (depth,
    # twists, projections) and all loss accumulations stay f32
    # regardless, and the Pallas warp kernels cast their image payloads
    # back to f32 at entry (ops/warp_pallas.py) — so bf16 narrows ONLY
    # the pyramid/elementwise traffic, not the warp kernels' (the
    # dominant image-sized HBM share). Measured effect on the train
    # step: a wash (PERF.md roofline section,
    # benchmarks/roofline.py --loss-dtype-ab), consistent with that
    # scope; f32 stays the default for its numerics.
    loss_dtype: str = "float32"

    # Static disparity bound (pixels, at full width) for the stereo warp
    # kernel. 0 = derive from the config at trace time:
    # margin * nominal_fx(width) * baseline * max inverse depth — see
    # :func:`stereo_dmax`. Pixels beyond the bound are masked invalid,
    # so the bound must dominate anything the depth head can produce;
    # the derived form does by construction (the head bounds inverse
    # depth at model.max_disp + model.min_disp).
    stereo_dmax: int = 0
    # Safety factor over the nominal KITTI fx/baseline (real rigs vary
    # ~1-2% in fx per campaign; 25% headroom costs one 8-px sublane).
    stereo_dmax_margin: float = 1.25

    # Vertical half-window (rows) of the Pallas general-warp kernel at the
    # finest scale; coarser scales halve it adaptively (ops.frozen_warp).
    # Samples with larger vertical displacement are masked invalid.
    # Quantified on KITTI-scale synthetic scenes (tests/test_warp_window.py):
    # 16 drops 0.00% of otherwise-valid pixels at <= 1.6 m/frame ego-motion
    # (58 km/h at 10 Hz) and 0.75% at 2.4 m/frame with 4-10 m obstacles;
    # 24 drops 0.00% in every tested scene. Raise for extreme motion.
    warp_pad_v: int = 16

    # Train feat net jointly (False == reference: frozen feature extractor).
    train_feat: bool = False

    batch_size: int = 4  # per-replica
    seed: int = 0
    log_every: int = 100
    checkpoint_every: int = 2_000
    init_from: str | None = None  # previous stage checkpoint dir
    # Separate feature-extractor init (the analog of the reference's
    # externally-trained NYUv2 feature weights): a pretrain-feat
    # checkpoint dir whose 'feat' params override whatever init_from set.
    init_feat_from: str | None = None


def stereo_dmax(cfg: ExperimentConfig, width: int | None = None) -> int:
    """Static disparity bound (pixels) for the stereo warp at ``width``.

    VERDICT r2 item 6: the kernel's bound must be config-derived, not a
    hardcoded 128 — raise the image width or ``model.max_disp`` and a
    fixed 128 silently masks valid disparities (supervision drops with
    no warning).

    disparity = fx_scaled * baseline * inverse_depth, and the depth head
    bounds inverse depth at ``max_disp + min_disp``, so

        dmax = margin * (KITTI_FX_608/608 * width) * baseline
                      * (max_disp + min_disp)

    rounded UP to a multiple of 8 (sublane). ``width`` defaults to the
    config's full width; pyramid scales pass their own width (the bound
    scales linearly with fx). An explicit ``cfg.stereo_dmax`` overrides
    the derivation (interpreted at full width, scaled per-scale).

    Raises ``ValueError`` — errors, not masks — when the bound exceeds
    the kernel's reach (``dmax + 2 > width``: the scatter-free backward
    caps its shift count at the padded width, so larger true disparities
    would silently drop gradient taps).
    """
    import math

    w = width if width is not None else cfg.model.width
    if cfg.stereo_dmax:
        d = cfg.stereo_dmax * w / cfg.model.width
    else:
        fx = (KITTI_FX_608 / 608.0) * w
        d = (
            cfg.stereo_dmax_margin
            * fx
            * cfg.stereo_baseline
            * (cfg.model.max_disp + cfg.model.min_disp)
        )
    dmax = max(8, int(math.ceil(d / 8.0)) * 8)
    if dmax + 2 > w:
        raise ValueError(
            f"stereo dmax {dmax} exceeds the kernel's reach at width {w} "
            f"(need dmax + 2 <= width). Lower model.max_disp / "
            f"stereo_baseline or raise the image width."
        )
    return dmax


def to_dict(cfg: ExperimentConfig) -> dict:
    """JSON-serializable dict (nested dataclasses included)."""
    return dataclasses.asdict(cfg)


def from_dict(d: dict) -> ExperimentConfig:
    """Inverse of :func:`to_dict` — rebuild the nested frozen dataclasses.

    Unknown keys are ignored (forward compatibility with configs saved by
    newer versions)."""
    def pick(cls, sub: dict) -> dict:
        names = {f.name for f in dataclasses.fields(cls)}
        return {k: v for k, v in sub.items() if k in names}

    kwargs = pick(ExperimentConfig, d)
    if isinstance(kwargs.get("model"), dict):
        mk = pick(ModelConfig, kwargs["model"])
        if "decoder_features" in mk:  # JSON arrays decode as lists
            mk["decoder_features"] = tuple(mk["decoder_features"])
        kwargs["model"] = ModelConfig(**mk)
    if isinstance(kwargs.get("optim"), dict):
        ok = pick(OptimConfig, kwargs["optim"])
        if "lr_step_values" in ok:  # JSON arrays decode as lists
            ok["lr_step_values"] = tuple(ok["lr_step_values"])
        kwargs["optim"] = OptimConfig(**ok)
    return ExperimentConfig(**kwargs)


def save_json(cfg: ExperimentConfig, path: str) -> None:
    import json

    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2)


def load_json(path: str) -> ExperimentConfig:
    import json

    with open(path) as f:
        return from_dict(json.load(f))


def stereo(**overrides) -> ExperimentConfig:
    """Stage 1: stereo photometric depth training (reference experiments/depth)."""
    return ExperimentConfig(name="stereo", **overrides)


def temporal_stereo(**overrides) -> ExperimentConfig:
    """Stage 2: + odometry net and temporal photometric loss."""
    return ExperimentConfig(
        name="temporal_stereo", use_temporal=True, **overrides
    )


def full_feat(**overrides) -> ExperimentConfig:
    """Stage 3: + deep feature reconstruction loss (the full model)."""
    return ExperimentConfig(
        name="full_feat", use_temporal=True, use_feature=True, **overrides
    )


# Monodepth2's KITTI split (eigen_zhou): 39810 training frames, so an
# epoch of batch 12 is 3317 steps (its trainer's num_train_samples //
# batch_size).
MONODEPTH2_STEPS_PER_EPOCH = 39810 // 12


def monodepth2_ms(**overrides) -> ExperimentConfig:
    """Monodepth2, mono+stereo (frames 0, -1, +1 and "s"), as its released
    ``mono+stereo_1024x320`` model trains (``options.py`` defaults):
    1024x320, scales 0-3, batch 12; Adam at 1e-4 decayed x0.1 after 15
    epochs, 20 epochs, no weight decay, no clipping; SSIM weight 0.85,
    smoothness 1e-3; depth 0.1-100 (a sigmoid disparity scaled to
    [0.01, 10]); auto-masking and the per-pixel minimum reprojection,
    every scale warped at full resolution. ``stereo_baseline`` is the
    data's (the scenes' right view); Monodepth2's stereo transform is its
    own constant, 0.1 (``train.monodepth2.STEREO_T``). The 640x192 model
    is the same with ``--height 192 --width 640``."""
    steps = MONODEPTH2_STEPS_PER_EPOCH
    kwargs = dict(
        name="monodepth2_ms",
        architecture="monodepth2",
        model=ModelConfig(height=320, width=1024, num_scales=4, max_disp=9.99, min_disp=0.01,
                          s2d_finest=False, decoder_features=(256, 128, 64, 32, 16)),
        optim=OptimConfig(learning_rate=1e-4, grad_clip_norm=None, lr_policy="step",
                          lr_decay_steps=15 * steps, lr_decay_factor=0.1,
                          total_steps=20 * steps, warmup_steps=0),
        use_stereo=True,
        use_temporal=True,
        use_feature=False,
        smooth_weight=1e-3,
        ssim_weight=0.85,
        batch_size=12,
    )
    kwargs.update(overrides)
    return ExperimentConfig(**kwargs)


# ManyDepth's KITTI split (eigen_zhou, as Monodepth2's): epochs of batch 12.
MANYDEPTH_STEPS_PER_EPOCH = 39810 // 12


def manydepth(**overrides) -> ExperimentConfig:
    """ManyDepth (Watson et al., "The Temporal Opportunist", CVPR 2021,
    arXiv:2104.14540; github.com/nianticlabs/manydepth ``options.py`` and
    ``trainer.py``) as its released ``KITTI_HR`` model trains, before
    ``freeze_teacher_epoch`` (teacher and pose net trained): 1024x320,
    scales 0-3, batch 12, frames 0, -1, +1, matching frames 0 and -1; a
    ResNet18 multi-frame depth net with a cost volume of 96 depth bins
    linear between the trackers (0.1 and 10.0 at the start) at a quarter of
    the resolution; a Monodepth2 ResNet18 teacher; depth 0.1-100; SSIM
    weight 0.85, smoothness 1e-3; static-camera and zero-cost-volume
    shares of 0.25 each; Adam at 1e-4, x0.1 after 15 epochs, no weight
    decay, no clipping."""
    steps = MANYDEPTH_STEPS_PER_EPOCH
    kwargs = dict(
        name="manydepth",
        architecture="manydepth",
        model=ModelConfig(height=320, width=1024, num_scales=4, max_disp=9.99, min_disp=0.01,
                          s2d_finest=False, decoder_features=(256, 128, 64, 32, 16)),
        optim=OptimConfig(learning_rate=1e-4, grad_clip_norm=None, lr_policy="step",
                          lr_decay_steps=15 * steps, lr_decay_factor=0.1,
                          total_steps=20 * steps, warmup_steps=0),
        use_stereo=False,
        use_temporal=True,
        use_feature=False,
        smooth_weight=1e-3,
        ssim_weight=0.85,
        batch_size=12,
    )
    kwargs.update(overrides)
    return ExperimentConfig(**kwargs)


def tiny_test(**overrides) -> ExperimentConfig:
    """Tiny shapes for unit/integration tests and the multi-chip dryrun."""
    kwargs = dict(
        name="tiny",
        model=ModelConfig(height=32, width=96, num_scales=2, compute_dtype="float32"),
        optim=OptimConfig(learning_rate=1e-3, total_steps=100, warmup_steps=0),
        use_temporal=True,
        use_feature=True,
        batch_size=2,
    )
    kwargs.update(overrides)
    return ExperimentConfig(**kwargs)
