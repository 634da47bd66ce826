"""Slow lane: the port learns metric odometry on the CPU (the port of
tests/test_metric_learning.py).

Stereo self-supervision grounds metric scale, so after 200 steps of the
port's ``fit`` on two fixed synthetic scenes the odometry net recovers
each scene's true translation within 20% (the reference's bar). Deselected
from the default run (``-m 'not slow'``); run with
``pytest -m slow tests/test_torch_metric_learning.py``. It needs no JAX.
Phase ``learn`` of ``chip_smoke.py`` runs the same check at full width on
the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.slow


def test_odometry_learns_metric_translation():
    from depthvo_tpu_torch import configs
    from depthvo_tpu_torch.data.synthetic import SyntheticScenes
    from depthvo_tpu_torch.geometry import se3
    from depthvo_tpu_torch.train import loop

    cfg = configs.tiny_test(batch_size=2)
    cfg = dataclasses.replace(cfg, optim=configs.OptimConfig(
        learning_rate=1e-3, total_steps=300, warmup_steps=10))
    scenes = SyntheticScenes(cfg, seed=3, num_scenes=2)
    state = loop.fit(cfg, scenes.iterator(cfg.batch_size, fixed=True), 200, device="cpu")
    odom = state.models.odom.eval()
    for idx in range(2):
        sc = scenes._scenes[idx]
        pair = torch.from_numpy(np.concatenate([sc["image_t"], sc["image_s"]], axis=-1)[None])
        with torch.no_grad():
            T_pred = se3.exp(odom(pair))[0].numpy()
        t_true = sc["T_ts"][:3, 3]
        err = np.linalg.norm(T_pred[:3, 3] - t_true)
        # Metric translation within 20% of the true forward motion.
        assert err < 0.2 * max(np.linalg.norm(t_true), 0.1), (T_pred[:3, 3], t_true)
