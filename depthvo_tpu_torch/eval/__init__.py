"""Evaluation suites of the port (counterpart of ``depthvo_tpu.eval``).

* ``depth_metrics``: the KITTI Eigen-split protocol (Garg crop, depth
  caps of 50/80 m, median scaling, abs_rel / sq_rel / rmse / rmse_log /
  delta<1.25^k).
* ``odometry``: trajectories composed from per-pair relative poses, the
  KITTI devkit metrics (per-length t_err %, r_err deg/100m) and ATE.
* ``resize``: the protocol's resize of a prediction to its ground
  truth's size (Pillow's float bilinear resample, without Pillow).
* ``runner``: the batched inference sweeps and the two evaluations
  (``run_depth_eval``, ``run_odometry_eval``).
* ``synthetic``: trained nets against the exact depth and poses of
  synthetic scenes (the reference's ``benchmarks/feat_ab.py`` protocol;
  ``chip_smoke.py`` phase ``learn``).

None of these modules imports PIL or matplotlib when it is imported.
"""

from depthvo_tpu_torch.eval.depth_metrics import (  # noqa: F401
    compute_depth_metrics,
    eigen_crop_mask,
    DEPTH_METRIC_NAMES,
)
from depthvo_tpu_torch.eval.odometry import (  # noqa: F401
    compose_trajectory,
    ate,
    kitti_odometry_errors,
    align_scale,
)
