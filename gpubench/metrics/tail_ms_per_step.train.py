"""Device milliseconds per train step in kernels that are not convolution,
matmul, copy or warp: the loss graph's elementwise work, BatchNorm, casts
and the solver."""

from gpubench.readers import NOT_TAIL, ms_per_step


def read(run):
    return ms_per_step(run, lambda cat: cat not in NOT_TAIL)
