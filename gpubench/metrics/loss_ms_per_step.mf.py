"""Device milliseconds per train step in kernels that are neither
convolution, matmul, memcpy nor BatchNorm by the frozen category table,
nor ``border`` or ``cost_volume`` by name: both nets' masked losses, the
SSIM, the minima, the matching mask, the upsampling, the geometry, the
smoothness and the solver."""

from gpubench.mf_readers import loss_ms_per_step as read  # noqa: F401
