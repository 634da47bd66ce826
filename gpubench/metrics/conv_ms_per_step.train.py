"""Device milliseconds per train step in kernels the frozen category table
names as convolution."""

from gpubench.readers import ms_per_step


def read(run):
    return ms_per_step(run, lambda cat: cat == "convolution")
