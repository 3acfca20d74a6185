"""Seconds from the process start to the first timed epoch or job: imports,
the CUDA context, the kernels (built by the first run in a checkout), the
inputs and weights from the seed, the warm-up."""


def read(ctx):
    return ctx["setup_s"]
