"""hmc.kernels_per_iter: the device kernels the traced window recorded,
over its outer iterations of the sampler."""


def read(ctx):
    t = ctx.trace
    iters = sum(i["outer_iterations"] for i in t.items) if t is not None else 0
    kernels = len(t.kernels()) if t is not None else 0
    return kernels / iters if kernels and iters else None
