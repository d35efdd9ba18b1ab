"""hmc.eager_launches_per_iter: the host's kernel launches, copies and
fills (`cudaLaunchKernel*`, `cudaMemcpyAsync`, `cudaMemsetAsync`) inside
the traced `gp.split.outer` spans, over their number: the sampler's work
outside its graphs (draws, copies in and out, writes of the draws). A
graph's replay (`cudaGraphLaunch`) is not counted."""
from gpbench.spans import eager_launches_per_span


def read(ctx):
    return eager_launches_per_span(ctx, "gp.split.outer")
