"""hmc.ess_per_s: the median over the parameters of the multi-chain ESS of
all the window's draws (the benchmark's own estimator) over the window's
seconds: the sampler's output in effective samples. It swings with how far
the chains have mixed, so it has no bound."""
from gpbench.loops.hmc import ess_per_s


def read(ctx):
    return ess_per_s(ctx.record)
