"""hmc.gram_roofline: the gram kernels' share of their roofline in the
traced outer iterations (every chain's gram in one launch)."""
from gpbench.readers import gram_roofline


def read(ctx):
    return gram_roofline(ctx, chains=ctx.traffic["chains"])
