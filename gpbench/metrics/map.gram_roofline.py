"""map.gram_roofline: the gram kernels' share of their roofline in the
traced restarts (one gram a launch)."""
from gpbench.readers import gram_roofline


def read(ctx):
    return gram_roofline(ctx, chains=1)
