"""fitc.gram_roofline: the gram kernels' share of their roofline in the
traced restart: K(Xu), K(Xu, X) and their VJPs (dp alone)."""
from gpbench.readers import gram_roofline


def read(ctx):
    return gram_roofline(ctx, chains=1)
