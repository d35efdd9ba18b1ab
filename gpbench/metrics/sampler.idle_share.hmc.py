"""sampler.idle_share.hmc: the share of the traced window in which the
device is idle while the host's innermost span of the program is the split
sampler's (`gp.split.outer`: an outer iteration's own host work, the
transitions' draws and the writes of the draws included)."""
from gpbench.spans import idle_share_under


def read(ctx):
    return idle_share_under(ctx, ("gp.split.", "gp.hmc."))
