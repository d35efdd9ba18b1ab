"""trainer.idle_share.fit: the share of the traced window in which the
device is idle while the host's innermost span of the program is the
L-BFGS loop's (`gp.lbfgs.iteration`: an iteration's own host work, its
host reads included)."""
from gpbench.spans import idle_share_under


def read(ctx):
    return idle_share_under(ctx, ("gp.lbfgs.",))
