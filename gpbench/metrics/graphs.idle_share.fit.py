"""graphs.idle_share.fit: the share of the traced window in which the
device is idle while the host's innermost span of the program is the
graph layer's (`gp.graph.<tag>`: a call of `utils/graphs.run` with its
flattening, its copies in and out and its replay's launch)."""
from gpbench.spans import idle_share_under


def read(ctx):
    return idle_share_under(ctx, ("gp.graph.",))
