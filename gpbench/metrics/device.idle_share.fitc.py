"""device.idle_share.fitc: the share of the traced window in which no
operation ran on the device."""
from gpbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
