"""hmc.accept_rate: block A's accept rate over the whole window, the mean
over chains and chunks of the sampler's own `accept_rate_a`."""


def read(ctx):
    return ctx.record.accept_rate
