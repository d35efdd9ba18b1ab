"""step.mfu.hmc: the operations of the traced outer iterations
(`counts.outer_iteration_flops` each) over the traced window at the card's
peak."""
from gpbench.readers import points, step_mfu


def read(ctx):
    if ctx.trace is None:
        return None
    iters = sum(i["outer_iterations"] for i in ctx.trace.items)
    per = ctx.counts.outer_iteration_flops(ctx.config, points(ctx), ctx.traffic["chains"])
    return step_mfu(ctx, iters * per)
