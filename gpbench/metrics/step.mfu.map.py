"""step.mfu.map: the operations of the traced restarts' evaluations
(`counts.evaluation_flops` each) over the traced window at the card's
peak."""
from gpbench.readers import points, step_mfu


def read(ctx):
    if ctx.trace is None:
        return None
    evals = sum(i["evaluations"] for i in ctx.trace.items)
    return step_mfu(ctx, evals * ctx.counts.evaluation_flops(ctx.config, points(ctx)))
