"""step.mfu.fitc: the operations of the traced restart's evaluations
(`counts.evaluation_flops` each: one FITC value and gradient) over the
traced window at the card's peak."""
from gpbench.readers import points, step_mfu


def read(ctx):
    if ctx.trace is None:
        return None
    evals = sum(i["evaluations"] for i in ctx.trace.items)
    return step_mfu(ctx, evals * ctx.counts.evaluation_flops(ctx.config, points(ctx)))
