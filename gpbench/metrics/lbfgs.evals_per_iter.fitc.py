"""lbfgs.evals_per_iter.fitc: the objective's evaluations an optimizer
iteration over the whole window, from `optimize`'s count of evaluations
(line-search trials included)."""


def read(ctx):
    r = ctx.record
    return r.evaluations / r.iterations if r.iterations else None
