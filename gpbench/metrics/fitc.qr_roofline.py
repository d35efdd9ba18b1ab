"""fitc.qr_roofline: the least time of the traced window's bracketed QRs
and QR VJPs over the device's busy time inside their brackets, in %. The
least time of each comes from its shape alone, (n + m) x m
(`counts.qr_bound_s`), whatever implements the factorization."""
from gpbench.brackets import busy_inside_s, intervals
from gpbench.readers import points


def read(ctx):
    t = ctx.trace
    rows, cols = points(ctx) + ctx.config["m"], ctx.config["m"]
    bound = inside = 0.0
    for kind in ("fwd", "vjp"):
        spans = intervals(t, f"gp.qr.{kind}")
        if spans:
            bound += len(spans) * ctx.counts.qr_bound_s(kind, rows, cols)
            inside += busy_inside_s(t, spans)
    return 100.0 * bound / inside if inside > 0 else None
