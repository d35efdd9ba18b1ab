"""fitc.qr_share: the device's busy time inside the QR's brackets
(`gp.qr.fwd` and `gp.qr.vjp`: the reduced QR of the stacked matrix and its
VJP, between the program's marker kernels) over the traced window's
device-busy time, in %."""
from gpbench.brackets import busy_inside_s, intervals

TAGS = ("gp.qr.fwd", "gp.qr.vjp")


def read(ctx):
    t = ctx.trace
    spans = [s for tag in TAGS for s in (intervals(t, tag) or [])]
    if not spans or t.busy_s <= 0:
        return None
    return 100.0 * busy_inside_s(t, spans) / t.busy_s
