"""What the per-layer readers share: the gram kernels' share of their
roofline, a step's share of the card's peak, the device's idle share.
Each returns None where the run has nothing to read."""
from __future__ import annotations

import re

__all__ = ["GRAM_KERNELS", "gram_roofline", "step_mfu", "idle_share", "points"]

# the gram op's kernels by their names in the trace: the forward, and the
# VJP with its reductions
GRAM_KERNELS = {"gram": re.compile(r"\bgram_kernel\b"),
                "gram_vjp": re.compile(r"\bgram_vjp_(kernel|reduce\w*)\b")}
_LAUNCHED = {"gram": re.compile(r"\bgram_kernel\b"), "gram_vjp": re.compile(r"\bgram_vjp_kernel\b")}


def points(ctx) -> int:
    return ctx.traffic.get("n", ctx.config.get("n"))


def gram_roofline(ctx, chains: int):
    """The least time of the traced gram launches over their time in the
    trace, in %. A launch's least time comes from its shape (`counts`);
    each family's bound is scaled to the launches the trace recorded, so a
    record the profiler lost is neither timed nor counted."""
    t = ctx.trace
    if t is None or not t.ops:
        return None
    bound = measured = 0.0
    for family, pattern in GRAM_KERNELS.items():
        ops = [(s, e) for name, s, e in t.ops if pattern.search(name)]
        recorded = sum(1 for name, _, _ in t.ops if _LAUNCHED[family].search(name))
        shapes = {k: v for k, v in t.launches.items()
                  if isinstance(k, tuple) and k[0] == family and v > 0}
        counted = sum(shapes.values())
        if not ops or not counted:
            continue
        per = sum(v * ctx.counts.launch_bound_s(ctx.config, family, k[1], k[2], k[3], chains)
                  for k, v in shapes.items()) / counted
        bound += per * recorded
        measured += sum(e - s for s, e in ops) * 1e-6
    return 100.0 * bound / measured if measured > 0 and bound > 0 else None


def step_mfu(ctx, flops: float):
    """flops over the traced window's seconds at the card's peak, in %."""
    t = ctx.trace
    if t is None or not t.ops or t.window_s <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (t.window_s * ctx.peak_flops)


def idle_share(ctx):
    """The share of the traced window in which no operation ran on the
    device, in %."""
    t = ctx.trace
    if t is None or not t.ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
