"""What the readers of the program's own spans share. The program opens
`gp.*` ranges (`record_function`) at its layers' boundaries while a
profiler session runs, so the traced window's host events hold them on the
device's clock. From them: the device's idle time split by the innermost
`gp.*` span the host was in, and the eager launches inside a span. Each
returns None where the run has no trace, no device operation, or no
`gp.*` span: a program without spans says nothing of its layers."""
from __future__ import annotations

import bisect
import re

__all__ = ["gaps", "innermost", "idle_share_under", "eager_launches_per_span"]

# the host's launch events, as the profiler names the runtime's calls; a
# graph's replay is one `cudaGraphLaunch`, not counted
LAUNCH = re.compile(r"^(cudaLaunchKernel\w*|cudaMemcpyAsync|cudaMemsetAsync)$")


def gaps(ops) -> list:
    """[(start, end)] between the device operations' merged intervals, as
    `profile.idle_gaps` finds them (the window's edges are not gaps)."""
    out, end = [], None
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def innermost(spans) -> list:
    """[(start, end, name)] in time order, each a stretch of a span's self
    time: the span is the innermost of `spans` (name, start, end) there."""
    pieces, stack, t = [], [], float("-inf")  # stack: (end, name), innermost last

    def close(x):
        nonlocal t
        while stack and stack[-1][0] <= x:
            end, name = stack.pop()
            if end > t:
                pieces.append((t, end, name))
                t = end

    for name, s, e in sorted(spans, key=lambda r: (r[1], -r[2])):
        close(s)
        if stack and s > t:
            pieces.append((t, s, stack[-1][1]))
        t = max(t, s)
        stack.append((e, name))
    close(float("inf"))
    return pieces


def _spans(trace):
    if trace is None or not trace.ops or trace.window_s <= 0:
        return None
    spans = [h for h in trace.host if h[0].startswith("gp.")]
    return spans or None


def idle_share_under(ctx, prefixes: tuple):
    """The device's idle time while the host's innermost `gp.*` span is one
    whose name starts with one of `prefixes`, over the traced window, in %.
    Idle time outside every `gp.*` span goes to no layer."""
    spans = _spans(ctx.trace)
    if spans is None:
        return None
    pieces = [p for p in innermost(spans) if p[2].startswith(prefixes)]
    idle, i = 0.0, 0
    for g0, g1 in gaps(ctx.trace.ops):
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < g1:
            idle += max(0.0, min(g1, pieces[j][1]) - max(g0, pieces[j][0]))
            j += 1
    return 100.0 * idle * 1e-6 / ctx.trace.window_s


def eager_launches_per_span(ctx, name: str):
    """The host's launch events (`LAUNCH`) inside the spans called `name`,
    over the number of those spans; a launch inside a `cudaGraphLaunch`
    is the replay's, and not counted."""
    if _spans(ctx.trace) is None:
        return None
    host = ctx.trace.host
    outer = sorted((s, e) for n, s, e in host if n == name)
    if not outer:
        return None
    replays = sorted((s, e) for n, s, e in host if n == "cudaGraphLaunch")
    starts = [s for s, _ in outer]
    replay_starts = [s for s, _ in replays]

    def within(x0, x1, intervals, first):
        k = bisect.bisect_right(first, x0) - 1
        return k >= 0 and intervals[k][1] >= x1

    count = sum(1 for n, s, e in host if LAUNCH.match(n) and within(s, e, outer, starts)
                and not within(s, e, replays, replay_starts))
    return count / len(outer)
