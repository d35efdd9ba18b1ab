"""What the readers of the program's device brackets share. Inside a graph's
replay the program marks a piece of work with two empty kernels on the
stream, `<tag>_begin` and `<tag>_end` (the tag's dots as underscores:
`gp_qr_fwd_begin`), so the traced window's device operations hold each
bracket on the device's own clock. From them: each bracket's interval and
the device's busy time inside the brackets. Each returns None where the
run has no trace or no bracket of the tag: a program without markers says
nothing of the work they would bracket."""
from __future__ import annotations

__all__ = ["intervals", "busy_inside_s"]


def intervals(trace, tag: str):
    """[(start, end)] in us, one a bracket of `tag`: from the end of a begin
    marker to the start of the next end marker. A begin without its end (a
    record the profiler lost) brackets nothing."""
    if trace is None or not trace.ops:
        return None
    stem = tag.replace(".", "_")
    begin, end = stem + "_begin", stem + "_end"
    out, opened = [], None
    for name, s, e in sorted(trace.ops, key=lambda o: o[1]):
        if name == begin:
            opened = e
        elif name == end and opened is not None:
            out.append((opened, s))
            opened = None
    return out or None


def _busy(ops) -> list:
    """The union of the operations' intervals, as sorted disjoint [start, end]."""
    out = []
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_inside_s(trace, spans) -> float:
    """Seconds of the device's busy time (the union of its operations)
    inside the disjoint intervals `spans`."""
    busy, total, i = _busy(trace.ops), 0.0, 0
    for a, b in sorted(spans):
        while i < len(busy) and busy[i][1] <= a:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < b:
            total += max(0.0, min(b, busy[j][1]) - max(a, busy[j][0]))
            j += 1
    return total * 1e-6
