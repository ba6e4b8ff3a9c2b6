"""Milliseconds of the bulk window, per million rows scored, with nothing
running on the card while the host was inside a ``pipeline.chunk`` span's
``wait``, ``pack`` or ``copy`` stage: the staging the card waits for, not
the staging hidden under a kernel. None where no chunk span carries stages
(a program that marks none) or no device trace was taken."""

from portbench.trace import idle_gaps, union

LAYER = "streaming executor"
STAGING = ("wait", "pack", "copy")


def overlap_ns(a, b):
    """Nanoseconds two sorted lists of disjoint ``(start, end)`` share."""
    total = i = j = 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx):
    staged = union([(start, end) for s in ctx["spans"] if s.name == "pipeline.chunk"
                    for name, start, end in s.attrs.get("stages", ()) if name in STAGING])
    if not staged or not ctx["device"] or not ctx["rows_scored"]:
        return None
    idle = idle_gaps(ctx["device"], ctx["w0_ns"], ctx["w1_ns"])
    return overlap_ns(idle, staged) / 1e6 / (ctx["rows_scored"] / 1e6)
