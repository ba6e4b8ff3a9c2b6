"""Host milliseconds a ``score_matrix`` call spends in its own work around
the executor, its ``prepare`` and ``finish`` stages (conversion, width
checks, ``auto``'s decision, the tables, the executor's construction; the
counters and the ``exp2``), over the calls inside the window. None where no
``score_matrix`` span carries stages (a program that marks none)."""

LAYER = "dispatch"
DISPATCH = ("prepare", "finish")


def read(ctx):
    w0, w1 = ctx["w0_ns"], ctx["w1_ns"]
    calls = [s.attrs["stages"] for s in ctx["spans"] if s.name == "score_matrix" and s.attrs.get("stages")]
    calls = [stages for stages in calls if stages[0][1] >= w0 and stages[-1][2] <= w1]
    if not calls:
        return None
    ns = sum(end - start for stages in calls for name, start, end in stages if name in DISPATCH)
    return ns / 1e6 / len(calls)
