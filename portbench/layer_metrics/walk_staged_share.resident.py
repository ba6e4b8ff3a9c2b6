"""Share of the window's ``walk_sum`` launches that ran the staged walk
(the forest's records in shared memory), in %, from the program's
``isoforest_walk_launches_total{kernel, variant}``. None where the program
counts no launch by its variant (a program without the counter) or launched
no ``walk_sum`` in the window. A call's ragged last chunk, below the
small-batch launch's row count, takes ``trees`` whatever the forest."""

from portbench.trace import delta

LAYER = "kernels"
COUNTER = "isoforest_walk_launches_total"


def read(ctx):
    launched, _ = delta(ctx, COUNTER, kernel="walk_sum")
    if not launched:
        return None
    staged, _ = delta(ctx, COUNTER, kernel="walk_sum", variant="staged")
    return 100.0 * staged / launched
