"""Share of the kernels' roofline in the resident cells: the least time for the window's scoring work over the device time of the kernels launched inside ``score_matrix`` spans (a standard node one compare, a (row, tree) one add)."""

from portbench.trace import roofline_share

LAYER = "kernels"


def read(ctx):
    return roofline_share(ctx)
