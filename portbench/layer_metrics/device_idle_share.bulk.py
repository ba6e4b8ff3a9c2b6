"""Share of the bulk window with no kernel, copy or memset on the card."""

from portbench.trace import idle_share

LAYER = "device"


def read(ctx):
    return idle_share(ctx)
