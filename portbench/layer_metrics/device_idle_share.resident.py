"""Share of the resident window with no kernel, copy or memset on the card:
where the host, and not the card, paces a call over rows already there."""

from portbench.trace import idle_share

LAYER = "device"


def read(ctx):
    return idle_share(ctx)
