"""Host milliseconds the streaming executor spends packing and enqueuing host rows, per million rows scored."""

from portbench.trace import staging_ms_per_mrow

LAYER = "streaming executor"


def read(ctx):
    return staging_ms_per_mrow(ctx)
