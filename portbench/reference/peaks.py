"""Published peaks of the card the benchmark runs on (NVIDIA's H100 SXM data
sheet, dense rates, at the full 700 W power limit). A run prints the
card's own name and power limit beside every share of these."""

PEAKS = {
    "H100": {"f32_ops_per_s": 67e12, "bytes_per_s": 3.35e12},
}


def peaks_for(device_name: str) -> dict:
    """The peaks of the card whose ``torch.cuda.get_device_name()`` is
    ``device_name``; a KeyError for a card the table lacks, so that no share
    is ever taken against another card's peaks."""
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    raise KeyError(f"no published peaks for {device_name!r}")


def least_seconds(ops: float, nbytes: float, peaks: dict) -> float:
    """The least time the card could take for ``ops`` operations and
    ``nbytes`` bytes: the larger of the two bounds."""
    return max(ops / peaks["f32_ops_per_s"], nbytes / peaks["bytes_per_s"])
