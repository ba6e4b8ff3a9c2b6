"""Overload autopilot of the port (``isoforest_tpu/autopilot``): closed-loop
SLO control with a reversible brownout ladder.

Under sustained queue pressure it widens coalescing toward throughput,
sheds low-weight tenants with typed 429s, and finally spends bounded
accuracy (``subsample_trees``, and q16 on the CPU): every rung a
degradation-ladder entry, every transition an ``autopilot.*`` event,
recovery rung by rung with hysteresis.

    from isoforest_tpu_torch.autopilot import Autopilot
    ap = Autopilot(services=[handle.service], start=True)  # or registry=fleet.registry
"""

from .controller import RUNG_REASONS, Autopilot, AutopilotConfig, current_rung, mount_autopilot

__all__ = [
    "RUNG_REASONS",
    "Autopilot",
    "AutopilotConfig",
    "current_rung",
    "mount_autopilot",
]
