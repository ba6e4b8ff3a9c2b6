"""Measured strategy autotuning (``isoforest_tpu/tuning``): probe once per
regime, persist the winner.

``strategy="auto"`` resolutions consult a persisted cost model keyed on
``(platform, model-shape bucket, batch bucket, extended?)``; cold keys run a
short warmed best-of-k probe of every eligible strategy, and the winner table
is kept as schema-versioned JSON with a TTL (:mod:`.autotuner`,
:mod:`.cost_model`). The streaming executor's chunk policy
(:func:`~isoforest_tpu_torch.ops.streaming.resolve_chunk_rows`, re-exported
here) bounds the probe on the card, so a probe times one chunk of the call.
"""

from ..ops.streaming import resolve_chunk_rows
from .autotuner import (
    DECISION_SOURCES,
    Decision,
    autotune_enabled,
    clear_table,
    decision_counts,
    decision_key,
    eligible_strategies,
    emit_decision,
    model_bucket,
    resolve_decision,
    table_snapshot,
)
from .cost_model import DEFAULT_TTL_S, SCHEMA_VERSION, CostModel, cost_model, reset_cost_model, table_path, ttl_s

__all__ = [
    "DECISION_SOURCES",
    "DEFAULT_TTL_S",
    "SCHEMA_VERSION",
    "CostModel",
    "Decision",
    "autotune_enabled",
    "clear_table",
    "cost_model",
    "decision_counts",
    "decision_key",
    "eligible_strategies",
    "emit_decision",
    "model_bucket",
    "reset_cost_model",
    "resolve_chunk_rows",
    "resolve_decision",
    "table_path",
    "table_snapshot",
    "ttl_s",
]
