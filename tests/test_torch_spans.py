"""The port's spans and histogram (``isoforest_tpu_torch/telemetry/spans.py``,
``telemetry/metrics.py``) against the JAX package's, on the CPU.

The histogram is stdlib code copied from the JAX package, so it must agree
exactly: buckets, quantiles, min and max. Span ids come from the same seeded
counter, so a port ``model.score`` and a JAX package one, both seeded, give
the same span names, nesting and ids (the strategy attributes aside: the
JAX side scores with its gather walk, which is quick on the CPU).
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

from isoforest_tpu.models import IsolationForestModel as JaxModel
from isoforest_tpu.telemetry import metrics as jax_metrics
from isoforest_tpu.telemetry import spans as jax_spans
from isoforest_tpu_torch import load_model, telemetry
from isoforest_tpu_torch.telemetry import metrics, spans

FIXTURE = pathlib.Path(__file__).parent / "resources" / "torch_port" / "mammography_std" / "model"


@pytest.fixture(autouse=True)
def _telemetry_on():
    telemetry.enable()
    yield
    telemetry.enable()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_matches_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    values = np.concatenate([rng.lognormal(-6, 3, 500), metrics.DEFAULT_LATENCY_BUCKETS, [0.0, 1e3]])
    name = f"isoforest_test_seconds_{seed}"
    ours = metrics.histogram(name, "test", labelnames=("op",))
    theirs = jax_metrics.histogram(name, "test", labelnames=("op",))
    for v in values:
        ours.observe(float(v), op="x")
        theirs.observe(float(v), op="x")
    assert ours.snapshot() == theirs.snapshot()  # per-bucket counts, sum, min, max
    assert ours.summary(op="x") == theirs.summary(op="x")
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert ours.quantile(q, op="x") == theirs.quantile(q, op="x")
    assert ours.summary(op="y")["count"] == 0 and ours.quantile(0.5, op="y") == 0.0


def test_histogram_registration_rules():
    h = metrics.histogram("isoforest_test_rules_seconds", "t", buckets=(1.0, 2.0, float("inf")))
    assert h.buckets == (1.0, 2.0)
    assert metrics.histogram("isoforest_test_rules_seconds", "t", buckets=(1.0, 2.0)) is h
    with pytest.raises(ValueError, match="already registered"):
        metrics.histogram("isoforest_test_rules_seconds", "t", buckets=(1.0, 3.0))
    with pytest.raises(ValueError, match="strictly increase"):
        metrics.Histogram("h", "t", buckets=(2.0, 1.0))
    with pytest.raises(ValueError, match="quantile"):
        h.quantile(1.5)


def test_seed_trace_ids_gives_the_jax_packages_ids():
    out = []
    for module in (spans, jax_spans):
        module.seed_trace_ids(1234)
        with module.span("outer") as outer:
            with module.span("inner") as inner:
                pass
        out.append([(s.trace_id, s.span_id, s.parent_id) for s in (outer, inner)])
    assert out[0] == out[1]
    assert out[0][0][0].startswith("04d2")


def _tree(records):
    return [(r.name, r.parent, r.depth, r.trace_id, r.span_id, r.parent_id, r.attrs.get("rows"),
             r.attrs.get("index")) for r in records]


def test_model_score_spans_nest_as_the_jax_packages(mammography):
    X = np.ascontiguousarray(mammography[0][:3000])
    port = load_model(str(FIXTURE), device="cpu")
    ref = JaxModel.load(str(FIXTURE))
    port.score(X, strategy="walk", chunk_size=1024)  # warm both: tables, the scoring layout
    ref.score(X, strategy="gather", chunk_size=1024)
    got = []
    for module, call in ((spans, lambda: port.score(X, strategy="walk", chunk_size=1024)),
                         (jax_spans, lambda: ref.score(X, strategy="gather", chunk_size=1024))):
        module.reset_spans()
        module.seed_trace_ids(77)
        call()
        got.append(_tree(module.records()))
    assert got[0] == got[1]
    assert [g[0] for g in got[0]] == ["pipeline.chunk"] * 3 + ["score_matrix", "model.score"]
    score_span = spans.records("score_matrix")[-1]
    assert score_span.attrs["strategy"] == "walk" and score_span.attrs["strategy_source"] == "explicit"


def test_spans_are_profiler_ranges_and_form_a_trace(mammography):
    X = np.ascontiguousarray(mammography[0][:1500])
    model = load_model(str(FIXTURE), device="cpu")
    model.score(X, chunk_size=512)
    spans.reset_traces()
    spans.set_trace_policy(slow_threshold_s=0.0, sample_every=1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.score(X, chunk_size=512)
    names = [e.name for e in prof.events()]
    assert {"model.score", "score_matrix", "pipeline.chunk"} <= set(names)
    assert names.count("pipeline.chunk") == 3
    trace = spans.get_trace(spans.recent_traces(1)[0]["trace_id"])
    assert trace["root"] == "model.score" and trace["complete"]
    assert sorted(s["name"] for s in trace["spans"]) == ["model.score"] + ["pipeline.chunk"] * 3 + ["score_matrix"]
    assert spans.trace_stats()["kept"] >= 1
    summary = spans.summary()
    assert {"model.score", "score_matrix", "pipeline.chunk"} <= set(summary)
    assert summary["pipeline.chunk"]["count"] >= 6


def test_fit_spans(tmp_path):
    from isoforest_tpu_torch import IsolationForest

    X = np.random.default_rng(0).normal(size=(500, 4)).astype(np.float32)
    spans.reset_spans()
    IsolationForest(num_estimators=8, max_samples=64.0, random_seed=1, device="cpu").fit(
        X, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=4)
    assert [r.attrs["block"] for r in spans.records("fit.grow_block")] == [0, 1]
    assert [r.attrs["rows"] for r in spans.records("fit.baseline")] == [500]


@pytest.mark.parametrize("extended", [False, True], ids=["standard", "extended"])
def test_fit_records_the_jax_packages_phase_spans(extended):
    """The JAX package's fit phases (``utils/logging.py::phase``): the growth
    under the model family's name, and the threshold pass when a
    contamination is set."""
    from isoforest_tpu.models import ExtendedIsolationForest as JaxExtended
    from isoforest_tpu.models import IsolationForest as JaxEstimator
    from isoforest_tpu_torch import ExtendedIsolationForest, IsolationForest

    X = np.random.default_rng(0).normal(size=(500, 4)).astype(np.float32)
    kw = dict(num_estimators=4, max_samples=64.0, contamination=0.05, random_seed=1)
    port_cls, jax_cls = (ExtendedIsolationForest, JaxExtended) if extended else (IsolationForest, JaxEstimator)
    spans.reset_spans()
    port_cls(**kw, device="cpu").fit(X, baseline=False)
    jax_spans.reset_spans()
    jax_cls(**kw).fit(X, baseline=False)
    phases = ("isolation_forest.fit.grow", "extended_isolation_forest.fit.grow", "isolation_forest.fit.threshold")
    port_names = {r.name for r in spans.records()}
    jax_names = {r.name for r in jax_spans.records()}
    assert [n for n in phases if n in port_names] == [n for n in phases if n in jax_names]
    grow = phases[1] if extended else phases[0]
    assert len(spans.records(grow)) == 1 and len(spans.records(phases[2])) == 1


def test_disabled_spans_are_a_shared_no_op():
    spans.reset_spans()
    telemetry.disable()
    a = spans.span("x", rows=1)
    b = spans.span("y")
    assert a is b is spans._NULL_SPAN
    with a as s:
        s.set_attrs(k=1)
        spans.set_span_attrs(k=2)
        assert spans.current_span_name() is None and spans.current_context() is None
    assert spans.records() == []
    telemetry.enable()
    with spans.span("z") as s:
        assert spans.current_span_name() == "z" and spans.current_context() == s.context
    assert [r.name for r in spans.records()] == ["z"]


def test_with_context_and_links():
    spans.reset_traces()
    with spans.span("request") as req:
        ctx = spans.current_context()
    with spans.with_context(ctx):
        with spans.span("adopted") as child:
            pass
    assert child.trace_id == req.trace_id and child.parent_id == req.span_id
    with spans.span("flush", links=[ctx]) as flush:
        pass
    assert flush.trace_id != req.trace_id
    linked = spans.get_trace(req.trace_id)["linked"]
    assert [t["root"] for t in linked] == ["flush"]
