"""The port's streaming executor (``isoforest_tpu_torch/ops/streaming.py``)
on the CPU, where it runs its whole schedule (pack, copy, chunk, count)
with plain host buffers.

Streamed scores equal single-shot scores bit for bit: every kernel is
row-independent and ``exp2`` runs once over all N. Against the JAX package's
``score_matrix`` each strategy keeps the tolerance its pair already has:
atol 2e-6 on scores, the walk against the JAX walk kernel in interpret mode
and ``dense`` against its own counterpart (the standard dense kernel, the
EIF sparse Pallas kernel).
"""

from __future__ import annotations

import logging
import pathlib
import threading

import numpy as np
import pytest
import torch

from isoforest_tpu.models import ExtendedIsolationForestModel as JaxExtModel
from isoforest_tpu.models import IsolationForestModel as JaxModel
from isoforest_tpu.ops.ext_growth import ExtendedForest as JaxExtForest
from isoforest_tpu.ops.traversal import score_matrix as jax_score_matrix
from isoforest_tpu.ops.tree_growth import StandardForest as JaxForest
from isoforest_tpu.utils.validation import check_non_finite as jax_check_non_finite
from isoforest_tpu_torch import load_model, telemetry
from isoforest_tpu_torch.io.interop import extended_model_from_arrays, model_from_arrays
from isoforest_tpu_torch.ops import streaming
from isoforest_tpu_torch.resilience import faults
from isoforest_tpu_torch.resilience.degradation import degradation_report, reset_degradations

RESOURCES = pathlib.Path(__file__).parent / "resources" / "torch_port"
ATOL = 2e-6
JAX_COUNTERPART = {"walk": "walk", "dense": "dense"}
JAX_EXT_COUNTERPART = {"walk": "walk", "dense": "pallas"}
TREES = 16


@pytest.fixture(scope="module")
def pairs():
    """16 trees of each committed fixture, in both packages."""
    std = JaxModel.load(str(RESOURCES / "mammography_std" / "model"))
    ext = JaxExtModel.load(str(RESOURCES / "mammography_eif" / "model"))
    std_arrays = tuple(np.asarray(a)[:TREES] for a in std.forest)
    ext_arrays = tuple(np.asarray(a)[:TREES] for a in ext.forest)
    common = lambda m: dict(num_samples=m.num_samples, num_features=m.num_features,  # noqa: E731
                            total_num_features=m.total_num_features,
                            outlier_score_threshold=m.outlier_score_threshold)
    jax_std = JaxModel(forest=JaxForest(*std_arrays), params=std.params, **common(std))
    jax_ext = JaxExtModel(forest=JaxExtForest(*ext_arrays), params=ext.params,
                          extension_level=ext.extension_level, **common(ext))
    return {
        "standard": (model_from_arrays(*std_arrays, device="cpu", **common(std)), jax_std, JAX_COUNTERPART),
        "extended": (extended_model_from_arrays(*ext_arrays, device="cpu", **common(ext)), jax_ext,
                     JAX_EXT_COUNTERPART),
    }


def _rows(mammography, n):
    X, _ = mammography
    return np.ascontiguousarray(X[np.arange(n) % len(X)])


@pytest.fixture(scope="module")
def single_shot(pairs, mammography):
    """Single-shot scores, computed once per (kind, strategy, rows)."""
    memo = {}

    def get(kind, strategy, rows):
        if (kind, strategy, rows) not in memo:
            memo[kind, strategy, rows] = pairs[kind][0].score(_rows(mammography, rows), strategy=strategy)
        return memo[kind, strategy, rows]
    return get


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("chunk,rows", [(1, 17), (7, 75), (333, 800), (1000, 800)])
@pytest.mark.parametrize("strategy", ["walk", "dense"])
@pytest.mark.parametrize("kind", ["standard", "extended"])
def test_streamed_scores_equal_single_shot(pairs, single_shot, mammography, kind, strategy, chunk, rows, pipeline):
    model = pairs[kind][0]
    X = _rows(mammography, rows)
    whole = single_shot(kind, strategy, rows)
    streamed = model.score(X, strategy=strategy, chunk_size=chunk, pipeline=pipeline)
    assert streamed.dtype == torch.float32 and streamed.shape == (rows,)
    assert torch.equal(streamed, whole)  # bit for bit, the ragged tail included


@pytest.mark.parametrize("strategy", ["walk", "dense"])
@pytest.mark.parametrize("kind", ["standard", "extended"])
def test_streamed_scores_agree_with_jax_score_matrix(pairs, mammography, kind, strategy):
    port, ref, counterpart = pairs[kind]
    X = _rows(mammography, 300)
    got = port.score(X, strategy=strategy, chunk_size=128).numpy()
    want = np.asarray(jax_score_matrix(ref.forest, X, ref.num_samples, strategy=counterpart[strategy]))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_resident_rows_are_chunked_in_place(pairs, mammography):
    model = pairs["standard"][0]
    X = torch.from_numpy(_rows(mammography, 1000))
    assert torch.equal(model.score(X, chunk_size=333), model.score(X))


def test_two_back_to_back_calls_keep_their_own_rows(pairs, mammography):
    """The cached buffers carry one call's rows into the next call's
    staging: each call still scores its own rows."""
    model = pairs["standard"][0]
    A = _rows(mammography, 2000)
    B = np.ascontiguousarray(A[::-1] * 1.5)
    want_a, want_b = model.score(A), model.score(B)
    got_a = model.score(A, chunk_size=512)
    got_b = model.score(B, chunk_size=512)
    assert torch.equal(got_a, want_a) and torch.equal(got_b, want_b)


def test_break_pipeline_stage_takes_pipeline_fallback_once(pairs, single_shot, mammography):
    model = pairs["extended"][0]
    X = _rows(mammography, 800)
    want = single_shot(kind="extended", strategy="walk", rows=800)
    reset_degradations()
    with faults.inject(break_pipeline_stage=True):
        assert not streaming.stage_available("cpu")
        got = model.score(X, strategy="walk", chunk_size=333, strict=True)  # strict-exempt rung
    assert torch.equal(got, want)
    assert degradation_report().count("pipeline_fallback") == 1
    # a single-chunk call has nothing to stage and takes no rung
    with faults.inject(break_pipeline_stage=True):
        model.score(X[:100], strategy="walk", chunk_size=333)
    assert degradation_report().count("pipeline_fallback") == 1
    reset_degradations()


def test_nonfinite_warns_with_the_jax_message_and_count(pairs, mammography, caplog):
    model = pairs["standard"][0]
    X = _rows(mammography, 3000)
    X[[5, 900, 2999], [0, 3, 5]] = [np.nan, np.inf, -np.inf]
    X[1500, :] = np.nan
    with caplog.at_level(logging.WARNING):
        jax_check_non_finite(X, "warn")
    want = [r.getMessage() for r in caplog.records if "non-finite" in r.getMessage()]
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="isoforest_tpu_torch"):
        model.score(X, chunk_size=777)
    got = [r.getMessage() for r in caplog.records if "non-finite" in r.getMessage()]
    assert want == got == [want[0]] and "input contains 9 non-finite" in want[0]


def test_nonfinite_raise_raises_before_the_monitor_folds(mammography):
    model = load_model(str(RESOURCES / "mammography_std" / "model"), device="cpu")
    monitor = model.enable_monitoring()
    X = _rows(mammography, 3000)
    X[2500, 1] = np.nan
    with pytest.raises(ValueError, match=r"input contains 1 non-finite .*nonfinite='raise'"):
        model.score(X, chunk_size=777, nonfinite="raise")
    assert monitor.drift()["rows"] == 0
    model.score(X, chunk_size=777, nonfinite="allow")
    assert monitor.drift()["rows"] == 3000


def test_monitor_folds_the_same_counts_streamed_or_not(mammography):
    """A streamed host batch folds on the scores' device with the same rows
    as an unchunked one."""
    folds = []
    for chunk in (None, 777):
        model = load_model(str(RESOURCES / "mammography_std" / "model"), device="cpu")
        monitor = model.enable_monitoring()
        model.score(_rows(mammography, 3000), chunk_size=chunk)
        folds.append((monitor._score_counts.copy(), np.array(monitor._feature_counts), monitor.drift()))
    np.testing.assert_array_equal(folds[0][0], folds[1][0])
    np.testing.assert_array_equal(folds[0][1], folds[1][1])
    assert folds[0][2] == folds[1][2]


def test_streamed_call_telemetry(pairs, mammography):
    model = pairs["standard"][0]
    telemetry.enable()
    telemetry.reset()
    model.score(_rows(mammography, 2000), strategy="walk", chunk_size=512)
    runs = telemetry.get_events("pipeline.run")
    assert [(e.fields["chunks"], e.fields["rows"], e.fields["fallback"], e.fields["staged"]) for e in runs] == [
        (4, 2000, False, True)]
    chunks = telemetry.span_records("pipeline.chunk")
    assert [r.attrs["rows"] for r in chunks] == [512, 512, 512, 464]
    assert all(r.parent == "score_matrix" for r in chunks)
    stats = streaming.pipeline_stats()
    assert stats["chunks"] == 4 and 0.0 <= stats["overlap_efficiency"] <= 1.0
    assert streaming._PIPELINE_H2D.summary(site="score_matrix")["count"] == 1


def test_chunk_rows_policy(monkeypatch):
    monkeypatch.delenv(streaming.CHUNK_ENV, raising=False)
    assert streaming.resolve_chunk_rows(None, "cuda") == streaming.PLATFORM_DEFAULT_CHUNK["cuda"]
    assert streaming.resolve_chunk_rows(777, "cuda") == 777  # no bucket rounding: nothing compiles per shape
    monkeypatch.setenv(streaming.CHUNK_ENV, "4096")
    assert streaming.resolve_chunk_rows(None, "cpu") == 4096
    assert streaming.resolve_chunk_rows(100, "cpu") == 100
    with pytest.raises(ValueError, match="chunk_rows"):
        streaming.resolve_chunk_rows(0)
    monkeypatch.setenv(streaming.PIPELINE_ENV, "0")
    assert not streaming.pipeline_enabled() and streaming.pipeline_enabled(True)


def test_a_held_staging_pair_is_never_shared():
    """Hazard 4: an execution that finds the cached buffers held (a run the
    watchdog abandoned, still running) stages through a private pair, and
    both runs score their own rows."""
    entered, release = threading.Event(), threading.Event()
    used = []

    def run_chunk(chunk):
        used.append(chunk.data_ptr())
        if threading.current_thread().name == "held":
            entered.set()
            release.wait(10.0)
        return chunk.sum(dim=1)

    A = torch.arange(40, dtype=torch.float32).reshape(20, 2)
    B = -A
    out = {}
    ex = lambda: streaming.StreamingExecutor(run_chunk, 8, device="cpu")  # noqa: E731
    held = threading.Thread(target=lambda: out.setdefault("A", ex().execute(A)), name="held")
    held.start()
    assert entered.wait(10.0)
    held_ptrs = set(used)
    out["B"] = ex().execute(B)
    release.set()
    held.join(10.0)
    assert not held.is_alive()
    assert torch.equal(out["A"], A.sum(dim=1)) and torch.equal(out["B"], B.sum(dim=1))
    assert held_ptrs.isdisjoint(used[len(held_ptrs):len(held_ptrs) + 3])


def test_concurrent_streamed_calls_keep_their_rows():
    """Threads sharing the staging cache (more threads than cores, a short
    switch interval): every call scores its own rows."""
    import sys

    def run_chunk(chunk):
        return chunk.sum(dim=1)

    inputs = [torch.arange(600, dtype=torch.float32).reshape(200, 3) * (i + 1) for i in range(12)]
    results, errors = {}, []

    def worker(i):
        try:
            for _ in range(5):
                got = streaming.StreamingExecutor(run_chunk, 16, device="cpu").execute(inputs[i])
                if not torch.equal(got, inputs[i].sum(dim=1)):
                    errors.append(i)
            results[i] = True
        except Exception as exc:  # reported below
            errors.append(repr(exc))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(inputs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(results) == len(inputs)


def test_staging_cache_is_bounded():
    """More shapes than the cache holds: the oldest unheld pair is dropped,
    and every call still scores its own rows."""
    streaming._STAGING.clear()
    for width in range(1, streaming._STAGING_MAX + 3):
        X = torch.arange(40 * width, dtype=torch.float32).reshape(40, width)
        got = streaming.StreamingExecutor(lambda c: c.sum(dim=1), 16, device="cpu").execute(X)
        assert torch.equal(got, X.sum(dim=1))
    assert len(streaming._STAGING) == streaming._STAGING_MAX
    assert [key[2] for key in streaming._STAGING] == list(range(3, streaming._STAGING_MAX + 3))
