"""The port's drift baseline and monitor (``isoforest_tpu_torch/telemetry/monitor.py``),
its baseline capture at fit and the ``_BASELINE.json`` sidecar
(``io/persistence.py``), against the JAX package's, on the CPU.

Tolerances: fed the same values, the folds' counts and the baselines'
``as_dict()`` are equal exactly (the same float64 and float32 arithmetic,
the same numpy summaries); PSI and KS within 1e-12 (one formula, evaluated
once in float64 by each). A fit's baseline is held to the committed
sidecar of the JAX package's fit of the same rows: feature streams exactly
(they depend on the rows alone); the score stream's counts may move only
by the rows whose JAX score lies within 2e-6 of a bin edge ``j / 64``, since
the port's walk sums in another order than the JAX package's and scores
differ by up to 2e-6; quantiles within 2e-6 for the same reason. Fault C4
(a model the port saved lost its sidecar) is held by the round trips.
"""

from __future__ import annotations

import json
import logging
import os
import pathlib
import shutil

import numpy as np
import pytest
import torch

from isoforest_tpu.io import persistence as jpersistence
from isoforest_tpu.telemetry import events as jevents
from isoforest_tpu.telemetry import metrics as jmetrics
from isoforest_tpu.telemetry import monitor as jmonitor
from isoforest_tpu_torch import ExtendedIsolationForest, IsolationForest, load_model, telemetry
from isoforest_tpu_torch.models.isolation_forest import _BASELINE_MAX_ROWS
from isoforest_tpu_torch.ops.traversal import score_matrix
from isoforest_tpu_torch.resilience.degradation import degradation_report, reset_degradations
from isoforest_tpu_torch.resilience import manifest
from isoforest_tpu_torch.telemetry import _state, events, metrics, monitor
from isoforest_tpu_torch.testing import torch_threads

RESOURCES = pathlib.Path(__file__).parent / "resources" / "torch_port"
FIXTURES = {"standard": RESOURCES / "mammography_std", "extended": RESOURCES / "mammography_eif"}
ESTIMATORS = {"standard": IsolationForest, "extended": ExtendedIsolationForest}
EDGE_TOL = 2e-6  # the two packages' walks differ by at most this much in a score


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run beside other test processes
    (``testing.torch_threads``)."""
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True)
def _clean():
    telemetry.reset()
    reset_degradations()
    yield
    telemetry.reset()
    reset_degradations()


def _json(d) -> str:
    """A baseline dict as its sidecar text: equal texts are equal floats,
    NaN quantiles included."""
    return json.dumps(d, sort_keys=True)


def _sidecar(path) -> dict:
    with open(os.path.join(path, monitor.BASELINE_NAME)) as fh:
        return json.load(fh)


# --------------------------------------------------------------------------- #
# PSI, KS and the folds, against the JAX package's on the same inputs
# --------------------------------------------------------------------------- #

# the hand cases of tests/test_monitor.py::TestDriftMath
DRIFT_CASES = [
    ([10, 20, 30], [10, 20, 30]),
    ([10, 20, 30], [1, 2, 3]),
    ([5, 5], [9, 1]),
    ([1, 1], [7, 0]),
    ([8, 4, 2, 1], [1, 2, 4, 8]),
    ([1, 2, 1], [2, 1, 1]),
    ([1, 1], [1, 1]),
    ([10, 0], [0, 10]),
]


@pytest.mark.parametrize("name", ["psi", "ks"])
@pytest.mark.parametrize("p,q", DRIFT_CASES)
def test_psi_and_ks_equal_the_jax_packages(name, p, q):
    assert abs(getattr(monitor, name)(p, q) - getattr(jmonitor, name)(p, q)) <= 1e-12


@pytest.mark.parametrize("name", ["psi", "ks"])
@pytest.mark.parametrize("p,q", [([1, 2], [1, 2, 3]), ([0, 0], [1, 2]), ([1, 2], [0, 0])])
def test_psi_and_ks_refuse_what_the_jax_package_refuses(name, p, q):
    with pytest.raises(ValueError):
        getattr(jmonitor, name)(p, q)
    with pytest.raises(ValueError):
        getattr(monitor, name)(p, q)


SPECIAL = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30, 0.5, 0.0, 1.0, 1 - 1e-9, -1e-9, 2.0**63, 2.0**62])


@pytest.mark.parametrize("lo,hi,bins", [(0.0, 1.0, 64), (-3.0, 5.0, 32), (2.0, 2.0, 32), (1.5, -1.0, 8)])
def test_fold_equals_the_jax_packages(lo, hi, bins):
    """Non-finite values and values at or past 2^63 land in bin 0 in both,
    a degenerate range takes width 1 in both."""
    rng = np.random.default_rng(0)
    v = np.concatenate([SPECIAL, rng.normal(lo, 4.0, 997), rng.uniform(lo - 1, max(hi, lo) + 1, 1000)])
    want = jmonitor._fold(v, lo, hi, bins)
    np.testing.assert_array_equal(monitor._fold(v, lo, hi, bins), want)
    np.testing.assert_array_equal(monitor._fold(torch.from_numpy(v), lo, hi, bins), want)


def test_the_bin_0_rule_is_the_reference_on_this_host():
    """The pinned difference of ROADMAP §C: on x86 numpy +inf and 1e30
    land in bin 0, not in the last bin; the port keeps that on every device."""
    v = np.array([np.inf, -np.inf, np.nan, 1e30, -1e30, 0.5])
    np.testing.assert_array_equal(jmonitor._fold(v, 0.0, 1.0, 64).nonzero()[0], [0, 32])
    idx = monitor._bin_index(torch.tensor(v, dtype=torch.float32) * 64, 64)
    assert idx.tolist() == [0, 0, 0, 0, 0, 32]


def _baseline_inputs(seed=3, n=4096, f=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[:, 1] = 2.5  # a constant feature: hi == lo
    X[:7, f - 1] = [np.nan, np.inf, -np.inf, 1e30, -1e30, np.nan, 0.0]
    scores = rng.random(n).astype(np.float32)
    scores[:3] = [np.nan, 0.0, 1.0]
    return scores, X


@pytest.mark.parametrize("total_rows", [None, 100_000])
def test_capture_baseline_equals_the_jax_packages(total_rows):
    scores, X = _baseline_inputs()
    want = _json(jmonitor.capture_baseline(scores, X, total_rows=total_rows).as_dict())
    assert _json(monitor.capture_baseline(scores, X, total_rows=total_rows).as_dict()) == want
    got = monitor.capture_baseline(torch.from_numpy(scores), torch.from_numpy(X), total_rows=total_rows)
    assert _json(got.as_dict()) == want


def _batches():
    rng = np.random.default_rng(4)
    scores, X = _baseline_inputs(seed=5, n=3000)
    shifted = (X * 3 + 5).astype(np.float32)
    odd = X.copy()
    odd[::5, 0] = np.nan
    odd[1::7, 3] = np.inf
    odd[2::11, 2] = -1e30
    return [
        (scores, X),
        (np.clip(scores * 0.2, 0, 1), shifted),
        (np.clip(scores * 0.2, 0, 1), shifted),
        (rng.random(70_000).astype(np.float32), rng.normal(size=(70_000, 4)).astype(np.float32)),  # strided folds
        (scores.astype(np.float64), X.astype(np.float64)),  # folds in float64, as numpy promotes
        (np.arange(3000) % 2, (np.clip(np.nan_to_num(X), -9, 9) * 10).astype(np.int32)),  # ints fold as f32
        (scores, odd),
        (scores[:1], X[:1]),
        (scores, None),
    ]


@pytest.mark.parametrize("as_tensor", [False, True], ids=["arrays", "cpu_tensors"])
def test_observe_gives_the_jax_packages_counts_and_alerts(as_tensor):
    scores, X = _baseline_inputs()
    base = jmonitor.capture_baseline(scores, X)
    ref = jmonitor.ScoreMonitor(base, threshold=0.25, min_rows=64, ladder=False, model_id="m")
    port = monitor.ScoreMonitor(monitor.Baseline.from_dict(base.as_dict()), threshold=0.25, min_rows=64,
                                ladder=True, model_id="m")
    for s, x in _batches():
        ref.observe(s, x)
        if as_tensor:
            port.observe(torch.from_numpy(np.asarray(s)), None if x is None else torch.from_numpy(x))
        else:
            port.observe(s, x)
        np.testing.assert_array_equal(port._score_counts, ref._score_counts)
        np.testing.assert_array_equal(port._feature_counts, ref._feature_counts)
        assert (port.rows, port._feature_rows) == (ref.rows, ref._feature_rows)
        assert port.report()["alerts"] == ref.report()["alerts"]
    got, want = port.drift(), ref.drift()
    assert abs(got["score"]["psi"] - want["score"]["psi"]) <= 1e-12
    assert abs(got["score"]["ks"] - want["score"]["ks"]) <= 1e-12
    assert max(abs(got["features"][i] - want["features"][i]) for i in range(4)) <= 1e-12
    alerts = port.report()["alerts"]
    assert [e.fields["stream"] for e in telemetry.get_events(kind="drift.alert")] == [a["stream"] for a in alerts]
    assert degradation_report().count("drift_alert") == len(alerts) >= 1
    assert telemetry.gauge("isoforest_fleet_drift_psi", labelnames=("model_id",)).value(model_id="m") > 0


def test_observe_per_stream_fold_of_a_mixed_baseline():
    """A hand-built baseline with unequal bin counts folds stream by stream."""
    scores, X = _baseline_inputs(f=3)
    d = jmonitor.capture_baseline(scores, X).as_dict()
    d["features"][0]["counts"] = d["features"][0]["counts"][:16]
    ref = jmonitor.ScoreMonitor(jmonitor.Baseline.from_dict(d), min_rows=1, ladder=False)
    port = monitor.ScoreMonitor(monitor.Baseline.from_dict(d), min_rows=1, ladder=False)
    for s, x in _batches()[:3]:
        x = None if x is None else x[:, :3]
        ref.observe(s, x)
        port.observe(s, x)
    for a, b in zip(port._feature_counts, ref._feature_counts):
        np.testing.assert_array_equal(a, b)
    assert port.report() == ref.report()


def test_rebind_and_reset_follow_the_jax_package():
    scores, X = _baseline_inputs(f=2)
    base = jmonitor.capture_baseline(scores, X)
    other = jmonitor.capture_baseline(np.clip(scores * 0.2, 0, 1), X * 3 + 5)
    ref = jmonitor.ScoreMonitor(base, threshold=0.1, min_rows=32, ladder=False)
    port = monitor.ScoreMonitor(monitor.Baseline.from_dict(base.as_dict()), threshold=0.1, min_rows=32, ladder=False)
    drifted = (np.clip(scores * 0.2, 0, 1), X * 3 + 5)
    steps = [
        ("observe", drifted), ("rebind", other), ("observe", drifted), ("observe", (scores, X)),
        ("reset", None), ("observe", (scores, X)), ("observe", drifted),
    ]
    for op, arg in steps:
        if op == "observe":
            ref.observe(*arg)
            port.observe(*arg)
        elif op == "rebind":
            ref.rebind(arg)
            port.rebind(monitor.Baseline.from_dict(arg.as_dict()))
        else:
            ref.reset()
            port.reset()
        assert port.report() == ref.report(), op
    with pytest.raises(ValueError, match="features"):
        port.rebind(monitor.capture_baseline(scores, X[:, :1]))
    with pytest.raises(ValueError, match=r"\[N, 2\]"):
        port.observe(scores[:10], np.zeros((10, 3), np.float32))


# --------------------------------------------------------------------------- #
# baseline capture at fit, against the committed JAX sidecars
# --------------------------------------------------------------------------- #


def _edge_rows(jax_scores: np.ndarray) -> int:
    """Rows whose JAX score lies within 2e-6 of a score bin edge ``j / 64``."""
    s = jax_scores.astype(np.float64) * monitor.SCORE_BINS
    return int((np.abs(s - np.round(s)) <= EDGE_TOL * monitor.SCORE_BINS).sum())


@pytest.fixture(scope="module")
def mammography_fits(mammography):
    X = mammography[0]
    return {kind: ESTIMATORS[kind](contamination=0.02, random_seed=1, device="cpu").fit(X) for kind in ESTIMATORS}


@pytest.mark.parametrize("kind", sorted(ESTIMATORS))
def test_fit_baseline_equals_the_committed_sidecar(kind, mammography_fits):
    got = mammography_fits[kind].baseline.as_dict()
    want = _sidecar(FIXTURES[kind] / "model")
    assert got["features"] == want["features"]
    assert (got["rows"], got["capturedRows"], got["baselineVersion"]) == (want["rows"], want["capturedRows"], 1)
    assert got["score"]["lo"] == want["score"]["lo"] and got["score"]["hi"] == want["score"]["hi"]
    # each moved row changes two bins by one
    moved = np.abs(np.array(got["score"]["counts"]) - np.array(want["score"]["counts"])).sum() / 2
    assert moved <= _edge_rows(np.load(FIXTURES[kind] / "jax_scores.npy"))
    for stat in ("min", "max", "mean"):
        assert abs(got["score"][stat] - want["score"][stat]) <= EDGE_TOL
    assert got["scoreQuantiles"].keys() == want["scoreQuantiles"].keys()
    assert max(abs(got["scoreQuantiles"][k] - want["scoreQuantiles"][k]) for k in want["scoreQuantiles"]) <= EDGE_TOL


def test_capture_strides_large_training_sets():
    """Above 65,536 rows every ``ceil(N / 65,536)``-th row is scored through
    the walk kernel and summarised."""
    rng = np.random.default_rng(9)
    X = rng.normal(size=(_BASELINE_MAX_ROWS + 5, 2)).astype(np.float32)
    model = IsolationForest(num_estimators=3, max_samples=32.0, random_seed=1, device="cpu").fit(X)
    sub = X[::2]
    want = monitor.capture_baseline(score_matrix(model.forest, sub, model.num_samples, strategy="walk", device="cpu"),
                                    sub, total_rows=len(X))
    assert model.baseline.as_dict() == want.as_dict()
    assert (model.baseline.rows, model.baseline.captured_rows) == (len(X), len(sub))


# --------------------------------------------------------------------------- #
# the sidecar: fault C4 and both directions
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_c4_a_loaded_fixture_saved_by_the_port_keeps_its_baseline(kind, tmp_path):
    """Fault C4: the port's save dropped ``_BASELINE.json``, and the JAX
    package then loaded the copy with no baseline."""
    src = str(FIXTURES[kind] / "model")
    model = load_model(src, device="cpu")
    assert model.baseline.as_dict() == _sidecar(src)
    model.save(str(tmp_path / "m"))
    assert "_BASELINE.json" in json.load(open(tmp_path / "m" / "_MANIFEST.json"))["files"]
    assert manifest.verify(str(tmp_path / "m")) == []
    back = jpersistence.load_model(str(tmp_path / "m"))
    assert back.baseline is not None and back.baseline.as_dict() == _sidecar(src)
    assert _sidecar(tmp_path / "m") == _sidecar(src)


@pytest.mark.parametrize("kind", sorted(ESTIMATORS))
def test_a_fit_by_the_port_saves_a_baseline_the_jax_package_reads(kind, tmp_path, mammography):
    X = mammography[0][:2000]
    model = ESTIMATORS[kind](num_estimators=8, max_samples=64.0, contamination=0.05, random_seed=2,
                             device="cpu").fit(X)
    model.save(str(tmp_path / "m"))
    assert jpersistence.load_model(str(tmp_path / "m")).baseline.as_dict() == model.baseline.as_dict()
    assert load_model(str(tmp_path / "m"), device="cpu").baseline.as_dict() == model.baseline.as_dict()
    # the JAX package's save of its own load writes the same sidecar back
    jpersistence.load_model(str(tmp_path / "m")).save(str(tmp_path / "j"))
    assert load_model(str(tmp_path / "j"), device="cpu").baseline == model.baseline


def test_env_switch_and_baseline_false_skip_capture(tmp_path, monkeypatch, mammography, caplog):
    X = mammography[0][:1500]
    params = dict(num_estimators=4, max_samples=32.0, random_seed=3, device="cpu")
    assert IsolationForest(**params).fit(X).baseline is not None
    assert IsolationForest(**params).fit(X, baseline=False).baseline is None
    monkeypatch.setenv("ISOFOREST_TPU_BASELINE", "0")
    model = IsolationForest(**params).fit(X)
    assert model.baseline is None
    model.save(str(tmp_path / "legacy"))
    assert not (tmp_path / "legacy" / monitor.BASELINE_NAME).exists()
    with caplog.at_level(logging.WARNING, logger="isoforest_tpu_torch"):
        loaded = load_model(str(tmp_path / "legacy"), device="cpu")
    assert loaded.baseline is None and any(monitor.BASELINE_NAME in r.message for r in caplog.records)
    loaded.score(X[:64])
    with pytest.raises(ValueError, match="no drift baseline"):
        loaded.enable_monitoring()
    with pytest.raises(ValueError, match="no drift monitor attached"):
        loaded.rebind_monitoring()


@pytest.mark.parametrize("body", ['{"baselineVersion": 999}', "{not json"])
def test_an_unsupported_or_unreadable_sidecar_loads_as_none(body, tmp_path, caplog):
    path = tmp_path / "m"
    shutil.copytree(FIXTURES["standard"] / "model", path)
    (path / monitor.BASELINE_NAME).write_text(body)
    manifest.write(str(path))
    with caplog.at_level(logging.WARNING, logger="isoforest_tpu_torch"):
        assert load_model(str(path), device="cpu").baseline is None
    assert any("baseline sidecar" in r.message for r in caplog.records)
    assert jpersistence.load_model(str(path)).baseline is None
    with pytest.raises(ValueError, match="baseline sidecar version"):
        monitor.Baseline.from_dict({"baselineVersion": 999})


# --------------------------------------------------------------------------- #
# the model's monitoring methods
# --------------------------------------------------------------------------- #


def test_model_monitoring_folds_scored_batches(mammography):
    X = mammography[0]
    model = load_model(str(FIXTURES["standard"] / "model"), device="cpu")
    mon = model.enable_monitoring(threshold=0.25)
    model.score(X)
    report = mon.report()
    assert report["rows"] == len(X) and report["score"]["psi"] < 0.1 and not report["drifted"]
    model.score(X * 3 + 5, fold_monitor=False)
    assert mon.rows == len(X)
    model.score(X * 3 + 5)
    assert mon.report()["drifted"] and degradation_report().count("drift_alert") >= 1
    assert telemetry.gauge("isoforest_score_drift_psi").value() > 0.25
    assert model.degradations()[0].reason == "drift_alert"
    assert model.rebind_monitoring() is mon and mon.rows == 0 and not mon.report()["drifted"]
    model.disable_monitoring()
    model.score(X)
    assert mon.rows == 0


# --------------------------------------------------------------------------- #
# the telemetry primitives the monitor reports through
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("labels", [(), ("stream",)])
def test_metrics_equal_the_jax_packages(labels):
    values = [0.0002, 0.003, 0.003, 0.07, 1.5, 45.0, 100.0]
    kw = {name: "score" for name in labels}
    got, want = [], []
    for mod, out in ((metrics, got), (jmetrics, want)):
        counter = mod.Counter("c_total", "help", labels)
        gauge = mod.Gauge("g", "help", labels)
        for v in values:
            counter.inc(v, **kw)
            gauge.set(v, **kw)
        gauge.dec(0.5, **kw)
        out.append((counter.snapshot(), gauge.snapshot(), counter.value(**kw), gauge.value(**kw)))
        with pytest.raises(ValueError):
            counter.inc(-1.0, **kw)
        with pytest.raises(ValueError):
            gauge.set(1.0, other="x")
    assert got == want
    with pytest.raises(ValueError, match="already registered"):
        metrics.gauge("isoforest_score_drift_psi", labelnames=("x",))


def test_events_and_the_switch_follow_the_jax_package():
    for mod in (events, jevents):
        mod.reset_events()
        first = mod.record_event("checkpoint.begin", directory="d")
        mod.record_event("drift.alert", stream="score")
        assert [e.kind for e in mod.get_events()] == ["checkpoint.begin", "drift.alert"]
        assert [e.kind for e in mod.get_events(since_seq=first.seq)] == ["drift.alert"]
        assert mod.get_events(kind="drift.alert")[0].as_dict()["stream"] == "score"
        mod.reset_events()
    timeline = events.EventTimeline(maxlen=2)
    for i in range(5):
        timeline.record("k", i=i)
    assert [e.fields["i"] for e in timeline.events()] == [3, 4] and timeline.dropped == 3
    _state.disable()
    try:
        assert telemetry.record_event("drift.alert") is None and telemetry.get_events() == []
        counter = telemetry.counter("isoforest_monitored_rows_total")
        counter.inc(5)
        assert counter.value() == 0.0
    finally:
        _state.enable()
