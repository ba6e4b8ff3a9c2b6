"""The port's measured autotuner and cost model (``isoforest_tpu_torch/tuning``),
on the CPU, mirroring ``tests/test_autotune.py`` where the port has the
feature.

The tuner is bypassed for the rest of the suite (``ISOFOREST_TPU_AUTOTUNE=0``
in ``tests/conftest.py``); each test here turns it on against its own
table. Autotuning never changes scores: ``auto`` is bitwise equal to the
explicitly named winner.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import isoforest_tpu.tuning as jax_tuning
import isoforest_tpu_torch.tuning as tuning
from isoforest_tpu.ops.ext_growth import ExtendedForest as JaxExtForest
from isoforest_tpu.ops.tree_growth import StandardForest as JaxForest
from isoforest_tpu_torch import ExtendedIsolationForest, IsolationForest, score_matrix, telemetry
from isoforest_tpu_torch.io.interop import forest_from_arrays
from isoforest_tpu_torch.ops.traversal import _SCORED_ROWS_TOTAL, _SCORING_SECONDS, batch_bucket
from isoforest_tpu_torch.resilience import faults
from isoforest_tpu_torch.resilience.degradation import DegradationError, degradation_report, reset_degradations
from isoforest_tpu_torch.tuning import autotuner


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(700, 5)).astype(np.float32)
    X[:20] += 3.5
    std = IsolationForest(num_estimators=12, max_samples=64.0, random_seed=7, device="cpu").fit(X)
    ext = ExtendedIsolationForest(num_estimators=12, max_samples=64.0, random_seed=7, extension_level=1,
                                  device="cpu").fit(X)
    return X, std, ext


@pytest.fixture
def autotune(tmp_path, monkeypatch):
    """The tuner on, against an isolated table, with cheap probes."""
    path = tmp_path / "table.json"
    monkeypatch.setenv("ISOFOREST_TPU_AUTOTUNE", "1")
    monkeypatch.setenv("ISOFOREST_TPU_AUTOTUNE_PATH", str(path))
    monkeypatch.setenv("ISOFOREST_TPU_AUTOTUNE_REPS", "1")
    monkeypatch.setenv("ISOFOREST_TPU_AUTOTUNE_PROBE_ROWS", "512")
    monkeypatch.delenv("ISOFOREST_TPU_STRATEGY", raising=False)
    telemetry.enable()
    tuning.reset_cost_model()
    yield path
    tuning.reset_cost_model()


def _decision_events():
    return telemetry.get_events("autotune.decision")


def _resolve(model, X, **kw):
    return tuning.resolve_decision(model.forest, X, model.num_samples, cache=model._cache, **kw)


class TestKeys:
    def test_batch_bucket_edges(self):
        assert [batch_bucket(n) for n in (0, 1, 1024, 1025, 2048, 2049)] == [1024, 1024, 1024, 2048, 2048, 4096]

    def test_batch_bucket_keys_split_at_pow2(self, models):
        _, std, _ = models
        k = lambda n: tuning.decision_key("cuda", std.forest, n, 5)  # noqa: E731
        assert k(1) == k(1024)
        assert k(2048) != k(2049)
        assert "b2048" in k(2048) and "b4096" in k(2049)

    def test_feature_dtype_boundary_keys(self, models):
        _, std, _ = models
        k = lambda f: tuning.decision_key("cuda", std.forest, 1024, f)  # noqa: E731
        assert "i8" in k(128) and "i16" in k(129)
        assert "i16" in k(32768) and "i32" in k(32769)

    @pytest.mark.parametrize("rows", [1, 1025, 70_000])
    @pytest.mark.parametrize("width", [5, 129, 40_000])
    def test_key_equals_the_jax_packages(self, models, rows, width):
        """The same forest, batch and width key alike in both packages, but
        for the platform string, the ``|q16`` facet included."""
        _, std, ext = models
        jax_std = JaxForest(*(a.numpy() for a in std.forest))
        jax_ext = JaxExtForest(*(a.numpy() for a in ext.forest))
        for port, jax in ((std.forest, jax_std), (ext.forest, jax_ext)):
            want = jax_tuning.decision_key("cpu", jax, rows, width)
            assert want.endswith("|q16")
            assert tuning.decision_key("cpu", port, rows, width) == want
            assert tuning.decision_key("cuda", port, rows, width) == want.replace("|cpu|", "|cuda|")
            assert tuning.model_bucket(port, width) == jax_tuning.model_bucket(jax, width)

    def test_extended_key_separation(self, models):
        _, std, ext = models
        assert tuning.decision_key("cuda", std.forest, 1024, 5).endswith("|std|q16")
        assert tuning.decision_key("cuda", ext.forest, 1024, 5).endswith("|ext|q16")
        assert "k2" in tuning.model_bucket(ext.forest, 5)


class TestEligibility:
    def test_pool_is_walk_then_dense(self, models):
        """The card pools the two kernels; the CPU adds ``q16`` for forests
        inside its fences."""
        _, std, ext = models
        for forest in (std.forest, ext.forest):
            assert tuning.eligible_strategies(forest, "cuda") == ("walk", "dense")
            assert tuning.eligible_strategies(forest, "cpu") == ("walk", "dense", "q16")

    def test_dense_height_fence(self):
        from isoforest_tpu_torch.ops.dense import DENSE_MAX_HEIGHT

        for h, pool in ((DENSE_MAX_HEIGHT, ("walk", "dense")), (DENSE_MAX_HEIGHT + 1, ("walk",))):
            m = 2 ** (h + 1) - 1
            forest = forest_from_arrays(np.full((1, m), -1, np.int32), np.zeros((1, m), np.float32),
                                        np.full((1, m), 1, np.int32), device="cpu")
            assert tuning.eligible_strategies(forest, "cuda") == pool
            assert tuning.eligible_strategies(forest, "cpu") == pool + ("q16",)

    def test_ties_go_to_the_walk(self, models, autotune, monkeypatch):
        X, std, _ = models
        monkeypatch.setattr(autotuner, "_probe", lambda *a, **k: {"walk": 1.0, "dense": 1.0})
        assert _resolve(std, X).strategy == "walk"


class TestResolutionAndParity:
    def test_probe_then_table_and_bitwise_parity(self, models, autotune):
        X, std, ext = models
        for model in (std, ext):
            d1 = _resolve(model, X)
            assert d1.source == "probe" and set(d1.timings_s) == {"walk", "dense", "q16"}
            d2 = _resolve(model, X)
            assert d2.source == "table" and d2.strategy == d1.strategy
            s_auto = model.score(X, strategy="auto")
            s_win = model.score(X, strategy=d1.strategy)
            assert np.array_equal(s_auto.numpy(), s_win.numpy())

    @pytest.mark.parametrize("winner", ["walk", "dense", "q16"])
    def test_auto_scores_equal_the_winners(self, models, autotune, monkeypatch, winner):
        X, _, ext = models
        monkeypatch.setattr(autotuner, "_probe", lambda forest, Xp, n, eligible, cache=None: {
            s: (1e-6 if s == winner else 1.0) for s in eligible})
        assert _resolve(ext, X).strategy == winner
        assert np.array_equal(ext.score(X).numpy(), ext.score(X, strategy=winner).numpy())

    def test_probe_rows_bounded_by_bucket_chunk_and_cap(self, models, autotune, monkeypatch):
        X, std, _ = models
        seen = []
        monkeypatch.setattr(autotuner, "_probe", lambda forest, Xp, n, eligible, cache=None: (
            seen.append((tuple(Xp.shape), Xp.device.type)) or {s: 1.0 for s in eligible}))
        _resolve(std, X[:3])  # bucket 1024 > cap 512
        monkeypatch.setenv("ISOFOREST_TPU_AUTOTUNE_PROBE_ROWS", "1000000")
        _resolve(std, X[:3], refresh=True)  # the batch's 3 rows tiled to its bucket
        _resolve(std, X, chunk_rows=300, refresh=True)  # the chunk bounds it
        assert seen == [((512, 5), "cpu"), ((1024, 5), "cpu"), ((300, 5), "cpu")]

    def test_table_persisted_and_valid(self, models, autotune):
        X, std, _ = models
        d = _resolve(std, X)
        doc = json.loads(autotune.read_text())
        assert doc["schema"] == tuning.SCHEMA_VERSION
        assert doc["entries"][d.key]["strategy"] == d.strategy
        assert set(doc["entries"][d.key]["timings_s"]) == {"walk", "dense", "q16"}
        assert doc["entries"][d.key]["probe_rows"] == 512

    def test_ttl_expiry_reprobes(self, models, autotune):
        X, std, _ = models
        d1 = _resolve(std, X)
        doc = json.loads(autotune.read_text())
        doc["entries"][d1.key]["unix_s"] -= tuning.ttl_s() + 10
        autotune.write_text(json.dumps(doc))
        tuning.reset_cost_model()
        d2 = _resolve(std, X)
        assert d2.source == "probe" and d2.refresh
        ev = _decision_events()[-1]
        assert ev.fields["source"] == "probe" and ev.fields.get("refresh") is True

    def test_forced_refresh_reprobes(self, models, autotune):
        X, std, _ = models
        _resolve(std, X)
        d = _resolve(std, X, refresh=True)
        assert d.source == "probe" and d.refresh

    def test_pin_beats_table(self, models, autotune, monkeypatch):
        X, std, _ = models
        assert _resolve(std, X).source == "probe"
        monkeypatch.setenv("ISOFOREST_TPU_STRATEGY", "dense")
        d = _resolve(std, X)
        assert (d.strategy, d.source) == ("dense", "pin")
        assert np.array_equal(std.score(X).numpy(), std.score(X, strategy="dense").numpy())

    @pytest.mark.parametrize("pin", ["gather", "native", "pallas", "q4"])
    def test_unknown_pin_takes_env_strategy_unknown_rung(self, models, autotune, monkeypatch, pin):
        X, std, _ = models
        reset_degradations("env_strategy_unknown")
        monkeypatch.setenv("ISOFOREST_TPU_STRATEGY", pin)
        monkeypatch.setenv("ISOFOREST_TPU_AUTOTUNE", "0")
        d = _resolve(std, X)
        assert (d.strategy, d.source) == ("walk", "fallback")
        rungs = {e.reason: e for e in degradation_report().events()}
        assert pin in rungs["env_strategy_unknown"].detail and rungs["env_strategy_unknown"].to == "walk"
        assert np.array_equal(std.score(X).numpy(), std.score(X, strategy="walk").numpy())
        with pytest.raises(DegradationError, match="env_strategy_unknown"):
            std.score(X, strict=True)
        reset_degradations("env_strategy_unknown")

    def test_disabled_resolves_static_default(self, models, autotune, monkeypatch):
        X, std, _ = models
        monkeypatch.setenv("ISOFOREST_TPU_AUTOTUNE", "0")
        d = _resolve(std, X)
        assert (d.strategy, d.source) == ("walk", "fallback")
        assert not autotune.exists()

    def test_a_probe_that_raises_propagates(self, models, autotune):
        X, std, _ = models
        with faults.inject(raise_strategy="dense"):
            with pytest.raises(faults.FaultInjectedError, match="dense"):
                std.score(X)
        assert not autotune.exists()  # nothing was chosen, nothing persisted

    def test_warmup_builds_each_buckets_decision(self, models, autotune):
        _, std, _ = models
        std.warmup((1, 64, 3000))
        keys = set(json.loads(autotune.read_text())["entries"])
        assert keys == {tuning.decision_key("cpu", std.forest, n, 5) for n in (1, 3000)}
        before = len(_decision_events())
        std.score(np.zeros((64, 5), np.float32))
        assert [e.fields["source"] for e in _decision_events()[before:]] == ["table"]
        with pytest.raises(ValueError, match="width"):
            type(std)(std.forest, std.params, std.num_samples, std.num_features).warmup()


class TestCorruptTable:
    @pytest.mark.parametrize("payload", [
        "{not json",
        json.dumps({"schema": 0, "entries": {}}),
        json.dumps([1, 2, 3]),
        json.dumps({"schema": 1}),
    ])
    def test_refused_with_clean_rebuild(self, models, autotune, payload):
        X, std, _ = models
        autotune.write_text(payload)
        tuning.reset_cost_model()
        d = _resolve(std, X)
        assert d.source == "probe"
        doc = json.loads(autotune.read_text())
        assert doc["schema"] == tuning.SCHEMA_VERSION
        assert doc["entries"][d.key]["strategy"] == d.strategy

    def test_invalid_entries_dropped(self, models, autotune):
        X, std, _ = models
        key = tuning.decision_key("cpu", std.forest, len(X), 5)
        autotune.write_text(json.dumps({"schema": 1, "entries": {key: {"strategy": 123}}}))
        tuning.reset_cost_model()
        assert tuning.cost_model().lookup(key)[0] is None

    def test_default_path_is_the_ports_own(self, monkeypatch):
        monkeypatch.delenv("ISOFOREST_TPU_AUTOTUNE_PATH", raising=False)
        assert tuning.table_path().name == "isoforest_tpu_torch_autotune.json"
        assert tuning.table_path() != jax_tuning.table_path()


class TestDecisionTelemetry:
    def test_exactly_one_event_and_tick_per_resolution(self, models, autotune):
        X, std, _ = models
        before_ev = len(_decision_events())
        before = tuning.decision_counts()
        score_matrix(std.forest, X, std.num_samples, strategy="auto", device="cpu", cache=std._cache)
        score_matrix(std.forest, X, std.num_samples, strategy="auto", device="cpu", cache=std._cache)
        events = _decision_events()[before_ev:]
        assert [e.fields["source"] for e in events] == ["probe", "table"]
        assert all(e.fields["site"] == "score_matrix" for e in events)
        after = tuning.decision_counts()
        assert after["probe"] - before["probe"] == 1 and after["table"] - before["table"] == 1

    def test_explicit_strategy_emits_no_decision(self, models, autotune):
        X, std, _ = models
        before = len(_decision_events())
        std.score(X, strategy="dense")
        assert len(_decision_events()) == before

    def test_probe_timings_kept_out_of_the_scoring_series(self, models, autotune):
        X, std, _ = models
        before = {s: (_SCORED_ROWS_TOTAL.value(strategy=s), _SCORING_SECONDS.summary(strategy=s)["count"])
                  for s in ("walk", "dense", "q16")}
        assert _resolve(std, X).source == "probe"
        after = {s: (_SCORED_ROWS_TOTAL.value(strategy=s), _SCORING_SECONDS.summary(strategy=s)["count"])
                 for s in ("walk", "dense", "q16")}
        assert after == before
