"""The port's stream engine (``isoforest_tpu_torch/stream``) on the CPU:
``tests/test_stream.py`` against the port, then the same stream through both
packages.

Event time on a FakeClock with no real sleeps: the watermark is a function
of the data (a stalled clock freezes it), out-of-order rows within the
lateness land in their windows, late rows are scored and counted but never
folded, empty windows close, sliding panes fold once, and the end of the
stream closes every window. The decay reservoir's kept set is the top keys
recomputed through ``keys_for``. The lifecycle loop runs end to end (a
regime shift, window-cadenced refits, validated swaps), and scores taken
while a swap is stalled are bit for bit the old or the new model's. Each
batch names the generation that scored it. Sources: CSV and shard tails on
an injected sleep, the generator adapter, and the TCP line protocol over
localhost (its own timeouts).

Parity: the same timed batches over the same model file give the JAX
package's fold, window, retrain and swap events and summary; window mean
scores within 2e-6 (the packages' float32 ``c(n)`` differs by a few ulps).
The JAX package's CLI cases wait for the port's CLI.
"""

from __future__ import annotations

import os
import socket
import threading

import numpy as np
import pytest

from isoforest_tpu_torch import IsolationForest, load_model, telemetry
from isoforest_tpu_torch.lifecycle import DataReservoir, DecayReservoir, ModelManager
from isoforest_tpu_torch.resilience import faults
from isoforest_tpu_torch.resilience.degradation import reset_degradations
from isoforest_tpu_torch.stream import (
    StreamBatch,
    StreamConfig,
    StreamEngine,
    generator_source,
    socket_source,
    tail_source,
)
from isoforest_tpu_torch.stream.sources import parse_lines, split_timed

N_TREES = 12
FEATURES = 3
SOCKET_TIMEOUT_S = 10


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.reset()
    reset_degradations()
    yield
    telemetry.reset()
    reset_degradations()


@pytest.fixture(scope="module")
def traffic():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(8000, FEATURES)).astype(np.float32)
    X[:80] += 5.0
    return X


@pytest.fixture(scope="module")
def incumbent(traffic):
    return IsolationForest(num_estimators=N_TREES, max_samples=64.0, random_seed=1, device="cpu").fit(traffic)


def _mgr(model, tmp_path, fc, **kw):
    kw.setdefault("window_rows", 4096)
    kw.setdefault("min_window_rows", 1)
    kw.setdefault("auto_retrain", False)
    kw.setdefault("background", False)
    return ModelManager(model, work_dir=str(tmp_path / "lc"), clock=fc.now, sleep=fc.sleep, **kw)


def _engine(mgr, fc, **cfg):
    cfg.setdefault("window_s", 60.0)
    cfg.setdefault("retrain_every", 10**6)  # windowing tests: no refits
    cfg.setdefault("linger_s", 0.0)
    return StreamEngine(mgr, StreamConfig(threaded=False, **cfg), clock=fc.now)


def _batch(ts, rng=None, value=None):
    ts = np.asarray(ts, np.float64)
    if value is not None:
        X = np.full((len(ts), FEATURES), value, np.float32)
    else:
        X = (rng or np.random.default_rng(0)).normal(size=(len(ts), FEATURES)).astype(np.float32)
    return StreamBatch(ts, X, None)


def _events(kind):
    return [e.as_dict() for e in telemetry.get_events() if e.kind == kind]


class TestDecayReservoir:
    def test_exact_membership_recomputed_from_public_keys(self):
        res = DecayReservoir(8, half_life_s=100.0, seed=42)
        rng = np.random.default_rng(0)
        ts_all = np.concatenate([np.sort(rng.uniform(i * 50, (i + 1) * 50, 10)) for i in range(3)])
        for i in range(3):
            X = np.zeros((10, 2), np.float32)
            X[:, 0] = np.arange(i * 10, (i + 1) * 10)
            res.fold(X, event_ts=ts_all[i * 10 : (i + 1) * 10])
        keys = DecayReservoir(8, half_life_s=100.0, seed=42).keys_for(0, ts_all)
        X_kept, _ = res.snapshot()
        assert set(X_kept[:, 0].astype(int).tolist()) == set(np.argsort(-keys)[:8].tolist())

    def test_deterministic_across_instances_and_seeds(self):
        def build(seed):
            r = DecayReservoir(16, half_life_s=50.0, seed=seed)
            rng = np.random.default_rng(1)
            for i in range(4):
                r.fold(rng.normal(size=(20, FEATURES)).astype(np.float32), event_ts=np.full(20, float(i * 100)))
            return r.snapshot()[0]

        np.testing.assert_array_equal(build(7), build(7))
        assert not np.array_equal(build(7), build(8))

    def test_recency_bias(self):
        res = DecayReservoir(100, half_life_s=10.0, seed=0)
        res.fold(np.zeros((1000, 2), np.float32), event_ts=np.full(1000, 0.0))
        res.fold(np.ones((1000, 2), np.float32), event_ts=np.full(1000, 200.0))
        X, _ = res.snapshot()
        assert X.shape[0] == 100 and (X[:, 0] == 1.0).sum() >= 95

    def test_scalar_ts_broadcast_and_clock_default(self):
        fc = faults.FakeClock()
        res = DecayReservoir(10, half_life_s=10.0, seed=0, clock=fc.now)
        res.fold(np.zeros((3, 2), np.float32), event_ts=[5.0])
        res.fold(np.ones((3, 2), np.float32))
        assert res.rows == 6
        res2 = DecayReservoir(10, half_life_s=10.0, seed=0)
        res2.fold(np.zeros((3, 2), np.float32), event_ts=[5.0])
        res2.fold(np.ones((3, 2), np.float32), event_ts=[fc.now()])
        np.testing.assert_array_equal(res.snapshot()[0], res2.snapshot()[0])

    def test_label_semantics_match_fifo(self):
        res = DecayReservoir(50, half_life_s=10.0, seed=0)
        X = np.zeros((20, 2), np.float32)
        X[:, 0] = np.arange(20)
        res.fold(X, y=np.arange(20.0), event_ts=np.full(20, 1.0))
        Xs, ys = res.snapshot()
        np.testing.assert_array_equal(Xs[:, 0], ys)
        res.fold(np.ones((5, 2), np.float32), event_ts=np.full(5, 2.0))
        assert res.snapshot()[1] is None
        res.fold(np.ones((5, 2), np.float32), y=np.ones(5), event_ts=[3.0])
        assert res.snapshot()[1] is None

    def test_snapshot_ordered_oldest_first(self):
        res = DecayReservoir(100, half_life_s=1000.0, seed=0)
        res.fold(np.full((5, 1), 2.0, np.float32), event_ts=np.full(5, 20.0))
        res.fold(np.full((5, 1), 1.0, np.float32), event_ts=np.full(5, 10.0))
        np.testing.assert_array_equal(res.snapshot()[0][:, 0], [1] * 5 + [2] * 5)

    def test_capacity_and_clear_advance_hash_stream(self):
        res = DecayReservoir(5, half_life_s=10.0, seed=0)
        res.fold(np.arange(20, dtype=np.float32).reshape(10, 2), event_ts=[1.0])
        assert res.rows == 5
        res.clear()
        assert res.rows == 0
        assert not np.array_equal(res.keys_for(0, np.full(10, 1.0)), res.keys_for(10, np.full(10, 1.0)))

    def test_validation_errors(self):
        with pytest.raises(ValueError, match="capacity"):
            DecayReservoir(0)
        with pytest.raises(ValueError, match="half_life_s"):
            DecayReservoir(4, half_life_s=0.0)
        res = DecayReservoir(4)
        with pytest.raises(ValueError, match="non-empty"):
            res.fold(np.empty((0, 2), np.float32))
        with pytest.raises(ValueError, match="labels"):
            res.fold(np.zeros((3, 2), np.float32), y=np.zeros(2))
        with pytest.raises(ValueError, match="event_ts"):
            res.fold(np.zeros((3, 2), np.float32), event_ts=[1.0, 2.0])
        res.fold(np.zeros((3, 2), np.float32), event_ts=[1.0])
        with pytest.raises(ValueError, match="width"):
            res.fold(np.zeros((3, 5), np.float32), event_ts=[1.0])

    def test_manager_selects_policy(self, incumbent, tmp_path):
        fc = faults.FakeClock()
        mgr = _mgr(incumbent, tmp_path, fc, reservoir="decay")
        try:
            assert isinstance(mgr.reservoir, DecayReservoir) and mgr.reservoir_mode == "decay"
            assert mgr.reservoir.seed == incumbent.params.random_seed
            assert mgr.state()["reservoir"] == "decay"
        finally:
            mgr.close()
        mgr = _mgr(incumbent, tmp_path / "b", fc, reservoir="fifo")
        try:
            assert isinstance(mgr.reservoir, DataReservoir)
        finally:
            mgr.close()
        with pytest.raises(ValueError, match="reservoir"):
            _mgr(incumbent, tmp_path / "c", fc, reservoir="lru")


class TestWindowing:
    def test_tumbling_close(self, incumbent, tmp_path):
        fc = faults.FakeClock()
        mgr = _mgr(incumbent, tmp_path, fc)
        eng = _engine(mgr, fc, lateness_s=0.0)
        try:
            eng.process(_batch(np.arange(0.0, 60.0, 2.0)))
            assert eng.windows_closed == 0
            eng.process(_batch([61.0]))
            assert eng.windows_closed == 1
            (ev,) = _events("stream.window_closed")
            assert (ev["start"], ev["end"], ev["rows"]) == (0.0, 60.0, 30)
            assert mgr.reservoir.rows == 30
            (fold,) = _events("stream.fold")
            assert fold["rows"] == 30 and fold["pane_end"] == 60.0
        finally:
            eng.close()
            mgr.close()

    def test_out_of_order_within_lateness_lands_in_window(self, incumbent, tmp_path):
        fc = faults.FakeClock()
        mgr = _mgr(incumbent, tmp_path, fc)
        eng = _engine(mgr, fc, lateness_s=15.0)
        try:
            eng.process(_batch([5.0, 15.0, 25.0, 35.0, 45.0, 55.0]))
            eng.process(_batch([70.0]))
            assert eng.watermark == 55.0 and eng.windows_closed == 0
            eng.process(_batch([58.0]))
            assert eng.late_rows == 0
            eng.process(_batch([80.0]))
            assert eng.windows_closed == 1
            (ev,) = _events("stream.window_closed")
            assert ev["rows"] == 7
        finally:
            eng.close()
            mgr.close()

    def test_late_rows_scored_counted_never_folded(self, incumbent, tmp_path):
        fc = faults.FakeClock()
        mgr = _mgr(incumbent, tmp_path, fc)
        eng = _engine(mgr, fc, lateness_s=0.0)
        try:
            eng.process(_batch([10.0, 20.0, 30.0]))
            eng.process(_batch([100.0]))
            folded = mgr.reservoir.rows
            eng.process(_batch([50.0]))
            assert eng.rows == 5 and eng.late_rows == 1
            assert mgr.reservoir.rows == folded
            (late,) = _events("stream.late")
            assert (late["rows"], late["watermark"], late["min_ts"], late["max_ts"]) == (1, 100.0, 50.0, 50.0)
        finally:
            eng.close()
            mgr.close()

    def test_empty_windows_close_and_count(self, incumbent, tmp_path):
        fc = faults.FakeClock()
        mgr = _mgr(incumbent, tmp_path, fc)
        eng = _engine(mgr, fc, lateness_s=0.0)
        try:
            eng.process(_batch([30.0]))
            eng.process(_batch([250.0]))
            assert eng.windows_closed == 4 and eng.empty_windows == 3
            evs = _events("stream.window_closed")
            assert [e["rows"] for e in evs] == [1, 0, 0, 0]
            assert evs[1]["mean_score"] is None
        finally:
            eng.close()
            mgr.close()

    def test_sliding_panes_fold_once(self, incumbent, tmp_path):
        fc = faults.FakeClock()
        mgr = _mgr(incumbent, tmp_path, fc)
        eng = _engine(mgr, fc, window_s=60.0, slide_s=30.0, lateness_s=0.0)
        try:
            eng.process(_batch([5.0] * 4))
            eng.process(_batch([35.0] * 6))
            eng.process(_batch([65.0] * 8))
            summary = eng.finish()
            assert len(_events("stream.fold")) == 3
            assert summary["folded_rows"] == 18 and mgr.reservoir.rows == 18
            evs = _events("stream.window_closed")
            assert [e["rows"] for e in evs] == [4, 10, 14, 8]
            assert [e["end"] for e in evs] == [30.0, 60.0, 90.0, 120.0]
        finally:
            mgr.close()

    def test_stalled_clock_watermark_frozen(self, incumbent, tmp_path):
        fc = faults.FakeClock()
        mgr = _mgr(incumbent, tmp_path, fc)
        eng = _engine(mgr, fc, lateness_s=0.0)
        try:
            eng.process(_batch([10.0, 50.0, 70.0]))
            assert eng.windows_closed == 1
            w, fresh0 = eng.watermark, eng.freshness_seconds()
            fc.advance(10_000.0)
            assert eng.drain() == 0
            assert eng.watermark == w and eng.windows_closed == 1
            assert eng.freshness_seconds() == pytest.approx(fresh0 + 10_000.0)
        finally:
            eng.close()
            mgr.close()

    def test_watermark_monotone(self, incumbent, tmp_path):
        fc = faults.FakeClock()
        mgr = _mgr(incumbent, tmp_path, fc)
        eng = _engine(mgr, fc, lateness_s=30.0)
        try:
            eng.process(_batch([100.0]))
            assert eng.watermark == 70.0
            eng.process(_batch([80.0]))
            assert eng.watermark == 70.0
        finally:
            eng.close()
            mgr.close()

    def test_finish_closes_everything_and_is_idempotent(self, incumbent, tmp_path):
        fc = faults.FakeClock()
        mgr = _mgr(incumbent, tmp_path, fc)
        eng = _engine(mgr, fc, lateness_s=120.0)
        try:
            eng.process(_batch(np.arange(0.0, 90.0, 10.0)))
            assert eng.windows_closed == 0
            summary = eng.finish()
            assert summary["windows_closed"] == 2 and summary["folded_rows"] == 9
            assert summary["watermark"] == 80.0 - 120.0
            (stop,) = _events("stream.stop")
            assert stop["windows_closed"] == 2
            assert eng.finish() == summary
            with pytest.raises(RuntimeError, match="finish"):
                eng.process(_batch([1.0]))
        finally:
            mgr.close()

    @pytest.mark.parametrize("kw,match", [(dict(window_s=0.0), "window_s"), (dict(window_s=60.0, slide_s=70.0),
                                          "slide_s"), (dict(window_s=60.0, slide_s=45.0), "whole multiple"),
                                          (dict(lateness_s=-1.0), "lateness_s"), (dict(retrain_every=0),
                                                                                  "retrain_every")])
    def test_config_validation(self, kw, match):
        with pytest.raises(ValueError, match=match):
            StreamConfig(**kw)

    def test_config_defaults(self):
        assert StreamConfig(window_s=60.0).slide_s == 60.0
        assert StreamConfig(window_s=60.0, slide_s=20.0).panes_per_window == 3

    def test_mismatched_batch_rejected(self, incumbent, tmp_path):
        fc = faults.FakeClock()
        mgr = _mgr(incumbent, tmp_path, fc)
        eng = _engine(mgr, fc)
        try:
            with pytest.raises(ValueError, match="timestamps"):
                eng.process(StreamBatch(np.zeros(2), np.zeros((3, FEATURES), np.float32), None))
        finally:
            eng.close()
            mgr.close()


class TestScoredBatches:
    def test_each_batch_names_the_generation_that_scored_it(self, incumbent, traffic, tmp_path):
        """Every ingested batch reaches ``on_scored`` with its scores (the
        manager's ``model.score`` of exactly its rows, one batch a flush)
        and the generation pinned with the model that scored it, across a
        swap; ``rows_by_generation`` sums them."""
        fc = faults.FakeClock()
        mgr = _mgr(incumbent, tmp_path, fc, min_window_rows=256, window_rows=2048, reservoir="decay")
        seen = []
        eng = StreamEngine(mgr, StreamConfig(window_s=60.0, lateness_s=0.0, retrain_every=1, threaded=False,
                                             linger_s=0.0, batch_rows=256),
                           clock=fc.now, on_scored=lambda b, s, g: seen.append((b, np.array(s), g)))
        models = {1: mgr.model}
        try:
            for k in range(4):
                eng.process(StreamBatch(np.full(300, k * 60.0 + 1.0), traffic[k * 300 : (k + 1) * 300], None))
                models.setdefault(mgr.generation, mgr.model)
            summary = eng.finish()
        finally:
            mgr.close()
        assert summary["swaps"] >= 1 and len(seen) == 4
        generations = [g for *_, g in seen]
        assert generations == sorted(generations) and generations[0] == 1 and len(set(generations)) >= 2
        for batch, scores, generation in seen:
            np.testing.assert_array_equal(scores, models[generation].score(batch.X).numpy())
        assert summary["rows_by_generation"] == {str(g): 300 * sum(1 for *_, h in seen if h == g)
                                                 for g in sorted({g for *_, g in seen})}
        assert sum(summary["rows_by_generation"].values()) == 1200


class TestLifecycleLoop:
    def test_min_window_rows_defers_retrain_without_losing_cadence(self, incumbent, traffic, tmp_path):
        fc = faults.FakeClock()
        mgr = _mgr(incumbent, tmp_path, fc, min_window_rows=250, reservoir="decay")
        eng = _engine(mgr, fc, retrain_every=1, lateness_s=0.0)
        try:
            for k in range(3):
                ts = k * 60.0 + np.linspace(0.0, 59.0, 100)
                eng.process(StreamBatch(ts, traffic[k * 100 : (k + 1) * 100], None))
            eng.process(_batch([200.0]))
            assert eng.windows_closed == 3
            assert len(_events("stream.retrain")) == 1
            assert mgr.generation == 2
        finally:
            eng.close()
            mgr.close()

    def test_regime_shift_drives_unattended_swaps(self, incumbent, traffic, tmp_path):
        fc = faults.FakeClock()
        mgr = _mgr(incumbent, tmp_path, fc, min_window_rows=256, window_rows=2048, mode="sliding",
                   reservoir="decay")
        eng = _engine(mgr, fc, retrain_every=2, lateness_s=5.0)
        try:
            summary = eng.run(generator_source(_shifted_batches(traffic)))
            assert summary["windows_closed"] == 6 and summary["late_rows"] == 0
            assert summary["folded_rows"] == 3600
            assert summary["swaps"] >= 2
            assert summary["generation"] == summary["swaps"] + 1
            assert summary["retrain_outcomes"] == {"swapped": summary["swaps"]}
            assert summary["reservoir"] == "decay"
            swaps = _events("stream.swap")
            assert len(swaps) == summary["swaps"]
            assert all(os.path.isdir(s["path"]) for s in swaps)
            assert any(s["window_end"] > 180.0 for s in swaps)
            assert [r["outcome"] for r in _events("stream.retrain")] == ["swapped"] * summary["swaps"]
        finally:
            mgr.close()

    def test_swap_stalled_mid_flight_scores_bitwise_old_or_new(self, incumbent, traffic, tmp_path):
        probe = np.ascontiguousarray(traffic[:256])
        old_scores = incumbent.score(probe).numpy()
        swap_entered, swap_release = threading.Event(), threading.Event()

        def slow_swap():
            swap_entered.set()
            assert swap_release.wait(timeout=300)

        recorded = []

        class RecordingManager(ModelManager):
            def score(self, X, **kw):
                out = super().score(X, **kw)
                scores = out[0] if isinstance(out, tuple) else out
                recorded.append(scores.numpy().copy())
                return out

        mgr = RecordingManager(incumbent, work_dir=str(tmp_path / "lc"), window_rows=2048, min_window_rows=256,
                               auto_retrain=False, background=True, hooks={"mid_swap": slow_swap},
                               reservoir="decay")
        eng = StreamEngine(mgr, StreamConfig(window_s=60.0, lateness_s=0.0, retrain_every=1, threaded=False,
                                             linger_s=0.0, batch_rows=256, wait_retrain=False))
        try:
            for k in range(2):
                eng.process(StreamBatch(np.full(256, k * 60.0), probe, None))
            assert swap_entered.wait(timeout=300)
            before_release = len(recorded)
            for k in range(2, 5):
                eng.process(StreamBatch(np.full(256, k * 60.0), probe, None))
            eng.drain()
            assert len(recorded) > before_release
            swap_release.set()
            assert mgr.wait_retrain(timeout_s=300)
            eng.finish()
            assert mgr.generation == 2
            new_scores = mgr.model.score(probe).numpy()
            assert not np.array_equal(old_scores, new_scores)
            torn = [s for s in recorded if not (np.array_equal(s, old_scores) or np.array_equal(s, new_scores))]
            assert not torn, f"{len(torn)} batch(es) saw a torn forest"
        finally:
            swap_release.set()
            mgr.close()


def _shifted_batches(traffic):
    """Six 60 s windows of 600 rows; the last three shifted by 3 standard
    deviations per feature."""
    shift = 3.0 * np.std(traffic, axis=0, keepdims=True)
    for k in range(6):
        X = traffic[k * 600 : (k + 1) * 600].copy()
        if k >= 3:
            X += shift
        yield StreamBatch(k * 60.0 + np.linspace(0.0, 59.9, 600), X, None)


class TestSources:
    def test_split_timed_and_parse_lines(self):
        b = split_timed(np.array([[1.5, 2.0, 3.0], [2.5, 4.0, 5.0]]), False)
        np.testing.assert_array_equal(b.ts, [1.5, 2.5])
        assert b.X.dtype == np.float32 and b.y is None
        b = parse_lines(["1.5,2,3,1", "2.5,4,5,0"], True)
        np.testing.assert_array_equal(b.y, [1.0, 0.0])
        assert b.X.shape == (2, 2) and b.ts.dtype == np.float64
        with pytest.raises(ValueError, match="columns"):
            split_timed(np.array([[1.0, 2.0]]), True)

    def test_generator_source_adapts_shapes(self):
        sb = StreamBatch(np.r_[1.0], np.zeros((1, 2), np.float32), None)
        items = [sb, (np.r_[2.0], np.ones((1, 2))), (np.r_[3.0], np.ones((1, 2)), np.r_[1.0]),
                 np.array([[4.0, 5.0, 6.0]])]
        out = list(generator_source(items))
        assert [float(b.ts[0]) for b in out] == [1.0, 2.0, 3.0, 4.0]
        assert out[0] is sb
        assert out[2].y is not None and out[1].y is None

    def test_tail_csv_follow_partial_lines_injected_sleep(self, tmp_path):
        path = tmp_path / "s.csv"
        path.write_text("1,1.0\n2,2.0\n# comment\n3,3.")
        stopped = []

        def fake_sleep(_):
            if not stopped:
                with open(path, "a") as fh:
                    fh.write("5\n4,4.0\n")
                stopped.append(True)

        batches = list(tail_source(str(path), follow=True, chunk_rows=2, sleep=fake_sleep,
                                   stop=lambda: len(stopped) > 0))
        np.testing.assert_array_equal(np.concatenate([b.ts for b in batches]), [1.0, 2.0, 3.0, 4.0])
        np.testing.assert_allclose(np.concatenate([b.X for b in batches])[:, 0], [1.0, 2.0, 3.5, 4.0])

    def test_tail_csv_non_follow_flushes_trailing_fragment(self, tmp_path):
        path = tmp_path / "s.csv"
        path.write_text("1,1.0\n2,2.0")
        batches = list(tail_source(str(path), chunk_rows=100))
        np.testing.assert_array_equal(np.concatenate([b.ts for b in batches]), [1.0, 2.0])

    def test_shard_dir_sorted_then_new_shards(self, tmp_path):
        d = tmp_path / "shards"
        d.mkdir()
        (d / "b.csv").write_text("2,2.0\n")
        (d / "a.csv").write_text("1,1.0\n")
        np.save(d / "c.npy", np.array([[3.0, 3.0]]))
        polls = []

        def fake_sleep(_):
            if not polls:
                (d / "d.csv").write_text("4,4.0\n")
            polls.append(True)

        batches = list(tail_source(str(d), follow=True, chunk_rows=10, sleep=fake_sleep,
                                   stop=lambda: len(polls) > 1))
        np.testing.assert_array_equal(np.concatenate([b.ts for b in batches]), [1.0, 2.0, 3.0, 4.0])

    def test_missing_source_raises_without_follow(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="matched no files"):
            list(tail_source(str(tmp_path / "nope.csv")))
        with pytest.raises(FileNotFoundError, match="matched no files"):
            list(tail_source(str(tmp_path / "nope-dir")))

    def test_float32_shard_formats_rejected(self, tmp_path):
        d = tmp_path / "shards"
        d.mkdir()
        (d / "x.avro").write_bytes(b"Obj\x01junk")
        with pytest.raises(ValueError, match="float32 record formats"):
            list(tail_source(str(d)))

    def test_socket_source_line_protocol(self):
        done = threading.Event()
        feed = socket_source(0, chunk_rows=10, idle_s=0.02, should_stop=done.is_set)
        try:
            with socket.create_connection(("127.0.0.1", feed.port), timeout=SOCKET_TIMEOUT_S) as s:
                s.sendall(b"1.5,1.0,2.0\n# comment\n2.5,3.0,4.0\n")
            out = []
            for b in feed.batches():
                out.append(b)
                if sum(x.rows for x in out) >= 2:
                    done.set()
            np.testing.assert_array_equal(np.sort(np.concatenate([b.ts for b in out])), [1.5, 2.5])
        finally:
            done.set()
            feed.stop()

    def test_socket_rows_score_as_the_generator_rows(self, incumbent, traffic, tmp_path):
        """The same timed rows over the TCP line protocol and through the
        generator adapter give the same windows and scores."""
        ts = np.linspace(0.0, 119.0, 200)
        rows = traffic[:200].astype(np.float64)
        lines = "".join(",".join(repr(float(v)) for v in (t, *r)) + "\n" for t, r in zip(ts, rows)).encode()
        outs = []
        for name in ("generator", "socket"):
            fc = faults.FakeClock()
            mgr = _mgr(incumbent, tmp_path / name, fc)
            got = []
            eng = StreamEngine(mgr, StreamConfig(window_s=60.0, retrain_every=10**6, threaded=False, linger_s=0.0),
                               clock=fc.now, on_scored=lambda b, s, g: got.append((b.ts.copy(), np.array(s))))
            try:
                if name == "generator":
                    summary = eng.run(generator_source([np.column_stack([ts, rows])]))
                else:
                    done = threading.Event()
                    feed = socket_source(0, chunk_rows=200, idle_s=0.05, should_stop=done.is_set)
                    with socket.create_connection(("127.0.0.1", feed.port), timeout=SOCKET_TIMEOUT_S) as s:
                        s.sendall(lines)
                    received = []
                    for b in feed.batches():
                        received.append(b)
                        if sum(x.rows for x in received) >= 200:
                            done.set()
                    summary = eng.run(generator_source(received))
            finally:
                mgr.close()
            order = np.argsort(np.concatenate([t for t, _ in got]), kind="stable")
            outs.append((summary["windows_closed"], summary["folded_rows"],
                         np.concatenate([s for _, s in got])[order]))
        assert outs[0][:2] == outs[1][:2] == (2, 200)
        np.testing.assert_allclose(outs[0][2], outs[1][2], rtol=2.5e-7, atol=0)


# -- parity with the JAX package ----------------------------------------------


def _stream_trace(manager_cls, engine_cls, config_cls, source, fault_mod, tel, model, traffic, work):
    fc = fault_mod.FakeClock()
    mgr = manager_cls(model, work_dir=str(work), clock=fc.now, sleep=fc.sleep, window_rows=2048, min_window_rows=256,
                      auto_retrain=False, background=False, mode="sliding", reservoir="decay")
    eng = engine_cls(mgr, config_cls(window_s=60.0, lateness_s=5.0, retrain_every=2, threaded=False, linger_s=0.0),
                     clock=fc.now)
    try:
        summary = eng.run(source(_shifted_batches(traffic)))
    finally:
        mgr.close()
    events = [(e.kind, dict(e.fields)) for e in tel.get_events() if e.kind.startswith("stream.")]
    return summary, events


def test_the_same_stream_folds_closes_and_swaps_as_the_jax_package(traffic, tmp_path):
    """Both packages over the same model file and the same six shifted
    windows: the same ``stream.*`` events in the same order (window means
    within 2e-6, paths aside) and the same summary (lag, RSS and the
    port's per-generation counts aside)."""
    from isoforest_tpu import IsolationForest as JaxForest
    from isoforest_tpu import telemetry as jax_telemetry
    from isoforest_tpu.lifecycle import ModelManager as JaxManager
    from isoforest_tpu.resilience import faults as jax_faults
    from isoforest_tpu.stream import StreamConfig as JaxConfig
    from isoforest_tpu.stream import StreamEngine as JaxEngine
    from isoforest_tpu.stream import generator_source as jax_generator_source

    path = str(tmp_path / "model")
    JaxForest(num_estimators=N_TREES, max_samples=64.0, random_seed=1).fit(traffic).save(path)
    from isoforest_tpu import IsolationForestModel as JaxModel

    jax_telemetry.reset()
    try:
        want = _stream_trace(JaxManager, JaxEngine, JaxConfig, jax_generator_source, jax_faults, jax_telemetry,
                             JaxModel.load(path), traffic, tmp_path / "jax")
    finally:
        jax_telemetry.reset()
    got = _stream_trace(ModelManager, StreamEngine, StreamConfig, generator_source, faults, telemetry,
                        load_model(path, device="cpu"), traffic, tmp_path / "port")

    def strip(events):
        out = []
        for kind, fields in events:
            fields = {k: v for k, v in fields.items() if k not in ("path", "mean_score")}
            out.append((kind, fields))
        return out

    assert strip(got[1]) == strip(want[1])
    means = [(f.get("mean_score"), g.get("mean_score")) for (_, f), (_, g) in zip(got[1], want[1])]
    for mine, theirs in means:
        assert (mine is None) == (theirs is None)
        if mine is not None:
            assert abs(mine - theirs) <= 2e-6
    skip = ("rss_trajectory", "peak_rss_bytes", "lag_p99_s", "freshness_seconds", "rows_by_generation")
    assert {k: v for k, v in got[0].items() if k not in skip} == {k: v for k, v in want[0].items() if k not in skip}
    assert got[0]["swaps"] >= 2
