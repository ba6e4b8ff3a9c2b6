"""The port's model lifecycle (``isoforest_tpu_torch/lifecycle``) on the CPU:
the JAX package's ``tests/test_lifecycle.py`` scenarios on the port, and
its reservoirs and gates against the JAX package's.

Tolerances: the refit, the sliding refresh, the rollbacks and the swap under
load are bitwise (``torch.equal``): the CPU runs each kernel's plain version
and a refit is deterministic. The reservoirs equal the JAX package's
exactly. ``validate_candidate`` of the same two model files in each package
gives the same verdicts, and values within 1e-5: the packages' scores differ
by up to 2e-6 and the gates round to 6 places. No real sleep: the retry runs
on a FakeClock, the stalled swap waits on an event.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from isoforest_tpu import IsolationForestModel as JaxModel
from isoforest_tpu.lifecycle import validation as jax_validation
from isoforest_tpu.lifecycle import window as jax_window
from isoforest_tpu_torch import ExtendedIsolationForest, IsolationForest, lifecycle, load_model, telemetry
from isoforest_tpu_torch.lifecycle import (
    DataReservoir,
    DecayReservoir,
    ModelManager,
    ValidationGates,
    retrain_seed,
    validate_candidate,
)
from isoforest_tpu_torch.resilience import faults
from isoforest_tpu_torch.resilience.degradation import reset_degradations
from isoforest_tpu_torch.resilience.retry import RetryPolicy
from isoforest_tpu_torch.telemetry.monitor import capture_baseline
from isoforest_tpu_torch.testing import torch_threads

N_TREES = 12
BLOCK = 4  # three refit blocks: a kill lands mid-refit


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.reset()
    telemetry.reset_resources()
    reset_degradations()
    yield
    telemetry.mark_warmup()
    telemetry.reset()
    telemetry.reset_resources()
    reset_degradations()


@pytest.fixture(scope="module")
def kddcup():
    """KDDCup-like rows and the 3-sigma covariate shift of the JAX package's test."""
    from isoforest_tpu.data import kddcup_http_hard

    X, y = kddcup_http_hard(n=20000, seed=7)
    return X, y, X + 3.0 * np.std(X, axis=0, keepdims=True)


@pytest.fixture(scope="module")
def incumbent_dir(kddcup, tmp_path_factory):
    """The incumbent, fitted once and saved: each test loads its own copy."""
    path = str(tmp_path_factory.mktemp("incumbent") / "model")
    IsolationForest(num_estimators=N_TREES, max_samples=64.0, random_seed=1, device="cpu").fit(kddcup[0]).save(path)
    return path


def _incumbent(path):
    return load_model(path, device="cpu")


def _manager(model, tmp_path, **kw):
    fc = faults.FakeClock()
    kw.setdefault("drift_debounce", 2)
    kw.setdefault("window_rows", 6144)
    kw.setdefault("min_window_rows", 1024)
    kw.setdefault("checkpoint_every", BLOCK)
    kw.setdefault("retry_policy", RetryPolicy(max_attempts=3, base_delay_s=0.25))
    mgr = ModelManager(model, work_dir=str(tmp_path / "lifecycle"), clock=fc.now, sleep=fc.sleep, **kw)
    mgr._fake_clock = fc
    return mgr


def _serve_shifted(mgr, shifted, batches=8, until=lambda m: m.generation > 1):
    for i in range(batches):
        mgr.score(shifted[i * 1024 : (i + 1) * 1024])
        if until(mgr):
            return i
    return None


def _forests_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


# --------------------------------------------------------------------------- #
# the chaos proof and the rollbacks
# --------------------------------------------------------------------------- #


def test_drift_kill_resume_validate_swap_bitwise(kddcup, incumbent_dir, tmp_path):
    X, _, shifted = kddcup
    model = _incumbent(incumbent_dir)
    mgr = _manager(model, tmp_path, background=True, window_rows=2048)
    try:
        for i in range(3):
            mgr.score(X[i * 1024 : (i + 1) * 1024])
        assert mgr.generation == 1 and mgr.state()["retrains"] == {}
        with faults.inject(kill_retrain_after_block=1):
            _serve_shifted(mgr, shifted)
            assert mgr.wait_retrain(timeout_s=300)
        assert mgr.generation == 2 and mgr.state()["retrains"] == {"swapped": 1}
        trail = [(e.fields["index"], e.fields["resumed"]) for e in telemetry.get_events(kind="retrain.block")]
        assert trail == [(0, False), (1, False), (0, True), (1, True), (2, False)]
        assert telemetry.get_events(kind="retry.attempt") and mgr._fake_clock.sleeps
        kinds = [e.kind for e in telemetry.get_events() if e.kind.startswith("retrain.")]
        assert kinds[0] == "retrain.start" and kinds[-1] == "retrain.swap" and "retrain.validate" in kinds
        assert telemetry.get_events(kind="retrain.validate")[-1].fields["passed"] is True

        info = mgr.last_retrain
        assert info["outcome"] == "swapped" and info["seed"] == retrain_seed(model.params.random_seed, 2)
        comparator = IsolationForest(params=model.params.replace(random_seed=info["seed"]),
                                     device="cpu").fit(info["window"])
        probe = shifted[:2048]
        assert _forests_equal(mgr.model.forest, comparator.forest)
        assert torch.equal(mgr.model.score(probe), comparator.score(probe)), "resumed refit != uninterrupted"
        assert mgr.model.device.type == "cpu"

        assert telemetry.gauge("isoforest_model_generation").value() == 2.0
        for i in range(4):
            mgr.score(shifted[i * 1024 : (i + 1) * 1024])
        assert mgr.monitor.drift()["score"]["psi"] < mgr.monitor.threshold
        assert telemetry.gauge("isoforest_score_drift_psi").value() < mgr.monitor.threshold

        current = json.load(open(os.path.join(mgr.work_dir, "CURRENT.json")))
        assert current == {"generation": 2, "path": os.path.join(mgr.work_dir, "gen-00002"),
                           "swapped_unix_s": mgr.last_swap_unix_s}
        assert os.path.exists(os.path.join(current["path"], "_MANIFEST.json"))
        assert torch.equal(load_model(current["path"], device="cpu").score(probe), mgr.model.score(probe))
        assert not os.path.exists(os.path.join(mgr.work_dir, "retrain", "r0001")), "spent checkpoints stay"
        counter = telemetry.counter("isoforest_retrain_total", labelnames=("outcome",))
        assert counter.value(outcome="swapped") == 1.0
        assert mgr.last_swap_lock_hold_s is not None and mgr.last_swap_lock_hold_s >= 0.0
    finally:
        mgr.close()


def test_forced_validation_failure_rolls_back(kddcup, incumbent_dir, tmp_path):
    _, _, shifted = kddcup
    model = _incumbent(incumbent_dir)
    mgr = _manager(model, tmp_path, background=False)
    try:
        probe = shifted[:2048]
        before = model.score(probe)
        with faults.inject(fail_validation=True):
            _serve_shifted(mgr, shifted, until=lambda m: m.state()["retrains"])
        assert mgr.state()["generation"] == 1 and mgr.state()["retrains"] == {"validation_failed": 1}
        assert mgr.model is model and torch.equal(model.score(probe), before)
        rollback = telemetry.get_events(kind="retrain.rollback")[-1]
        assert rollback.fields["reason"] == "validation_failed"
        assert "fault_injected" in rollback.fields["failed_gates"]
        assert not os.path.exists(os.path.join(mgr.work_dir, "gen-00002"))
        assert telemetry.counter("isoforest_retrain_total", labelnames=("outcome",)).value(
            outcome="validation_failed") == 1.0
    finally:
        mgr.close()


def test_a_corrupt_candidate_is_refused_by_the_gates(kddcup, incumbent_dir, tmp_path):
    _, _, shifted = kddcup
    model = _incumbent(incumbent_dir)
    mgr = _manager(model, tmp_path, background=False)
    try:
        probe = shifted[:1024]
        before = model.score(probe)
        with faults.inject(corrupt_candidate=True):
            _serve_shifted(mgr, shifted, until=lambda m: m.state()["retrains"])
        assert mgr.generation == 1 and mgr.state()["retrains"] == {"validation_failed": 1}
        failed = mgr.last_validation.failed_gates()
        assert "baseline_sanity" in failed or "finite" in failed
        assert mgr.model is model and torch.equal(model.score(probe), before)
        assert not os.path.exists(os.path.join(mgr.work_dir, "gen-00002"))
    finally:
        mgr.close()


def test_the_poison_reaches_the_tables_the_gates_score(kddcup, incumbent_dir, tmp_path):
    """The port keeps a model's tables in ``model._cache``: a poisoned
    forest behind a cache of clean tables would score clean and pass every
    gate. The seam empties the cache, so the gates see the poison."""
    X, _, _ = kddcup
    incumbent = _incumbent(incumbent_dir)
    candidate = IsolationForest(num_estimators=N_TREES, max_samples=64.0, random_seed=2, device="cpu").fit(X)
    clean = candidate.score(X[:2048])
    assert candidate._cache, "the fit built the candidate's tables"

    # the trap: the forest replaced, the clean tables kept
    stale = IsolationForest(num_estimators=N_TREES, max_samples=64.0, random_seed=2, device="cpu").fit(X)
    stale.forest = stale.forest._replace(threshold=torch.full_like(stale.forest.threshold, float("nan")))
    assert torch.equal(stale.score(X[:2048]), clean)
    assert validate_candidate(incumbent, stale, X[:2048]).passed, "stale tables pass every gate"

    mgr = _manager(incumbent, tmp_path, background=False)
    try:
        with faults.inject(corrupt_candidate=True):
            mgr._maybe_poison_candidate(candidate)
        assert bool(torch.isnan(candidate.forest.threshold).all())
        assert not torch.equal(candidate.score(X[:2048]), clean)
        result = validate_candidate(incumbent, candidate, X[:2048])
        assert not result.passed and "baseline_sanity" in result.failed_gates()
    finally:
        mgr.close()


def test_mid_swap_fault_rolls_back_and_the_next_retrain_swaps(kddcup, incumbent_dir, tmp_path):
    _, _, shifted = kddcup
    model = _incumbent(incumbent_dir)
    mgr = _manager(model, tmp_path, background=False)
    try:
        probe = shifted[:1024]
        before = model.score(probe)
        with faults.inject(fail_swap=True):
            _serve_shifted(mgr, shifted, until=lambda m: m.state()["retrains"])
        assert mgr.generation == 1 and mgr.state()["retrains"] == {"swap_failed": 1}
        assert mgr.model is model and torch.equal(model.score(probe), before)
        assert not os.path.exists(os.path.join(mgr.work_dir, "gen-00002"))
        rollback = telemetry.get_events(kind="retrain.rollback")[-1]
        assert rollback.fields["reason"] == "swap_failed" and "fail_swap" in rollback.fields["error"]
        assert mgr.retrain(reason="after_fault") == "swapped" and mgr.generation == 2
    finally:
        mgr.close()


def test_retrain_error_after_exhausted_retries(kddcup, incumbent_dir, tmp_path):
    _, _, shifted = kddcup
    mgr = _manager(_incumbent(incumbent_dir), tmp_path, background=False, auto_retrain=False,
                   retry_policy=RetryPolicy(max_attempts=2, base_delay_s=0.25))
    try:
        for i in range(6):
            mgr.score(shifted[i * 1024 : (i + 1) * 1024])
        with faults.inject(kill_retrain_after_block=0):
            with faults.inject(kill_retrain_after_block=0):
                assert mgr.retrain(reason="doomed") == "error"
        assert mgr.generation == 1 and mgr.state()["retrains"] == {"error": 1}
        assert "RetryError" in mgr.state()["last_error"]
        assert telemetry.get_events(kind="retry.exhausted") and mgr._fake_clock.sleeps
        rollback = telemetry.get_events(kind="retrain.rollback")[-1]
        assert rollback.fields["reason"] == "retrain_error" and "RetryError" in rollback.fields["error"]
        assert mgr.retrain(reason="recovery") == "swapped"
    finally:
        mgr.close()


def test_a_failure_while_the_gates_score_rolls_back_with_the_error(kddcup, incumbent_dir, tmp_path, monkeypatch):
    """A kernel or device failure in validation ends the refit as an error
    with ``retrain.rollback`` naming it; the manager is idle again."""
    _, _, shifted = kddcup
    mgr = _manager(_incumbent(incumbent_dir), tmp_path, background=True, auto_retrain=False)
    try:
        for i in range(6):
            mgr.score(shifted[i * 1024 : (i + 1) * 1024])

        def broken(*args, **kwargs):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        monkeypatch.setattr(lifecycle.manager, "validate_candidate", broken)
        assert mgr.retrain(reason="kernel_fault") == "error"
        assert not mgr.retrain_in_progress and mgr.generation == 1
        rollback = telemetry.get_events(kind="retrain.rollback")[-1]
        assert rollback.fields["reason"] == "validation_error" and "illegal memory" in rollback.fields["error"]
    finally:
        mgr.close()


# --------------------------------------------------------------------------- #
# swap under load
# --------------------------------------------------------------------------- #


def test_concurrent_scores_see_old_or_new_never_torn(kddcup, incumbent_dir, tmp_path):
    _, _, shifted = kddcup
    model = _incumbent(incumbent_dir)
    swap_entered, swap_release = threading.Event(), threading.Event()

    def slow_swap():
        swap_entered.set()
        assert swap_release.wait(timeout=300)

    mgr = _manager(model, tmp_path, background=True, auto_retrain=False, hooks={"mid_swap": slow_swap})
    try:
        probe = np.ascontiguousarray(shifted[:512])
        old_scores = model.score(probe)
        for i in range(6):
            mgr.score(shifted[i * 1024 : (i + 1) * 1024])
        assert mgr.retrain(reason="load_test", wait=False) == "started"
        assert swap_entered.wait(timeout=300)
        results, errors = [], []
        go = threading.Barrier(9)

        def scorer():
            try:
                go.wait(timeout=300)
                for _ in range(4):
                    results.append(mgr.score(probe, return_generation=True))
            except Exception as exc:  # surfaced below
                errors.append(exc)

        threads = [threading.Thread(target=scorer) for _ in range(8)]
        for t in threads:
            t.start()
        go.wait(timeout=300)
        swap_release.set()
        for t in threads:
            t.join(timeout=300)
        assert mgr.wait_retrain(timeout_s=300) and not errors, errors
        assert mgr.generation == 2
        new_scores = mgr.model.score(probe)
        assert not torch.equal(old_scores, new_scores)
        assert len(results) == 32
        for scores, generation in results:
            assert torch.equal(scores, old_scores if generation == 1 else new_scores), "a torn forest"
    finally:
        swap_release.set()
        mgr.close()


# --------------------------------------------------------------------------- #
# sliding refresh
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", ["std", "ext"])
def test_sliding_refresh_retires_the_oldest_and_keeps_the_rest_bitwise(kind, kddcup, incumbent_dir, tmp_path):
    X, _, shifted = kddcup
    if kind == "ext":
        model = ExtendedIsolationForest(num_estimators=N_TREES, max_samples=64.0, extension_level=2, random_seed=1,
                                        device="cpu").fit(X)
    else:
        model = _incumbent(incumbent_dir)
    before = {f: getattr(model.forest, f).clone() for f in model.forest._fields}
    mgr = _manager(model, tmp_path, background=False, mode="sliding", sliding_fraction=0.5)
    try:
        for i in range(6):
            mgr.score(shifted[i * 1024 : (i + 1) * 1024])
        assert mgr.generation == 2, mgr.state()
        swapped = mgr.model
        replaced = N_TREES // 2
        assert swapped.forest.num_trees == N_TREES and swapped.num_samples == model.num_samples
        for f in before:
            after = getattr(swapped.forest, f)
            assert torch.equal(after[: N_TREES - replaced], before[f][replaced:]), f
            if f in ("threshold", "weights", "offset"):
                assert not torch.equal(after[N_TREES - replaced :], before[f][:replaced])
        scores = mgr.model.score(shifted[:1024])
        assert bool(torch.isfinite(scores).all()) and bool(((scores >= 0) & (scores <= 1)).all())
        for i in range(4):
            mgr.score(shifted[i * 1024 : (i + 1) * 1024])
        assert mgr.monitor.drift()["score"]["psi"] < mgr.monitor.threshold
        block = telemetry.get_events(kind="retrain.block")[-1]
        assert block.fields["sliding"] is True and block.fields["retired_trees"] == replaced
    finally:
        mgr.close()


def test_a_small_window_falls_back_to_a_full_refit(tmp_path):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(4000, 3)).astype(np.float32)
    model = IsolationForest(num_estimators=8, max_samples=256.0, random_seed=1, device="cpu").fit(X)
    mgr = _manager(model, tmp_path, background=False, mode="sliding", window_rows=128, min_window_rows=64)
    try:
        shifted = X + 4.0
        for i in range(30):
            mgr.score(shifted[i * 128 : (i + 1) * 128])
            if mgr.generation > 1:
                break
        assert mgr.generation == 2 and mgr.model.num_samples <= 128
    finally:
        mgr.close()


# --------------------------------------------------------------------------- #
# debounce and knobs
# --------------------------------------------------------------------------- #


def test_a_single_alert_edge_does_not_trigger(kddcup, incumbent_dir, tmp_path):
    _, _, shifted = kddcup
    mgr = _manager(_incumbent(incumbent_dir), tmp_path, background=False, drift_debounce=4)
    try:
        mgr.score(shifted[:1024])
        assert telemetry.get_events(kind="drift.alert")
        assert mgr.state()["consecutive_over_threshold"] == 1
        assert mgr.generation == 1 and not mgr.state()["retrains"]
    finally:
        mgr.close()


def test_recovered_drift_resets_the_count(kddcup, incumbent_dir, tmp_path):
    X, _, shifted = kddcup
    mgr = _manager(_incumbent(incumbent_dir), tmp_path, background=False, drift_debounce=3, auto_retrain=False)
    try:
        mgr.score(shifted[:1024])
        assert mgr.state()["consecutive_over_threshold"] == 1
        for i in range(12):
            mgr.score(X[i * 1024 : (i + 1) * 1024])
        assert mgr.state()["consecutive_over_threshold"] == 0 and not mgr.state()["retrains"]
    finally:
        mgr.close()


def test_the_manager_requires_a_baseline(tmp_path):
    X = np.random.default_rng(0).normal(size=(600, 3)).astype(np.float32)
    model = IsolationForest(num_estimators=4, random_seed=1, device="cpu").fit(X, baseline=False)
    with pytest.raises(ValueError, match="baseline"):
        ModelManager(model, str(tmp_path / "lc"))


@pytest.mark.parametrize("kwargs, match", [
    (dict(mode="weekly"), "mode"),
    (dict(drift_debounce=0), "drift_debounce"),
    (dict(sliding_fraction=0.0), "sliding_fraction"),
    (dict(sliding_fraction=1.5), "sliding_fraction"),
    (dict(reservoir="lifo"), "reservoir"),
])
def test_knob_checks(kwargs, match, incumbent_dir, tmp_path):
    model = _incumbent(incumbent_dir)
    with pytest.raises(ValueError, match=match):
        ModelManager(model, str(tmp_path / "lc"), **kwargs)
    assert model._monitor is None


def test_the_decay_reservoir_is_the_managers_window(kddcup, incumbent_dir, tmp_path):
    _, _, shifted = kddcup
    mgr = _manager(_incumbent(incumbent_dir), tmp_path, background=False, auto_retrain=False, reservoir="decay",
                   window_rows=1500, reservoir_half_life_s=10.0)
    try:
        assert isinstance(mgr.reservoir, DecayReservoir) and mgr.reservoir.seed == 1
        for i in range(3):
            mgr._fake_clock.advance(5.0)
            mgr.score(shifted[i * 1024 : (i + 1) * 1024])
        assert mgr.state()["reservoir"] == "decay" and mgr.state()["window_rows"] == 1500
        assert mgr.retrain(reason="decay_window") == "swapped"
        assert mgr.last_retrain["rows"] == 1500
    finally:
        mgr.close()


# --------------------------------------------------------------------------- #
# resume and refresh stay on the incumbent's device
# --------------------------------------------------------------------------- #


def test_resume_and_refresh_load_onto_the_incumbents_device(kddcup, incumbent_dir, tmp_path):
    """This machine has no card: a load onto the default device would raise,
    and the manager would keep generation 1."""
    _, _, shifted = kddcup
    mgr = _manager(_incumbent(incumbent_dir), tmp_path, background=False)
    _serve_shifted(mgr, shifted)
    assert mgr.generation == 2
    mgr.close()
    resumed = ModelManager(_incumbent(incumbent_dir), str(tmp_path / "lifecycle"))
    try:
        assert resumed.generation == 2 and resumed.model.device.type == "cpu"
        assert _forests_equal(resumed.model.forest, mgr.model.forest)
        assert telemetry.get_events(kind="lifecycle.resume")[-1].fields["generation"] == 2
        # another process's push: CURRENT.json names generation 3
        gen3 = os.path.join(str(tmp_path / "lifecycle"), "gen-00003")
        shutil.copytree(mgr.model_path, gen3)
        with open(os.path.join(str(tmp_path / "lifecycle"), "CURRENT.json"), "w") as fh:
            json.dump({"generation": 3, "path": gen3, "swapped_unix_s": 7.0}, fh)
        assert resumed.refresh_from_current() is True
        assert resumed.generation == 3 and resumed.model.device.type == "cpu" and resumed.last_swap_unix_s == 7.0
        assert resumed.refresh_from_current() is False, "no newer generation"
    finally:
        resumed.close()


def test_a_torn_pointer_keeps_the_given_model(incumbent_dir, tmp_path, caplog):
    work = tmp_path / "lc"
    work.mkdir()
    (work / "CURRENT.json").write_text("{torn")
    model = _incumbent(incumbent_dir)
    mgr = ModelManager(model, str(work))
    try:
        assert mgr.generation == 1 and mgr.model is model
        assert mgr.refresh_from_current() is False
    finally:
        mgr.close()


# --------------------------------------------------------------------------- #
# reservoirs and gates against the JAX package
# --------------------------------------------------------------------------- #


def _fold_both(ours, theirs, batches):
    for X, y in batches:
        ours.fold(X, y)
        theirs.fold(X, y)
    (xa, ya), (xb, yb) = ours.snapshot(), theirs.snapshot()
    np.testing.assert_array_equal(xa, xb)
    assert (ya is None) == (yb is None)
    if ya is not None:
        np.testing.assert_array_equal(ya, yb)
    assert ours.rows == theirs.rows
    return xa, ya


def test_the_fifo_reservoir_is_the_jax_packages():
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(n, 3)).astype(np.float32), rng.integers(0, 2, n)) for n in (40, 7, 100, 3)]
    X, y = _fold_both(DataReservoir(64), jax_window.DataReservoir(64), batches)
    assert X.shape == (64, 3) and np.array_equal(X[-1], batches[-1][0][-1])
    X, y = _fold_both(DataReservoir(64), jax_window.DataReservoir(64), batches + [(batches[0][0][:5], None)])
    assert y is None, "one unlabeled batch drops the label track"
    ours = DataReservoir(5)
    ours.fold(torch.arange(8, dtype=torch.float32).reshape(4, 2))  # a tensor folds as its host rows
    with pytest.raises(ValueError, match="width"):
        ours.fold(np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError, match="capacity"):
        DataReservoir(0)
    with pytest.raises(ValueError, match="align"):
        ours.fold(np.zeros((2, 2), np.float32), [1.0])


@pytest.mark.parametrize("seed", [0, 17])
def test_the_decay_reservoir_keeps_the_jax_packages_rows(seed):
    rng = np.random.default_rng(seed)
    ours = DecayReservoir(50, half_life_s=30.0, seed=seed)
    theirs = jax_window.DecayReservoir(50, half_life_s=30.0, seed=seed)
    batches = []
    for i in range(6):
        n = int(rng.integers(5, 40))
        batches.append((rng.normal(size=(n, 4)).astype(np.float32), rng.integers(0, 2, n)))
    for i, (X, y) in enumerate(batches):
        ts = 10.0 * i + rng.random(X.shape[0]) if i % 2 else np.array([10.0 * i])
        ours.fold(X, y, event_ts=ts)
        theirs.fold(X, y, event_ts=ts)
    (xa, ya), (xb, yb) = ours.snapshot(), theirs.snapshot()
    np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(ya, yb)
    np.testing.assert_array_equal(ours._seq, theirs._seq)
    np.testing.assert_array_equal(ours.keys_for(3, np.arange(9.0)), theirs.keys_for(3, np.arange(9.0)))
    # the kept set is the top-50 keys of every offer
    total = sum(len(X) for X, _ in batches)
    assert ours.rows == 50 and ours._offered == total
    with pytest.raises(ValueError, match="half_life_s"):
        DecayReservoir(5, half_life_s=0.0)


@pytest.mark.parametrize("kwargs, match", [
    (dict(max_score_delta=0.0), "positive"),
    (dict(max_candidate_psi=-1.0), "positive"),
    (dict(median_band=(0.9, 0.1)), "median_band"),
    (dict(median_band=(-0.1, 0.5)), "median_band"),
    (dict(max_reference_rows=0), "max_reference_rows"),
])
def test_gate_bounds(kwargs, match):
    with pytest.raises(ValueError, match=match):
        ValidationGates(**kwargs)
    with pytest.raises(ValueError, match=match):
        jax_validation.ValidationGates(**kwargs)


@pytest.fixture(scope="module")
def validation_models(kddcup, incumbent_dir, tmp_path_factory):
    """Pairs of model files, each loaded by both packages: the incumbent, a
    refit on the shifted rows, a baseline-less candidate and a degenerate
    one (NaN thresholds)."""
    X, _, shifted = kddcup
    root = tmp_path_factory.mktemp("candidates")
    refit = IsolationForest(num_estimators=N_TREES, max_samples=64.0, random_seed=5, device="cpu").fit(shifted[:6144])
    refit.save(str(root / "refit"))
    bare = IsolationForest(num_estimators=N_TREES, max_samples=64.0, random_seed=2, device="cpu").fit(X,
                                                                                                      baseline=False)
    bare.save(str(root / "bare"))
    degenerate = IsolationForest(num_estimators=N_TREES, max_samples=64.0, random_seed=2, device="cpu").fit(X)
    degenerate.forest = degenerate.forest._replace(threshold=torch.full_like(degenerate.forest.threshold,
                                                                              float("nan")))
    degenerate._cache.clear()
    degenerate.save(str(root / "degenerate"))
    paths = {"incumbent": incumbent_dir, "refit": str(root / "refit"), "bare": str(root / "bare"),
             "degenerate": str(root / "degenerate")}
    return {name: (load_model(p, device="cpu"), JaxModel.load(p)) for name, p in paths.items()}


VALIDATION_CASES = {
    "identical_labeled": ("incumbent", "incumbent", "X", True),
    "identical_unlabeled": ("incumbent", "incumbent", "X", False),
    "refit_on_shift": ("incumbent", "refit", "shifted", True),
    "refit_on_shift_tight": ("incumbent", "refit", "shifted", False),
    "baselineless": ("incumbent", "bare", "X", False),
    "degenerate": ("incumbent", "degenerate", "X", True),
}


@pytest.mark.parametrize("case", sorted(VALIDATION_CASES))
def test_validate_candidate_gives_the_jax_packages_verdicts(case, kddcup, validation_models):
    inc_name, cand_name, rows, labeled = VALIDATION_CASES[case]
    X, y, shifted = kddcup
    data = (X if rows == "X" else shifted)[:4096]
    labels = y[:4096] if labeled else None
    gates = dict(max_score_delta=0.05) if case == "refit_on_shift_tight" else {}
    ours = validate_candidate(validation_models[inc_name][0], validation_models[cand_name][0], data, labels,
                              gates=ValidationGates(**gates))
    theirs = jax_validation.validate_candidate(validation_models[inc_name][1], validation_models[cand_name][1],
                                               data, labels, gates=jax_validation.ValidationGates(**gates))
    assert ours.passed == theirs.passed and ours.reference_rows == theirs.reference_rows
    assert [(g.name, g.passed, g.bound) for g in ours.gates] == [(g.name, g.passed, g.bound) for g in theirs.gates]
    for a, b in zip(ours.gates, theirs.gates):
        if a.value is None or not np.isfinite(a.value):
            assert a.value == b.value
        else:
            assert abs(a.value - b.value) <= 1e-5, (a, b)
    if case == "identical_labeled":
        assert [g.name for g in ours.gates] == ["finite", "score_parity", "baseline_sanity", "auroc"]
        assert ours.gates[1].value == 0.0
    if case == "baselineless":
        assert ours.failed_gates() == ("baseline_sanity",)
    if case == "degenerate":
        assert "baseline_sanity" in ours.failed_gates()
    with faults.inject(fail_validation=True):
        forced = validate_candidate(validation_models[inc_name][0], validation_models[cand_name][0], data)
    assert not forced.passed and forced.failed_gates()[-1] == "fault_injected"


# --------------------------------------------------------------------------- #
# monitor rebind and the HTTP state
# --------------------------------------------------------------------------- #


def test_rebind_rearms_the_edge_triggered_alert(kddcup, incumbent_dir):
    X, _, shifted = kddcup
    model = _incumbent(incumbent_dir)
    monitor = model.enable_monitoring(threshold=0.25, min_rows=256)
    try:
        model.score(shifted[:2048])
        first = len(monitor.report()["alerts"])
        assert first >= 1
        model.score(shifted[:2048])
        assert len(monitor.report()["alerts"]) == first, "latched"
        refit = IsolationForest(num_estimators=N_TREES, max_samples=64.0, random_seed=5, device="cpu").fit(shifted)
        assert model.rebind_monitoring(refit.baseline) is monitor
        assert monitor.rows == 0 and not monitor.report()["drifted"]
        batch = shifted[:2048]
        monitor.observe(refit.score(batch), batch)
        assert not monitor.report()["drifted"]
        before = len(telemetry.get_events(kind="drift.alert"))
        again = batch + 4.0 * np.std(shifted, axis=0)
        monitor.observe(refit.score(again), again)
        assert len(telemetry.get_events(kind="drift.alert")) > before
        narrow = capture_baseline(np.random.default_rng(0).random(600), np.zeros((600, 2), np.float32))
        with pytest.raises(ValueError, match="feature"):
            monitor.rebind(narrow)
    finally:
        model.disable_monitoring()


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read().decode("utf-8")
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode("utf-8")


def test_healthz_and_snapshot_carry_the_lifecycle_state(kddcup, incumbent_dir, tmp_path):
    _, _, shifted = kddcup
    mgr = _manager(_incumbent(incumbent_dir), tmp_path, background=False)
    server = telemetry.serve(port=0)
    try:
        status, body = _get(server.url + "/healthz")
        state = json.loads(body)["lifecycle"]
        assert status == 200 and state == mgr.state()
        assert state["generation"] == 1 and state["retrain_in_progress"] is False
        assert state["last_swap_unix_s"] is None
        _serve_shifted(mgr, shifted, batches=6)
        assert mgr.generation == 2
        state = json.loads(_get(server.url + "/healthz")[1])["lifecycle"]
        assert state == mgr.state() and state["retrains"] == {"swapped": 1}
        assert state["last_swap_unix_s"] is not None
        snap = json.loads(_get(server.url + "/snapshot")[1])
        assert snap["lifecycle"]["generation"] == 2 and "isoforest_model_generation" in snap["metrics"]
        mgr.close()
        assert "lifecycle" not in json.loads(_get(server.url + "/healthz")[1])
        assert lifecycle.state_snapshot() is None
    finally:
        server.stop()
        mgr.close()


def test_a_swap_in_steady_state_counts_the_candidates_table_builds(kddcup, incumbent_dir, tmp_path):
    """The port counts table builds as compiles: after ``mark_steady`` a swap
    ticks one steady build, the candidate's walk tables (the CPU's tuner is
    off here, so ``auto`` is the walk); nothing else of the refit builds."""
    _, _, shifted = kddcup
    model = _incumbent(incumbent_dir)
    model.warmup((1024,), width=model.total_num_features)
    mgr = _manager(model, tmp_path, background=False)
    try:
        telemetry.reset_resources()
        telemetry.mark_steady()
        _serve_shifted(mgr, shifted)
        assert mgr.generation == 2
        steady = [(e["site"], e["key"]) for e in telemetry.compile_log() if e["phase"] == "steady"]
        assert steady == [("unattributed", "tables:walk")]
        for i in range(3):
            mgr.score(shifted[i * 1024 : (i + 1) * 1024])
        assert telemetry.compile_counts()["by_phase"]["steady"] == 1, "serving the new generation builds nothing"
    finally:
        mgr.close()


def test_streamed_scoring_during_a_background_refit_stays_exact(kddcup, incumbent_dir, tmp_path, monkeypatch):
    """The refit's validation and a concurrent scorer both stream host rows
    through the executor (256-row chunks here): one takes the cached
    staging pair, the other a private one, and every answer is bit for bit
    the old or the new generation's scores of the same chunks."""
    _, _, shifted = kddcup
    monkeypatch.setenv("ISOFOREST_TPU_PIPELINE_CHUNK", "256")
    model = _incumbent(incumbent_dir)
    mgr = _manager(model, tmp_path, background=True, auto_retrain=False)
    try:
        probe = np.ascontiguousarray(shifted[:1024])
        old_scores = model.score(probe)
        for i in range(6):
            mgr.score(shifted[i * 1024 : (i + 1) * 1024])
        results = []
        assert mgr.retrain(reason="streamed_load", wait=False) == "started"
        while mgr.retrain_in_progress or not results:
            results.append(mgr.score(probe, return_generation=True))
        assert mgr.wait_retrain(timeout_s=300) and mgr.generation == 2
        new_scores = mgr.model.score(probe)
        assert telemetry.get_events(kind="pipeline.run"), "the scores streamed"
        for scores, generation in results:
            assert torch.equal(scores, old_scores if generation == 1 else new_scores)
    finally:
        mgr.close()
