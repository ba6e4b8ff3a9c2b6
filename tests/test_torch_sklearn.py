"""The port's scikit-learn adapter (``isoforest_tpu_torch/sklearn.py``)
against ``isoforest_tpu.sklearn.TpuIsolationForest`` on the CPU.

Tolerances: both adapters fit the same forest from the same rows and seed
(node for node, the packages' growth), so their outputs agree within 2e-6
(the packages' scores differ by up to that much) and their labels agree
away from the threshold. ``manage`` keeps ``model_`` on the live
generation. The port's adapter adds ``device`` (``None``: the card) and
refuses ``fit(mesh=...)``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from sklearn.base import clone
from sklearn.exceptions import NotFittedError
from sklearn.pipeline import Pipeline
from sklearn.preprocessing import StandardScaler

from isoforest_tpu.sklearn import TpuIsolationForest as JaxAdapter
from isoforest_tpu_torch import ExtendedIsolationForestModel, IsolationForestModel, telemetry
from isoforest_tpu_torch.lifecycle import ModelManager, ValidationGates
from isoforest_tpu_torch.resilience import faults
from isoforest_tpu_torch.sklearn import TpuIsolationForest
from isoforest_tpu_torch.testing import torch_threads

KINDS = {"standard": {}, "extended": {"extension_level": 2}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(3000, 5)).astype(np.float32)
    X[:60] += 6.0
    return X


@pytest.fixture(scope="module")
def fitted(data):
    """Each kind fitted once by each adapter, with a contamination threshold."""
    out = {}
    for kind, extra in KINDS.items():
        params = dict(n_estimators=16, max_samples=128.0, contamination=0.02, random_state=3, **extra)
        out[kind] = (TpuIsolationForest(device="cpu", **params).fit(data), JaxAdapter(**params).fit(data))
    return out


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_outputs_are_the_jax_adapters(kind, data, fitted):
    ours, theirs = fitted[kind]
    assert isinstance(ours.model_, ExtendedIsolationForestModel if kind == "extended" else IsolationForestModel)
    assert ours.model_.device.type == "cpu" and ours.n_features_in_ == theirs.n_features_in_ == 5
    assert abs(ours.offset_ - theirs.offset_) <= 2e-6
    for method in ("anomaly_score", "score_samples", "decision_function"):
        got, want = getattr(ours, method)(data), np.asarray(getattr(theirs, method)(data))
        assert isinstance(got, np.ndarray) and got.shape == want.shape == (3000,)
        assert np.abs(got - want).max() <= 2e-6, method
    away = np.abs(ours.decision_function(data)) > 2e-6
    pred = ours.predict(data)
    assert isinstance(pred, np.ndarray) and set(np.unique(pred)) <= {-1, 1}
    np.testing.assert_array_equal(pred[away], np.asarray(theirs.predict(data))[away])
    assert (pred[:60] == -1).mean() > 0.8
    assert ours.diagnostics()["num_trees"] == theirs.diagnostics()["num_trees"] == 16


def test_fit_predict_and_a_pipeline(data):
    est = TpuIsolationForest(n_estimators=16, contamination=0.02, device="cpu")
    np.testing.assert_array_equal(est.fit_predict(data), est.predict(data))
    pipe = Pipeline([("scale", StandardScaler()),
                     ("forest", TpuIsolationForest(n_estimators=16, contamination=0.02, device="cpu"))])
    assert (pipe.fit_predict(data)[:60] == -1).mean() > 0.8


def test_get_params_clone_and_set_params():
    est = TpuIsolationForest(n_estimators=7, extension_level=1, device="cpu")
    params = est.get_params()
    theirs = JaxAdapter(n_estimators=7, extension_level=1).get_params()
    assert params == dict(theirs, device="cpu")
    twin = clone(est)
    assert twin is not est and twin.get_params() == params
    est.set_params(n_estimators=9, device=None)
    assert est.n_estimators == 9 and est.device is None


def test_not_fitted_and_mesh_errors(data):
    for method in ("score_samples", "anomaly_score", "diagnostics", "enable_monitoring"):
        with pytest.raises(NotFittedError):
            getattr(TpuIsolationForest(device="cpu"), method)(*((data[:2],) if "score" in method else ()))
    with pytest.raises(NotImplementedError, match="item 15"):
        TpuIsolationForest(device="cpu").fit(data, mesh=object())


def test_without_a_device_the_adapter_wants_the_card(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert TpuIsolationForest().device is None
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TpuIsolationForest(n_estimators=4).fit(data)


def test_checkpointed_fit_and_monitoring_pass_through(data, tmp_path):
    est = TpuIsolationForest(n_estimators=8, device="cpu")
    est.fit(data, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=4)
    plain = TpuIsolationForest(n_estimators=8, device="cpu").fit(data)
    np.testing.assert_array_equal(est.anomaly_score(data), plain.anomaly_score(data))
    monitor = est.enable_monitoring(threshold=0.3)
    est.anomaly_score(data[:1024])
    assert monitor.rows == 1024 and est.rebind_monitoring() is monitor and monitor.rows == 0
    est.disable_monitoring()
    assert est.model_._monitor is None


def test_manage_tracks_swaps(tmp_path):
    from isoforest_tpu.data import kddcup_http_hard

    X, _ = kddcup_http_hard(n=20000, seed=7)
    shifted = X + 3.0 * np.std(X, axis=0, keepdims=True)
    est = TpuIsolationForest(n_estimators=12, max_samples=64.0, random_state=1, device="cpu").fit(X)
    fc = faults.FakeClock()
    mgr = est.manage(str(tmp_path / "lc"), drift_debounce=2, window_rows=6144,
                     gates=ValidationGates(max_score_delta=0.5), min_window_rows=1024, checkpoint_every=4,
                     background=False, clock=fc.now, sleep=fc.sleep)
    try:
        assert isinstance(mgr, ModelManager)
        assert mgr.gates.max_score_delta == 0.5 and mgr.drift_debounce == 2
        incumbent = est.model_
        for i in range(6):
            mgr.score(shifted[i * 1024 : (i + 1) * 1024])
            if mgr.generation > 1:
                break
        assert mgr.generation == 2
        assert est.model_ is mgr.model and est.model_ is not incumbent
        assert est.model_.device.type == "cpu"
        np.testing.assert_array_equal(est.anomaly_score(shifted[:256]), mgr.model.score(shifted[:256]).numpy())
    finally:
        mgr.close()
        telemetry.reset()
