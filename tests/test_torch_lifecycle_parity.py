"""The port's ``ModelManager`` against the JAX package's on the CPU: the same
incumbent file, the same traffic, ``background=False`` and a FakeClock in
each, a refit killed after its second block and resumed.

Held: the same batch triggers the refit; the events are the same sequence of
names and fields (paths aside, the gates' values within 1e-5: the packages'
scores differ by up to 2e-6 and the gates round to 6 places); the swapped
generation's forest equals the JAX package's node for node (the packages
draw the same threefry streams, and these seeded trees meet no Gumbel
near-tie, so the growth's own draws are used); ``state()`` and
``CURRENT.json`` match; and each package's manager resumes the other's work
directory at its generation. One JAX manager run for the module.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest
import torch

from isoforest_tpu import IsolationForestModel as JaxModel
from isoforest_tpu import telemetry as jax_telemetry
from isoforest_tpu.lifecycle import ModelManager as JaxManager
from isoforest_tpu.resilience import faults as jax_faults
from isoforest_tpu.resilience.retry import RetryPolicy as JaxRetryPolicy
from isoforest_tpu_torch import load_model, telemetry
from isoforest_tpu_torch.lifecycle import ModelManager
from isoforest_tpu_torch.resilience import faults
from isoforest_tpu_torch.resilience.retry import RetryPolicy
from isoforest_tpu_torch.testing import torch_threads

N_TREES = 12
KNOBS = dict(drift_debounce=2, window_rows=6144, min_window_rows=1024, checkpoint_every=4, background=False)
BATCHES = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def shifted():
    from isoforest_tpu.data import kddcup_http_hard

    X, _ = kddcup_http_hard(n=20000, seed=7)
    return X, X + 3.0 * np.std(X, axis=0, keepdims=True)


def _drive(manager_cls, model, work_dir, fault_module, policy_cls, rows):
    """One manager over ``BATCHES`` shifted batches with a kill armed after
    refit block 1; returns ``(manager, first batch that swapped)``."""
    fc = fault_module.FakeClock()
    mgr = manager_cls(model, work_dir, clock=fc.now, sleep=fc.sleep,
                      retry_policy=policy_cls(max_attempts=3, base_delay_s=0.25), **KNOBS)
    swapped_at = None
    with fault_module.inject(kill_retrain_after_block=1):
        for i in range(BATCHES):
            mgr.score(rows[i * 1024 : (i + 1) * 1024])
            if swapped_at is None and mgr.generation > 1:
                swapped_at = i
    return mgr, swapped_at


def _events(tel):
    return [(e.kind, dict(e.fields)) for e in tel.get_events()
            if e.kind.startswith(("retrain.", "retry.", "lifecycle.", "drift."))]


@pytest.fixture(scope="module")
def runs(shifted, tmp_path_factory):
    """The JAX package's incumbent saved once; then each package's manager
    over the same traffic from that file, with its events, state, pointer
    and steady compiles."""
    from isoforest_tpu import IsolationForest as JaxEstimator
    from isoforest_tpu.telemetry import resources as jax_resources

    import jax

    # compile as a fresh process would: a test that ran earlier in this
    # process (the JAX package's tests/test_lifecycle.py refits the same
    # window shapes) leaves the refit's programs compiled, and the steady
    # compiles this module counts would not happen
    jax.clear_caches()
    X, rows = shifted
    root = tmp_path_factory.mktemp("lifecycle_parity")
    JaxEstimator(num_estimators=N_TREES, max_samples=64.0, random_seed=1).fit(X).save(str(root / "model"))
    out = {}
    for name, tel in (("jax", jax_telemetry), ("torch", telemetry)):
        resources = jax_resources if name == "jax" else telemetry
        model = JaxModel.load(str(root / "model")) if name == "jax" else load_model(str(root / "model"), device="cpu")
        model.score(rows[:1024])  # warm: the incumbent's own builds come before steady state
        tel.reset()
        resources.reset_resources()
        resources.mark_steady()
        try:
            if name == "jax":
                mgr, at = _drive(JaxManager, model, str(root / "lc-jax"), jax_faults, JaxRetryPolicy, rows)
            else:
                mgr, at = _drive(ModelManager, model, str(root / "lc-torch"), faults, RetryPolicy, rows)
            out[name] = dict(manager=mgr, swapped_at=at, events=_events(tel), state=mgr.state(),
                             current=json.load(open(os.path.join(mgr.work_dir, "CURRENT.json"))),
                             steady=resources.compile_counts()["by_phase"]["steady"],
                             steady_log=[e for e in resources.compile_log() if e["phase"] == "steady"])
            mgr.close()
        finally:
            resources.mark_warmup()
            tel.reset()
            resources.reset_resources()
    out["root"] = root
    return out


def test_the_same_batch_triggers_and_swaps(runs):
    assert runs["jax"]["swapped_at"] is not None
    assert runs["torch"]["swapped_at"] == runs["jax"]["swapped_at"]
    assert runs["torch"]["state"]["generation"] == runs["jax"]["state"]["generation"] == 2


def _same_fields(ours: dict, theirs: dict) -> None:
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        if key == "path":
            assert os.path.basename(ours[key]) == os.path.basename(value)
        elif key == "gates":
            a, b = json.loads(ours[key]), json.loads(value)
            assert [(g["name"], g["passed"], g["bound"], g["detail"]) for g in a] == \
                [(g["name"], g["passed"], g["bound"], g["detail"]) for g in b]
            for ga, gb in zip(a, b):
                assert (ga["value"] is None) == (gb["value"] is None)
                if gb["value"] is not None:
                    assert abs(ga["value"] - gb["value"]) <= 1e-5
        elif key in ("psi",):
            assert abs(ours[key] - value) <= 1e-5
        else:
            assert ours[key] == value, key


def test_the_events_are_the_same_sequence(runs):
    ours, theirs = runs["torch"]["events"], runs["jax"]["events"]
    assert [k for k, _ in ours] == [k for k, _ in theirs]
    assert "retry.attempt" in [k for k, _ in ours] and [k for k, _ in ours][-1] == "retrain.swap"
    for (kind, a), (_, b) in zip(ours, theirs):
        _same_fields(a, b)


def test_the_swapped_generation_is_the_jax_packages_node_for_node(runs):
    ours, theirs = runs["torch"]["manager"].model, runs["jax"]["manager"].model
    for field in theirs.forest._fields:
        a = getattr(ours.forest, field).numpy()
        b = np.asarray(getattr(theirs.forest, field))
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=field)
    assert (ours.num_samples, ours.num_features, ours.params.random_seed) == \
        (theirs.num_samples, theirs.num_features, theirs.params.random_seed)
    assert ours.baseline.as_dict()["score"]["counts"] == theirs.baseline.as_dict()["score"]["counts"]


def test_state_and_current_json_match(runs):
    ours, theirs = dict(runs["torch"]["state"]), dict(runs["jax"]["state"])
    assert sorted(ours) == sorted(theirs)
    for key in ("model_uid", "model_path"):
        ours.pop(key), theirs.pop(key)
    assert ours == theirs
    a, b = runs["torch"]["current"], runs["jax"]["current"]
    assert sorted(a) == sorted(b) == ["generation", "path", "swapped_unix_s"]
    assert a["generation"] == b["generation"] == 2 and a["swapped_unix_s"] == b["swapped_unix_s"]
    assert os.path.basename(a["path"]) == os.path.basename(b["path"]) == "gen-00002"


def test_a_steady_swap_counts_table_builds_where_the_jax_package_counts_xla_compiles(runs):
    """The pinned difference (ROADMAP §C): after ``mark_steady`` the JAX
    package's refit compiles XLA programs for the window's shapes, each a
    steady compile; the port compiles nothing, and counts the candidate's
    one table build."""
    assert runs["jax"]["steady"] > 0
    assert [(e["site"], e["key"]) for e in runs["torch"]["steady_log"]] == [("unattributed", "tables:walk")]


def _copy_work_dir(src: str, dst: str) -> str:
    """A work directory moved elsewhere: its pointer rewritten to the copy."""
    shutil.copytree(src, dst)
    doc = json.load(open(os.path.join(dst, "CURRENT.json")))
    doc["path"] = os.path.join(dst, os.path.basename(doc["path"]))
    with open(os.path.join(dst, "CURRENT.json"), "w") as fh:
        json.dump(doc, fh)
    return dst


def test_the_port_resumes_the_jax_packages_work_directory(runs, shifted):
    root = runs["root"]
    work = _copy_work_dir(runs["jax"]["manager"].work_dir, str(root / "resume-in-torch"))
    mgr = ModelManager(load_model(str(root / "model"), device="cpu"), work)
    try:
        assert mgr.generation == 2 and mgr.model.device.type == "cpu"
        assert mgr.model_path == os.path.join(work, "gen-00002")
        theirs = runs["jax"]["manager"].model
        for field in theirs.forest._fields:
            np.testing.assert_array_equal(getattr(mgr.model.forest, field).numpy(), np.asarray(getattr(theirs.forest,
                                                                                                        field)))
        probe = shifted[1][:2048]
        got = mgr.score(probe).numpy()
        assert np.abs(got - np.asarray(theirs.score(probe))).max() <= 2e-6
    finally:
        mgr.close()


def test_the_jax_package_resumes_the_ports_work_directory(runs, shifted):
    root = runs["root"]
    work = _copy_work_dir(runs["torch"]["manager"].work_dir, str(root / "resume-in-jax"))
    mgr = JaxManager(JaxModel.load(str(root / "model")), work)
    try:
        assert mgr.generation == 2 and mgr.model_path == os.path.join(work, "gen-00002")
        ours = runs["torch"]["manager"].model
        for field in ours.forest._fields:
            np.testing.assert_array_equal(np.asarray(getattr(mgr.model.forest, field)),
                                          getattr(ours.forest, field).numpy())
        probe = shifted[1][:2048]
        got = np.asarray(mgr.score(probe))
        assert np.abs(got - ours.score(probe).numpy()).max() <= 2e-6
    finally:
        mgr.close()
        jax_telemetry.reset()


def test_a_jax_push_is_adopted_by_refresh(runs):
    """A serving replica of the port adopts a generation the JAX package's
    manager swapped into a shared work directory (``POST /reload``)."""
    root = runs["root"]
    work = str(root / "shared")
    os.makedirs(work)
    mgr = ModelManager(load_model(str(root / "model"), device="cpu"), work)
    try:
        assert mgr.generation == 1 and mgr.refresh_from_current() is False
        shutil.copytree(runs["jax"]["manager"].model_path, os.path.join(work, "gen-00002"))
        doc = dict(runs["jax"]["current"], path=os.path.join(work, "gen-00002"))
        with open(os.path.join(work, "CURRENT.json"), "w") as fh:
            json.dump(doc, fh)
        assert mgr.refresh_from_current() is True
        assert mgr.generation == 2 and mgr.last_swap_unix_s == doc["swapped_unix_s"]
        assert torch.equal(mgr.model.forest.threshold,
                           torch.from_numpy(np.array(runs["jax"]["manager"].model.forest.threshold)))
        assert [e.kind for e in telemetry.get_events(kind="lifecycle.refresh")] == ["lifecycle.refresh"]
    finally:
        mgr.close()
