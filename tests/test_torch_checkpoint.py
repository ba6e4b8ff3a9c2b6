"""The port's checkpointed fit (``isoforest_tpu_torch/resilience/checkpoint.py``,
``models/isolation_forest.py::_blockwise_grow``) against its plain fit and
against the JAX package's checkpoint directories, on the CPU.

Tolerances: none. A checkpointed fit, killed and resumed or not, equals the
port's plain fit bitwise (forest arrays, threshold and scores), because the
ensemble's bags, feature subsets and tree keys are drawn once and sliced
per block. A directory the JAX package wrote resumes in the port, and the
reverse, to the same forest node for node: the two packages grow these
seeded trees identically (``tests/test_torch_fit.py``), and they write the
same fingerprint and block files.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from isoforest_tpu.models import IsolationForest as JaxEstimator
from isoforest_tpu.models.extended import ExtendedIsolationForest as JaxExtendedEstimator
from isoforest_tpu.resilience import faults as jfaults
from isoforest_tpu_torch import ExtendedIsolationForest, IsolationForest, telemetry
from isoforest_tpu_torch.resilience import checkpoint as ckpt
from isoforest_tpu_torch.resilience import faults
from isoforest_tpu_torch.resilience.checkpoint import CheckpointMismatchError
from isoforest_tpu_torch.testing import torch_threads

N_TREES = 12
BLOCK = 4  # three blocks: a kill after the first or the middle one
PARAMS = {
    "standard": (IsolationForest, JaxEstimator, dict(num_estimators=N_TREES, max_samples=64.0, random_seed=11)),
    "extended": (ExtendedIsolationForest, JaxExtendedEstimator,
                 dict(num_estimators=N_TREES, max_samples=64.0, extension_level=2, random_seed=11)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run beside other test processes
    (``testing.torch_threads``)."""
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def data(mammography):
    return mammography[0][:3000]


def _port(kind, **kw):
    cls, _, params = PARAMS[kind]
    return cls(**{**params, **kw}, device="cpu")


@pytest.fixture(scope="module")
def plain(data):
    return {kind: _port(kind).fit(data) for kind in PARAMS}


def _assert_bitwise(model, ref, X):
    for a, b in zip(model.forest, ref.forest):
        a, b = np.asarray(a.cpu().numpy() if isinstance(a, torch.Tensor) else a), np.asarray(b.cpu().numpy())
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    if hasattr(model, "outlier_score_threshold") and isinstance(model.forest[0], torch.Tensor):
        assert model.outlier_score_threshold == ref.outlier_score_threshold
        assert torch.equal(model.score(X), ref.score(X))


@pytest.mark.parametrize("kind", sorted(PARAMS))
def test_checkpointed_fit_equals_the_plain_fit(kind, data, plain, tmp_path):
    calls = []
    model = _port(kind).fit(data, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=BLOCK,
                            block_callback=lambda *a: calls.append(a))
    _assert_bitwise(model, plain[kind], data)
    assert model.baseline.as_dict() == plain[kind].baseline.as_dict()
    assert calls == [(0, 0, 4, False), (1, 4, 8, False), (2, 8, 12, False)]
    assert (model.fit_checkpoint.blocks_written, model.fit_checkpoint.blocks_loaded) == (3, 0)
    assert sorted(os.listdir(tmp_path / "ck")) == ["block-00000", "block-00001", "block-00002", "fingerprint.json"]
    assert [e.kind for e in telemetry.get_events() if e.kind.startswith("checkpoint.")][-3:] == [
        "checkpoint.block_sealed"] * 3


@pytest.mark.parametrize("kill_at", [0, 1])
@pytest.mark.parametrize("kind", sorted(PARAMS))
def test_killed_fit_resumes_bitwise(kind, kill_at, data, plain, tmp_path):
    d = str(tmp_path / "ck")
    with pytest.raises(faults.FaultInjectedError):
        with faults.inject(kill_fit_after_block=kill_at):
            _port(kind).fit(data, checkpoint_dir=d, checkpoint_every=BLOCK)
    calls = []
    resumed = _port(kind).fit(data, checkpoint_dir=d, checkpoint_every=BLOCK, resume=True,
                              block_callback=lambda *a: calls.append(a[-1]))
    _assert_bitwise(resumed, plain[kind], data)
    assert resumed.fit_checkpoint.blocks_loaded == kill_at + 1
    assert resumed.fit_checkpoint.blocks_written == 2 - kill_at
    assert calls == [True] * (kill_at + 1) + [False] * (2 - kill_at)


@pytest.mark.parametrize("kind", sorted(PARAMS))
def test_checkpointed_fit_from_sample_equals_the_plain_one(kind, data, tmp_path):
    rng = np.random.default_rng(2)
    bag = rng.integers(0, 500, size=(N_TREES, 64)).astype(np.int32)
    want = _port(kind).fit_from_sample(data[:500], bag)
    got = _port(kind).fit_from_sample(data[:500], bag, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=5)
    _assert_bitwise(got, want, data[:500])


# --------------------------------------------------------------------------- #
# one checkpoint directory, two packages
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", sorted(PARAMS))
def test_a_jax_checkpoint_resumes_in_the_port(kind, data, plain, tmp_path):
    _, jax_cls, params = PARAMS[kind]
    d = str(tmp_path / "ck")
    with pytest.raises(jfaults.FaultInjectedError):
        with jfaults.inject(kill_fit_after_block=0):
            jax_cls(**params).fit(data, checkpoint_dir=d, checkpoint_every=BLOCK, baseline=False)
    with open(os.path.join(d, ckpt.FINGERPRINT_NAME)) as fh:
        jax_fingerprint = json.load(fh)
    resumed = _port(kind).fit(data, checkpoint_dir=d, checkpoint_every=BLOCK, resume=True)
    assert resumed.fit_checkpoint.fingerprint == jax_fingerprint
    assert resumed.fit_checkpoint.blocks_loaded == 1
    _assert_bitwise(resumed, plain[kind], data)


@pytest.mark.parametrize("kind", sorted(PARAMS))
def test_a_port_checkpoint_resumes_in_the_jax_package(kind, data, plain, tmp_path):
    _, jax_cls, params = PARAMS[kind]
    d = str(tmp_path / "ck")
    with pytest.raises(faults.FaultInjectedError):
        with faults.inject(kill_fit_after_block=0):
            _port(kind).fit(data, checkpoint_dir=d, checkpoint_every=BLOCK)
    resumed = jax_cls(**params).fit(data, checkpoint_dir=d, checkpoint_every=BLOCK, resume=True, baseline=False)
    assert resumed.fit_checkpoint.blocks_loaded == 1
    _assert_bitwise(resumed, plain[kind], data)


# --------------------------------------------------------------------------- #
# resume safety (tests/test_checkpoint.py::TestResumeSafety)
# --------------------------------------------------------------------------- #


@pytest.fixture()
def killed_dir(data, tmp_path):
    d = str(tmp_path / "ck")
    with pytest.raises(faults.FaultInjectedError):
        with faults.inject(kill_fit_after_block=1):
            _port("standard").fit(data, checkpoint_dir=d, checkpoint_every=BLOCK)
    return d


@pytest.mark.parametrize("field,change", [
    ("randomSeed", dict(est={"random_seed": 99})),
    ("dataSha256", dict(data=True)),
    ("blockTrees", dict(every=6)),
    ("numEstimators", dict(est={"num_estimators": 16})),
    ("kind", dict(kind="extended")),
])
def test_a_mismatched_resume_refuses(field, change, data, killed_dir):
    X = data
    if change.get("data"):
        X = data.copy()
        X[0, 0] += 1.0
    est = _port(change.get("kind", "standard"), **change.get("est", {}))
    with pytest.raises(CheckpointMismatchError, match=field) as err:
        est.fit(X, checkpoint_dir=killed_dir, checkpoint_every=change.get("every", BLOCK), resume=True)
    assert field in err.value.mismatched_fields


def test_resume_false_refuses_sealed_progress(data, killed_dir):
    with pytest.raises(CheckpointMismatchError, match="resume=True"):
        _port("standard").fit(data, checkpoint_dir=killed_dir, checkpoint_every=BLOCK)


@pytest.mark.parametrize("damage", ["corrupt_npz", "unsealed"])
def test_a_damaged_block_is_grown_again(damage, data, plain, killed_dir):
    if damage == "corrupt_npz":
        npz = os.path.join(killed_dir, "block-00001", ckpt._ARRAYS_NAME)
        raw = bytearray(open(npz, "rb").read())
        raw[len(raw) // 2] ^= 0x5A
        open(npz, "wb").write(bytes(raw))
    else:
        os.remove(os.path.join(killed_dir, "block-00000", "_MANIFEST.json"))
    resumed = _port("standard").fit(data, checkpoint_dir=killed_dir, checkpoint_every=BLOCK, resume=True)
    _assert_bitwise(resumed, plain["standard"], data)
    assert (resumed.fit_checkpoint.blocks_loaded, resumed.fit_checkpoint.blocks_written) == (1, 2)
    assert len(telemetry.get_events(kind="checkpoint.block_regrown")) >= 1


@pytest.mark.parametrize("damage,match", [("no_fingerprint", "no fingerprint"), ("bad_fingerprint", "unreadable")])
def test_a_damaged_fingerprint_refuses(damage, match, data, killed_dir):
    path = os.path.join(killed_dir, ckpt.FINGERPRINT_NAME)
    if damage == "no_fingerprint":
        os.remove(path)
    else:
        with open(path, "w") as fh:
            fh.write("{not json")
    with pytest.raises(CheckpointMismatchError, match=match):
        _port("standard").fit(data, checkpoint_dir=killed_dir, checkpoint_every=BLOCK, resume=True)


def test_the_environment_arms_the_kill(data, plain, tmp_path, monkeypatch):
    """``ISOFOREST_TPU_FAULTS`` arms the port's seam as it arms the JAX package's."""
    monkeypatch.setenv("ISOFOREST_TPU_FAULTS", "kill_fit_after_block=0,hide_native")
    assert faults.get("kill_fit_after_block") == "0" and jfaults.get("kill_fit_after_block") == "0"
    assert faults.active("kill_fit_after_block") and not faults.active("corrupt_avro")
    with pytest.raises(faults.FaultInjectedError):
        _port("standard").fit(data, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=BLOCK)
    monkeypatch.delenv("ISOFOREST_TPU_FAULTS")
    resumed = _port("standard").fit(data, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=BLOCK, resume=True)
    _assert_bitwise(resumed, plain["standard"], data)
    with pytest.raises(ValueError, match="unknown fault"):
        with faults.inject(hide_native=True):
            pass


@pytest.mark.parametrize("every,trees,want", [(None, 100, 32), (None, 12, 12), (5, 12, 5), (40, 12, 12)])
def test_block_size_and_ranges(every, trees, want):
    assert ckpt.resolve_block_size(every, trees) == want
    ranges = ckpt.block_ranges(trees, want)
    assert ranges[0][1] == 0 and ranges[-1][2] == trees
    assert all(a[2] == b[1] for a, b in zip(ranges, ranges[1:]))
    with pytest.raises(ValueError):
        ckpt.resolve_block_size(0, trees)
