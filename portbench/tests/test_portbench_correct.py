"""``correct`` must come out false for the control (the reference computed
one precision lower) and for each fault a cell can have, planted under a
run that skips the look for a card and runs on the CPU at a small size."""

import time

import pytest
import torch

from portbench import check, harness, inputs, spec
from portbench.reference import score as ref_score

SEED = 2 ** 31 + 99

SMALL_STD = {"mix": {"rows": 3000}, "config": {"trainingRows": 20000}}
SMALL_EIF = {"mix": {"rows": 2048},
             "config": {"numEstimators": 10, "numFeatures": 6, "extensionLevel": 5,
                        "data": {"generator": "high_dim_blobs", "num_features": 6, "contamination": 0.146}}}
CELLS = [("kddhttp-std.resident-10m", SMALL_STD), ("arrhythmia-eif.staged-1m", SMALL_EIF)]


@pytest.fixture(autouse=True)
def _walk_on_the_cpu(monkeypatch, tmp_path):
    """The CPU's plain walk, pinned: an autotune probe of the CPU's plain
    versions would take most of a test's time."""
    monkeypatch.setenv("ISOFOREST_TPU_STRATEGY", "walk")
    monkeypatch.setenv("ISOFOREST_TPU_AUTOTUNE_PATH", str(tmp_path / "autotune.json"))


def run(cell, overrides, seconds=1.0):
    return harness.run(cell, SEED, seconds, False, t_start=time.perf_counter(), device="cpu",
                       require_card=False, overrides=overrides)


@pytest.mark.parametrize("cell,rows", [
    ("kddhttp-std.resident-10m", 4096),
    ("arrhythmia-eif.staged-1m", 2048),
])
def test_the_control_is_not_correct(cell, rows):
    """The reference in the program's place, one precision below the
    configuration's float32, fails the configuration's limits."""
    config = spec.load_cell(cell).config
    forest = inputs.forest_tensors(inputs.grow_forest(config, seed=SEED, device="cpu"), "cpu")
    X = inputs.scored_rows(config, rows, seed=SEED, device="cpu", place="device")
    truth = ref_score.score(forest, X, max_samples=config["maxSamples"])
    control = ref_score.score(forest, X, max_samples=config["maxSamples"], precision=config["control"]).scores
    numbers = check.compare([harness_answer(control)], 1, truth)
    assert not check.judge(numbers, config["limits"]), numbers


def harness_answer(scores):
    from portbench.loops import Answer

    return Answer(0, scores.shape[0], scores.float())


@pytest.mark.parametrize("cell,overrides", CELLS)
def test_sound_runs_are_correct(cell, overrides):
    result = run(cell, overrides)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0, result["checks"]


def _unchanged(real):
    """A step that returns its state unchanged: the output never written."""
    def fault(forest, X, *args, **kwargs):
        return torch.ones(X.shape[0], dtype=torch.float32)
    return fault


def _half_the_trees(real):
    """Half the batch left out, the mean taken over the rest: the trees."""
    def fault(forest, X, *args, **kwargs):
        half = type(forest)(*(leaf[: max(1, leaf.shape[0] // 2)] for leaf in forest))
        return real(half, X, *args, **kwargs)
    return fault


def _half_the_rows(real):
    """Half the batch left out, the mean taken over the rest: the rows."""
    def fault(forest, X, *args, **kwargs):
        out = real(forest, X, *args, **kwargs).clone()
        half = out.shape[0] // 2
        out[half:] = out[:half].mean()
        return out
    return fault


def _one_answer_altered(real):
    """An answer altered where it is produced."""
    def fault(forest, X, *args, **kwargs):
        out = real(forest, X, *args, **kwargs).clone()
        out[out.shape[0] // 3] += 0.25
        return out
    return fault


def _raises_in_the_window(real):
    """A call that raises once the window has answered more calls than the
    comparison reads: the window ends there, and the call is due and
    missing."""
    from portbench.loops import bulk

    calls = iter(range(1 << 30))

    def fault(forest, X, *args, **kwargs):
        if next(calls) >= bulk.WARM_CALLS + bulk.KEEP + 2:
            raise RuntimeError("planted")
        return real(forest, X, *args, **kwargs)
    return fault


FAULTS = [_unchanged, _half_the_trees, _half_the_rows, _one_answer_altered, _raises_in_the_window]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("cell,overrides", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, cell, overrides):
    from isoforest_tpu_torch.models import isolation_forest

    monkeypatch.setattr(isolation_forest, "score_matrix", fault(isolation_forest.score_matrix))
    # the raising call ends its window long before the window's length
    result = run(cell, overrides, seconds=300.0 if fault is _raises_in_the_window else 3.0)
    assert result["attempted"] > 0
    assert not result["correct"], result["checks"]

