"""The port's quantized (q16) scoring plane (``ops/scoring_layout.py``,
``ops/traversal.py``, ``score_matrix(strategy="q16")``, the autotuner's
``|q16`` facet and the models' scoring representation) against the JAX
package's, on the CPU.

Tolerances: the layouts are equal array for array, and the rank walks'
path lengths bitwise, wherever the two packages' leaf values agree (the
leaf LUT holds ``depth + c(n)``, and torch's and XLA's float32 ``log`` make
``c(n)`` differ by an ulp at a few n, ``test_torch_math.py``): the committed
fixtures hit none of them, and the random forests here draw leaf sizes
only where the two agree. The q16 walk equals the port's own gather walk
bitwise on rows without NaN (a NaN ranks past every edge and goes right,
where the float compare sends it left: the JAX package's documented
exception). Scores are held within 2e-6 of the JAX package's ``q16``
scores: the final ``exp2`` and ``c(num_samples)`` round differently in
the two frameworks, and the JAX package's CPU ``q16`` runs its native
walker, which sums trees in another order.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

import isoforest_tpu.tuning as jax_tuning
from isoforest_tpu.models import ExtendedIsolationForestModel as JaxExtendedModel
from isoforest_tpu.models import IsolationForestModel as JaxModel
from isoforest_tpu.ops import scoring_layout as jlayout
from isoforest_tpu.ops import traversal as jtraversal
from isoforest_tpu.ops.dense_traversal import standard_path_lengths_dense_q as jax_dense_q
from isoforest_tpu.ops.ext_growth import ExtendedForest as JaxExtForest
from isoforest_tpu.ops.tree_growth import StandardForest as JaxForest
from isoforest_tpu.utils.math import avg_path_length as jax_avg_path_length
import isoforest_tpu_torch.tuning as tuning
from isoforest_tpu_torch import IsolationForest, load_model, telemetry
from isoforest_tpu_torch.io.interop import extended_forest_from_arrays, forest_from_arrays, model_from_arrays
from isoforest_tpu_torch.ops import scoring_layout as layout
from isoforest_tpu_torch.ops import traversal
from isoforest_tpu_torch.ops.traversal import _SCORED_ROWS_TOTAL
from isoforest_tpu_torch.resilience import faults
from isoforest_tpu_torch.resilience.degradation import DegradationError, degradation_report, reset_degradations
from isoforest_tpu_torch.testing import random_extended_forest, random_heap_forest, rows
from isoforest_tpu_torch.utils.math import avg_path_length, score_from_path_length

PORT_DIR = pathlib.Path(__file__).parent / "resources" / "torch_port"
FIXTURES = {"std": PORT_DIR / "mammography_std" / "model", "eif": PORT_DIR / "mammography_eif" / "model"}
JAX_MODELS = {"std": JaxModel, "eif": JaxExtendedModel}
ATOL = 2e-6


@pytest.fixture(scope="module")
def fixtures():
    return {kind: (load_model(str(path), device="cpu"), JAX_MODELS[kind].load(str(path)))
            for kind, path in FIXTURES.items()}


def _numpy(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_layouts_equal(port, ref):
    assert type(port).__name__ == type(ref).__name__ and len(port) == len(ref)
    for field, got, want in zip(port._fields, port, ref):
        got, want = _numpy(got), np.asarray(want)
        if want.dtype == np.uint32:  # the port keeps the u32 records' bits in int32
            assert got.dtype == np.int32, field
            got = got.view(np.uint32)
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), err_msg=field)


def _agreeing_sizes(limit: int = 300) -> list:
    """Leaf sizes whose ``c(n)`` is bitwise equal in both packages."""
    n = np.arange(limit)
    same = avg_path_length(n).numpy().view(np.int32) == np.asarray(jax_avg_path_length(n)).view(np.int32)
    return [int(v) for v in n[same]]


def _standard_pair(seed: int, trees: int = 11, height: int = 6, features: int = 5):
    rng = np.random.default_rng(seed)
    arrays = random_heap_forest(rng, trees=trees, height=height, features=features, sizes=_agreeing_sizes())
    return rng, forest_from_arrays(*arrays, device="cpu"), JaxForest(*arrays)


def _extended_pair(seed: int, trees: int = 9, height: int = 5, features: int = 6, k: int = 3):
    rng = np.random.default_rng(seed)
    arrays = random_extended_forest(rng, trees=trees, height=height, features=features, k=k, unused_p=0.2,
                                    sizes=_agreeing_sizes())
    return rng, extended_forest_from_arrays(*arrays, device="cpu"), JaxExtForest(*arrays)


def _ineligible(fence: str):
    """``(port forest, JAX forest)`` that fail one fence each."""
    rng = np.random.default_rng(len(fence))
    if fence == "ext_index":
        arrays = list(random_extended_forest(rng, trees=3, height=3, features=6, k=2))
        arrays[0] = np.where(arrays[0] >= 0, arrays[0] + 40_000, -1).astype(np.int32)
        return extended_forest_from_arrays(*arrays, device="cpu"), JaxExtForest(*arrays)
    trees = {"edges": 400, "lut": 400, "feature": 3}[fence]  # about 96,000 internal nodes and leaves
    feature, threshold, num_instances = random_heap_forest(rng, trees=trees, height=8, features=4, split_p=0.99)
    if fence == "edges":
        threshold = rng.normal(size=threshold.shape).astype(np.float32)
    elif fence == "lut":
        sizes = np.asarray(_agreeing_sizes(1_000_000))
        num_instances = np.where(num_instances >= 0, rng.choice(sizes, num_instances.shape), -1).astype(np.int32)
    else:
        feature = np.where(feature >= 0, 65_535, -1).astype(np.int32)
    arrays = (feature, threshold, num_instances)
    return forest_from_arrays(*arrays, device="cpu"), JaxForest(*arrays)


# -- layouts and fences ------------------------------------------------------


@pytest.mark.parametrize("kind", ["std", "eif"])
def test_layouts_equal_the_jax_packages_on_the_fixtures(fixtures, kind):
    port, ref = fixtures[kind]
    _assert_layouts_equal(layout.pack_forest_q(port.forest), jlayout.pack_forest_q(ref.forest))
    assert layout.quantized_unsupported_reason(port.forest) is None
    assert jlayout.quantized_unsupported_reason(ref.forest) is None


@pytest.mark.parametrize("fence", ["edges", "lut", "feature", "ext_index"])
def test_each_fence_refuses_as_the_jax_package_does(fence):
    port, ref = _ineligible(fence)
    reason = layout.quantized_unsupported_reason(port)
    assert reason is not None and reason == jlayout.quantized_unsupported_reason(ref)
    assert not layout.quantized_eligible(port)
    _assert_layouts_equal(layout.pack_forest_q(port), jlayout.pack_forest_q(ref))


def test_fence_limits_are_the_jax_packages():
    for name in ("_Q16_MAX_EDGES", "_Q16_MAX_LUT", "_Q16_FEATURE_SENTINEL", "_Q16_MAX_FEATURE_ID",
                 "_Q16_EXT_MAX_FEATURE_ID"):
        assert getattr(layout, name) == getattr(jlayout, name), name


def test_the_verdict_is_cached_per_forest(monkeypatch):
    """The verdict lives in the caller's per-forest dict, and nowhere else."""
    _, forest, _ = _standard_pair(5)
    cache: dict = {}
    assert layout.quantized_unsupported_reason(forest, cache) is None
    assert "q16_reason" in cache and cache["q16_reason"] is None
    monkeypatch.setattr(layout, "_quantized_unsupported_reason_uncached",
                        lambda f: pytest.fail("the verdict was computed again"))
    assert layout.quantized_eligible(forest, cache)
    with pytest.raises(pytest.fail.Exception):
        layout.quantized_eligible(forest, {})
    with pytest.raises(pytest.fail.Exception):
        layout.quantized_eligible(forest)


def test_a_model_computes_the_verdict_once(mammography, tmp_path, monkeypatch):
    """``auto``'s key and pool, ``q16``'s fence and the representation's
    all read the verdict from the model's own cache."""
    monkeypatch.setenv("ISOFOREST_TPU_AUTOTUNE", "1")
    monkeypatch.setenv("ISOFOREST_TPU_AUTOTUNE_PATH", str(tmp_path / "table.json"))
    monkeypatch.setenv("ISOFOREST_TPU_AUTOTUNE_REPS", "1")
    monkeypatch.delenv("ISOFOREST_TPU_STRATEGY", raising=False)
    X = mammography[0][:256]
    model = IsolationForest(num_estimators=8, max_samples=64.0, random_seed=4, device="cpu").fit(X, baseline=False)
    calls = []
    uncached = layout._quantized_unsupported_reason_uncached
    monkeypatch.setattr(layout, "_quantized_unsupported_reason_uncached", lambda f: calls.append(f) or uncached(f))
    tuning.reset_cost_model()
    try:
        for _ in range(2):
            model.score(X)
            model.score(X[:1])
            model.score(X, strategy="q16")
        model.set_scoring_representation("q16")
    finally:
        tuning.reset_cost_model()
    assert len(calls) == 1


def test_layout_bytes_count_every_table(fixtures):
    port, _ = fixtures["std"]
    q = layout.pack_standard_q(port.forest)
    t, m = port.forest.feature.shape
    assert layout.layout_nbytes(q) == 4 * (t * m + q.edges.numel() + q.lut.numel())
    assert layout.layout_nbytes(layout.pack_standard(port.forest)) == 8 * t * m


# -- the walks ----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["std", "eif"])
def test_q16_walk_is_bitwise_on_the_fixtures(fixtures, mammography, kind):
    port, ref = fixtures[kind]
    X = np.ascontiguousarray(mammography[0][:1500])
    got = traversal.path_lengths_q(port.forest, torch.from_numpy(X)).numpy()
    gather = traversal.standard_path_lengths if kind == "std" else traversal.extended_path_lengths
    np.testing.assert_array_equal(got, gather(port.forest, torch.from_numpy(X)).numpy())
    np.testing.assert_array_equal(got, np.asarray(jtraversal.path_lengths_q(ref.forest, X)))


@pytest.mark.parametrize("kind", ["std", "eif"])
@pytest.mark.parametrize("seed", [1, 2])
def test_q16_walk_is_bitwise_on_random_forests_with_nonfinite_rows(kind, seed):
    """Trees not a multiple of the 8-tree block, rows with NaN and +-inf:
    bitwise to the JAX package's rank walk on every row, and to the port's
    gather walk on the rows without NaN."""
    rng, port, ref = (_standard_pair if kind == "std" else _extended_pair)(seed)
    X = rows(rng, 517, 5 if kind == "std" else 6)
    got = traversal.path_lengths_q(port, torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jtraversal.path_lengths_q(ref, X)))
    gather = traversal.standard_path_lengths if kind == "std" else traversal.extended_path_lengths
    finite = ~np.isnan(X).any(axis=1)
    np.testing.assert_array_equal(got[finite], gather(port, torch.from_numpy(X)).numpy()[finite])


def test_binarize_ranks_equals_jax_searchsorted():
    edges = np.float32([-2.0, -0.5, 0.0, 0.5, 3.0])
    X = np.float32([[-3, -2, -0.5, -0.0, 0.0], [0.25, 0.5, 3.0, np.inf, -np.inf], [np.nan, 1, 2, 4, -1]])
    got = traversal.binarize_ranks(torch.from_numpy(edges), torch.from_numpy(X))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtraversal.binarize_ranks(edges, X)))


def test_dense_q_is_bitwise_to_the_jax_function(fixtures, mammography):
    port, ref = fixtures["std"]
    X = np.ascontiguousarray(mammography[0][:512])
    got = traversal.standard_path_lengths_dense_q(port.forest, torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_dense_q(ref.forest, X)))
    rng, forest, jforest = _standard_pair(3, trees=6, height=4, features=14)  # the JAX one-hot branch
    X = rows(rng, 300, 14)
    got = traversal.standard_path_lengths_dense_q(forest, torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_dense_q(jforest, X)))


def test_rows_exactly_on_a_threshold_route_as_the_float_compare():
    """Grid rows land on thresholds: ``rx > code`` must go right exactly
    where ``x >= threshold`` does."""
    rng = np.random.default_rng(9)
    X = rng.integers(0, 3, size=(3000, 4)).astype(np.float32)
    model = IsolationForest(num_estimators=16, max_samples=128.0, random_seed=2, device="cpu").fit(X, baseline=False)
    feature, threshold = model.forest.feature.numpy(), model.forest.threshold.numpy()
    thr = threshold[feature >= 0]
    Xt = np.ascontiguousarray(np.tile(thr[:64], (4, 1)).T.astype(np.float32))
    jforest = JaxForest(*(a.numpy() for a in model.forest))
    for data in (X[:512], Xt):
        t = torch.from_numpy(data)
        base = score_from_path_length(traversal.standard_path_lengths(model.forest, t), model.num_samples)
        got = model.score(t, strategy="q16")
        np.testing.assert_array_equal(got.numpy(), base.numpy())
        np.testing.assert_array_equal(traversal.path_lengths_q(model.forest, t).numpy(),
                                      np.asarray(jtraversal.path_lengths_q(jforest, data)))


# -- score_matrix -------------------------------------------------------------


@pytest.mark.parametrize("kind", ["std", "eif"])
def test_q16_scores_match_the_jax_packages(fixtures, mammography, kind):
    port, ref = fixtures[kind]
    X = np.ascontiguousarray(mammography[0][:4096])
    got = port.score(X, strategy="q16")
    assert got.dtype == torch.float32 and got.shape == (len(X),)
    gather = traversal.standard_path_lengths if kind == "std" else traversal.extended_path_lengths
    want_port = score_from_path_length(gather(port.forest, torch.from_numpy(X)), port.num_samples)
    np.testing.assert_array_equal(got.numpy(), want_port.numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.score(X, strategy="q16")), rtol=0, atol=ATOL)


def test_q16_chunks_are_bitwise_neutral(fixtures, mammography):
    port, _ = fixtures["std"]
    X = mammography[0][:300]
    whole = port.score(X, strategy="q16")
    np.testing.assert_array_equal(port.score(X, strategy="q16", chunk_size=7).numpy(), whole.numpy())
    np.testing.assert_array_equal(port.score(X, strategy="q16", chunk_size=7, pipeline=False).numpy(),
                                  whole.numpy())


def test_q16_keeps_its_own_tables_beside_the_f32_ones(fixtures, mammography):
    port, _ = fixtures["std"]
    cache: dict = {}
    X = torch.from_numpy(mammography[0][:64])
    traversal.score_matrix(port.forest, X, port.num_samples, strategy="walk", device="cpu", cache=cache)
    traversal.score_matrix(port.forest, X, port.num_samples, strategy="q16", device="cpu", cache=cache)
    q = cache[("q16", torch.device("cpu"))]
    assert isinstance(q, layout.QuantizedStandardLayout) and ("walk", torch.device("cpu")) in cache
    traversal.score_matrix(port.forest, X, port.num_samples, strategy="q16", device="cpu", cache=cache)
    assert cache[("q16", torch.device("cpu"))] is q


def test_an_ineligible_forest_takes_the_rung_onto_the_walk():
    """The pinned difference: the JAX package lands on its gather walk, the
    port on the walk kernel; ``strict`` raises instead."""
    port, _ = _ineligible("edges")
    model = model_from_arrays(*(a.numpy() for a in port), num_samples=256, num_features=4, device="cpu")
    X = rows(np.random.default_rng(0), 200, 4)
    reset_degradations("q16_unsupported")
    got = model.score(X, strategy="q16")
    np.testing.assert_array_equal(got.numpy(), model.score(X, strategy="walk").numpy())
    event = {e.reason: e for e in degradation_report().events()}["q16_unsupported"]
    assert (event.from_, event.to) == ("q16", "walk") and "distinct thresholds" in event.detail
    with pytest.raises(DegradationError, match="q16_unsupported"):
        model.score(X, strategy="q16", strict=True)
    with pytest.raises(ValueError, match="cannot take the q16 representation"):
        model.set_scoring_representation("q16")
    assert model.scoring_representation == "f32"
    reset_degradations("q16_unsupported")


def test_q16_runs_the_fault_seam_and_the_scoring_telemetry(fixtures, mammography):
    port, _ = fixtures["std"]
    X = mammography[0][:100]
    with faults.inject(raise_strategy="q16"):
        with pytest.raises(faults.FaultInjectedError, match="q16"):
            port.score(X, strategy="q16")
    telemetry.enable()
    before = _SCORED_ROWS_TOTAL.value(strategy="q16")
    port.score(X, strategy="q16")
    assert _SCORED_ROWS_TOTAL.value(strategy="q16") - before == 100


# -- the autotuner -------------------------------------------------------------


def test_the_q16_facet_keys_as_the_jax_package(fixtures):
    port, ref = fixtures["std"]
    for p, j, facet in ((port.forest, ref.forest, True), (*_ineligible("edges"), False)):
        key = tuning.decision_key("cpu", p, 4096, 6)
        assert key == jax_tuning.decision_key("cpu", j, 4096, 6)
        assert key.endswith("|q16") == facet
        assert ("q16" in tuning.eligible_strategies(p, "cpu")) == facet
        assert "q16" not in tuning.eligible_strategies(p, "cuda")


def test_the_card_probes_walk_and_dense_only(fixtures, mammography, tmp_path, monkeypatch):
    """A cold ``auto`` key on the card probes the two kernels and no q16,
    under the JAX package's ``|q16`` key."""
    from isoforest_tpu_torch.tuning import autotuner

    port, _ = fixtures["std"]
    monkeypatch.setenv("ISOFOREST_TPU_AUTOTUNE", "1")
    monkeypatch.setenv("ISOFOREST_TPU_AUTOTUNE_PATH", str(tmp_path / "table.json"))
    monkeypatch.delenv("ISOFOREST_TPU_STRATEGY", raising=False)
    probed = []
    monkeypatch.setattr(traversal, "score_matrix", lambda forest, X, n, strategy, **kw: probed.append(strategy))
    monkeypatch.setattr(autotuner, "_probe_slice", lambda X, rows, device: X[:rows])  # rows stay on the host
    tuning.reset_cost_model()
    try:
        d = tuning.resolve_decision(port.forest, mammography[0][:64], port.num_samples, device="cuda",
                                    cache=port._cache)
    finally:
        tuning.reset_cost_model()
    assert d.source == "probe" and d.key.startswith("v1|cuda|") and d.key.endswith("|std|q16")
    assert set(d.timings_s) == {"walk", "dense"} and set(probed) == {"walk", "dense"}


def test_a_q16_pin_resolves_as_a_pin(fixtures, mammography, monkeypatch):
    port, _ = fixtures["std"]
    monkeypatch.setenv("ISOFOREST_TPU_STRATEGY", "q16")
    X = mammography[0][:64]
    d = tuning.resolve_decision(port.forest, X, port.num_samples, cache=port._cache)
    assert (d.strategy, d.source) == ("q16", "pin")
    np.testing.assert_array_equal(port.score(X).numpy(), port.score(X, strategy="q16").numpy())


# -- the models' representation -------------------------------------------------


def test_set_scoring_representation_swaps_the_tables(mammography):
    X = mammography[0][:1000]
    model = IsolationForest(num_estimators=8, max_samples=64.0, contamination=0.0, random_seed=4,
                            device="cpu").fit(X, baseline=False)
    cpu = torch.device("cpu")
    # fit finalizes the f32 walk's tables: no threshold pass or baseline ran
    assert model.scoring_representation == "f32" and set(model._cache) == {("walk", cpu)}
    walk = model.score(X)
    gather = score_from_path_length(traversal.standard_path_lengths(model.forest, torch.from_numpy(X)),
                                    model.num_samples)
    model.score(X, strategy="dense")
    with pytest.raises(ValueError, match="must be one of f32/q16"):
        model.set_scoring_representation("q4")
    assert model.set_scoring_representation("q16") is model
    assert model.scoring_representation == "q16"
    assert [k for k in model._cache if isinstance(k, tuple)] == [("q16", cpu)]
    # a preference, not a pin: auto still resolves (the walk, with the tuner off)
    np.testing.assert_array_equal(model.score(X).numpy(), walk.numpy())
    np.testing.assert_array_equal(model.score(X, strategy="q16").numpy(), gather.numpy())
    assert model.set_scoring_representation("f32").finalize_scoring() is model
    assert ("walk", cpu) in model._cache


def test_on_the_card_the_representation_keeps_the_f32_tables(mammography, monkeypatch):
    """On the card ``auto`` serves the kernels from the f32 tables, so
    ``q16`` is recorded and the tables stay; the plane waits for its first
    ``strategy="q16"`` call."""
    from isoforest_tpu_torch.models.isolation_forest import IsolationForestModel

    X = mammography[0][:300]
    model = IsolationForest(num_estimators=8, max_samples=64.0, random_seed=4, device="cpu").fit(X, baseline=False)
    card = torch.device("cuda")
    monkeypatch.setattr(IsolationForestModel, "device", property(lambda self: card))
    walk = model._cache[("walk", torch.device("cpu"))]
    assert model.set_scoring_representation("q16").scoring_representation == "q16"
    assert model._cache[("walk", torch.device("cpu"))] is walk and ("walk", card) in model._cache
    assert not any(isinstance(k, tuple) and k[0] == "q16" for k in model._cache)


def test_the_representation_errors_name_the_jax_packages_values(fixtures):
    from isoforest_tpu.models.isolation_forest import SCORING_REPRESENTATIONS as JAX_REPRESENTATIONS
    from isoforest_tpu_torch.models.isolation_forest import SCORING_REPRESENTATIONS

    assert SCORING_REPRESENTATIONS == JAX_REPRESENTATIONS
    port, ref = fixtures["eif"]
    with pytest.raises(ValueError) as ours:
        port.set_scoring_representation("q8")
    with pytest.raises(ValueError) as theirs:
        ref.set_scoring_representation("q8")
    assert str(ours.value) == str(theirs.value)
