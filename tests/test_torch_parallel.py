"""The port's multi-device layer (``isoforest_tpu_torch/parallel``) against
the JAX package's (``isoforest_tpu/parallel``), on the CPU: a port mesh of
eight logical ``cpu`` shards beside the JAX package's mesh over its eight
virtual CPU devices (``tests/conftest.py``), class for class as
``tests/test_parallel.py``.

Tolerances: growth is bitwise (per-tree keys make the shard placement
irrelevant), to the port's own growth and to the JAX package's; row-sharded
scores are bit for bit the port's unsharded ones (scoring is
row-independent and the scores come from one ``exp2`` over all N) and
within 2e-6 of the JAX package's (the packages' walks sum in other
orders); 2-D scores and the train step's scores within 2e-6 (other sum
orders again); thresholds are exactly the port's unsharded ones and meet
the rank contract.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isoforest_tpu import ExtendedIsolationForest as JaxEIF
from isoforest_tpu import IsolationForest as JaxIF
from isoforest_tpu.ops import bagging as jbagging
from isoforest_tpu.ops.ext_growth import ExtendedForest as JaxExtendedForest
from isoforest_tpu.ops.tree_growth import StandardForest as JaxStandardForest
from isoforest_tpu.parallel import create_mesh as jax_create_mesh
from isoforest_tpu.parallel import make_train_step as jax_make_train_step
from isoforest_tpu.parallel import sharded_grow_extended_forest as jax_sharded_grow_extended
from isoforest_tpu.parallel import sharded_grow_forest as jax_sharded_grow
from isoforest_tpu.parallel import sharded_score as jax_sharded_score
from isoforest_tpu.parallel import sharded_score_2d as jax_sharded_score_2d
from isoforest_tpu_torch import ExtendedIsolationForest, IsolationForest, telemetry
from isoforest_tpu_torch.ops import bagging, prng
from isoforest_tpu_torch.ops.ext_growth import grow_extended_forest
from isoforest_tpu_torch.ops.quantile import quantile_rank_error
from isoforest_tpu_torch.ops.streaming import pipeline_stats
from isoforest_tpu_torch.ops.traversal import mean_path_lengths
from isoforest_tpu_torch.ops.tree_growth import StandardForest, grow_forest
from isoforest_tpu_torch.parallel import (
    create_mesh,
    make_train_step,
    sharded_grow_extended_forest,
    sharded_grow_forest,
    sharded_score,
    sharded_score_2d,
)
from isoforest_tpu_torch.parallel import sharded as sh
from isoforest_tpu_torch.resilience.degradation import degradation_report, reset_degradations
from isoforest_tpu_torch.testing import torch_threads
from isoforest_tpu_torch.utils.math import height_limit

CPU8 = [torch.device("cpu")] * 8
TOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def mesh():
    return create_mesh(CPU8)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest should force 8 virtual cpu devices"
    return jax_create_mesh()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(4096, 5)).astype(np.float32)
    X[:50] += 6.0
    return X


@pytest.fixture(scope="module")
def models(data):
    """Port models (device cpu) of both kinds: 16 standard trees and 10 EIF
    trees (10 pads to 12 over the trees axis, and to 16 over eight shards)."""
    return {
        "standard": IsolationForest(num_estimators=16, max_samples=64.0, device="cpu").fit(data, baseline=False),
        "extended": ExtendedIsolationForest(num_estimators=10, max_samples=64.0, extension_level=2,
                                            device="cpu").fit(data, baseline=False),
    }


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _jax_forest(forest):
    cls = JaxStandardForest if isinstance(forest, StandardForest) else JaxExtendedForest
    return cls(*(jnp.asarray(_np(a)) for a in forest))


def _assert_forests_equal(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        a, b = _np(a), _np(b)
        if a.dtype == np.float32:
            np.testing.assert_array_equal(a.view(np.int32), b.astype(np.float32).view(np.int32))
        else:
            np.testing.assert_array_equal(a, b)


class TestMesh:
    def test_factorisation(self, mesh, jmesh):
        assert mesh.shape == {"data": 2, "trees": 4} == dict(jmesh.shape)
        assert mesh.size == 8 and mesh.local_shards == list(range(8)) and not mesh.distributed

    @pytest.mark.parametrize("d", [1, 2, 4, 8])
    def test_explicit_data_parallelism(self, d):
        assert create_mesh(CPU8, data_parallelism=d).shape == dict(jax_create_mesh(data_parallelism=d).shape)

    def test_indivisible_data_parallelism_refused_as_in_jax(self):
        with pytest.raises(ValueError) as ref:
            jax_create_mesh(data_parallelism=3)
        with pytest.raises(ValueError) as got:
            create_mesh(CPU8, data_parallelism=3)
        assert str(got.value) == str(ref.value)

    def test_single_device_mesh(self):
        m = create_mesh([torch.device("cpu")])
        assert m.shape == {"data": 1, "trees": 1} == dict(jax_create_mesh(devices=jax.devices()[:1]).shape)

    def test_without_devices_the_mesh_wants_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="torch.device\\('cpu'\\)"):
            create_mesh()


def _draws(seed: int, rows: int, trees: int, samples: int, features: int):
    """The port's draws and the JAX package's from the same seed (both
    packages' threefry streams are bitwise equal)."""
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    port = (bagging.per_tree_keys(prng.fold_in(key, 2), trees),
            bagging.bagged_indices(prng.fold_in(key, 0), rows, samples, trees, False),
            bagging.feature_subsets(prng.fold_in(key, 1), features, features, trees))
    ref = (jbagging.per_tree_keys(jax.random.fold_in(jkey, 2), trees),
           jbagging.bagged_indices(jax.random.fold_in(jkey, 0), rows, samples, trees, False),
           jbagging.feature_subsets(jax.random.fold_in(jkey, 1), features, features, trees))
    return port, ref


class TestShardedGrowth:
    @pytest.mark.parametrize("trees,seed", [(16, 0), (10, 1)], ids=["T16", "T10_padded"])
    @pytest.mark.parametrize("kind", ["standard", "extended"])
    def test_grow_bitwise_to_local_and_to_jax(self, mesh, jmesh, data, kind, trees, seed):
        (tk, bag, fidx), (jtk, jbag, jfidx) = _draws(seed, len(data), trees, 64, 5)
        np.testing.assert_array_equal(_np(bag), np.asarray(jbag))
        h = height_limit(64)
        X = torch.from_numpy(data)
        if kind == "standard":
            got = sharded_grow_forest(mesh, tk, X, bag, fidx, h)
            local = grow_forest(tk, X, bag, fidx, h)
            ref = jax_sharded_grow(jmesh, jtk, data, jbag, jfidx, h)
        else:
            got = sharded_grow_extended_forest(mesh, tk, X, bag, fidx, h, 2)
            local = grow_extended_forest(tk, X, bag, fidx, h, 2)
            ref = jax_sharded_grow_extended(jmesh, jtk, data, jbag, jfidx, h, 2)
        assert got.num_trees == trees
        _assert_forests_equal(got, local)
        _assert_forests_equal(got, ref)


class TestShardedScore:
    @pytest.mark.parametrize("chunk", [None, 1024, 1000], ids=["single", "chunk1024", "chunk1000"])
    @pytest.mark.parametrize("rows", [4096, 4093])
    @pytest.mark.parametrize("strategy", ["walk", "dense"])
    @pytest.mark.parametrize("kind", ["standard", "extended"])
    def test_bit_for_bit_unsharded_and_near_jax(self, mesh, jmesh, data, models, kind, strategy, rows, chunk):
        model = models[kind]
        X = data[:rows]
        local = model.score(X, strategy=strategy)
        got = sharded_score(mesh, model.forest, X, model.num_samples, strategy,
                            pipeline=chunk is not None, chunk_rows=chunk, cache=model._cache)
        assert got.shape == (rows,) and got.dtype == torch.float32
        np.testing.assert_array_equal(_np(got), _np(local))
        if chunk is None:
            ref = np.asarray(jax_sharded_score(jmesh, _jax_forest(model.forest), X, model.num_samples))
            assert np.abs(_np(got) - ref).max() <= TOL

    def test_streamed_chunks_split_over_the_shards(self, mesh, data, models):
        from isoforest_tpu_torch.ops import streaming

        model = models["standard"]
        before = pipeline_stats("sharded")["chunks"]
        sharded_score(mesh, model.forest, data, model.num_samples, "walk", pipeline=True, chunk_rows=1024)
        # 4096 rows in 512-row shard blocks, 128 rows a shard a step
        assert pipeline_stats("sharded")["chunks"] - before == 8 * 4
        # the eight shards on one device share one cached pair of buffers
        assert [k for k in streaming._STAGING if k[1:] == (128, 5)] == [("cpu", 128, 5)]

    def test_explicit_strategy_outside_the_pool_raises(self, mesh, data, models):
        model = models["standard"]
        for bad in ("gather", "q16", "native"):
            with pytest.raises(ValueError, match="score_strategy"):
                sharded_score(mesh, model.forest, data, model.num_samples, bad)


class TestShardedScore2D:
    @pytest.mark.parametrize("streamed", [False, True])
    @pytest.mark.parametrize("strategy", ["walk", "dense"])
    @pytest.mark.parametrize("kind", ["standard", "extended"])
    def test_near_unsharded_and_jax(self, mesh, jmesh, data, models, kind, strategy, streamed):
        model = models[kind]
        X = data[:4093]
        got = sharded_score_2d(mesh, model.forest, X, model.num_samples, strategy, cache=model._cache,
                               pipeline=streamed, chunk_rows=1024 if streamed else None)
        assert got.shape == (4093,)
        assert float((got - model.score(X, strategy=strategy)).abs().max()) <= TOL
        ref = np.asarray(jax_sharded_score_2d(jmesh, _jax_forest(model.forest), X, model.num_samples))
        assert np.abs(_np(got) - ref).max() <= TOL
        if streamed:
            single = sharded_score_2d(mesh, model.forest, X, model.num_samples, strategy, pipeline=False)
            np.testing.assert_array_equal(_np(got), _np(single))

    @pytest.mark.parametrize("strategy", ["walk", "dense"])
    @pytest.mark.parametrize("kind", ["standard", "extended"])
    def test_neutral_pad_trees_add_exactly_zero(self, data, models, kind, strategy):
        # the pad trees are root leaves of one instance (c(1) = 0): a forest
        # of only such trees walks every row to exactly 0 through the
        # kernels' tables (an EIF pad's root has indices -1)
        forest = models[kind].forest
        one = type(forest)(*(a[:1] for a in forest))
        padded, pad = sh._pad_trees_neutral(one, 4)
        assert pad == 3 and padded.num_trees == 4
        neutral = type(forest)(*(a[1:] for a in padded))
        if kind == "extended":
            assert bool((neutral.indices == -1).all())
        pl = mean_path_lengths(neutral, torch.from_numpy(data), strategy, device=torch.device("cpu"), cache={},
                               chunk_rows=4096)
        assert float(pl.abs().max()) == 0.0


class TestFitViaMesh:
    @pytest.mark.parametrize("checkpointed", [False, True])
    @pytest.mark.parametrize("kind", ["standard", "extended"])
    def test_fit_with_mesh(self, mesh, jmesh, data, tmp_path, kind, checkpointed):
        params = dict(num_estimators=12, max_samples=128.0, contamination=0.02)
        if kind == "extended":
            params["extension_level"] = 2
        port_cls, jax_cls = (IsolationForest, JaxIF) if kind == "standard" else (ExtendedIsolationForest, JaxEIF)
        ck = dict(checkpoint_dir=str(tmp_path / "port"), checkpoint_every=5) if checkpointed else {}
        jck = dict(checkpoint_dir=str(tmp_path / "jax"), checkpoint_every=5) if checkpointed else {}
        local = port_cls(**params, device="cpu").fit(data, baseline=False)
        got = port_cls(**params, device="cpu").fit(data, baseline=False, mesh=mesh, **ck)
        ref = jax_cls(**params).fit(data, mesh=jmesh, baseline=False, **jck)
        _assert_forests_equal(got.forest, local.forest)
        _assert_forests_equal(got.forest, ref.forest)
        assert got.outlier_score_threshold == local.outlier_score_threshold
        assert abs(got.outlier_score_threshold - ref.outlier_score_threshold) <= TOL
        if checkpointed:
            assert got.fit_checkpoint.blocks_written == 3

    def test_score_and_transform_through_the_mesh(self, mesh, data, models):
        model = models["standard"].set_outlier_score_threshold(0.6)
        np.testing.assert_array_equal(_np(model.score(data, mesh=mesh)), _np(model.score(data)))
        got, want = model.transform(data, mesh=mesh), model.transform(data)
        for col in want:
            np.testing.assert_array_equal(_np(got[col]), _np(want[col]))
        with pytest.raises(ValueError, match="features"):
            model.score(data[:, :4], mesh=mesh)
        bad = data[:64].copy()
        bad[0, 0] = np.nan
        with pytest.raises(ValueError, match="non-finite"):
            model.score(bad, mesh=mesh, nonfinite="raise")


    def test_nonfinite_counted_on_the_shards_once(self, mesh, data, models, caplog):
        # the last row repeats into the pad of the last shards; it counts once
        import logging

        model = models["standard"]
        bad = data[:4093].copy()
        bad[[0, 1000, 4092], 1] = [np.nan, np.inf, np.nan]
        messages = []
        for call in (lambda: model.score(bad), lambda: model.score(bad, mesh=mesh),
                     lambda: sharded_score_2d(mesh, model.forest, bad, model.num_samples, "walk", nonfinite="warn")):
            caplog.clear()
            with caplog.at_level(logging.WARNING):
                call()
            messages.append([r.getMessage() for r in caplog.records if "non-finite" in r.getMessage()])
        assert messages[0] == messages[1] == messages[2] and "3 non-finite" in messages[0][0]


class TestFusedTrainStep:
    KW = dict(num_rows=4096, num_features_total=5, num_trees=16, num_samples=64, num_features=5, contamination=0.1)
    SKETCH_EPS = 0.01

    @pytest.fixture(scope="class")
    def steps(self, mesh, jmesh, data):
        out = {}
        for name, extra in (("exact", {}), ("sketch", {"contamination_error": self.SKETCH_EPS}),
                            ("extended", {"extended": True, "extension_level": 2})):
            out[name] = (make_train_step(mesh, **self.KW, **extra)(prng.PRNGKey(0), data),
                         jax_make_train_step(jmesh, **self.KW, **extra)(jax.random.PRNGKey(0), data))
        return out

    @pytest.mark.parametrize("name", ["exact", "sketch", "extended"])
    def test_step_against_jax_and_own_scores(self, mesh, data, steps, name):
        got, ref = steps[name]
        _assert_forests_equal(got.forest, ref.forest)
        assert np.abs(_np(got.scores) - np.asarray(ref.scores)).max() <= TOL
        own = sharded_score(mesh, got.forest, data, 64, "walk")
        np.testing.assert_array_equal(_np(got.scores), _np(own))
        thr = float(got.threshold)
        err = quantile_rank_error(got.scores, thr, 0.9)
        if name == "exact":
            assert err == 0
            rank = int(np.ceil(0.9 * len(data))) - 1
            assert thr == float(np.sort(_np(got.scores))[rank])
        elif name == "sketch":
            assert err <= max(int(self.SKETCH_EPS * len(data)), 1)
        if name != "extended":
            assert abs(thr - float(ref.threshold)) <= TOL

    def test_dense_in_step_agrees_with_walk(self, mesh, data, steps):
        dense = make_train_step(mesh, score_strategy="dense", **self.KW)(prng.PRNGKey(0), data)
        assert float((dense.scores - steps["exact"][0].scores).abs().max()) <= TOL
        with pytest.raises(ValueError, match="score_strategy"):
            make_train_step(mesh, score_strategy="gather", **self.KW)

    def test_extended_without_contamination(self, mesh, jmesh, data):
        kw = dict(self.KW, num_trees=8, contamination=0.0)
        got = make_train_step(mesh, extended=True, extension_level=2, **kw)(prng.PRNGKey(0), data)
        ref = jax_make_train_step(jmesh, extended=True, extension_level=2, **kw)(jax.random.PRNGKey(0), data)
        assert float(got.threshold) == float(ref.threshold) == -1.0
        assert got.forest.k == ref.forest.k == 3

    @pytest.mark.parametrize("bad", [{"num_trees": 9}, {"num_rows": 4095}])
    def test_indivisible_counts_rejected_as_in_jax(self, mesh, jmesh, bad):
        kw = dict(self.KW, **bad)
        with pytest.raises(ValueError) as ref:
            jax_make_train_step(jmesh, **kw)
        with pytest.raises(ValueError) as got:
            make_train_step(mesh, **kw)
        assert str(got.value) == str(ref.value)

    def test_ineligible_pin_warns_once(self, mesh, data, models, monkeypatch, caplog):
        import logging

        model = models["standard"]
        monkeypatch.setenv("ISOFOREST_TPU_STRATEGY", "gather")
        reset_degradations("shard_pin_ineligible")
        with caplog.at_level(logging.WARNING):
            assert sh.resolve_sharded_strategy(mesh) == sh.resolve_sharded_strategy(mesh) == "walk"
            sharded_score(mesh, model.forest, data[:64], model.num_samples)
        assert degradation_report().count("shard_pin_ineligible") == 3
        assert len([r for r in caplog.records if "shard_pin_ineligible" in r.getMessage()]) == 1
        monkeypatch.setenv("ISOFOREST_TPU_STRATEGY", "dense")
        assert sh.resolve_sharded_strategy(mesh) == "dense"


class TestShardedAutotune:
    def test_sharded_pool_keys_and_per_shard_bucket(self, mesh, data, models, monkeypatch, tmp_path):
        from isoforest_tpu_torch import tuning

        monkeypatch.setenv("ISOFOREST_TPU_AUTOTUNE", "1")
        monkeypatch.setenv("ISOFOREST_TPU_AUTOTUNE_PATH", str(tmp_path / "table.json"))
        monkeypatch.setenv("ISOFOREST_TPU_AUTOTUNE_REPS", "1")
        tuning.reset_cost_model()
        model = models["standard"]
        last = max((e.seq for e in telemetry.get_events()), default=-1)
        sharded_score(mesh, model.forest, data, model.num_samples, cache=model._cache)
        (event,) = [e for e in telemetry.get_events(kind="autotune.decision", since_seq=last)]
        # 4096 rows over 8 shards: the 512-row shard keys the 1024 bucket
        assert event.fields["site"] == "sharded" and event.fields["source"] == "probe"
        assert event.fields["key"].endswith("|b1024|std|jittable")
        entry = tuning.table_snapshot()["entries"][event.fields["key"]]
        assert set(entry["timings_s"]) == {"walk", "dense"}
        tuning.reset_cost_model()


class TestMeshWarmup:
    def test_warmup_builds_what_a_warm_score_needs(self, mesh, data, models, monkeypatch):
        from isoforest_tpu_torch.utils import monitoring

        model = IsolationForest(num_estimators=8, max_samples=64.0, device="cpu").fit(data, baseline=False)
        assert model.warmup(batch_sizes=(64,), mesh=mesh, strategy="dense") is model
        builds = []
        real = monitoring.record_event_duration_secs
        monkeypatch.setattr(monitoring, "record_event_duration_secs",
                            lambda event, secs, **kw: (builds.append(event), real(event, secs, **kw)))
        scores = model.score(data[:64], mesh=mesh, strategy="dense")
        assert builds == [] and bool(torch.isfinite(scores).all())
