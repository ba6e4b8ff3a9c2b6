"""The port's out-of-core data plane (``isoforest_tpu_torch/io/source.py``,
``io/outofcore.py``, the streamed samplers of ``ops/bagging.py`` and
``fit_source``) against the JAX package's, on the CPU; and the fit volume
counters of every fit entry point (fault C8).

Tolerances. The sources, the samplers and the model hash are host numpy
copies: equal array for array and byte for byte. ``fit_source`` grows the
JAX package's forest node for node (its bags are the sampler's, its other
draws jax's threefry streams; these seeded fits meet no Gumbel near-tie).
The threshold is an exact quantile of each package's own training scores,
whose walks sum in other orders, so the thresholds agree within 2e-6, as
in ``tests/test_torch_fit.py``. ``score_source`` equals the port's own
``model.score`` of the same chunks under the same strategy exactly (one
call over all rows within an ulp: torch's CPU ``exp2`` rounds by vector
position), and the JAX package's ``score_source`` within 2e-6; sealed parts are byte-equal however the run
was cut, and a part either package sealed stays byte-equal when the other
resumes the sink.
"""

from __future__ import annotations

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from isoforest_tpu.io import outofcore as joutofcore
from isoforest_tpu.io import source as jsource
from isoforest_tpu.io.persistence import load_model as jax_load_model
from isoforest_tpu.models import ExtendedIsolationForest as JaxExtendedEstimator
from isoforest_tpu.models import IsolationForest as JaxEstimator
from isoforest_tpu.ops import bagging as jbagging
from isoforest_tpu.resilience import faults as jfaults
from isoforest_tpu.telemetry import metrics as jmetrics
from isoforest_tpu_torch import ExtendedIsolationForest, IsolationForest, load_model
from isoforest_tpu_torch.io import outofcore, source
from isoforest_tpu_torch.io.source import SourceFormatError, open_source
from isoforest_tpu_torch.ops import bagging
from isoforest_tpu_torch.resilience import faults
from isoforest_tpu_torch.resilience.checkpoint import CheckpointMismatchError
from isoforest_tpu_torch.telemetry import metrics
from isoforest_tpu_torch.testing import torch_threads

N, F = 8000, 5
TREES, SAMPLES = 10, 64
SEED = 23
BOUNDS = (0, 1000, 2500, 6999, N)  # four uneven shards
STD = dict(num_estimators=TREES, max_samples=float(SAMPLES), contamination=0.02, random_seed=SEED)
EXT = dict(STD, extension_level=2)
FIT_COUNTERS = ("isoforest_fit_rows_total", "isoforest_fit_trees_total")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run beside other test processes."""
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(41)
    X = rng.normal(size=(N, F)).astype(np.float32)
    X[:80] += 6.0
    y = np.zeros(N, dtype=np.float32)
    y[:80] = 1.0
    return X, y


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory, data):
    """Four uneven .npy shards covering ``data`` exactly."""
    X, _ = data
    d = tmp_path_factory.mktemp("shards")
    for i in range(4):
        source.write_npy_shard(str(d / f"part-{i:03d}.npy"), X[BOUNDS[i] : BOUNDS[i + 1]])
    return str(d)


def _chunks(X, sizes, chunk_cls):
    """A SourceChunk stream of ``X`` cut at ``sizes`` (cycled)."""
    out, start, i = [], 0, 0
    while start < len(X):
        n = sizes[i % len(sizes)]
        out.append(chunk_cls(X=X[start : start + n], y=None, shard_index=0, global_start=start))
        start += n
        i += 1
    return out


def _assert_same_sample(got, want):
    for field in ("X", "bag", "rows"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.total_rows == want.total_rows
    assert got.sha256 == want.sha256


def _fit_counts(metrics_module) -> dict:
    """A package's fit counters by (name, model label), read by name from its registry."""
    snap = metrics_module.registry().snapshot()
    return {(name, s["labels"]["model"]): s["value"]
            for name in FIT_COUNTERS for s in snap.get(name, {}).get("series", [])}


def _counted(metrics_module, fit):
    """``fit()``'s model and the package's fit counters' deltas over the call."""
    before = _fit_counts(metrics_module)
    model = fit()
    after = _fit_counts(metrics_module)
    return model, {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


def _forest_arrays(model):
    return [np.asarray(a.cpu().numpy() if isinstance(a, torch.Tensor) else a) for a in model.forest]


def _assert_same_forest(port, ref):
    for a, b in zip(_forest_arrays(port), _forest_arrays(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def _assert_port_models_bitwise(a, b, X):
    for x, y in zip(a.forest, b.forest):
        assert torch.equal(x, y)
    assert a.outlier_score_threshold == b.outlier_score_threshold
    assert torch.equal(a.score(X, strategy="walk"), b.score(X, strategy="walk"))


# --------------------------------------------------------------------------- #
# the fits of both packages, each with its fit counters' deltas (compiled once)
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def sample(data):
    bagger = jbagging.StreamedBagger(SEED, TREES, SAMPLES)
    bagger.consume(data[0])
    return bagger.finalize()


@pytest.fixture(scope="module")
def jax_fits(data, shard_dir, sample):
    X = data[0]
    run = {
        "fit": lambda: JaxEstimator(**STD).fit(X[:3000], baseline=False),
        "fit_from_sample": lambda: JaxEstimator(**STD).fit_from_sample(sample.X, sample.bag, baseline=False),
        "fit_from_sample_source_rows": lambda: JaxEstimator(**STD).fit_from_sample(
            sample.X, sample.bag, baseline=False, source_rows=N),
        "fit_source": lambda: JaxEstimator(**STD).fit_source(shard_dir, chunk_rows=997, baseline=False),
        "eif_fit": lambda: JaxExtendedEstimator(**EXT).fit(X[:3000], baseline=False),
        "eif_fit_from_sample": lambda: JaxExtendedEstimator(**EXT).fit_from_sample(sample.X, sample.bag,
                                                                                  baseline=False),
        "eif_fit_source": lambda: JaxExtendedEstimator(**EXT).fit_source(shard_dir, baseline=False),
    }
    return {name: _counted(jmetrics, fit) for name, fit in run.items()}


@pytest.fixture(scope="module")
def port_fits(data, shard_dir, sample):
    X = data[0]
    run = {
        "fit": lambda: IsolationForest(**STD, device="cpu").fit(X[:3000]),
        "fit_from_sample": lambda: IsolationForest(**STD, device="cpu").fit_from_sample(sample.X, sample.bag),
        "fit_from_sample_source_rows": lambda: IsolationForest(**STD, device="cpu").fit_from_sample(
            sample.X, sample.bag, source_rows=N),
        "fit_source": lambda: IsolationForest(**STD, device="cpu").fit_source(shard_dir, chunk_rows=997),
        "eif_fit": lambda: ExtendedIsolationForest(**EXT, device="cpu").fit(X[:3000]),
        "eif_fit_from_sample": lambda: ExtendedIsolationForest(**EXT, device="cpu").fit_from_sample(
            sample.X, sample.bag),
        "eif_fit_source": lambda: ExtendedIsolationForest(**EXT, device="cpu").fit_source(shard_dir),
    }
    return {name: _counted(metrics, fit) for name, fit in run.items()}


# --------------------------------------------------------------------------- #
# C8: the fit volume counters
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("entry", ["fit", "fit_from_sample", "fit_from_sample_source_rows", "fit_source", "eif_fit",
                                   "eif_fit_from_sample", "eif_fit_source"])
def test_fit_counters_count_as_the_jax_packages(entry, jax_fits, port_fits):
    want = jax_fits[entry][1]
    assert want, "the JAX package counted nothing"
    assert port_fits[entry][1] == want


def test_fit_counters_are_registered_as_the_jax_packages():
    port, ref = metrics.registry().snapshot(), jmetrics.registry().snapshot()
    for name in FIT_COUNTERS:
        assert port[name]["type"] == ref[name]["type"] == "counter"
        assert (port[name]["help"], port[name]["labelnames"]) == (ref[name]["help"], ref[name]["labelnames"])


def test_checkpointed_fit_counts_as_the_jax_packages(data, tmp_path):
    X = data[0][:3000]
    _, want = _counted(jmetrics, lambda: JaxEstimator(**STD).fit(
        X, baseline=False, checkpoint_dir=str(tmp_path / "jax"), checkpoint_every=4))
    _, got = _counted(metrics, lambda: IsolationForest(**STD, device="cpu").fit(
        X, checkpoint_dir=str(tmp_path / "port"), checkpoint_every=4))
    assert got == want == {("isoforest_fit_rows_total", "standard"): 3000.0,
                           ("isoforest_fit_trees_total", "standard"): float(TREES)}


# --------------------------------------------------------------------------- #
# the streamed samplers
# --------------------------------------------------------------------------- #


CHUNKINGS = {"one": [N], "rows_1": [1], "997": [997], "2^16": [1 << 16], "uneven": [7, 997, 64, 3001]}


@pytest.fixture(scope="module")
def whole_sample(data):
    bagger = bagging.StreamedBagger(SEED, TREES, SAMPLES)
    bagger.consume(data[0])
    return bagger.finalize()


@pytest.mark.parametrize("sizes", list(CHUNKINGS.values()), ids=list(CHUNKINGS))
def test_streamed_bagger_equals_the_jax_packages(sizes, data, whole_sample):
    X = data[0]
    port, ref = bagging.StreamedBagger(SEED, TREES, SAMPLES), jbagging.StreamedBagger(SEED, TREES, SAMPLES)
    for chunk in _chunks(X, sizes, source.SourceChunk):
        port.consume(chunk.X)
        ref.consume(chunk.X)
    got = port.finalize()
    _assert_same_sample(got, ref.finalize())
    _assert_same_sample(got, whole_sample)
    np.testing.assert_array_equal(got.X, X[got.rows])


def test_streamed_bagger_keeps_distinct_rows_per_tree(whole_sample):
    assert whole_sample.bag.min() >= 0 and whole_sample.bag.max() < len(whole_sample.rows)
    for t in range(TREES):
        assert len(np.unique(whole_sample.bag[t])) == SAMPLES


def test_a_stream_shorter_than_the_sample_raises():
    for mod in (bagging, jbagging):
        b = mod.StreamedBagger(1, num_trees=2, num_samples=64)
        b.consume(np.zeros((10, 3), np.float32))
        with pytest.raises(ValueError, match="cannot draw 64 distinct rows from a 10-row stream"):
            b.finalize()
    with pytest.raises(ValueError, match="num_trees > 0"):
        bagging.StreamedBagger(1, num_trees=0, num_samples=4)


@pytest.mark.parametrize("sizes", [[N], [333], [7, 997]], ids=["one", "333", "uneven"])
def test_streamed_bootstrap_equals_the_jax_packages(sizes, data):
    X = data[0]
    idx = bagging.streamed_bootstrap_indices(SEED, 6, 48, N)
    ref_idx = jbagging.streamed_bootstrap_indices(SEED, 6, 48, N)
    assert idx.dtype == ref_idx.dtype == np.int64
    np.testing.assert_array_equal(idx, ref_idx)
    got = bagging.materialise_bootstrap_sample(_chunks(X, sizes, source.SourceChunk), idx)
    _assert_same_sample(got, jbagging.materialise_bootstrap_sample(_chunks(X, [N], jsource.SourceChunk), ref_idx))
    with pytest.raises(ValueError, match="stream ended"):
        bagging.materialise_bootstrap_sample(_chunks(X[:100], sizes, source.SourceChunk), idx)


def test_sampler_helpers_equal_the_jax_packages():
    rows = np.array([0, 1, 2, 2**40, 2**62], dtype=np.int64)
    np.testing.assert_array_equal(bagging._tree_salts(SEED, 7), jbagging._tree_salts(SEED, 7))
    np.testing.assert_array_equal(bagging._row_hash(rows), jbagging._row_hash(rows))
    salts = bagging._tree_salts(5, 3)
    np.testing.assert_array_equal(bagging._row_keys(salts, salts | np.uint64(1), bagging._row_hash(rows)),
                                  jbagging._row_keys(salts, salts | np.uint64(1), jbagging._row_hash(rows)))
    for const in ("_GOLDEN", "_KEY_SENTINEL", "_ROW_SENTINEL", "_STREAM_BLOCK_ROWS"):
        assert getattr(bagging, const) == getattr(jbagging, const)


# --------------------------------------------------------------------------- #
# the sources
# --------------------------------------------------------------------------- #


def test_npy_source_equals_the_jax_packages(data, shard_dir):
    X, _ = data
    src, ref = open_source(shard_dir), jsource.open_source(shard_dir)
    assert (src.num_shards, src.total_rows(), src.num_features()) == (4, N, F)
    assert src.shard_rows() == ref.shard_rows() == [BOUNDS[i + 1] - BOUNDS[i] for i in range(4)]
    assert src.fingerprint() == ref.fingerprint()
    got, want = list(src.iter_chunks(chunk_rows=701)), list(ref.iter_chunks(chunk_rows=701))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.shard_index, a.global_start, a.y) == (b.shard_index, b.global_start, b.y)
        assert a.X.dtype == b.X.dtype and a.X.shape[0] <= 701
        np.testing.assert_array_equal(a.X, b.X)
    np.testing.assert_array_equal(src.read_all()[0], X)
    tail = list(src.iter_chunks(start_shard=2, stop_shard=3))
    assert [c.global_start for c in tail] == [BOUNDS[2]] and tail[0].X.shape[0] == BOUNDS[3] - BOUNDS[2]


@pytest.mark.parametrize("fmt", ["csv", "avro", "npy"])
def test_labeled_round_trips_read_as_the_jax_package_reads(fmt, data, tmp_path):
    X, y = data
    Xs, ys = X[:500], y[:500]
    writer = getattr(source, f"write_{fmt}_shard")
    writer(str(tmp_path / f"a.{fmt}"), Xs[:200], ys[:200])
    writer(str(tmp_path / f"b.{fmt}"), Xs[200:], ys[200:])
    src = open_source(str(tmp_path), labeled=True)
    got_X, got_y = src.read_all(chunk_rows=64)
    np.testing.assert_array_equal(got_X, Xs)
    np.testing.assert_array_equal(got_y, ys)
    ref = jsource.open_source(str(tmp_path), labeled=True)
    assert src.fingerprint() == ref.fingerprint() and src.shard_rows() == ref.shard_rows() == [200, 300]
    for a, b in zip(src.iter_chunks(chunk_rows=128), ref.iter_chunks(chunk_rows=128)):
        assert (a.shard_index, a.global_start) == (b.shard_index, b.global_start)
        np.testing.assert_array_equal(a.X, b.X)
        np.testing.assert_array_equal(a.y, b.y)
    # the port reads a shard the JAX package wrote
    jwriter = getattr(jsource, f"write_{fmt}_shard")
    jwriter(str(tmp_path / f"c.{fmt}"), Xs[:50], ys[:50])
    np.testing.assert_array_equal(open_source(str(tmp_path / f"c.{fmt}"), labeled=True).read_all()[1], ys[:50])


def test_glob_single_file_and_formats(shard_dir, data, tmp_path):
    X, _ = data
    src = open_source(os.path.join(shard_dir, "part-00[01].npy"))
    assert src.num_shards == 2
    np.testing.assert_array_equal(src.read_all()[0], X[: BOUNDS[2]])
    assert open_source(sorted(glob.glob(os.path.join(shard_dir, "*.npy")))[0]).num_shards == 1
    assert open_source(src) is src
    text = tmp_path / "rows.txt"  # one file of another extension is CSV
    text.write_text("# comment\n1,2\n\n3,4\n")
    np.testing.assert_array_equal(open_source(str(text)).read_all()[0], [[1, 2], [3, 4]])
    source.write_csv_shard(str(tmp_path / "a.csv"), X[:3])
    assert open_source(str(tmp_path), formats=["csv"]).num_shards == 1


def test_empty_and_unknown_sources_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        open_source(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="matched no files"):
        open_source(str(tmp_path / "nothing-*.npy"))
    (tmp_path / "x.bin").write_bytes(b"")
    with pytest.raises(SourceFormatError, match="unrecognised shard extension"):
        open_source(str(tmp_path / "*.bin"))
    with pytest.raises(ValueError, match="chunk_rows must be > 0"):
        next(open_source(str(tmp_path / "x.bin")).iter_chunks(chunk_rows=-1))


def test_a_shard_that_changes_mid_run_raises(data, tmp_path):
    X, _ = data
    path = str(tmp_path / "a.npy")
    source.write_npy_shard(path, X[:100])
    src = open_source(path)
    assert src.total_rows() == 100
    source.write_npy_shard(path, X[:90])
    with pytest.raises(ValueError, match="row count changed mid-run"):
        list(src.iter_chunks())


def test_parquet_shards_read_as_the_jax_package_reads(data, tmp_path):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    X, y = data
    pq.write_table(pa.table({"features": [list(map(float, r)) for r in X[:300]], "label": y[:300]}),
                   str(tmp_path / "a.parquet"))
    pq.write_table(pa.table({f"c{j}": X[300:400, j] for j in range(F)}), str(tmp_path / "b.parquet"))
    for labeled, path in ((True, "a.parquet"), (False, "b.parquet")):
        src = open_source(str(tmp_path / path), labeled=labeled)
        ref = jsource.open_source(str(tmp_path / path), labeled=labeled)
        assert src.total_rows() == ref.total_rows()
        for a, b in zip(src.iter_chunks(chunk_rows=128), ref.iter_chunks(chunk_rows=128)):
            np.testing.assert_array_equal(a.X, b.X)
            assert (a.y is None) == (b.y is None) == (not labeled)
    np.testing.assert_array_equal(open_source(str(tmp_path / "a.parquet"), labeled=True).read_all()[0], X[:300])


def test_parquet_without_pyarrow_raises_source_format_error(monkeypatch, tmp_path):
    (tmp_path / "x.parquet").write_bytes(b"PAR1")
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    src = open_source(str(tmp_path / "x.parquet"))
    with pytest.raises(SourceFormatError, match="pyarrow"):
        src.total_rows()
    with pytest.raises(SourceFormatError, match="pyarrow"):
        list(src.iter_chunks())


# --------------------------------------------------------------------------- #
# fit_source
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("entry", ["fit_source", "eif_fit_source"])
def test_fit_source_grows_the_jax_packages_forest(entry, jax_fits, port_fits, data):
    port, ref = port_fits[entry][0], jax_fits[entry][0]
    assert port.forest.device.type == "cpu"
    _assert_same_forest(port, ref)
    assert (port.num_samples, port.num_features, port.total_num_features) == (
        ref.num_samples, ref.num_features, ref.total_num_features)
    assert abs(port.outlier_score_threshold - ref.outlier_score_threshold) <= 2e-6


@pytest.mark.parametrize("entry", ["fit_source", "eif_fit_source"])
def test_fit_source_equals_fit_from_sample_of_the_sample(entry, port_fits, data):
    X = data[0]
    _assert_port_models_bitwise(port_fits[entry][0], port_fits[entry.replace("source", "from_sample")][0], X[:512])


def test_fit_source_is_chunk_invariant(port_fits, shard_dir, data):
    model = IsolationForest(**STD, device="cpu").fit_source(shard_dir, chunk_rows=64, baseline=False)
    _assert_port_models_bitwise(model, port_fits["fit_source"][0], data[0][:512])


def test_bootstrap_fit_source_grows_the_jax_packages_forest(shard_dir, data):
    kw = dict(STD, num_estimators=8, max_samples=48.0, bootstrap=True)
    port = IsolationForest(**kw, device="cpu").fit_source(shard_dir, chunk_rows=313)
    ref = JaxEstimator(**kw).fit_source(shard_dir, chunk_rows=313, baseline=False)
    _assert_same_forest(port, ref)
    assert abs(port.outlier_score_threshold - ref.outlier_score_threshold) <= 2e-6
    idx = bagging.streamed_bootstrap_indices(SEED, 8, 48, N)
    s = bagging.materialise_bootstrap_sample(_chunks(data[0], [N], source.SourceChunk), idx)
    _assert_port_models_bitwise(port, IsolationForest(**kw, device="cpu").fit_from_sample(s.X, s.bag), data[0][:512])


def test_fractional_max_samples_is_refused(shard_dir):
    for est in (IsolationForest(num_estimators=4, max_samples=0.5, random_seed=1, device="cpu"),
                ExtendedIsolationForest(num_estimators=4, max_samples=0.5, random_seed=1, device="cpu")):
        with pytest.raises(ValueError, match="absolute maxSamples"):
            est.fit_source(shard_dir)


@pytest.mark.parametrize("killer", ["port", "jax"])
def test_a_killed_checkpointed_fit_source_resumes_in_the_other_package(killer, port_fits, shard_dir, tmp_path):
    d = str(tmp_path / "ck")
    kw = dict(chunk_rows=997, checkpoint_dir=d, checkpoint_every=4)
    if killer == "port":
        with pytest.raises(faults.FaultInjectedError):
            with faults.inject(kill_fit_after_block=1):
                IsolationForest(**STD, device="cpu").fit_source(shard_dir, **kw)
        resumed = JaxEstimator(**STD).fit_source(shard_dir, resume=True, baseline=False, **kw)
    else:
        with pytest.raises(jfaults.FaultInjectedError):
            with jfaults.inject(kill_fit_after_block=1):
                JaxEstimator(**STD).fit_source(shard_dir, baseline=False, **kw)
        resumed = IsolationForest(**STD, device="cpu").fit_source(shard_dir, resume=True, **kw)
    assert (resumed.fit_checkpoint.blocks_loaded, resumed.fit_checkpoint.blocks_written) == (2, 1)
    with open(os.path.join(d, "fingerprint.json")) as fh:
        assert "samplerSha256" in json.load(fh)
    _assert_same_forest(resumed, port_fits["fit_source"][0])


def test_a_plain_fit_fingerprint_has_no_sampler_field():
    from isoforest_tpu.resilience import checkpoint as jckpt
    from isoforest_tpu_torch.resilience import checkpoint as ckpt

    kw = dict(kind="standard", random_seed=1, num_estimators=4, bootstrap=False, num_samples=8, num_features=2,
              height=3, total_rows=10, total_features=2, block_trees=2, data_sha256="x")
    assert ckpt.fit_fingerprint(**kw) == jckpt.fit_fingerprint(**kw)
    assert "samplerSha256" not in ckpt.fit_fingerprint(**kw)
    assert ckpt.fit_fingerprint(**kw, sampler_sha256="s") == jckpt.fit_fingerprint(**kw, sampler_sha256="s")


# --------------------------------------------------------------------------- #
# score_source
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def model(port_fits):
    return port_fits["fit_source"][0]


@pytest.fixture(scope="module")
def model_dir(model, tmp_path_factory):
    """The port's model saved once, for both packages to load."""
    path = str(tmp_path_factory.mktemp("model") / "model")
    model.save(path)
    return path


@pytest.fixture(scope="module")
def jax_clean_sink(model_dir, shard_dir, tmp_path_factory):
    """The JAX package's uninterrupted walk sink of the shared model."""
    sink = str(tmp_path_factory.mktemp("jax_sink") / "sink")
    joutofcore.score_source(jax_load_model(model_dir), shard_dir, sink, strategy="walk")
    return sink


def _part_bytes(sink: str) -> dict:
    out = {}
    for part in sorted(os.listdir(sink)):
        if part.startswith("part-"):
            for name in sorted(os.listdir(os.path.join(sink, part))):
                with open(os.path.join(sink, part, name), "rb") as fh:
                    out[f"{part}/{name}"] = fh.read()
    return out


def test_score_source_equals_the_in_memory_scores(model, data, shard_dir, jax_clean_sink, tmp_path):
    X, _ = data
    sink = str(tmp_path / "sink")
    summary = outofcore.score_source(model, shard_dir, sink, strategy="walk", chunk_rows=997)
    assert (summary["shards"], summary["sealed"], summary["skipped"], summary["rows"]) == (4, 4, 0, N)
    with open(os.path.join(sink, outofcore.SUMMARY_NAME)) as fh:
        assert json.load(fh) == summary
    got = outofcore.read_scores(sink, num_shards=4)
    assert got.dtype == np.float32
    # the same calls in memory: each shard in chunks of 997 rows
    want = [model.score(c.X, strategy="walk").numpy() for c in open_source(shard_dir).iter_chunks(chunk_rows=997)]
    np.testing.assert_array_equal(got, np.concatenate(want))
    # torch's CPU exp2 rounds by vector position (the card's does not), so
    # one call over all rows may differ by an ulp
    np.testing.assert_array_max_ulp(got, model.score(X, strategy="walk").numpy(), maxulp=1)
    assert np.abs(got - joutofcore.read_scores(jax_clean_sink)).max() <= 2e-6
    with pytest.raises(FileNotFoundError, match="expected 5"):
        outofcore.read_scores(sink, num_shards=5)


def test_score_source_dense_equals_the_in_memory_scores(model, data, shard_dir, tmp_path):
    sink = str(tmp_path / "sink")
    outofcore.score_source(model, open_source(shard_dir), sink, strategy="dense")
    want = [model.score(c.X, strategy="dense").numpy() for c in open_source(shard_dir).iter_chunks()]
    np.testing.assert_array_equal(outofcore.read_scores(sink), np.concatenate(want))


def test_kill_and_resume_give_byte_equal_parts(model, shard_dir, tmp_path):
    clean = str(tmp_path / "clean")
    outofcore.score_source(model, shard_dir, clean, strategy="walk")
    sink = str(tmp_path / "killed")
    with pytest.raises(faults.FaultInjectedError, match="shard 1"):
        with faults.inject(kill_score_after_shard=1):
            outofcore.score_source(model, shard_dir, sink, strategy="walk")
    assert sorted(n for n in os.listdir(sink) if n.startswith("part-")) == ["part-00000", "part-00001"]
    summary = outofcore.score_source(model, shard_dir, sink, strategy="walk", resume=True)
    assert (summary["skipped"], summary["sealed"]) == (2, 2)
    assert _part_bytes(sink) == _part_bytes(clean)
    np.testing.assert_array_equal(outofcore.read_scores(sink), outofcore.read_scores(clean))


def test_a_damaged_part_is_scored_again_on_resume(model, shard_dir, tmp_path):
    sink = str(tmp_path / "sink")
    outofcore.score_source(model, shard_dir, sink, strategy="walk")
    clean = _part_bytes(sink)
    with open(os.path.join(sink, "part-00002", "scores.npy"), "r+b") as fh:
        fh.seek(-4, os.SEEK_END)
        fh.write(b"\0\0\0\0")
    with pytest.raises(ValueError, match="fails verification"):
        outofcore.read_scores(sink)
    summary = outofcore.score_source(model, shard_dir, sink, strategy="walk", resume=True)
    assert (summary["skipped"], summary["sealed"]) == (3, 1)
    assert _part_bytes(sink) == clean


def test_sink_gate_refuses_reuse_strategy_and_model(model, shard_dir, tmp_path, port_fits):
    sink = str(tmp_path / "gate")
    outofcore.score_source(model, shard_dir, sink, strategy="walk")
    with pytest.raises(CheckpointMismatchError) as ei:
        outofcore.score_source(model, shard_dir, sink, strategy="walk")
    assert list(ei.value.mismatched_fields) == ["resume"]
    with pytest.raises(CheckpointMismatchError) as ei:
        outofcore.score_source(model, shard_dir, sink, strategy="dense", resume=True)
    assert list(ei.value.mismatched_fields) == ["strategy"]
    with pytest.raises(CheckpointMismatchError) as ei:
        outofcore.score_source(port_fits["eif_fit_source"][0], shard_dir, sink, strategy="walk", resume=True)
    assert list(ei.value.mismatched_fields) == ["modelSha256"]


@pytest.mark.parametrize("strategy", ["gather", "pallas", "native"])
def test_strategies_the_port_does_not_serve_are_refused_before_the_sink(strategy, model, shard_dir, tmp_path):
    sink = tmp_path / "sink"
    with pytest.raises(ValueError, match="unknown scoring strategy"):
        outofcore.score_source(model, shard_dir, str(sink), strategy=strategy)
    assert not sink.exists()


@pytest.mark.parametrize("fixture", ["mammography_std", "mammography_eif"])
def test_model_fingerprint_equals_the_jax_packages(fixture, model_dir):
    path = os.path.join(os.path.dirname(__file__), "resources", "torch_port", fixture, "model")
    for d in (path, model_dir):
        port = load_model(d, device="cpu")
        assert outofcore.model_fingerprint(port) == joutofcore.model_fingerprint(jax_load_model(d))


@pytest.mark.parametrize("first", ["jax", "port"])
def test_a_half_sealed_sink_resumes_in_the_other_package(first, model_dir, shard_dir, jax_clean_sink, tmp_path):
    port, ref = load_model(model_dir, device="cpu"), jax_load_model(model_dir)
    sink = str(tmp_path / "sink")
    if first == "jax":
        with pytest.raises(jfaults.FaultInjectedError):
            with jfaults.inject(kill_score_after_shard=1):
                joutofcore.score_source(ref, shard_dir, sink, strategy="walk")
        sealed = _part_bytes(sink)
        summary = outofcore.score_source(port, shard_dir, sink, strategy="walk", resume=True)
    else:
        with pytest.raises(faults.FaultInjectedError):
            with faults.inject(kill_score_after_shard=1):
                outofcore.score_source(port, shard_dir, sink, strategy="walk")
        sealed = _part_bytes(sink)
        summary = joutofcore.score_source(ref, shard_dir, sink, strategy="walk", resume=True)
    assert (summary["skipped"], summary["sealed"]) == (2, 2)
    after = _part_bytes(sink)
    assert {k: after[k] for k in sealed} == sealed and len(sealed) == 6
    got, want = outofcore.read_scores(sink, num_shards=4), joutofcore.read_scores(jax_clean_sink)
    assert np.abs(got - want).max() <= 2e-6
    rows = BOUNDS[2]
    (np.testing.assert_array_equal(got[:rows], want[:rows]) if first == "jax"
     else np.testing.assert_array_equal(got[rows:], want[rows:]))


def test_score_source_counts_and_records_its_shards(model, shard_dir, tmp_path):
    from isoforest_tpu_torch import telemetry

    counter = metrics.counter("isoforest_score_source_shards_sealed_total")
    rows = metrics.counter("isoforest_source_rows_total", labelnames=("format",))
    before, rows_before = counter.value(), rows.value(format="npy")
    seq = max((e.seq for e in telemetry.get_events()), default=-1)
    outofcore.score_source(model, shard_dir, str(tmp_path / "sink"), strategy="walk")
    assert counter.value() - before == 4
    assert rows.value(format="npy") - rows_before == N
    kinds = [e.kind for e in telemetry.get_events(since_seq=seq)]
    assert [k for k in kinds if k.startswith("score_source.")] == (
        ["score_source.begin"] + ["score_source.shard_sealed"] * 4 + ["score_source.complete"])
