"""The standard isolation forest: the estimator :class:`IsolationForest` and
the fitted :class:`IsolationForestModel` (``isoforest_tpu/models/isolation_forest.py``).

``IsolationForest(...).fit(X)`` runs on one device: the bags, feature
subsets and per-tree keys drawn once from the fit's key
(:func:`~isoforest_tpu_torch.ops.bagging.ensemble_draws`), growth
(:func:`~isoforest_tpu_torch.ops.tree_growth.grow_forest`; the extended
estimator shares this path, :func:`_grow`), then the
contamination threshold over the training rows' scores, which go through
the model's own scoring path (the walk kernel on the card). Only the
parameters' resolution, the threshold's one float and a save's Avro encode
run on the host. The forest is the JAX package's for the same data and seed
(the draws are its threefry streams), up to Gumbel near-ties where torch's
``log`` and XLA's differ by an ulp.

``fit(..., checkpoint_dir=...)`` grows the trees in blocks and seals each
block on disk (:mod:`..resilience.checkpoint`); a killed fit resumes from
its last sealed block, bitwise equal to an uninterrupted fit, and a
checkpoint directory one package wrote resumes in the other. After the
threshold, ``fit`` captures the drift baseline (``baseline=True``, unless
``ISOFOREST_TPU_BASELINE`` turns it off) from a strided subsample of the
training rows, scored through the walk kernel; ``enable_monitoring`` then
folds every scored batch into a :class:`~..telemetry.monitor.ScoreMonitor`.

``fit(X, mesh=...)`` grows the trees over a device mesh
(:mod:`..parallel`: each shard grows a slab, the slabs are gathered) and
thresholds through row-sharded scoring; ``score``, ``warmup`` and
``transform`` take a ``mesh`` too. The forest, scores and threshold equal
the unsharded fit's bit for bit. ``mesh`` is a keyword: the JAX package's
``fit(data, mesh, ...)`` takes it second.

``fit_source`` fits a sharded on-disk source out of core: one pass through
the streamed sampler on the host (:class:`~..ops.bagging.StreamedBagger`),
then ``fit_from_sample`` of its sample; the sample, and so the forest, is
the JAX package's bit for bit whatever the chunking.

``fit``/``transform`` take an ``[N, F]`` tensor or array, or a pandas
DataFrame with a vector-valued features column; ``transform`` of a frame
returns the frame with ``outlierScore`` and ``predictedLabel`` appended
(IsolationForestModel.scala:142-148).
"""

from __future__ import annotations

import math
import os
import uuid
from typing import Optional

import numpy as np
import torch

from ..ops import prng
from ..ops.bagging import ensemble_draws
from ..ops.ext_growth import grow_extended_forest
from ..ops.quantile import contamination_threshold, observed_contamination
from ..ops.traversal import score_matrix
from ..ops.tree_growth import StandardForest, grow_forest
from ..telemetry.metrics import counter as _telemetry_counter
from ..telemetry.spans import span as _telemetry_span
from ..utils.device import resolve_device
from ..utils.logging import phase
from ..utils.math import height_limit
from ..utils.params import IsolationForestParams, resolve_extension_level, resolve_params
from ..utils.validation import (
    UNKNOWN_TOTAL_NUM_FEATURES,
    extract_features,
    logger,
    validate_feature_vector_size,
)


# Fit volume, by model family ("standard" or "extended"), counted once a
# forest is grown, as the JAX package counts it
_FIT_ROWS_TOTAL = _telemetry_counter(
    "isoforest_fit_rows_total",
    "Training rows consumed by fit(), by model family",
    labelnames=("model",),
)
_FIT_TREES_TOTAL = _telemetry_counter(
    "isoforest_fit_trees_total",
    "Trees grown by fit(), by model family",
    labelnames=("model",),
)


def _new_uid(prefix: str) -> str:
    return f"{prefix}_{uuid.uuid4().hex[:12]}"


# The scoring representations a model can prefer, saved as the tolerated
# ``scoringRepresentation`` metadata extra: the exact f32 tables, or the
# rank-quantized q16 plane (ops/scoring_layout.py), which takes the f32
# walk's branch at every node.
SCORING_REPRESENTATIONS = ("f32", "q16")


def _resolve_subsample_trees(subsample_trees, num_estimators: int) -> int:
    """FastForest-style subbagging (arxiv 2004.02423): an int is a tree
    count, a float in (0, 1] a fraction of ``numEstimators``. Returns the
    number of trees to grow (>= 1)."""
    if isinstance(subsample_trees, bool) or not isinstance(subsample_trees, (int, float)):
        raise ValueError(
            f"subsample_trees must be an int tree count or a float fraction "
            f"in (0, 1], got {subsample_trees!r}"
        )
    if isinstance(subsample_trees, int):
        count = subsample_trees
    else:
        if not 0.0 < subsample_trees <= 1.0:
            raise ValueError(f"fractional subsample_trees must be in (0, 1], got {subsample_trees!r}")
        count = int(round(subsample_trees * num_estimators))
    if not 1 <= count <= num_estimators:
        raise ValueError(
            f"subsample_trees resolves to {count} trees, outside [1, numEstimators={num_estimators}]"
        )
    return count


def _seed_key(params: IsolationForestParams, device) -> torch.Tensor:
    """The fit's root key, from the seed's low 32 bits as the JAX package takes it."""
    return prng.PRNGKey(params.random_seed & 0xFFFFFFFF, device=device)


# The drift baseline of a fit scores at most this many training rows, a
# deterministic stride of them (no draw: a checkpointed fit and a plain one
# capture the same baseline); ISOFOREST_TPU_BASELINE=0 turns capture off,
# in both packages.
_BASELINE_ENV = "ISOFOREST_TPU_BASELINE"
_BASELINE_MAX_ROWS = 65536


def _baseline_env_enabled() -> bool:
    return os.environ.get(_BASELINE_ENV, "1").strip().lower() not in ("0", "false", "off", "no")


def _capture_fit_baseline(model, X: torch.Tensor) -> None:
    """Set ``model.baseline`` from the training rows: every
    ``ceil(N / 65,536)``-th row is scored through the walk kernel (named,
    not ``"auto"``), then its scores and rows are copied to the host once
    and summarised (:func:`~..telemetry.monitor.capture_baseline`)."""
    from ..telemetry.monitor import capture_baseline

    n = int(X.shape[0])
    step = max(1, -(-n // _BASELINE_MAX_ROWS))
    sub = X[::step].contiguous()
    with _telemetry_span("fit.baseline", rows=int(sub.shape[0])):
        scores = score_matrix(model.forest, sub, model.num_samples, strategy="walk", device=model.device,
                              cache=model._cache)
        model.baseline = capture_baseline(scores, sub, total_rows=n)


def _grow_block(tree_keys, X: torch.Tensor, bag, fidx, height: int, extension_level, mesh=None):
    """Grow the trees of these draws: standard, or EIF at ``extension_level``;
    over ``mesh``'s shards when one is given."""
    if mesh is not None:
        from ..parallel.sharded import sharded_grow_extended_forest, sharded_grow_forest

        if extension_level is None:
            return sharded_grow_forest(mesh, tree_keys, X, bag, fidx, height)
        return sharded_grow_extended_forest(mesh, tree_keys, X, bag, fidx, height, extension_level)
    if extension_level is None:
        return grow_forest(tree_keys, X, bag, fidx, height)
    return grow_extended_forest(tree_keys, X, bag, fidx, height, extension_level)


def _grow(key, X: torch.Tensor, *, params, resolved, height: int, extension_level, checkpoint, bag=None,
          sampler_sha256=None, mesh=None):
    """The forest of either estimator and its checkpoint: the ensemble's
    draws from ``key`` (``bag`` replaces the bagging draw of a fit from a
    sample), then growth in one call, or in sealed blocks when
    ``checkpoint = (dir, every, resume, callback)`` names a directory
    (:func:`_blockwise_grow`; ``sampler_sha256`` joins its fingerprint);
    over ``mesh``'s shards when one is given."""
    draws = ensemble_draws(key, X, num_samples=resolved.num_samples, num_trees=params.num_estimators,
                           bootstrap=params.bootstrap, num_features=resolved.num_features, bag=bag)
    checkpoint_dir, checkpoint_every, resume, block_callback = checkpoint
    if checkpoint_dir is None:
        tree_keys, bag, fidx = draws
        return _grow_block(tree_keys, X, bag, fidx, height, extension_level, mesh), None
    return _blockwise_grow(checkpoint_dir, resume, checkpoint_every, X, draws, params=params, resolved=resolved,
                           height=height, extension_level=extension_level, on_block=block_callback,
                           sampler_sha256=sampler_sha256, mesh=mesh)


def _blockwise_grow(checkpoint_dir: str, resume: bool, checkpoint_every, X: torch.Tensor, draws, *, params,
                    resolved, height: int, extension_level=None, on_block=None, sampler_sha256=None, mesh=None):
    """Growth of either estimator in checkpointed blocks of trees:
    ``(forest, FitCheckpoint)``.

    It equals the plain fit bitwise: each block grows a slice of the
    ensemble's ``draws`` (:func:`~..ops.bagging.ensemble_draws`). Each
    block is grown on ``X``'s device, copied to the host and sealed; the
    fingerprint hashes the host copy of ``X``, one device-to-host copy per
    fit. ``on_block(index, start, stop, resumed)`` runs after each block is
    durable. ``sampler_sha256`` (an out-of-core fit's sample hash) joins the
    fingerprint. With ``mesh`` each block grows over its shards.
    """
    from ..ops.ext_growth import ExtendedForest
    from ..resilience import checkpoint as ckpt
    from ..resilience import faults

    extended = extension_level is not None
    forest_cls = ExtendedForest if extended else StandardForest
    num_trees = params.num_estimators
    block_trees = ckpt.resolve_block_size(checkpoint_every, num_trees)
    fingerprint = ckpt.fit_fingerprint(
        kind="extended" if extended else "standard",
        random_seed=params.random_seed,
        num_estimators=num_trees,
        bootstrap=params.bootstrap,
        num_samples=resolved.num_samples,
        num_features=resolved.num_features,
        height=height,
        total_rows=int(X.shape[0]),
        total_features=int(X.shape[1]),
        block_trees=block_trees,
        data_sha256=ckpt.data_fingerprint(X.cpu().numpy()),
        extension_level=extension_level,
        sampler_sha256=sampler_sha256,
    )
    state = ckpt.FitCheckpoint(checkpoint_dir, fingerprint)
    state.begin(resume=resume)

    tree_keys, bag, fidx = draws
    parts = []
    for index, start, stop in ckpt.block_ranges(num_trees, block_trees):
        arrays = state.load_block(index, start, stop)
        resumed = arrays is not None
        if arrays is None:
            trees = slice(start, stop)
            with _telemetry_span("fit.grow_block", block=index, trees=stop - start):
                block = _grow_block(tree_keys[trees], X, bag[trees], fidx[trees], height, extension_level, mesh)
                arrays = {field: getattr(block, field).cpu().numpy() for field in forest_cls._fields}
                state.seal_block(index, start, stop, arrays)
            faults.check_fit_block(index)  # a kill lands after the seal
        if on_block is not None:
            on_block(index, start, stop, resumed)
        parts.append(arrays)
    logger.info(
        "checkpointed fit: %d/%d block(s) grown this session, %d resumed from %s",
        state.blocks_written, len(parts), state.blocks_loaded, checkpoint_dir,
    )
    forest = forest_cls(**{field: torch.from_numpy(np.concatenate([part[field] for part in parts])).to(X.device)
                           for field in forest_cls._fields})
    return forest, state


class _ParamSetters:
    """Fluent setters of the reference's Params traits
    (IsolationForestParamsBase.scala:8-110); each replaces ``params``."""

    params: IsolationForestParams

    def _set(self, **kw):
        self.params = self.params.replace(**kw)
        return self

    def set_num_estimators(self, v: int):
        return self._set(num_estimators=v)

    def set_max_samples(self, v: float):
        return self._set(max_samples=v)

    def set_contamination(self, v: float):
        return self._set(contamination=v)

    def set_contamination_error(self, v: float):
        return self._set(contamination_error=v)

    def set_max_features(self, v: float):
        return self._set(max_features=v)

    def set_bootstrap(self, v: bool):
        return self._set(bootstrap=v)

    def set_random_seed(self, v: int):
        return self._set(random_seed=v)

    def set_features_col(self, v: str):
        return self._set(features_col=v)

    def set_prediction_col(self, v: str):
        return self._set(prediction_col=v)

    def set_score_col(self, v: str):
        return self._set(score_col=v)


class IsolationForest(_ParamSetters):
    """Estimator: ``fit(data) -> IsolationForestModel`` (IsolationForest.scala:46-105)
    on ``device`` (default: the card)."""

    def __init__(self, params: Optional[IsolationForestParams] = None, uid=None, device=None, **kw):
        self.params = params if params is not None else IsolationForestParams(**kw)
        self.uid = uid or _new_uid("isolation-forest")
        self.device = device

    def fit(self, data, nonfinite: str = "warn", subsample_trees=None, checkpoint_dir: Optional[str] = None,
            checkpoint_every: Optional[int] = None, resume: bool = False, baseline: bool = True,
            block_callback=None, *, mesh=None) -> "IsolationForestModel":
        """Fit on an ``[N, F]`` tensor, array or DataFrame. With ``mesh`` (a
        :class:`~..parallel.mesh.Mesh`) the trees grow over its shards and
        the threshold pass scores row-sharded; the model lives on the mesh's
        first local device, and its forest, scores and threshold equal the
        unsharded fit's bit for bit. ``nonfinite`` is
        the NaN/inf policy (``"warn"``, ``"raise"``, ``"allow"``);
        ``subsample_trees`` grows only that many (int) or that share
        (float) of ``numEstimators`` trees, and the model records the
        smaller ensemble.

        ``checkpoint_dir`` grows the trees in blocks of ``checkpoint_every``
        (default 32) and seals each one there; a killed fit run again with
        ``resume=True`` continues from the last sealed block, to a forest
        bitwise equal to an uninterrupted fit's. A resume with other
        params, data or block size raises
        :class:`~..resilience.checkpoint.CheckpointMismatchError`.
        ``block_callback(index, start, stop, resumed)`` runs after each
        block is durable. ``baseline`` (and ``ISOFOREST_TPU_BASELINE``)
        captures the drift baseline the model saves as ``_BASELINE.json``."""
        return _fit_impl(self, data, extended=False, nonfinite=nonfinite, subsample_trees=subsample_trees,
                         checkpoint=(checkpoint_dir, checkpoint_every, resume, block_callback), baseline=baseline,
                         mesh=mesh)

    def fit_from_sample(self, X_sample, bag, nonfinite: str = "warn", checkpoint_dir: Optional[str] = None,
                        checkpoint_every: Optional[int] = None, resume: bool = False, baseline: bool = True,
                        block_callback=None, sample_sha256: Optional[str] = None,
                        source_rows: Optional[int] = None) -> "IsolationForestModel":
        """Fit from a materialised sample: ``X_sample [U, F]`` and the bags
        ``[numEstimators, numSamples]`` that index it (what
        :class:`~..ops.bagging.StreamedBagger` gives). The bag replaces the
        bagging draw; feature subsets and growth keys come from the same
        ``(k_bag, k_feat, k_grow)`` split as :meth:`fit`, so two fits of one
        sample are bitwise equal. ``maxSamples`` must be a count; the
        threshold and the baseline come from the sample's own rows. The
        checkpoint and baseline knobs are :meth:`fit`'s; ``sample_sha256``
        joins a checkpoint's fingerprint, and ``source_rows`` (the rows the
        sample was drawn from) is what the fit counts as its rows."""
        return _fit_from_sample_impl(self, X_sample, bag, extended=False, nonfinite=nonfinite,
                                     checkpoint=(checkpoint_dir, checkpoint_every, resume, block_callback),
                                     baseline=baseline, sample_sha256=sample_sha256, source_rows=source_rows)

    def fit_source(self, source, chunk_rows: Optional[int] = None, checkpoint_dir: Optional[str] = None,
                   checkpoint_every: Optional[int] = None, resume: bool = False, baseline: bool = True,
                   nonfinite: str = "warn", block_callback=None) -> "IsolationForestModel":
        """Out-of-core fit of a sharded on-disk source (a directory, glob or
        file, or a :class:`~..io.source.ShardedSource`): one pass of
        ``chunk_rows``-row chunks through the streamed sampler on the host,
        then :meth:`fit_from_sample` of its sample on the estimator's
        device. The forest is the same for any ``chunk_rows`` and shard
        layout, and the JAX package's for the same source and seed.
        ``maxSamples`` must be a count."""
        return _fit_source_impl(self, source, extended=False, chunk_rows=chunk_rows, nonfinite=nonfinite,
                                checkpoint=(checkpoint_dir, checkpoint_every, resume, block_callback),
                                baseline=baseline)

    def save(self, path: str, overwrite: bool = False) -> None:
        """Save the params (metadata only, IsolationForest.scala:114-125)."""
        from ..io.persistence import STANDARD_ESTIMATOR_CLASS, save_estimator

        save_estimator(self, path, STANDARD_ESTIMATOR_CLASS, overwrite=overwrite)

    @classmethod
    def load(cls, path: str, device=None) -> "IsolationForest":
        from ..io.persistence import STANDARD_ESTIMATOR_CLASS, load_estimator

        params, uid = load_estimator(path, IsolationForestParams, STANDARD_ESTIMATOR_CLASS)
        return cls(params=params, uid=uid, device=device)


def _grow_and_threshold(p, X, resolved, extended: bool, key, checkpoint, baseline: bool, counted_rows: int,
                        bag=None, sampler_sha256=None, mesh=None) -> "IsolationForestModel":
    """The model of either estimator: grow its forest (:func:`_grow`), count
    ``counted_rows`` and the trees, then threshold it on ``X`` and capture
    its baseline; over ``mesh`` when one is given."""
    h = height_limit(resolved.num_samples)

    def grow(level):
        # the JAX package's phase span names
        with phase("extended_isolation_forest.fit.grow" if extended else "isolation_forest.fit.grow"):
            return _grow(key, X, params=p, resolved=resolved, height=h, extension_level=level,
                         checkpoint=checkpoint, bag=bag, sampler_sha256=sampler_sha256, mesh=mesh)

    common = dict(params=p, num_samples=resolved.num_samples, num_features=resolved.num_features,
                  total_num_features=int(X.shape[1]))
    if extended:
        from .extended import ExtendedIsolationForestModel

        level = resolve_extension_level(p.extension_level, resolved.num_features)
        logger.info("resolved extensionLevel=%d", level)
        forest, fit_checkpoint = grow(level)
        model = ExtendedIsolationForestModel(forest=forest, extension_level=level, **common)
    else:
        forest, fit_checkpoint = grow(None)
        model = IsolationForestModel(forest=forest, **common)
    kind = "extended" if extended else "standard"
    _FIT_ROWS_TOTAL.inc(counted_rows, model=kind)
    _FIT_TREES_TOTAL.inc(p.num_estimators, model=kind)
    model.fit_checkpoint = fit_checkpoint
    model.finalize_scoring()
    _compute_and_set_threshold(model, X, mesh=mesh)
    if baseline and _baseline_env_enabled():
        _capture_fit_baseline(model, X)
    return model


def _fit_impl(est, data, *, extended: bool, nonfinite: str, subsample_trees, checkpoint,
              baseline: bool, mesh=None) -> "IsolationForestModel":
    """``fit`` of both estimators on one device, or over ``mesh`` (on its
    first local device): bags, feature subsets and growth from one key (in
    one call, or in checkpointed blocks when ``checkpoint = (dir, every,
    resume, callback)`` names a directory), then the threshold and the
    baseline."""
    dev = mesh.first_device if mesh is not None else resolve_device(est.device)
    p = est.params
    if subsample_trees is not None:
        effective = _resolve_subsample_trees(subsample_trees, p.num_estimators)
        logger.info("subsample_trees=%r: growing %d of %d trees", subsample_trees, effective, p.num_estimators)
        p = p.replace(num_estimators=effective)
    X, _ = extract_features(data, p.features_col, nonfinite=nonfinite, device=dev)
    total_rows, total_feats = int(X.shape[0]), int(X.shape[1])
    resolved = resolve_params(p, total_feats, total_rows)
    logger.info(
        "resolved params: numSamples=%d numFeatures=%d (of %d rows x %d features)",
        resolved.num_samples, resolved.num_features, total_rows, total_feats,
    )
    return _grow_and_threshold(p, X, resolved, extended, _seed_key(p, dev), checkpoint, baseline, total_rows,
                               mesh=mesh)


def _require_absolute_max_samples(params) -> int:
    """``maxSamples`` as a count: a fit from a sample or a stream cannot
    resolve a fraction (the stream's length is unknown until its end)."""
    if params.max_samples <= 1.0:
        raise ValueError(
            f"out-of-core fit requires an absolute maxSamples (> 1), got "
            f"fraction {params.max_samples!r}; set max_samples to the "
            "per-tree sample count (e.g. 256)"
        )
    return int(math.floor(params.max_samples))


def _fit_from_sample_impl(est, X_sample, bag, *, extended: bool, nonfinite: str, checkpoint, baseline: bool,
                          sample_sha256=None, source_rows=None) -> "IsolationForestModel":
    """``fit_from_sample`` of both estimators: the given bag replaces the
    bagging draw; feature subsets and growth keys come from the fit's key
    (checkpointed as :func:`_fit_impl`, with ``sample_sha256`` in the
    fingerprint). The fit counts ``source_rows`` rows when given, else the
    sample's."""
    dev = resolve_device(est.device)
    p = est.params
    X, _ = extract_features(X_sample, p.features_col, nonfinite=nonfinite, device=dev)
    if X.shape[0] == 0:
        raise ValueError(f"sample matrix must be non-empty 2-D, got shape {tuple(X.shape)}")
    bag = (bag if isinstance(bag, torch.Tensor) else torch.from_numpy(np.asarray(bag))).to(dev)
    if bag.dim() != 2:
        raise ValueError(f"bag must be [trees, samples], got shape {tuple(bag.shape)}")
    if bag.shape[0] != p.num_estimators:
        raise ValueError(f"bag has {bag.shape[0]} trees but numEstimators={p.num_estimators}")
    num_samples = _require_absolute_max_samples(p)
    if bag.shape[1] != num_samples:
        raise ValueError(
            f"bag has {bag.shape[1]} samples per tree but maxSamples resolves to {num_samples}"
        )
    u, f = int(X.shape[0]), int(X.shape[1])
    lo, hi = int(bag.min()), int(bag.max())
    if lo < 0 or hi >= u:
        raise ValueError(f"bag indexes rows outside the sample matrix [0, {u}) (min={lo}, max={hi})")
    # max(U, S) keeps the small-dataset cap from shrinking S below the bag width
    resolved = resolve_params(p, f, max(u, num_samples))
    return _grow_and_threshold(p, X, resolved, extended, _seed_key(p, dev), checkpoint, baseline,
                               int(source_rows) if source_rows else u, bag=bag.to(torch.int32),
                               sampler_sha256=sample_sha256)


def _fit_source_impl(est, source, *, extended: bool, chunk_rows, nonfinite: str, checkpoint,
                     baseline: bool) -> "IsolationForestModel":
    """``fit_source`` of both estimators: one pass over the source through
    the streamed sampler on the host (with ``bootstrap``, a row count
    first, then the with-replacement bags' rows), then
    :func:`_fit_from_sample_impl` of the sample."""
    from ..io.source import open_source
    from ..ops.bagging import StreamedBagger, materialise_bootstrap_sample, streamed_bootstrap_indices

    src = open_source(source)
    p = est.params
    num_samples = _require_absolute_max_samples(p)
    if p.bootstrap:
        idx = streamed_bootstrap_indices(p.random_seed, p.num_estimators, num_samples, src.total_rows())
        sample = materialise_bootstrap_sample(src.iter_chunks(chunk_rows=chunk_rows), idx)
    else:
        bagger = StreamedBagger(p.random_seed, p.num_estimators, num_samples)
        for chunk in src.iter_chunks(chunk_rows=chunk_rows):
            bagger.consume(chunk.X)
        sample = bagger.finalize()
    logger.info(
        "streamed sample: %d distinct rows from a %d-row source (%d trees x %d samples)",
        sample.X.shape[0], sample.total_rows, p.num_estimators, num_samples,
    )
    return _fit_from_sample_impl(est, sample.X, sample.bag, extended=extended, nonfinite=nonfinite,
                                 checkpoint=checkpoint, baseline=baseline, sample_sha256=sample.sha256,
                                 source_rows=sample.total_rows)


def _compute_and_set_threshold(model: "IsolationForestModel", X: torch.Tensor, mesh=None) -> None:
    """Contamination thresholding (SharedTrainLogic.scala:175-242): with
    contamination 0 the threshold stays -1 and every label is 0; else it is
    the ``1 - contamination`` quantile of the training scores within
    ``contaminationError``, and the observed contamination is checked.
    The pass names the walk: the JAX package resolves ``auto`` here, but a
    tuned ``dense`` could move an EIF fit's threshold (K3 and K4 split tied
    rows differently), so the fit stays threshold-exact whatever the
    autotuner's table holds; with ``mesh`` the walk runs row-sharded, to
    the same scores bit for bit."""
    p = model.params
    if p.contamination == 0.0:
        return
    with phase("isolation_forest.fit.threshold"):
        scores = model.score(X, nonfinite="allow", strategy="walk", mesh=mesh)  # the policy was applied at fit
        thr = contamination_threshold(scores, p.contamination, p.contamination_error)
        model.set_outlier_score_threshold(thr)
    observed = observed_contamination(scores, thr)
    allowed = p.contamination_error if p.contamination_error > 0 else 0.01 * p.contamination
    if abs(observed - p.contamination) > allowed:
        logger.warning(
            "observed contamination %.6f deviates from requested %.6f by more "
            "than %.6f (SharedTrainLogic verification)", observed, p.contamination, allowed,
        )


class IsolationForestModel:
    """Fitted model over a heap-tensor forest that lives on one device.

    Construction contract of IsolationForestModel.scala:37-78: a non-empty
    forest and ``numSamples >= 2``; ``outlierScoreThreshold`` starts at
    ``-1`` (unset), and labels are all zero until it is set (:142-148).
    """

    def __init__(
        self,
        forest: StandardForest,
        params: IsolationForestParams,
        num_samples: int,
        num_features: int,
        total_num_features: int = UNKNOWN_TOTAL_NUM_FEATURES,
        outlier_score_threshold: float = -1.0,
        uid: Optional[str] = None,
    ):
        if forest.num_trees < 1:
            raise ValueError("model requires a non-empty forest")
        if num_samples < 2:
            raise ValueError(f"numSamples must be >= 2, got {num_samples}")
        self.forest = forest
        self.params = params
        self.num_samples = int(num_samples)
        self.num_features = int(num_features)
        self.total_num_features = int(total_num_features)
        self.outlier_score_threshold = float(outlier_score_threshold)
        self.uid = uid or _new_uid("isolation-forest")
        # kernel tables and the width floor, built on first score; one
        # model's own, so a salvaged model never reads an intact one's tables
        self._cache: dict = {}
        # on_corrupt="drop" loads: which trees were lost (LoadReport)
        self.load_report = None
        # checkpointed fits: the FitCheckpoint (blocks_written, blocks_loaded)
        self.fit_checkpoint = None
        # the drift baseline: captured by fit, read from _BASELINE.json on load
        self.baseline = None
        # the drift monitor every score() folds into, while attached
        self._monitor = None
        # the preferred scoring representation, "f32" or "q16": saved as the
        # scoringRepresentation extra and restored on load; the node table on
        # disk is always the exact f32 Avro form
        self.scoring_representation = "f32"

    @property
    def device(self) -> torch.device:
        return self.forest.device

    def set_outlier_score_threshold(self, value: float) -> "IsolationForestModel":
        """Override the threshold (IsolationForestModel.scala:86-95)."""
        if not (0.0 <= value <= 1.0 or value == -1.0):
            raise ValueError(
                f"outlierScoreThreshold must be in [0, 1] (or -1 = unset), got {value}"
            )
        self.outlier_score_threshold = float(value)
        return self

    def set_scoring_representation(self, value: str) -> "IsolationForestModel":
        """Record the preferred scoring representation, ``"f32"`` (default)
        or ``"q16"``, the rank-quantized plane, and return self. ``"q16"``
        needs a forest inside the plane's fences
        (:func:`~..ops.scoring_layout.quantized_unsupported_reason`; else a
        ValueError). Off the card it drops the f32 tables the model holds
        and builds the q16 plane now, as the JAX package does. On the card
        the preference is only recorded: ``auto`` serves the walk and dense
        kernels there, which read the f32 tables, and the q16 plane is
        larger than they are, so the model keeps them and builds the plane
        at its first ``strategy="q16"`` call. Save and load carry the
        preference. It does not pin the kernel: ``strategy="auto"`` still
        measures."""
        if value not in SCORING_REPRESENTATIONS:
            raise ValueError(
                f"scoring representation must be one of {'/'.join(SCORING_REPRESENTATIONS)}, got {value!r}"
            )
        if value == "q16":
            from ..ops.scoring_layout import quantized_unsupported_reason

            reason = quantized_unsupported_reason(self.forest, self._cache)
            if reason is not None:
                raise ValueError(f"this forest cannot take the q16 representation: {reason}")
        self.scoring_representation = value
        if value == "q16":
            if self.device.type != "cuda":
                # the f32 tables are built again if a strategy that reads them runs
                for key in [k for k in self._cache if isinstance(k, tuple) and k[0] != "q16"]:
                    del self._cache[key]
            self.finalize_scoring()
        return self

    def finalize_scoring(self) -> "IsolationForestModel":
        """Build the scoring tables of the preferred representation on the
        model's device, once: the q16 plane for ``"q16"`` off the card, else
        the walk's records (the static default and the fit's threshold
        pass; on the card, what ``auto`` serves). ``fit`` calls this; a
        loaded model builds its tables on first score. Returns self."""
        from ..ops.traversal import scoring_tables

        q16 = self.scoring_representation == "q16" and self.device.type != "cuda"
        strategy = "q16" if q16 else "walk"
        with _telemetry_span("model.finalize_scoring", trees=self.forest.num_trees):
            scoring_tables(self.forest, strategy, self.device, self._cache)
        return self

    def score(
        self,
        X,
        nonfinite: str = "warn",
        strategy: str = "auto",
        chunk_size: Optional[int] = None,
        pipeline: Optional[bool] = None,
        timeout_s: Optional[float] = None,
        strict: bool = False,
        fold_monitor: bool = True,
        *,
        mesh=None,
    ) -> torch.Tensor:
        """Outlier scores ``2^(-E[h(x)]/c(n))`` of an ``[N, F]`` tensor, array
        or DataFrame, as a float32 tensor on the model's device, inside a
        ``model.score`` span.

        Rows on the host stay there until the streaming executor stages them
        chunk by chunk (``chunk_size``, ``pipeline``: see
        :func:`~..ops.traversal.score_matrix`); rows already on the card are
        chunked in place. Scores are bitwise equal however they are chunked.
        ``nonfinite``: NaN/inf policy (``"warn"``/``"raise"``/``"allow"``);
        under ``"raise"`` the call raises before it returns scores or folds
        the monitor. ``strategy``: ``"auto"`` (the measured autotuner),
        ``"walk"``, ``"dense"`` or ``"q16"``. ``timeout_s`` arms the
        scoring watchdog, which raises
        :class:`~..resilience.watchdog.WatchdogTimeout` on a stall;
        ``strict`` turns an unknown ``ISOFOREST_TPU_STRATEGY`` pin, or
        ``"q16"`` on a forest outside its fences, into
        :class:`~..resilience.degradation.DegradationError`. With a
        drift monitor attached the batch is folded into it after scoring,
        unless ``fold_monitor=False``.

        With ``mesh`` the rows are sharded over its shards, the forest
        replicated (:func:`~..parallel.sharded.sharded_score`; ``strategy``
        from the pool ``"auto"``, ``"walk"``, ``"dense"``), bit for bit the
        unsharded scores, returned on the mesh's first local device; no
        watchdog is armed (``timeout_s`` and ``strict`` do not apply)."""
        X, _ = extract_features(X, self.params.features_col, nonfinite="allow")
        expected = (
            self.total_num_features
            if self.total_num_features != UNKNOWN_TOTAL_NUM_FEATURES
            else None
        )
        with _telemetry_span("model.score", rows=int(X.shape[0])):
            if mesh is not None:
                from ..parallel.sharded import sharded_score

                if expected is not None:
                    validate_feature_vector_size(int(X.shape[1]), expected)
                scores = sharded_score(mesh, self.forest, X, self.num_samples, score_strategy=strategy,
                                       pipeline=pipeline, chunk_rows=chunk_size, cache=self._cache,
                                       nonfinite=nonfinite)
            else:
                scores = score_matrix(
                self.forest,
                X,
                self.num_samples,
                    strategy=strategy,
                    chunk_size=chunk_size,
                    expected_features=expected,
                    device=self.device,
                    cache=self._cache,
                    nonfinite=nonfinite,
                    strict=strict,
                    timeout_s=timeout_s,
                    pipeline=pipeline,
                )
        monitor = self._monitor
        if monitor is not None and fold_monitor:
            monitor.observe(scores, X)
        return scores

    def warmup(self, batch_sizes=(1024,), strategy: str = "auto", width: Optional[int] = None, *, mesh=None
               ) -> "IsolationForestModel":
        """Build what a first request would otherwise pay for: the kernels,
        the kernel tables and, for ``"auto"``, the autotuner's decision of
        each batch size's power-of-two bucket (the buckets ``score`` keys
        on), by scoring a zero matrix of each bucket from the host. Warm
        with the strategy serving will use, and with the ``mesh`` it will
        score through (its devices' tables and its sharded buckets). A
        model that does not record ``totalNumFeatures`` needs ``width``.
        Returns self."""
        if width is None:
            if self.total_num_features == UNKNOWN_TOTAL_NUM_FEATURES:
                raise ValueError(
                    "this model does not record totalNumFeatures (legacy); "
                    "pass width=<serving feature count> to warmup"
                )
            width = self.total_num_features
        from ..ops.traversal import batch_bucket

        for bucket in sorted({batch_bucket(n) for n in batch_sizes}):
            dummy = torch.zeros((bucket, max(int(width), 1)), dtype=torch.float32)
            if mesh is not None:
                from ..parallel.sharded import sharded_score

                sharded_score(mesh, self.forest, dummy, self.num_samples, score_strategy=strategy, cache=self._cache)
            else:
                score_matrix(self.forest, dummy, self.num_samples, strategy=strategy, device=self.device,
                             cache=self._cache)
        for dev in {self.device, *(mesh.flat_devices if mesh is not None else ())}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return self

    def degradations(self):
        """The degradation events of this process (the ladder of
        :mod:`..resilience.degradation`); this model's load details are in
        ``self.load_report``."""
        from ..resilience.degradation import degradations

        return degradations()

    def diagnostics(self) -> dict:
        """Structure of the forest in plain JSON types
        (:func:`~..telemetry.diagnostics.forest_diagnostics`)."""
        from ..telemetry.diagnostics import forest_diagnostics

        return forest_diagnostics(self)

    def enable_monitoring(self, threshold: Optional[float] = None, **monitor_kwargs):
        """Attach a drift monitor (:class:`~..telemetry.monitor.ScoreMonitor`,
        ``threshold`` and ``monitor_kwargs`` its own) and return it: every
        later :meth:`score` folds its batch on the model's device. Needs a
        baseline: a fit with capture on, or a directory with ``_BASELINE.json``."""
        if self.baseline is None:
            raise ValueError(
                "this model has no drift baseline: it was loaded from a "
                "legacy directory (no _BASELINE.json sidecar) or fitted "
                "with baseline capture disabled — refit, or re-save from a "
                "fit with baseline=True, to enable monitoring"
            )
        from ..telemetry.monitor import ScoreMonitor

        if threshold is not None:
            monitor_kwargs["threshold"] = threshold
        self._monitor = ScoreMonitor(self.baseline, **monitor_kwargs)
        return self._monitor

    def rebind_monitoring(self, baseline=None):
        """Re-arm the attached monitor against ``baseline`` (default: the
        model's own): its counts are dropped and every alert re-arms; the
        monitor object stays and is returned."""
        monitor = self._monitor
        if monitor is None:
            raise ValueError("no drift monitor attached; call enable_monitoring() first")
        target = baseline if baseline is not None else self.baseline
        if target is None:
            raise ValueError("no baseline to rebind to: this model carries none and no explicit baseline was given")
        monitor.rebind(target)
        return monitor

    def disable_monitoring(self) -> None:
        """Detach the drift monitor; its counts are discarded."""
        self._monitor = None

    def predict(self, scores: torch.Tensor) -> torch.Tensor:
        """Labels: ``score >= threshold`` when a threshold is set, else all
        zeros (IsolationForestModel.scala:142-148); float64, like the JAX
        package's."""
        scores = torch.as_tensor(scores)
        if self.outlier_score_threshold > 0:
            return (scores >= self.outlier_score_threshold).to(torch.float64)
        return torch.zeros_like(scores, dtype=torch.float64)

    def transform(self, data, nonfinite: str = "warn", *, mesh=None):
        """Score and label columns, named by the params' ``scoreCol`` and
        ``predictionCol`` (IsolationForestModel.scala:116-151): a DataFrame
        comes back as a copy with both columns appended, and is refused if
        it already has either; a tensor or array gives a dict of tensors.
        ``mesh`` scores row-sharded (:meth:`score`)."""
        p = self.params
        X, frame = extract_features(data, p.features_col, output_cols=(p.score_col, p.prediction_col),
                                    nonfinite="allow")
        scores = self.score(X, nonfinite=nonfinite, mesh=mesh)
        labels = self.predict(scores)
        if frame is None:
            return {p.score_col: scores.to(torch.float64), p.prediction_col: labels}
        out = frame.copy()
        out[p.score_col] = scores.to(torch.float64).cpu().numpy()
        out[p.prediction_col] = labels.cpu().numpy()
        return out

    def save(self, path: str, overwrite: bool = False) -> None:
        """Save atomically in the reference's Avro + JSON-metadata layout
        (IsolationForestModelReadWrite.scala:210-249), sealed with
        ``_MANIFEST.json``; the JAX package loads it."""
        from ..io.persistence import save_standard_model

        save_standard_model(self, path, overwrite=overwrite)

    @classmethod
    def load(cls, path: str, device=None, require_success: bool = True, verify="auto",
             on_corrupt: str = "raise") -> "IsolationForestModel":
        """Load a model directory saved in the reference layout onto
        ``device`` (default: the card); ``verify`` checks its manifest
        (``"auto"``: when there is one); ``on_corrupt="drop"`` salvages the
        intact trees of a damaged one and sets ``load_report``."""
        from ..io.persistence import load_standard_model

        return load_standard_model(path, device=device, require_success=require_success, verify=verify,
                                   on_corrupt=on_corrupt)
