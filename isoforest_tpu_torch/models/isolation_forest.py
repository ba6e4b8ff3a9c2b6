"""The standard isolation forest: the estimator :class:`IsolationForest` and
the fitted :class:`IsolationForestModel` (``isoforest_tpu/models/isolation_forest.py``).

``IsolationForest(...).fit(X)`` runs on one device: the bags, feature
subsets, per-level statistics and draws of growth
(:func:`~isoforest_tpu_torch.ops.tree_growth.grow_forest_fused`; the
extended estimator shares this path, :func:`_fit_impl`), then the
contamination threshold over the training rows' scores, which go through
the model's own scoring path (the walk kernel on the card). Only the
parameters' resolution, the threshold's one float and a save's Avro encode
run on the host. The forest is the JAX package's for the same data and seed
(the draws are its threefry streams), up to Gumbel near-ties where torch's
``log`` and XLA's differ by an ulp.

``fit``/``transform`` take an ``[N, F]`` tensor or array, or a pandas
DataFrame with a vector-valued features column; ``transform`` of a frame
returns the frame with ``outlierScore`` and ``predictedLabel`` appended
(IsolationForestModel.scala:142-148).
"""

from __future__ import annotations

import math
import uuid
from typing import Optional

import numpy as np
import torch

from ..ops import prng
from ..ops.bagging import feature_subsets, per_tree_keys
from ..ops.ext_growth import grow_extended_forest, grow_extended_forest_fused
from ..ops.quantile import contamination_threshold, observed_contamination
from ..ops.traversal import score_matrix
from ..ops.tree_growth import StandardForest, grow_forest, grow_forest_fused
from ..utils.device import resolve_device
from ..utils.math import height_limit
from ..utils.params import IsolationForestParams, resolve_extension_level, resolve_params
from ..utils.validation import UNKNOWN_TOTAL_NUM_FEATURES, extract_features, logger


def _new_uid(prefix: str) -> str:
    return f"{prefix}_{uuid.uuid4().hex[:12]}"


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

    def fit(self, data, nonfinite: str = "warn", subsample_trees=None) -> "IsolationForestModel":
        """Fit on an ``[N, F]`` tensor, array or DataFrame. ``nonfinite`` is
        the NaN/inf policy (``"warn"``, ``"raise"``, ``"allow"``);
        ``subsample_trees`` grows only that many (int) or that share
        (float) of ``numEstimators`` trees, and the model records the
        smaller ensemble."""
        return _fit_impl(self, data, extended=False, nonfinite=nonfinite, subsample_trees=subsample_trees)

    def fit_from_sample(self, X_sample, bag, nonfinite: str = "warn") -> "IsolationForestModel":
        """Fit from a materialised sample: ``X_sample [U, F]`` and the bags
        ``[numEstimators, numSamples]`` that index it. The bag replaces the
        bagging draw; feature subsets and growth keys come from the same
        ``(k_bag, k_feat, k_grow)`` split as :meth:`fit`, so two fits of one
        sample are bitwise equal. ``maxSamples`` must be a count; the
        threshold comes from the sample's own scores."""
        return _fit_from_sample_impl(self, X_sample, bag, extended=False, nonfinite=nonfinite)

    def save(self, path: str, overwrite: bool = False) -> None:
        """Save the params (metadata only, IsolationForest.scala:114-125)."""
        from ..io.persistence import STANDARD_ESTIMATOR_CLASS, save_estimator

        save_estimator(self, path, STANDARD_ESTIMATOR_CLASS, overwrite=overwrite)

    @classmethod
    def load(cls, path: str, device=None) -> "IsolationForest":
        from ..io.persistence import STANDARD_ESTIMATOR_CLASS, load_estimator

        params, uid = load_estimator(path, IsolationForestParams, STANDARD_ESTIMATOR_CLASS)
        return cls(params=params, uid=uid, device=device)


def _grow_and_threshold(p, X, resolved, extended: bool, grow) -> "IsolationForestModel":
    """The model of either estimator: ``grow(height, level)`` its forest
    (``level``: the resolved ``extensionLevel`` of an EIF, else None), then
    threshold it on ``X``."""
    h = height_limit(resolved.num_samples)
    common = dict(params=p, num_samples=resolved.num_samples, num_features=resolved.num_features,
                  total_num_features=int(X.shape[1]))
    if extended:
        from .extended import ExtendedIsolationForestModel

        level = resolve_extension_level(p.extension_level, resolved.num_features)
        logger.info("resolved extensionLevel=%d", level)
        model = ExtendedIsolationForestModel(forest=grow(h, level), extension_level=level, **common)
    else:
        model = IsolationForestModel(forest=grow(h, None), **common)
    _compute_and_set_threshold(model, X)
    return model


def _fit_impl(est, data, *, extended: bool, nonfinite: str, subsample_trees) -> "IsolationForestModel":
    """``fit`` of both estimators on one device: bags, feature subsets and
    growth from one key (the fused program), then the threshold."""
    dev = resolve_device(est.device)
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
    key = _seed_key(p, dev)
    shape = dict(num_samples=resolved.num_samples, num_trees=p.num_estimators, bootstrap=p.bootstrap,
                 num_features=resolved.num_features)

    def grow(h, level):
        if level is None:
            return grow_forest_fused(key, X, **shape, height=h)
        return grow_extended_forest_fused(key, X, **shape, height=h, extension_level=level)

    return _grow_and_threshold(p, X, resolved, extended, grow)


def _fit_from_sample_impl(est, X_sample, bag, *, extended: bool, nonfinite: str) -> "IsolationForestModel":
    """``fit_from_sample`` of both estimators: the given bag replaces the
    bagging draw; feature subsets and growth keys come from the fit's key."""
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
    if p.max_samples <= 1.0:
        raise ValueError(
            f"a fit from a sample requires an absolute maxSamples (> 1), got fraction {p.max_samples!r}"
        )
    num_samples = int(math.floor(p.max_samples))
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
    _, k_feat, k_grow = prng.split(_seed_key(p, dev), 3)  # k_bag is replaced by the bag
    fidx = feature_subsets(k_feat, f, resolved.num_features, p.num_estimators)
    tree_keys = per_tree_keys(k_grow, p.num_estimators)
    bag = bag.to(torch.int32)

    def grow(h, level):
        if level is None:
            return grow_forest(tree_keys, X, bag, fidx, h)
        return grow_extended_forest(tree_keys, X, bag, fidx, h, level)

    return _grow_and_threshold(p, X, resolved, extended, grow)


def _compute_and_set_threshold(model: "IsolationForestModel", X: torch.Tensor) -> None:
    """Contamination thresholding (SharedTrainLogic.scala:175-242): with
    contamination 0 the threshold stays -1 and every label is 0; else it is
    the ``1 - contamination`` quantile of the training scores within
    ``contaminationError``, and the observed contamination is checked."""
    p = model.params
    if p.contamination == 0.0:
        return
    scores = model.score(X, nonfinite="allow")  # the policy was applied at fit
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
        # kernel tables and the width floor, built on first score
        self._cache: dict = {}

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

    def score(
        self,
        X,
        nonfinite: str = "warn",
        strategy: str = "auto",
        chunk_size: Optional[int] = None,
    ) -> torch.Tensor:
        """Outlier scores ``2^(-E[h(x)]/c(n))`` of an ``[N, F]`` tensor, array
        or DataFrame, as a float32 tensor on the model's device.
        ``nonfinite``: NaN/inf policy (``"warn"``/``"raise"``/``"allow"``);
        ``strategy``: ``"auto"``, ``"walk"`` or ``"dense"``."""
        X, _ = extract_features(X, self.params.features_col, nonfinite=nonfinite, device=self.device)
        expected = (
            self.total_num_features
            if self.total_num_features != UNKNOWN_TOTAL_NUM_FEATURES
            else None
        )
        return score_matrix(
            self.forest,
            X,
            self.num_samples,
            strategy=strategy,
            chunk_size=chunk_size,
            expected_features=expected,
            device=self.device,
            cache=self._cache,
        )

    def predict(self, scores: torch.Tensor) -> torch.Tensor:
        """Labels: ``score >= threshold`` when a threshold is set, else all
        zeros (IsolationForestModel.scala:142-148); float64, like the JAX
        package's."""
        scores = torch.as_tensor(scores)
        if self.outlier_score_threshold > 0:
            return (scores >= self.outlier_score_threshold).to(torch.float64)
        return torch.zeros_like(scores, dtype=torch.float64)

    def transform(self, data, nonfinite: str = "warn"):
        """Score and label columns, named by the params' ``scoreCol`` and
        ``predictionCol`` (IsolationForestModel.scala:116-151): a DataFrame
        comes back as a copy with both columns appended, and is refused if
        it already has either; a tensor or array gives a dict of tensors."""
        p = self.params
        X, frame = extract_features(
            data, p.features_col, output_cols=(p.score_col, p.prediction_col),
            nonfinite=nonfinite, device=self.device,
        )
        scores = self.score(X, nonfinite="allow")  # checked above
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
    def load(cls, path: str, device=None, require_success: bool = True, verify="auto") -> "IsolationForestModel":
        """Load a model directory saved in the reference layout onto
        ``device`` (default: the card); ``verify`` checks its manifest
        (``"auto"``: when there is one)."""
        from ..io.persistence import load_standard_model

        return load_standard_model(path, device=device, require_success=require_success, verify=verify)
