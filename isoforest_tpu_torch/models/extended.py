"""The extended isolation forest: the estimator :class:`ExtendedIsolationForest`
and the fitted :class:`ExtendedIsolationForestModel`
(``isoforest_tpu/models/extended.py``).

``ExtendedIsolationForest(...).fit(X)`` runs on one device through the
standard estimator's path (bags, feature subsets, then growth by random
hyperplanes, :func:`~isoforest_tpu_torch.ops.ext_growth.grow_extended_forest`,
then the contamination threshold over the training rows' scores, through
the EIF walk kernel on the card). ``extensionLevel`` resolves at fit
(unset: ``numFeatures - 1``, fully extended); the estimator keeps its own
params and the model records the resolved level
(ExtendedIsolationForest.scala:56-69, 102). Scoring dispatches on the
forest's type (ExtendedIsolationForestModel.scala:98-135); only the recorded
``extension_level`` and persistence differ from the standard model.
"""

from __future__ import annotations

from typing import Optional

from ..ops.ext_growth import ExtendedForest
from ..utils.params import ExtendedIsolationForestParams
from ..utils.validation import UNKNOWN_TOTAL_NUM_FEATURES
from .isolation_forest import (
    IsolationForestModel,
    _fit_from_sample_impl,
    _fit_impl,
    _fit_source_impl,
    _new_uid,
    _ParamSetters,
)


class ExtendedIsolationForest(_ParamSetters):
    """Estimator: ``fit(data) -> ExtendedIsolationForestModel``
    (ExtendedIsolationForest.scala:40-136) on ``device`` (default: the card)."""

    def __init__(self, params: Optional[ExtendedIsolationForestParams] = None, uid=None, device=None, **kw):
        self.params = params if params is not None else ExtendedIsolationForestParams(**kw)
        self.uid = uid or _new_uid("extended-isolation-forest")
        self.device = device

    def set_extension_level(self, v: int):
        return self._set(extension_level=v)

    def fit(self, data, nonfinite: str = "warn", subsample_trees=None, checkpoint_dir: Optional[str] = None,
            checkpoint_every: Optional[int] = None, resume: bool = False, baseline: bool = True,
            block_callback=None) -> "ExtendedIsolationForestModel":
        """Fit on an ``[N, F]`` tensor, array or DataFrame; the same knobs
        as :meth:`IsolationForest.fit`, checkpoints and baseline included."""
        return _fit_impl(self, data, extended=True, nonfinite=nonfinite, subsample_trees=subsample_trees,
                         checkpoint=(checkpoint_dir, checkpoint_every, resume, block_callback), baseline=baseline)

    def fit_from_sample(self, X_sample, bag, nonfinite: str = "warn", checkpoint_dir: Optional[str] = None,
                        checkpoint_every: Optional[int] = None, resume: bool = False, baseline: bool = True,
                        block_callback=None, sample_sha256: Optional[str] = None,
                        source_rows: Optional[int] = None) -> "ExtendedIsolationForestModel":
        """Fit from a materialised sample and its bags, as
        :meth:`IsolationForest.fit_from_sample`."""
        return _fit_from_sample_impl(self, X_sample, bag, extended=True, nonfinite=nonfinite,
                                     checkpoint=(checkpoint_dir, checkpoint_every, resume, block_callback),
                                     baseline=baseline, sample_sha256=sample_sha256, source_rows=source_rows)

    def fit_source(self, source, chunk_rows: Optional[int] = None, checkpoint_dir: Optional[str] = None,
                   checkpoint_every: Optional[int] = None, resume: bool = False, baseline: bool = True,
                   nonfinite: str = "warn", block_callback=None) -> "ExtendedIsolationForestModel":
        """Out-of-core fit of a sharded source, as :meth:`IsolationForest.fit_source`."""
        return _fit_source_impl(self, source, extended=True, chunk_rows=chunk_rows, nonfinite=nonfinite,
                                checkpoint=(checkpoint_dir, checkpoint_every, resume, block_callback),
                                baseline=baseline)

    def save(self, path: str, overwrite: bool = False) -> None:
        """Save the params (metadata only) under the reference's estimator class."""
        from ..io.persistence import EXTENDED_ESTIMATOR_CLASS, save_estimator

        save_estimator(self, path, EXTENDED_ESTIMATOR_CLASS, overwrite=overwrite)

    @classmethod
    def load(cls, path: str, device=None) -> "ExtendedIsolationForest":
        from ..io.persistence import EXTENDED_ESTIMATOR_CLASS, load_estimator

        params, uid = load_estimator(path, ExtendedIsolationForestParams, EXTENDED_ESTIMATOR_CLASS)
        return cls(params=params, uid=uid, device=device)


class ExtendedIsolationForestModel(IsolationForestModel):
    """Fitted EIF model over a heap-tensor forest that lives on one device."""

    def __init__(
        self,
        forest: ExtendedForest,
        params: ExtendedIsolationForestParams,
        num_samples: int,
        num_features: int,
        extension_level: int,
        total_num_features: int = UNKNOWN_TOTAL_NUM_FEATURES,
        outlier_score_threshold: float = -1.0,
        uid: Optional[str] = None,
    ):
        super().__init__(
            forest=forest,
            params=params,
            num_samples=num_samples,
            num_features=num_features,
            total_num_features=total_num_features,
            outlier_score_threshold=outlier_score_threshold,
            uid=uid or _new_uid("extended-isolation-forest"),
        )
        self.extension_level = int(extension_level)

    def save(self, path: str, overwrite: bool = False) -> None:
        """Save atomically in the reference's extended layout, with the
        resolved ``extensionLevel`` in the paramMap; the JAX package loads it."""
        from ..io.persistence import save_extended_model

        save_extended_model(self, path, overwrite=overwrite)

    @classmethod
    def load(
        cls, path: str, device=None, require_success: bool = True, verify="auto", on_corrupt: str = "raise"
    ) -> "ExtendedIsolationForestModel":
        """Load an extended model directory saved in the reference layout
        onto ``device`` (default: the card); ``verify`` and ``on_corrupt``
        as :meth:`IsolationForestModel.load`."""
        from ..io.persistence import load_extended_model

        return load_extended_model(path, device=device, require_success=require_success, verify=verify,
                                   on_corrupt=on_corrupt)
