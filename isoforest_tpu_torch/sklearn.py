"""The scikit-learn adapter (``isoforest_tpu/sklearn.py``): the port's
forests as a ``BaseEstimator``/``OutlierMixin``, for ``Pipeline``,
``GridSearchCV`` and ``clone``.

sklearn's conventions: ``fit(X, y=None)`` returns self; ``score_samples``
is the negated anomaly score (higher is more normal, as
``sklearn.ensemble.IsolationForest``); ``predict`` gives +1 (inlier) or -1
(outlier); ``decision_function = score_samples - offset_``. Every output is
host numpy, as the JAX package's adapter gives. ``device`` (default: the
card) is where the model fits and scores; ``device="cpu"`` runs the
kernels' plain versions. scikit-learn is optional: without it the adapter
keeps the same methods over plain base classes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

try:
    from sklearn.base import BaseEstimator, OutlierMixin
    from sklearn.exceptions import NotFittedError
except Exception:  # pragma: no cover - scikit-learn is optional
    class BaseEstimator:  # type: ignore
        pass

    class OutlierMixin:  # type: ignore
        pass

    class NotFittedError(Exception):  # type: ignore
        pass

from .models import ExtendedIsolationForest, IsolationForest
from .utils.params import ExtendedIsolationForestParams, IsolationForestParams


def _host(scores) -> np.ndarray:
    return scores.detach().cpu().numpy() if hasattr(scores, "detach") else np.asarray(scores)


class TpuIsolationForest(BaseEstimator, OutlierMixin):
    """A scikit-learn outlier detector backed by the port's isolation forest."""

    def __init__(
        self,
        n_estimators: int = 100,
        max_samples: float = 256.0,
        contamination: float = 0.0,
        contamination_error: float = 0.0,
        max_features: float = 1.0,
        bootstrap: bool = False,
        random_state: int = 1,
        extension_level: Optional[int] = None,
        nonfinite: str = "warn",
        device=None,
    ):
        self.n_estimators = n_estimators
        self.max_samples = max_samples
        self.contamination = contamination
        self.contamination_error = contamination_error
        self.max_features = max_features
        self.bootstrap = bootstrap
        self.random_state = random_state
        self.extension_level = extension_level
        # the NaN/inf input policy ("warn", "raise", "allow") of fit and score
        self.nonfinite = nonfinite
        self.device = device

    def _build_estimator(self):
        common = dict(
            num_estimators=self.n_estimators,
            max_samples=float(self.max_samples),
            contamination=self.contamination,
            contamination_error=self.contamination_error,
            max_features=float(self.max_features),
            bootstrap=self.bootstrap,
            random_seed=self.random_state,
        )
        if self.extension_level is not None:
            return ExtendedIsolationForest(
                params=ExtendedIsolationForestParams(extension_level=self.extension_level, **common),
                device=self.device,
            )
        return IsolationForest(params=IsolationForestParams(**common), device=self.device)

    def fit(self, X, y=None, mesh=None, checkpoint_dir=None, checkpoint_every=None, resume=False):
        """Fit; ``checkpoint_dir``/``checkpoint_every``/``resume`` go to the
        estimator's checkpointed fit (a killed fit resumes bit for bit). A
        ``mesh`` is refused: the port fits on one device."""
        if mesh is not None:
            raise NotImplementedError(
                "fit(mesh=...) needs the multi-device layer (ROADMAP item 15), which the port does not have "
                "yet; fit on one device (device=...)"
            )
        X = np.asarray(X, np.float32)
        self.model_ = self._build_estimator().fit(
            X,
            nonfinite=self.nonfinite,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            resume=resume,
        )
        thr = self.model_.outlier_score_threshold
        # sklearn flags decision_function < 0
        self.offset_ = -thr if thr > 0 else -0.5
        self.n_features_in_ = X.shape[1]
        return self

    def score_samples(self, X) -> np.ndarray:
        """Negated anomaly score (higher is more normal)."""
        return -self.anomaly_score(X)

    def decision_function(self, X) -> np.ndarray:
        return self.score_samples(X) - self.offset_

    def predict(self, X) -> np.ndarray:
        """+1 inlier, -1 outlier."""
        return np.where(self.decision_function(X) < 0, -1, 1)

    def fit_predict(self, X, y=None) -> np.ndarray:
        return self.fit(X).predict(X)

    def anomaly_score(self, X) -> np.ndarray:
        """The reference's outlier score in [0, 1] (not negated)."""
        self._check_fitted()
        return _host(self.model_.score(np.asarray(X, np.float32), nonfinite=self.nonfinite))

    # -- the model's observability -- #

    def diagnostics(self) -> dict:
        """Forest-structure diagnostics of the fitted model."""
        self._check_fitted()
        return self.model_.diagnostics()

    def enable_monitoring(self, threshold=None, **monitor_kwargs):
        """Attach a drift monitor to the fitted model (every later score
        folds into it) and return it."""
        self._check_fitted()
        return self.model_.enable_monitoring(threshold=threshold, **monitor_kwargs)

    def disable_monitoring(self) -> None:
        self._check_fitted()
        self.model_.disable_monitoring()

    def rebind_monitoring(self, baseline=None):
        """Re-arm the attached monitor against ``baseline`` (default: the
        model's own)."""
        self._check_fitted()
        return self.model_.rebind_monitoring(baseline=baseline)

    def manage(self, work_dir, drift_debounce=3, window_rows=65536, gates=None, **manager_kwargs):
        """Wrap the fitted model in a lifecycle
        :class:`~isoforest_tpu_torch.lifecycle.ModelManager` (drift-triggered
        refits, validated hot swaps) on the model's device; the knobs go to
        it (``drift_debounce``, ``window_rows``, ``gates`` and any other).
        Score through the returned manager: after a swap ``self.model_`` is
        the live generation."""
        self._check_fitted()
        from .lifecycle import ModelManager

        adapter = self

        class _AdapterTrackingManager(ModelManager):
            # the adapter follows the live generation
            def _swap(self, candidate, seq, target):
                super()._swap(candidate, seq, target)
                adapter.model_ = candidate

        return _AdapterTrackingManager(
            self.model_,
            work_dir,
            drift_debounce=drift_debounce,
            window_rows=window_rows,
            gates=gates,
            **manager_kwargs,
        )

    def _check_fitted(self):
        if not hasattr(self, "model_"):
            raise NotFittedError("This TpuIsolationForest instance is not fitted yet; call fit first")
