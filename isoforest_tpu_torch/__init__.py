"""isoforest_tpu_torch: the isolation forest of ``isoforest_tpu`` in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (H100).

It fits and serves standard and extended (EIF) forests: fit one on the card
(:class:`IsolationForest`, :class:`ExtendedIsolationForest`) or load a model
the JAX package (or the reference) saved, and score rows on the card through the
O(h) walk kernels (``walk_sum`` and ``ext_walk_sum`` of
``csrc/path_walk.cu``) or the dense level-walk kernels (``csrc/dense.cu``,
``ext_sparse_mean`` of ``csrc/path_walk.cu``, ``csrc/ext_gemm.cu``). Entry points
run on the card unless the caller names another device; ``device="cpu"``
runs the kernels' plain PyTorch versions.

    from isoforest_tpu_torch import ExtendedIsolationForest, IsolationForest, io, load_model
    model = IsolationForest(contamination=0.02).fit(X)  # or ExtendedIsolationForest(...)
    model = IsolationForest(contamination=0.02).fit(X, checkpoint_dir="ckpt")  # resumable
    model.save("path/to/model")  # with its drift baseline, _BASELINE.json
    served = load_model("path/to/model").warmup((1, 64, 4096))  # kernels, tables, autotuned buckets
    monitor = served.enable_monitoring()  # every score() now folds into it
    scores = served.score(X, timeout_s=5.0)  # host rows stream through pinned buffers
    print(monitor.report())  # score and feature PSI, KS, alerts
    big = IsolationForest(max_samples=256.0, random_seed=1).fit_source("shards/")  # out of core: .npy/.csv/.avro
    io.outofcore.score_source(big, "shards/", "scores/", strategy="walk")  # sealed per shard, resume=True

``strategy="auto"`` (the default) is resolved by the measured autotuner
(:mod:`.tuning`); rows on the host reach the card chunk by chunk through the
streaming executor (:mod:`.ops.streaming`); :mod:`.telemetry` holds spans,
metrics and events, :mod:`.resilience` the watchdog and the fault seams,
:mod:`.io` model files and the out-of-core data plane (sharded sources,
``score_source``, ``read_scores``), :mod:`.serving` the online scoring service
(``serving.serve_model``: ``POST /score`` on the telemetry daemon, requests
coalesced into one ``model.score`` a flush), :mod:`.lifecycle` the model
lifecycle (``lifecycle.ModelManager``: drift-triggered refits, validated
hot swaps; ``serve_model`` serves a model with a baseline through one) and
:mod:`.sklearn` the scikit-learn adapter. :mod:`.fleet`, :mod:`.autopilot`
and :mod:`.stream` serve many tenants, brown out under overload and score
event-time streams; :mod:`.replication` fronts replica processes with a
router (``python -m isoforest_tpu_torch serve|route|journal``).

    manager = lifecycle.ModelManager(served, "work_dir")  # refits on drift, swaps when the gates pass
    scores = manager.score(X)
"""

from . import io, lifecycle, ops, parallel, resilience, serving, telemetry, tuning, utils
from .io import persistence
from .models import ExtendedIsolationForest, ExtendedIsolationForestModel, IsolationForest, IsolationForestModel
from .ops.traversal import score_matrix

__version__ = "0.6.0"


def load_model(path: str, device=None, require_success: bool = True, verify="auto",
               on_corrupt: str = "raise") -> IsolationForestModel:
    """Load a model directory onto ``device`` (default: the card) as the
    class its metadata names: an :class:`ExtendedIsolationForestModel` or an
    :class:`IsolationForestModel`. ``verify="auto"`` checks the directory's
    ``_MANIFEST.json`` when it has one, and refuses it on any mismatch
    unless ``on_corrupt="drop"`` and only data files are damaged: then the
    intact trees are kept and ``model.load_report`` says which were lost."""
    return persistence.load_model(path, device=device, require_success=require_success, verify=verify,
                                  on_corrupt=on_corrupt)


__all__ = ["ExtendedIsolationForest", "ExtendedIsolationForestModel", "IsolationForest", "IsolationForestModel",
           "__version__", "io", "lifecycle", "load_model", "ops", "parallel", "resilience", "score_matrix", "serving",
           "telemetry", "tuning", "utils"]
