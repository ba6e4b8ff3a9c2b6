"""Regenerate the JAX-written extended (EIF) model fixture the PyTorch port is held against.

Fits the JAX package's extended forest on the committed mammography CSV
(``ExtendedIsolationForest(contamination=0.02, random_seed=1)``: 100 trees,
``maxSamples=256``, extension level F - 1 = 5, so k = 6 coordinates per
hyperplane), saves it in the reference Avro + JSON layout under
``tests/resources/torch_port/mammography_eif/model`` and writes beside it,
each float32 ``[11183]``:

* ``jax_scores.npy``: ``score(X, strategy="gather")``;
* ``jax_walk_scores.npy``: the walk kernel ``_extended_walk``
  (``pallas_walk.path_lengths_walk``) in interpret mode, as scores;
* ``jax_pallas_scores.npy``: the sparse dense-walk kernel
  ``_extended_pallas_sparse`` (``pallas_traversal.path_lengths_pallas``) in
  interpret mode, as scores.

Path lengths become scores through the JAX package's
``score_from_path_length``. The script prints the JAX package's own max
gaps between the three files. The GPU machine that runs ``chip_smoke.py``
has no JAX, so these files are what it compares the port's scores with.
Run on the CPU::

    JAX_PLATFORMS=cpu python tools/torch_port_fixture_eif.py
"""

from __future__ import annotations

import os
import pathlib
import shutil
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "tests" / "resources" / "torch_port" / "mammography_eif"


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    sys.path.insert(0, str(ROOT))
    from isoforest_tpu import ExtendedIsolationForest
    from isoforest_tpu.ops.pallas_traversal import path_lengths_pallas
    from isoforest_tpu.ops.pallas_walk import path_lengths_walk
    from isoforest_tpu.utils.math import score_from_path_length

    data = np.loadtxt(
        ROOT / "tests" / "resources" / "mammography.csv", delimiter=",", comments="#"
    ).astype(np.float32)
    X = data[:, :-1]
    model = ExtendedIsolationForest(contamination=0.02, random_seed=1).fit(X)
    model_dir = OUT / "model"
    if model_dir.exists():
        shutil.rmtree(model_dir)
    OUT.mkdir(parents=True, exist_ok=True)
    model.save(str(model_dir))
    files = {
        "jax_scores.npy": model.score(X, strategy="gather"),
        "jax_walk_scores.npy": score_from_path_length(
            path_lengths_walk(model.forest, X, interpret=True), model.num_samples
        ),
        "jax_pallas_scores.npy": score_from_path_length(
            path_lengths_pallas(model.forest, X, interpret=True), model.num_samples
        ),
    }
    scores = {name: np.asarray(s, np.float32) for name, s in files.items()}
    for name, s in scores.items():
        np.save(OUT / name, s)
    forest = model.forest
    print(
        f"wrote {model_dir} ({forest.num_trees} trees, heap slots {forest.max_nodes}, "
        f"k {forest.indices.shape[2]}, extension level {model.extension_level}, "
        f"threshold {model.outlier_score_threshold!r}) and {', '.join(scores)}"
    )
    gather = scores["jax_scores.npy"]
    for name in ("jax_walk_scores.npy", "jax_pallas_scores.npy"):
        gap = np.abs(scores[name] - gather)
        print(f"{name} vs jax_scores.npy: max |delta| {gap.max()!r}, rows over 1e-6: {int((gap > 1e-6).sum())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
