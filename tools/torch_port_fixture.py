"""Regenerate the JAX-written model fixture the PyTorch port is held against.

Fits the JAX package's standard forest on the committed mammography CSV
(``IsolationForest(contamination=0.02, random_seed=1)``), saves it in the
reference Avro + JSON layout under
``tests/resources/torch_port/mammography_std/model`` and writes
``jax_scores.npy`` beside it: the JAX package's ``score(X,
strategy="gather")`` on all 11,183 rows, float32.

The GPU machine that runs ``chip_smoke.py`` has no JAX, so these files are
what it compares the port's scores with. Run on the CPU::

    JAX_PLATFORMS=cpu python tools/torch_port_fixture.py
"""

from __future__ import annotations

import os
import pathlib
import shutil
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "tests" / "resources" / "torch_port" / "mammography_std"


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    sys.path.insert(0, str(ROOT))
    from isoforest_tpu import IsolationForest

    data = np.loadtxt(
        ROOT / "tests" / "resources" / "mammography.csv", delimiter=",", comments="#"
    ).astype(np.float32)
    X = data[:, :-1]
    model = IsolationForest(contamination=0.02, random_seed=1).fit(X)
    model_dir = OUT / "model"
    if model_dir.exists():
        shutil.rmtree(model_dir)
    OUT.mkdir(parents=True, exist_ok=True)
    model.save(str(model_dir))
    scores = np.asarray(model.score(X, strategy="gather"), np.float32)
    np.save(OUT / "jax_scores.npy", scores)
    print(
        f"wrote {model_dir} ({model.forest.num_trees} trees, threshold "
        f"{model.outlier_score_threshold!r}) and jax_scores.npy "
        f"({scores.shape[0]} rows)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
