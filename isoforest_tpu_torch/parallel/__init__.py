"""The multi-device layer (``isoforest_tpu/parallel``): a ``(data, trees)``
mesh of devices (:mod:`.mesh`), tree-sharded growth and row- and 2-D-sharded
scoring (:mod:`.sharded`), and the fused train step (:mod:`.train_step`), on
``torch.distributed`` across processes.

    from isoforest_tpu_torch.parallel import create_mesh
    mesh = create_mesh()  # every local card; [torch.device("cpu")] * 8 on the CPU
    model = IsolationForest(contamination=0.02).fit(X, mesh=mesh)
    scores = model.score(X, mesh=mesh)
"""

from .mesh import DATA_AXIS, TREES_AXIS, create_mesh, initialize_distributed
from .sharded import (
    sharded_grow_extended_forest,
    sharded_grow_forest,
    sharded_score,
    sharded_score_2d,
)
from .train_step import TrainStepResult, make_train_step

__all__ = [
    "DATA_AXIS",
    "TREES_AXIS",
    "create_mesh",
    "initialize_distributed",
    "sharded_grow_extended_forest",
    "sharded_grow_forest",
    "sharded_score",
    "sharded_score_2d",
    "TrainStepResult",
    "make_train_step",
]
