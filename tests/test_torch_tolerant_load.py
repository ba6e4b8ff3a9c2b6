"""The port's tolerant load (``on_corrupt="drop"``, ``isoforest_tpu_torch/io/persistence.py``,
``io/avro.py::read_blocks_tolerant``, ``resilience/faults.py``) against the
JAX package's, on the CPU, on copies of the committed fixtures.

Each copy's node table is rewritten in blocks of 1,000 records (the
fixtures hold one block, which a read fault would lose whole), then damaged
by each package's read-fault seam or by editing trees. Tolerances: the two
packages give the same ``LoadReport`` (kept and dropped tree ids, issue
strings) and the same salvaged forest arrays; the survivors' scores are
within 2e-6 of the JAX package's gather scores of the same salvaged forest
(the walks sum in other orders): the standard walk's, and for the EIF the
``dense`` strategy's, which routes ties as the gather walk does
(``tests/test_torch_ext_model.py``), on 2,048 rows.
"""

from __future__ import annotations

import os
import pathlib
import shutil

import numpy as np
import pytest
import torch

from isoforest_tpu.io import persistence as jpersistence
from isoforest_tpu.resilience import faults as jfaults
from isoforest_tpu.resilience.degradation import reset_degradations as jreset_degradations
from isoforest_tpu_torch import load_model, telemetry
from isoforest_tpu_torch.io import avro
from isoforest_tpu_torch.resilience import faults, manifest
from isoforest_tpu_torch.resilience.degradation import degradation_report, reset_degradations
from isoforest_tpu_torch.testing import torch_threads

RESOURCES = pathlib.Path(__file__).parent / "resources" / "torch_port"
FIXTURES = {"standard": RESOURCES / "mammography_std" / "model", "extended": RESOURCES / "mammography_eif" / "model"}
PAYLOAD = {"standard": "nodeData", "extended": "extendedNodeData"}
GATHER_TWIN = {"standard": "walk", "extended": "dense"}  # the port strategy held to the JAX gather walk
BLOCK_RECORDS = 1000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run beside other test processes
    (``testing.torch_threads``)."""
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True)
def _clean():
    telemetry.reset()
    reset_degradations()
    jreset_degradations()
    yield
    telemetry.reset()
    reset_degradations()


def _part(path) -> str:
    data = os.path.join(path, "data")
    return os.path.join(data, next(f for f in sorted(os.listdir(data)) if f.endswith(".avro")))


def _copy(kind, tmp_path, block_records=BLOCK_RECORDS) -> str:
    """A sealed copy of the fixture whose node table has ``block_records`` records a block."""
    path = str(tmp_path / kind)
    shutil.copytree(FIXTURES[kind], path)
    part = _part(path)
    schema, records = avro.read_container(part)
    avro.write_container(part, schema, records, block_records=block_records)
    manifest.write(path)
    return path


def _edit_trees(path, kind) -> None:
    """Damage trees inside an intact container, then reseal: a missing node
    (standard tree 2, EIF tree 1) and a dangling child (standard tree 5)."""
    part = _part(path)
    schema, records = avro.read_container(part)
    field = PAYLOAD[kind]
    kept = []
    for r in records:
        node = r[field]
        if (r["treeID"], node["id"]) == ((2, 1) if kind == "standard" else (1, 2)):
            continue
        if kind == "standard" and (r["treeID"], node["id"]) == (5, 0):
            r = {**r, field: {**node, "leftChild": 10_000}}
        kept.append(r)
    avro.write_container(part, schema, kept, block_records=BLOCK_RECORDS)
    manifest.write(path)


def _sync_offsets(path) -> list:
    """Where the node table's sync markers start (one after each block)."""
    raw = open(_part(path), "rb").read()
    sync = raw[-avro.SYNC_SIZE :]
    return [i for i in range(len(raw) - avro.SYNC_SIZE + 1) if raw.startswith(sync, i)]


def _flip_on_disk(path, kind) -> None:
    """The third block's sync marker flipped on disk, the manifest left as it was."""
    part = _part(path)
    raw = bytearray(open(part, "rb").read())
    raw[_sync_offsets(path)[2]] ^= 0x5A
    open(part, "wb").write(bytes(raw))


# damage -> (the read faults armed in each package, from the copy's path; an edit of the copy)
DAMAGE = {
    "corrupt_sync_marker": (lambda path: dict(corrupt_avro=str(_sync_offsets(path)[3])), None),
    "corrupt_block_count": (lambda path: dict(corrupt_avro=str(_sync_offsets(path)[1] + avro.SYNC_SIZE)), None),
    "truncate_data": (lambda path: dict(truncate_data=True), None),
    "truncate_data_to_bytes": (lambda path: dict(truncate_data="20000"), None),
    "edited_trees": (lambda path: {}, _edit_trees),
    "flipped_on_disk": (lambda path: {}, _flip_on_disk),
}


def _load_both(path, armed):
    with faults.inject(**armed):
        port = load_model(path, device="cpu", on_corrupt="drop")
    with jfaults.inject(**armed):
        ref = jpersistence.load_model(path, on_corrupt="drop")
    return port, ref


@pytest.mark.parametrize("damage", sorted(DAMAGE))
@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_drop_gives_the_jax_packages_report_and_forest(kind, damage, tmp_path, mammography):
    X = np.ascontiguousarray(mammography[0][:2048])
    path = _copy(kind, tmp_path)
    arm, edit = DAMAGE[damage]
    armed = arm(path)
    if edit is not None:
        edit(path, kind)
    port, ref = _load_both(path, armed)
    assert port.load_report.as_dict() == ref.load_report.as_dict()
    assert port.load_report.dropped_tree_ids and port.load_report.issues
    assert port.forest.num_trees == port.load_report.kept_trees < 100
    for a, b in zip(port.forest, ref.forest):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = port.score(X, strategy=GATHER_TWIN[kind]).numpy()
    assert np.abs(got - np.asarray(ref.score(X, strategy="gather"))).max() <= 2e-6
    # the survivors' own forest: the scores of the intact model differ
    intact = load_model(str(FIXTURES[kind]), device="cpu")
    assert np.abs(intact.score(X, strategy=GATHER_TWIN[kind]).numpy() - got).max() > 1e-4
    assert degradation_report().count("dropped_trees") == 1
    assert [e.reason for e in port.degradations()] == ["dropped_trees"]
    assert telemetry.get_events(kind="degradation")[0].fields["reason"] == "dropped_trees"
    assert port.baseline is not None and port.baseline == load_model(path, device="cpu", on_corrupt="drop",
                                                                     verify=False).baseline


@pytest.mark.parametrize("damage", sorted(DAMAGE))
def test_raise_still_refuses_the_damaged_copy(damage, tmp_path):
    path = _copy("standard", tmp_path)
    arm, edit = DAMAGE[damage]
    armed = arm(path)
    if edit is not None:
        edit(path, "standard")
    with faults.inject(**armed):
        with pytest.raises(ValueError):
            load_model(path, device="cpu")
    assert degradation_report().count("dropped_trees") == 0


@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_total_loss_is_loud_even_when_dropping(kind, tmp_path):
    """The committed fixtures hold one block: a torn read loses every tree,
    and no tree is no model."""
    path = str(tmp_path / "m")
    shutil.copytree(FIXTURES[kind], path)
    for inject, load in ((faults.inject, lambda: load_model(path, device="cpu", on_corrupt="drop")),
                         (jfaults.inject, lambda: jpersistence.load_model(path, on_corrupt="drop"))):
        with inject(truncate_data=True):
            with pytest.raises(ValueError, match="no usable tree data"):
                load()


@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_drop_of_an_intact_copy_is_lossless(kind, tmp_path, mammography):
    X = mammography[0][:2000]
    path = _copy(kind, tmp_path)
    back = load_model(path, device="cpu", on_corrupt="drop")
    assert back.load_report.as_dict() == jpersistence.load_model(path, on_corrupt="drop").load_report.as_dict()
    assert back.load_report.dropped_tree_ids == () and back.load_report.issues == ()
    assert torch.equal(back.score(X), load_model(path, device="cpu").score(X))
    assert load_model(path, device="cpu").load_report is None
    assert degradation_report().count("dropped_trees") == 0


def test_on_corrupt_takes_raise_or_drop(tmp_path):
    with pytest.raises(ValueError, match="on_corrupt"):
        load_model(str(FIXTURES["standard"]), device="cpu", on_corrupt="skip")


def test_a_damaged_metadata_file_is_never_dropped(tmp_path):
    path = _copy("standard", tmp_path)
    with open(os.path.join(path, "metadata", "part-00000"), "a") as fh:
        fh.write(" ")
    with pytest.raises(ValueError, match="metadata/part-00000"):
        load_model(path, device="cpu", on_corrupt="drop")
