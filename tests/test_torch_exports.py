"""The port's packages export the JAX package's names: for every subpackage
both have, each name of the JAX package's ``__all__`` is an attribute of
the port's subpackage, or stands on :data:`PINNED` with its reason. A
pinned name the port has gained fails too, so the list only shrinks.

Also held here: the ``ops`` dispatchers the exports needed
(``path_lengths``, ``path_lengths_dense``, ``extended_path_lengths_dense``)
against the JAX package's functions of those names, and the on-disk fault
mutators against the JAX package's.
"""

from __future__ import annotations

import importlib
import pathlib
import shutil

import numpy as np
import pytest
import torch

SUBPACKAGES = ("", ".telemetry", ".utils", ".ops", ".resilience", ".serving", ".lifecycle", ".tuning",
               ".parallel", ".models", ".io", ".autopilot", ".fleet", ".stream", ".replication", ".onnx")

_LAYOUT = ("the port builds its tables per strategy (ops/traversal.py scoring_tables), "
           "not the JAX package's packed layout")

# subpackage -> {JAX name: why the port has no attribute of that name}
PINNED = {
    ".ops": {n: _LAYOUT for n in ("PackedStandardLayout", "get_layout", "pack_forest")},
    ".tuning": {
        "JITTABLE_STRATEGIES": ("the JAX package's sharded pool is its shard_map-jittable pair (gather, dense); "
                                "the port's is the kernels walk and dense, tuning.SHARDED_STRATEGIES "
                                "(ROADMAP C, 'The sharded pool')"),
        "unkeyed": ("the port's resolve_decision keys a resolution without a forest itself (forest=None); "
                    "its key helper is private (ROADMAP C, 'The sharded pool')"),
    },
}


def _pair(sub: str):
    return importlib.import_module("isoforest_tpu" + sub), importlib.import_module("isoforest_tpu_torch" + sub)


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s.lstrip(".") or "top")
def test_every_jax_name_is_exported_or_pinned(sub):
    jax_pkg, port_pkg = _pair(sub)
    pinned = PINNED.get(sub, {})
    missing = [n for n in jax_pkg.__all__ if not hasattr(port_pkg, n) and n not in pinned]
    assert not missing, f"isoforest_tpu_torch{sub} lacks {missing}"


@pytest.mark.parametrize("sub", sorted(PINNED), ids=lambda s: s.lstrip("."))
def test_pins_name_only_what_is_missing(sub):
    jax_pkg, port_pkg = _pair(sub)
    for name, reason in PINNED[sub].items():
        assert name in jax_pkg.__all__, f"{name} is not a JAX name of {sub}"
        assert not hasattr(port_pkg, name), f"isoforest_tpu_torch{sub}.{name} exists now: unpin it"
        assert reason


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s.lstrip(".") or "top")
def test_the_ports_own_all_resolves(sub):
    _, port_pkg = _pair(sub)
    assert all(hasattr(port_pkg, n) for n in port_pkg.__all__)


def test_the_new_packages_are_in_the_import_check():
    root = pathlib.Path(__file__).resolve().parent.parent / "isoforest_tpu_torch"
    for name in ("autopilot", "fleet", "stream", "replication", "onnx"):
        assert sorted(p.name for p in (root / name).glob("*.py")), name


# -- the ops dispatchers against the JAX package's -----------------------------


@pytest.fixture(scope="module")
def forests(tmp_path_factory):
    """A standard and an extended (k = 3) forest fitted by the JAX package,
    each with the port's load of its saved directory, and the rows."""
    from isoforest_tpu import ExtendedIsolationForest as JaxEIF
    from isoforest_tpu import IsolationForest as JaxIF
    from isoforest_tpu_torch import load_model

    rng = np.random.default_rng(0)
    X = rng.normal(size=(1500, 6)).astype(np.float32)
    out = {}
    for kind, est in (("std", JaxIF(num_estimators=16, max_samples=128.0, random_seed=3)),
                      ("eif", JaxEIF(num_estimators=16, max_samples=128.0, random_seed=3, extension_level=3))):
        model = est.fit(X)
        path = str(tmp_path_factory.mktemp(kind) / "model")
        model.save(path)
        out[kind] = (model.forest, load_model(path, device="cpu").forest)
    return X, out


# The dispatchers run the port's gather walks and the dense kernels' plain
# versions; the JAX package's dense walk adds path lengths in another order
# (and its EIF dots are HIGHEST matmuls), so mean path lengths are held
# within 1e-5 (float32 over 16 trees of depth <= 13). On these seeded
# forests both agree exactly.
PATH_TOL = 1e-5


@pytest.mark.parametrize("kind", ["std", "eif"])
@pytest.mark.parametrize("name", ["path_lengths", "path_lengths_dense"])
def test_dispatchers_match_the_jax_package(forests, kind, name):
    import jax.numpy as jnp

    from isoforest_tpu import ops as jax_ops
    from isoforest_tpu_torch import ops

    X, pairs = forests
    jax_forest, port_forest = pairs[kind]
    want = np.asarray(getattr(jax_ops, name)(jax_forest, jnp.asarray(X)))
    got = getattr(ops, name)(port_forest, torch.from_numpy(X)).numpy()
    assert got.shape == want.shape == (len(X),)
    np.testing.assert_allclose(got, want, rtol=0, atol=PATH_TOL)


def test_extended_path_lengths_dense_matches_the_jax_package(forests):
    import jax.numpy as jnp

    from isoforest_tpu import ops as jax_ops
    from isoforest_tpu_torch import ops

    X, pairs = forests
    jax_forest, port_forest = pairs["eif"]
    want = np.asarray(jax_ops.extended_path_lengths_dense(jax_forest, jnp.asarray(X)))
    np.testing.assert_allclose(ops.extended_path_lengths_dense(port_forest, torch.from_numpy(X)).numpy(), want,
                               rtol=0, atol=PATH_TOL)


def test_dispatch_picks_the_forest_kind(forests):
    from isoforest_tpu_torch import ops

    X, pairs = forests
    x = torch.from_numpy(X[:64])
    for kind, single in (("std", ops.standard_path_lengths), ("eif", ops.extended_path_lengths)):
        forest = pairs[kind][1]
        assert torch.equal(ops.path_lengths(forest, x), single(forest, x))
    std = pairs["std"][1]
    assert torch.equal(ops.path_lengths_dense(std, x), ops.standard_path_lengths_dense(std, x))


# -- the on-disk mutators -------------------------------------------------------


@pytest.mark.parametrize("offset", [None, 0, 5, 10**9])
def test_corrupt_file_on_disk_flips_as_the_jax_package(tmp_path, offset):
    from isoforest_tpu.resilience import faults as jax_faults
    from isoforest_tpu_torch.resilience import faults

    data = bytes(range(256)) * 3
    ours, theirs = tmp_path / "a.bin", tmp_path / "b.bin"
    ours.write_bytes(data)
    shutil.copy(ours, theirs)
    assert faults.corrupt_file_on_disk(str(ours), offset) == jax_faults.corrupt_file_on_disk(str(theirs), offset)
    assert ours.read_bytes() == theirs.read_bytes() != data
    empty = tmp_path / "empty.bin"
    empty.write_bytes(b"")
    with pytest.raises(ValueError, match="empty"):
        faults.corrupt_file_on_disk(str(empty))


@pytest.mark.parametrize("keep", [None, 0, 7, 10**9])
def test_truncate_file_on_disk_keeps_as_the_jax_package(tmp_path, keep):
    from isoforest_tpu.resilience import faults as jax_faults
    from isoforest_tpu_torch.resilience import faults

    ours, theirs = tmp_path / "a.bin", tmp_path / "b.bin"
    ours.write_bytes(b"x" * 101)
    shutil.copy(ours, theirs)
    assert faults.truncate_file_on_disk(str(ours), keep) == jax_faults.truncate_file_on_disk(str(theirs), keep)
    assert ours.read_bytes() == theirs.read_bytes()


def test_a_corrupted_model_file_fails_its_manifest(tmp_path):
    """What the mutator is for: a flipped data byte on disk is refused at
    load by the manifest."""
    from isoforest_tpu_torch import load_model
    from isoforest_tpu_torch.resilience import faults

    src = pathlib.Path(__file__).parent / "resources" / "torch_port" / "mammography_std" / "model"
    model_dir = tmp_path / "model"
    shutil.copytree(src, model_dir)
    part = sorted((model_dir / "data").glob("*.avro"))[0]
    faults.corrupt_file_on_disk(str(part))
    with pytest.raises(Exception, match="(?i)manifest|crc|checksum|corrupt"):
        load_model(str(model_dir), device="cpu")
