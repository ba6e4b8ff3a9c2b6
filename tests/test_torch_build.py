"""The port's kernel build (``ops/_build.py``) without ``nvcc``: a built
library's name covers its source and the nvcc flags, so a change of either
builds anew instead of loading a stale library."""

from __future__ import annotations

import pytest

from isoforest_tpu_torch.ops import _build


def test_every_kernel_source_is_listed_and_present():
    assert set(_build.SOURCES) == {"dense", "path_walk", "ext_gemm"}
    for source in _build.SOURCES.values():
        assert (_build.CSRC_DIR / source).is_file()


def test_flags_change_the_library_path(monkeypatch):
    base = _build.library_path("ext_gemm")
    assert base == _build.library_path("ext_gemm")
    assert base.parent == _build.BUILD_DIR and base.name.startswith("libext_gemm-")
    seen = {base}
    for extra in (("--fmad=false",), ("-lineinfo",)):
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + extra)
        assert _build.library_path("ext_gemm") not in seen
        seen.add(_build.library_path("ext_gemm"))


def test_source_changes_the_library_path(monkeypatch, tmp_path):
    for name in ("dense.cu", "path_walk.cu"):
        (tmp_path / name).write_text("// a kernel\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = _build.library_path("path_walk")
    (tmp_path / "path_walk.cu").write_text("// an edited kernel\n")
    assert _build.library_path("path_walk") != before
    assert _build.library_path("dense").name != before.name


def _fake_toolkit(tmp_path, monkeypatch, script: str):
    """A CUDA_HOME whose bin/nvcc is ``script`` (Python), and a scratch
    build directory."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/usr/bin/env python3\nimport pathlib, sys, time\nargs = sys.argv[1:]\n" + script)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")


def test_build_starts_every_nvcc_together_and_times_each(tmp_path, monkeypatch):
    """path_walk's nvcc sleeps longer than dense's; each reports its own
    time, and the libraries land under their hashed names."""
    _fake_toolkit(tmp_path, monkeypatch, (
        "src = args[-1]\n"
        "time.sleep(0.6 if src.endswith('path_walk.cu') else 0.05)\n"
        "pathlib.Path(args[args.index('-o') + 1]).write_text('lib')\n"
        "print('ptxas info    : Used 32 registers')\n"
    ))
    report = _build.build(["path_walk", "dense"], ptxas_verbose=True)
    assert set(report) == {"path_walk", "dense"}
    assert report["dense"]["seconds"] < 0.5 <= report["path_walk"]["seconds"]
    assert "Used 32 registers" in report["dense"]["log"]
    assert _build.library_path("dense").read_text() == "lib"
    assert _build.build(["dense"]) == {}  # built already


def test_failed_nvcc_raises_with_its_log(tmp_path, monkeypatch):
    _fake_toolkit(tmp_path, monkeypatch, "print('error: no such intrinsic'); sys.exit(2)\n")
    with pytest.raises(RuntimeError, match="nvcc failed for ext_gemm.cu .exit 2.:\nerror: no such intrinsic"):
        _build.build(["ext_gemm"])
    assert not _build.library_path("ext_gemm").exists()


def test_the_build_directory_comes_from_the_environment(tmp_path, monkeypatch):
    import importlib

    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path / "kernels"))
    try:
        importlib.reload(_build)
        assert _build.BUILD_DIR == tmp_path / "kernels"
        assert _build.library_path("dense").parent == tmp_path / "kernels"
    finally:
        monkeypatch.delenv(_build.BUILD_DIR_ENV)
        importlib.reload(_build)
    assert _build.BUILD_DIR == _build.PACKAGE_DIR.parent / "build" / "isoforest_tpu_torch"


# two processes that find the same library missing, as two cold replicas
# of the tier do: each runs its own (fake) nvcc into a file of its own
_CONCURRENT_BUILD = (
    "import sys; sys.path.insert(0, sys.argv[1]); "
    "from isoforest_tpu_torch.ops import _build; "
    "print(sorted(_build.build(['path_walk'])))"
)


def test_two_processes_building_one_source_at_once(tmp_path):
    import os
    import pathlib
    import subprocess
    import sys

    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    # each nvcc waits (up to 60 s) until both have started, then writes
    nvcc.write_text("#!/usr/bin/env python3\nimport os, pathlib, sys, time\nargs = sys.argv[1:]\n"
                    f"gate = pathlib.Path({str(tmp_path / 'gate')!r})\n"
                    "gate.mkdir(exist_ok=True)\n(gate / str(os.getpid())).touch()\n"
                    "t0 = time.time()\n"
                    "while len(list(gate.iterdir())) < 2 and time.time() - t0 < 60:\n    time.sleep(0.01)\n"
                    "pathlib.Path(args[args.index('-o') + 1]).write_text('lib')\n")
    nvcc.chmod(0o755)
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"), ISOFOREST_TPU_TORCH_BUILD_DIR=str(tmp_path / "kernels"))
    root = str(pathlib.Path(__file__).resolve().parent.parent)
    procs = [subprocess.Popen([sys.executable, "-c", _CONCURRENT_BUILD, root], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err[-2000:] for _, err in outs]
    # both compiled at once (neither saw the other's library), one library stands
    assert [out.strip() for out, _ in outs] == ["['path_walk']", "['path_walk']"]
    built = sorted(p.name for p in (tmp_path / "kernels").iterdir())
    assert len(built) == 1 and built[0].startswith("libpath_walk-") and built[0].endswith(".so")
