"""Checksummed model-directory manifest, ``_MANIFEST.json``
(``isoforest_tpu/resilience/manifest.py``).

An empty ``_SUCCESS`` marker proves a writer finished, not that the bytes
on disk are the bytes it wrote. Every save also writes a manifest with each
file's size, CRC32 and SHA-256 and a schema version, inside the temporary
directory before the atomic rename, so a directory either carries a
complete manifest or does not exist under its final name. Empty marker
files (``_SUCCESS``) carry no content and are left out. Loads verify a
present manifest before parsing any Avro, so a corrupt part file is
reported by name and digest. The format is the JAX package's: each package
verifies what the other wrote.
"""

from __future__ import annotations

import hashlib
import json
import os
import zlib
from typing import Dict, List

MANIFEST_NAME = "_MANIFEST.json"
MANIFEST_VERSION = 1

# files that exist only as presence markers — no content to verify
_MARKER_NAMES = frozenset({"_SUCCESS"})


def _digests(path: str) -> Dict[str, object]:
    sha = hashlib.sha256()
    crc = 0
    size = 0
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(1 << 20)
            if not chunk:
                break
            sha.update(chunk)
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return {
        "size": size,
        "crc32": f"{crc & 0xFFFFFFFF:08x}",
        "sha256": sha.hexdigest(),
    }


def build(root: str) -> dict:
    """Manifest dict for every content file under ``root`` (recursive),
    keyed by /-separated relative path."""
    files: Dict[str, Dict[str, object]] = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for name in sorted(filenames):
            if name == MANIFEST_NAME or name in _MARKER_NAMES:
                continue
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, root).replace(os.sep, "/")
            files[rel] = _digests(full)
    return {"manifestVersion": MANIFEST_VERSION, "files": files}


def write(root: str) -> str:
    """Build and write ``root/_MANIFEST.json``; returns its path."""
    path = os.path.join(root, MANIFEST_NAME)
    with open(path, "w") as fh:
        json.dump(build(root), fh, indent=1, sort_keys=True)
        fh.write("\n")
    return path


def present(root: str) -> bool:
    """Whether ``root`` carries a manifest."""
    return os.path.exists(os.path.join(root, MANIFEST_NAME))


def verify(root: str) -> List[str]:
    """Verify ``root`` against its manifest; returns a list of mismatch
    descriptions (empty = intact). Raises if the manifest itself is missing
    or unparseable — callers decide legacy tolerance via :func:`present`."""
    mpath = os.path.join(root, MANIFEST_NAME)
    try:
        with open(mpath) as fh:
            manifest = json.load(fh)
    except FileNotFoundError:
        raise
    except Exception as exc:
        return [f"{MANIFEST_NAME}: unparseable ({exc})"]
    issues: List[str] = []
    version = manifest.get("manifestVersion")
    if version != MANIFEST_VERSION:
        issues.append(
            f"{MANIFEST_NAME}: manifestVersion {version!r} != supported "
            f"{MANIFEST_VERSION} (written by an incompatible library version)"
        )
        return issues
    files = manifest.get("files")
    if not isinstance(files, dict):
        return [f"{MANIFEST_NAME}: malformed 'files' table"]
    for rel, want in sorted(files.items()):
        full = os.path.join(root, *rel.split("/"))
        if not os.path.isfile(full):
            issues.append(f"{rel}: listed in manifest but missing on disk")
            continue
        got = _digests(full)
        for field in ("size", "crc32", "sha256"):
            if got[field] != want.get(field):
                issues.append(
                    f"{rel}: {field} mismatch (manifest {want.get(field)!r}, "
                    f"on disk {got[field]!r})"
                )
                break
    # a part file the loader would consume but the writer never manifested
    # is itself an integrity violation (e.g. an injected extra .avro)
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for name in sorted(filenames):
            if name == MANIFEST_NAME or name in _MARKER_NAMES:
                continue
            rel = os.path.relpath(os.path.join(dirpath, name), root).replace(
                os.sep, "/"
            )
            if rel not in files:
                issues.append(f"{rel}: on disk but not in manifest")
    return issues
