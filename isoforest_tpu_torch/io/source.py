"""Sharded on-disk sources, the input side of the out-of-core data plane
(``isoforest_tpu/io/source.py``, copied: it is numpy only).

A :class:`ShardedSource` is an ordered list of shard files (CSV, NPY, Avro,
Parquet), named by a directory, a glob or one file, and read through a
bounded-memory chunk iterator. Shards go in sorted file-name order and
global row indices run on across them, so two passes over one source give
the same ``(global_row, features)`` pairs: the streamed sampler
(:class:`~..ops.bagging.StreamedBagger`) and the resumable scoring sink
(:func:`~.outofcore.score_source`) build on that.

Memory: :meth:`ShardedSource.iter_chunks` holds one decoded chunk
(``chunk_rows`` rows) and, for Avro, one shard's container bytes; nothing is
concatenated across shards.

Formats:

* ``.csv``: text rows, parsed as ``np.loadtxt`` does (``delimiter=","``,
  ``#`` comments, blank lines skipped);
* ``.npy``: 2-D float arrays, memory-mapped; the header gives the row count;
* ``.avro``: containers of :func:`write_avro_shard` (records
  ``{"features": [...]}``, with ``"label"`` when labeled); block counts give
  the row count without decoding;
* ``.parquet``: only where ``pyarrow`` imports; else
  :class:`SourceFormatError` names the dependency.

``labeled=True`` drops the last column (CSV/NPY) or the ``label`` field
(Avro/Parquet) from the features and returns it as ``y``.
"""

from __future__ import annotations

import glob as _glob
import io as _io
import os
from dataclasses import dataclass, field
from typing import Iterator, List, NamedTuple, Optional, Sequence

import numpy as np

from ..telemetry.metrics import counter as _telemetry_counter
from . import avro as _avro

_SOURCE_ROWS_TOTAL = _telemetry_counter(
    "isoforest_source_rows_total",
    "Rows streamed from sharded on-disk sources, by shard format",
    labelnames=("format",),
)

#: Shard file extensions and their format names.
SHARD_FORMATS = {
    ".csv": "csv",
    ".npy": "npy",
    ".avro": "avro",
    ".parquet": "parquet",
}

#: Rows a streamed chunk holds by default: enough to amortise a chunk's
#: fixed cost, few enough that a chunk of f32 features stays small.
DEFAULT_CHUNK_ROWS = 1 << 16


class SourceFormatError(ValueError):
    """A shard has an unknown or unavailable format."""


class SourceChunk(NamedTuple):
    """One decoded chunk of a sequential pass: ``global_start`` is the
    absolute row index of ``X[0]`` across the source (shard order, then row
    order), the coordinate the streamed sampler keys on; ``y`` is None for
    an unlabeled source."""

    X: np.ndarray
    y: Optional[np.ndarray]
    shard_index: int
    global_start: int


def _parquet_module():
    try:
        import pyarrow.parquet as pq
    except ImportError as exc:
        raise SourceFormatError(
            "parquet shards require pyarrow, which is not installed; "
            "convert the source to .npy/.csv/.avro shards or install pyarrow"
        ) from exc
    return pq


@dataclass
class Shard:
    """One shard file: path, format and size, with its row count counted
    on first use."""

    path: str
    format: str
    size_bytes: int
    _rows: Optional[int] = field(default=None, repr=False)

    @property
    def name(self) -> str:
        return os.path.basename(self.path)

    def count_rows(self) -> int:
        """The row count, as cheaply as the format allows (npy header, avro
        block counts, parquet metadata; a CSV is read once), cached."""
        if self._rows is None:
            self._rows = _count_rows(self)
        return self._rows


def _count_rows(shard: Shard) -> int:
    if shard.format == "npy":
        shape = np.load(shard.path, mmap_mode="r").shape  # the header only: nothing is paged in
        return int(shape[0]) if shape else 0
    if shard.format == "csv":
        rows = 0
        with open(shard.path, "r") as fh:
            for line in fh:
                line = line.strip()
                if line and not line.startswith("#"):
                    rows += 1
        return rows
    if shard.format == "avro":
        _, blocks = _avro.read_blocks(shard.path)
        return int(sum(count for count, _ in blocks))
    if shard.format == "parquet":
        return int(_parquet_module().ParquetFile(shard.path).metadata.num_rows)
    raise SourceFormatError(f"unknown shard format {shard.format!r}")


def _rows_from_records(records: Sequence[dict], labeled: bool):
    X = np.asarray([r["features"] for r in records], dtype=np.float32)
    if X.ndim != 2:
        X = X.reshape(len(records), -1)
    if labeled:
        return X, np.asarray([float(r.get("label", 0.0)) for r in records], dtype=np.float32)
    return X, None


def _split_label(data: np.ndarray, labeled: bool):
    data = np.asarray(data, dtype=np.float32)
    if data.ndim != 2:
        data = data.reshape(data.shape[0], -1) if data.size else data.reshape(0, 1)
    if labeled:
        if data.shape[1] < 2:
            raise ValueError(f"labeled source needs >= 2 columns (features + label), got {data.shape[1]}")
        return np.ascontiguousarray(data[:, :-1]), np.ascontiguousarray(data[:, -1])
    return data, None


def _iter_shard_csv(shard: Shard, labeled: bool, chunk_rows: int):
    buf: list = []
    with open(shard.path, "r") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            buf.append(line)
            if len(buf) >= chunk_rows:
                data = np.loadtxt(_io.StringIO("\n".join(buf)), delimiter=",", ndmin=2)
                buf.clear()
                yield _split_label(data, labeled)
        if buf:
            yield _split_label(np.loadtxt(_io.StringIO("\n".join(buf)), delimiter=",", ndmin=2), labeled)


def _iter_shard_npy(shard: Shard, labeled: bool, chunk_rows: int):
    mm = np.load(shard.path, mmap_mode="r")
    if mm.ndim != 2:
        raise SourceFormatError(f"npy shard {shard.name} must be 2-D, got shape {mm.shape}")
    for start in range(0, mm.shape[0], chunk_rows):
        yield _split_label(np.array(mm[start : start + chunk_rows]), labeled)


def _iter_shard_avro(shard: Shard, labeled: bool, chunk_rows: int):
    schema, blocks = _avro.read_blocks(shard.path)
    reader_schema = _avro._normalise(schema)
    buf: list = []
    for count, payload in blocks:
        reader = _avro._Reader(payload)
        for _ in range(count):
            buf.append(_avro.decode_value(reader_schema, reader))
            if len(buf) >= chunk_rows:
                yield _rows_from_records(buf, labeled)
                buf = []
    if buf:
        yield _rows_from_records(buf, labeled)


def _iter_shard_parquet(shard: Shard, labeled: bool, chunk_rows: int):
    pf = _parquet_module().ParquetFile(shard.path)
    for batch in pf.iter_batches(batch_size=chunk_rows):
        cols = batch.schema.names
        if "features" in cols:
            X = np.asarray(batch.column("features").to_pylist(), dtype=np.float32)
            y = np.asarray(batch.column("label").to_pylist(), dtype=np.float32) if labeled else None
            yield X, y
        else:
            yield _split_label(np.column_stack([np.asarray(batch.column(c), dtype=np.float32) for c in cols]),
                               labeled)


_SHARD_ITERATORS = {
    "csv": _iter_shard_csv,
    "npy": _iter_shard_npy,
    "avro": _iter_shard_avro,
    "parquet": _iter_shard_parquet,
}


class ShardedSource:
    """An ordered set of on-disk shards that can be read many times; every
    pass (:meth:`iter_chunks`) gives the same rows in the same order."""

    def __init__(self, shards: Sequence[Shard], labeled: bool = False):
        if not shards:
            raise ValueError("source matched no shard files")
        self.shards: List[Shard] = list(shards)
        self.labeled = bool(labeled)
        self._num_features: Optional[int] = None

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    def shard_rows(self) -> List[int]:
        """Row counts by shard (cached; a CSV shard is read once)."""
        return [s.count_rows() for s in self.shards]

    def total_rows(self) -> int:
        return sum(self.shard_rows())

    def num_features(self) -> int:
        """The feature width, from the first chunk of the first shard (cached)."""
        if self._num_features is None:
            for chunk in self.iter_chunks(chunk_rows=1):
                self._num_features = int(chunk.X.shape[1])
                break
            else:
                raise ValueError("source has no rows")
        return self._num_features

    def fingerprint(self) -> dict:
        """The source's identity for a resume: shard names, formats and
        sizes, and the labeled flag. Neither ``chunk_rows`` (chunking does
        not change a result) nor absolute paths (a moved source stays
        resumable) take part."""
        return {
            "shards": [{"name": s.name, "format": s.format, "sizeBytes": s.size_bytes} for s in self.shards],
            "labeled": self.labeled,
        }

    def iter_chunks(self, chunk_rows: Optional[int] = None, start_shard: int = 0,
                    stop_shard: Optional[int] = None) -> Iterator[SourceChunk]:
        """One sequential pass in chunks of at most ``chunk_rows`` rows
        (default :data:`DEFAULT_CHUNK_ROWS`), with absolute ``global_start``.
        ``start_shard``/``stop_shard`` read a range of shards and keep the
        global coordinates: the shards before it are counted, not decoded.
        A shard whose row count differs from an earlier count raises."""
        chunk_rows = int(chunk_rows or DEFAULT_CHUNK_ROWS)
        if chunk_rows <= 0:
            raise ValueError(f"chunk_rows must be > 0, got {chunk_rows}")
        stop = self.num_shards if stop_shard is None else min(stop_shard, self.num_shards)
        global_row = sum(s.count_rows() for s in self.shards[:start_shard])
        for index in range(start_shard, stop):
            shard = self.shards[index]
            shard_rows = 0
            for X, y in _SHARD_ITERATORS[shard.format](shard, self.labeled, chunk_rows):
                if X.shape[0] == 0:
                    continue
                if self._num_features is None:
                    self._num_features = int(X.shape[1])
                _SOURCE_ROWS_TOTAL.inc(X.shape[0], format=shard.format)
                yield SourceChunk(X, y, index, global_row)
                global_row += X.shape[0]
                shard_rows += X.shape[0]
            if shard._rows is None:
                shard._rows = shard_rows
            elif shard._rows != shard_rows:
                raise ValueError(
                    f"shard {shard.name} row count changed mid-run "
                    f"({shard._rows} -> {shard_rows}); source must be immutable"
                )

    def read_all(self, chunk_rows: Optional[int] = None):
        """The whole source as ``(X, y)``, read chunk by chunk (one chunk
        above the final matrix at the peak)."""
        xs, ys = [], []
        for chunk in self.iter_chunks(chunk_rows=chunk_rows):
            xs.append(chunk.X)
            if chunk.y is not None:
                ys.append(chunk.y)
        if not xs:
            raise ValueError("source has no rows")
        X = np.concatenate(xs, axis=0) if len(xs) > 1 else xs[0]
        y = (np.concatenate(ys, axis=0) if len(ys) > 1 else ys[0]) if ys else None
        return X, y


def _shard_from_path(path: str) -> Shard:
    ext = os.path.splitext(path)[1].lower()
    fmt = SHARD_FORMATS.get(ext)
    if fmt is None:
        raise SourceFormatError(
            f"unrecognised shard extension {ext!r} for {path!r} (expected one of {sorted(SHARD_FORMATS)})"
        )
    return Shard(path=path, format=fmt, size_bytes=os.path.getsize(path))


def open_source(spec, labeled: bool = False, formats: Optional[Sequence[str]] = None) -> ShardedSource:
    """Open ``spec`` as a sharded source: a directory (its shard files,
    sorted by name; ``formats`` keeps only those formats), a glob
    (``shards/part-*.npy``) or one file (one of another extension is read
    as CSV). A :class:`ShardedSource` is returned as it is."""
    if isinstance(spec, ShardedSource):
        return spec
    if os.path.isdir(spec):
        wanted = set(formats) if formats else set(SHARD_FORMATS.values())
        paths = sorted(
            os.path.join(spec, name)
            for name in os.listdir(spec)
            if os.path.isfile(os.path.join(spec, name))
            and SHARD_FORMATS.get(os.path.splitext(name)[1].lower()) in wanted
        )
        if not paths:
            raise FileNotFoundError(f"directory {spec!r} contains no shard files ({sorted(SHARD_FORMATS)})")
    elif os.path.isfile(spec):
        if os.path.splitext(spec)[1].lower() not in SHARD_FORMATS:
            return ShardedSource([Shard(path=spec, format="csv", size_bytes=os.path.getsize(spec))],
                                 labeled=labeled)
        paths = [spec]
    else:
        paths = sorted(_glob.glob(spec))
        if not paths:
            raise FileNotFoundError(f"source {spec!r} matched no files")
    return ShardedSource([_shard_from_path(p) for p in paths], labeled=labeled)


def _with_label(X: np.ndarray, y: Optional[np.ndarray]) -> np.ndarray:
    X = np.asarray(X, dtype=np.float32)
    return X if y is None else np.column_stack([X, np.asarray(y, dtype=np.float32)])


def write_csv_shard(path: str, X: np.ndarray, y: Optional[np.ndarray] = None) -> None:
    np.savetxt(path, _with_label(X, y), delimiter=",", fmt="%.9g")


def write_npy_shard(path: str, X: np.ndarray, y: Optional[np.ndarray] = None) -> None:
    np.save(path, _with_label(X, y))


def write_avro_shard(path: str, X: np.ndarray, y: Optional[np.ndarray] = None) -> None:
    """An Avro container of ``{"features": [...]}`` records, with
    ``"label"`` when ``y`` is given."""
    X = np.asarray(X, dtype=np.float32)
    fields = [{"name": "features", "type": {"type": "array", "items": "float"}}]
    if y is not None:
        fields.append({"name": "label", "type": "float"})
        records = [{"features": row.tolist(), "label": float(lab)}
                   for row, lab in zip(X, np.asarray(y, dtype=np.float32))]
    else:
        records = [{"features": row.tolist()} for row in X]
    _avro.write_container(path, {"type": "record", "name": "Row", "fields": fields}, records)
