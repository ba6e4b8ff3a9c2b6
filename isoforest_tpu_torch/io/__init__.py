"""Model files and forest arrays (:mod:`.persistence`, :mod:`.avro`,
:mod:`.interop`), and the out-of-core data plane: sharded sources
(:mod:`.source`) and resumable shard-by-shard scoring (:mod:`.outofcore`)."""

from . import avro, outofcore, persistence, source

__all__ = ["avro", "outofcore", "persistence", "source"]
