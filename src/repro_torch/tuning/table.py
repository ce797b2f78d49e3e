"""Versioned tuning tables: the autotuner's measured winners.

A :class:`TuningTable` maps ``EngineSpec.tuning_key()`` (the canonical
identity less the tunable knobs) to a :class:`TableEntry` holding the
measured-best knob values. Tables are plain versioned JSON, the
reference package's schema: ``tables/default.json`` ships with the package
and is consulted by ``EngineSpec.normalize()`` whenever a tunable knob is
left unset.

Environment:

* ``SQUEEZE_TUNING=off|0|false|no`` turns consults off: every lookup
  counts an ``engine.tune.fallback`` and the static heuristics apply (tests
  that pin a heuristic k set it);
* ``SQUEEZE_TUNING_TABLE=/path/to/table.json`` takes that table in place
  of the shipped one (a path that is missing or broken falls back to the
  heuristics with a one-time warning, never an exception).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

from repro_torch import obs
from repro_torch.tuning.spec import EngineSpec

log = logging.getLogger("repro_torch.tuning")

#: bump when the on-disk schema changes; loaders refuse other versions
TABLE_VERSION = 1

#: the table shipped with the package
DEFAULT_TABLE_PATH = os.path.join(
    os.path.dirname(__file__), "tables", "default.json")

_OFF_VALUES = frozenset({"0", "off", "false", "no"})


def tuning_enabled() -> bool:
    """False when ``SQUEEZE_TUNING`` turns table consults off."""
    return os.environ.get(
        "SQUEEZE_TUNING", "on").strip().lower() not in _OFF_VALUES


@dataclasses.dataclass(frozen=True)
class TableEntry:
    """Measured-best knob values for one configuration. ``None`` /
    ``'auto'`` fields have no opinion: the heuristic resolves them.
    ``meta`` holds the measurement's provenance (time, baseline, speedup)
    and is ignored by lookups."""

    fusion_k: Optional[int] = None
    macro_p: Optional[int] = None
    exchange: str = "auto"
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        d = {"fusion_k": self.fusion_k, "macro_p": self.macro_p,
             "exchange": self.exchange}
        if self.meta:
            d["meta"] = self.meta
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "TableEntry":
        return cls(fusion_k=d.get("fusion_k"), macro_p=d.get("macro_p"),
                   exchange=d.get("exchange", "auto"),
                   meta=dict(d.get("meta", {})))


class TuningTable:
    """A tuning table in memory, with JSON load/save and diff."""

    def __init__(self, entries: Optional[Dict[str, TableEntry]] = None,
                 meta: Optional[Dict[str, Any]] = None) -> None:
        self.entries: Dict[str, TableEntry] = dict(entries or {})
        self.meta: Dict[str, Any] = dict(meta or {})

    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self) -> Iterator[Tuple[str, TableEntry]]:
        return iter(sorted(self.entries.items()))

    def get(self, spec: EngineSpec) -> Optional[TableEntry]:
        return self.entries.get(spec.tuning_key())

    def put(self, spec: EngineSpec, entry: TableEntry) -> None:
        self.entries[spec.tuning_key()] = entry

    def to_json(self) -> Dict[str, Any]:
        return {"version": TABLE_VERSION, "meta": self.meta,
                "entries": {k: e.to_json()
                            for k, e in sorted(self.entries.items())}}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "TuningTable":
        version = d.get("version")
        if version != TABLE_VERSION:
            raise ValueError(f"tuning table version {version!r} unsupported "
                             f"(want {TABLE_VERSION})")
        return cls(entries={k: TableEntry.from_json(e)
                            for k, e in d.get("entries", {}).items()},
                   meta=dict(d.get("meta", {})))

    def save(self, path: str) -> None:
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(self.to_json(), fh, indent=2, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "TuningTable":
        with open(path, "r", encoding="utf-8") as fh:
            return cls.from_json(json.load(fh))

    def diff(self, other: "TuningTable") -> Dict[str, Any]:
        """Key-level diff against ``other`` (self the new table, other the
        old): added and removed keys, and the changed knob values."""
        mine, theirs = self.entries, other.entries
        changed = {}
        for key in sorted(set(mine) & set(theirs)):
            a, b = theirs[key], mine[key]
            if (a.fusion_k, a.macro_p, a.exchange) != (
                    b.fusion_k, b.macro_p, b.exchange):
                old, new = a.to_json(), b.to_json()
                old.pop("meta", None)
                new.pop("meta", None)
                changed[key] = {"old": old, "new": new}
        return {"added": sorted(set(mine) - set(theirs)),
                "removed": sorted(set(theirs) - set(mine)),
                "changed": changed}


# --------------------------------------------------- the active table cache
_cache_lock = threading.Lock()
_cache: Dict[str, Optional[TuningTable]] = {}
_warned: set = set()


def _active_table_path() -> str:
    return os.environ.get("SQUEEZE_TUNING_TABLE", DEFAULT_TABLE_PATH)


def default_table() -> Optional[TuningTable]:
    """The active table (the shipped one unless ``SQUEEZE_TUNING_TABLE``
    names another), cached by path; ``None`` when the file is missing or
    broken, and consults then fall back to the heuristics."""
    path = _active_table_path()
    with _cache_lock:
        if path in _cache:
            return _cache[path]
    try:
        table: Optional[TuningTable] = TuningTable.load(path)
    except FileNotFoundError:
        table = None
        if path != DEFAULT_TABLE_PATH and path not in _warned:
            _warned.add(path)
            log.warning("tuning table %s not found; falling back to "
                        "static heuristics", path)
    except (ValueError, OSError) as exc:  # JSONDecodeError is a ValueError
        table = None
        if path not in _warned:
            _warned.add(path)
            log.warning("failed to load tuning table %s (%s); falling "
                        "back to static heuristics", path, exc)
    with _cache_lock:
        _cache[path] = table
    return table


def reset_default_table_cache() -> None:
    """Forget the cached tables (after a ``save`` to the active path, or
    between tests)."""
    with _cache_lock:
        _cache.clear()
        _warned.clear()


def consult(spec: EngineSpec,
            table: Optional[TuningTable] = None) -> Optional[TableEntry]:
    """One table lookup for ``EngineSpec.normalize()``; ``table=None`` is
    the active table. Counts exactly one ``engine.tune.{hit,miss,fallback}``:
    *hit* an entry found, *miss* a table consulted without one, *fallback*
    no table consulted (tuning off, or the table unavailable)."""
    if table is None:
        if not tuning_enabled():
            obs.inc("engine.tune.fallback", kind=spec.kind)
            return None
        table = default_table()
        if table is None:
            obs.inc("engine.tune.fallback", kind=spec.kind)
            return None
    entry = table.get(spec)
    obs.inc("engine.tune.miss" if entry is None else "engine.tune.hit",
            kind=spec.kind)
    return entry
