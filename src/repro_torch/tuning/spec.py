"""``EngineSpec`` -- the canonical engine-configuration identity of the port.

One frozen, hashable, JSON-serializable dataclass names a configuration:
``make_engine(spec)`` builds an engine from it, the ``BatchedRunner`` keys
its engine cache on ``spec.normalize()``, ``SimRequest.bucket`` batches
serving traffic by it, and the tuning table (``tuning/table.py``) keeps
autotuned winners under ``spec.tuning_key()``. ``canonical()`` validates
the kind, rewrites an alias (``KIND_ALIASES``) and zeroes the knobs that do
not apply to it; ``normalize()`` then resolves the tunable knobs left
``None`` (or ``'auto'``) by the rule

    explicit argument  >  tuning-table hit  >  static heuristic

counting one ``engine.tune.{hit,miss,fallback}`` a table consult. Two
configurations share an engine exactly when their normalized specs are
equal.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, Optional, Tuple, Union

#: port kind -> the reference kind it is held against (parity tests walk
#: this one list)
REFERENCE_KINDS: Dict[str, str] = {
    "bb": "bb", "lambda": "lambda", "cell": "cell", "block": "block",
    "cuda-blocks": "pallas-blocks", "cuda-strips": "pallas-strips",
    "cuda-fused": "pallas-fused", "cuda-mxu": "pallas-mxu",
    "dist-block": "dist-block", "dist-fused": "dist-fused",
    "dist-mxu": "dist-mxu",
    "bb3d": "bb3d", "cell3d": "cell3d", "block3d": "block3d",
    "cuda-3d": "pallas-3d", "cuda-3d-mxu": "pallas-3d-mxu",
}

#: every engine kind ``make_engine`` accepts, after alias rewriting
KINDS: Tuple[str, ...] = tuple(REFERENCE_KINDS)

#: kind aliases, rewritten by ``canonical()`` (as the reference rewrites
#: 'pallas' to 'pallas-strips'), so an alias and its kind share one engine
KIND_ALIASES: Dict[str, str] = {"cuda": "cuda-strips"}

#: kinds with block tiles (fusion depth applies)
BLOCK_KINDS = frozenset({"block", "cuda-blocks", "cuda-strips",
                         "cuda-fused", "cuda-mxu", "dist-block", "dist-fused",
                         "dist-mxu", "block3d", "cuda-3d", "cuda-3d-mxu"})

#: kinds whose kernel packs P blocks per CTA
MXU_KINDS = frozenset({"cuda-mxu", "dist-mxu", "cuda-3d-mxu"})

#: kinds of the distributed engine: the block axis sharded over devices
DIST_KINDS = frozenset({"dist-block", "dist-fused", "dist-mxu"})

#: halo-exchange modes of the dist kinds: neighbor-only p2p, strip gather,
#: or p2p where the strip decomposition is valid
EXCHANGES = ("auto", "p2p", "gather")

#: kinds of the 3D engines (an ``NBBFractal3D``, 3D workloads)
KINDS_3D = frozenset({"bb3d", "cell3d", "block3d", "cuda-3d",
                      "cuda-3d-mxu"})

#: sentinel of ``normalize(table=...)``: consult the active tuning table
ACTIVE_TABLE = object()

FracId = Union[str, Tuple[Tuple[int, ...], ...]]


def is_block_kind(kind: str) -> bool:
    return kind in BLOCK_KINDS


def is_dist_kind(kind: str) -> bool:
    return kind in DIST_KINDS


def _frac_identity(frac) -> Tuple[int, FracId]:
    """(s, name-or-mask): the registry name when the object is that
    registry entry (2D or 3D), else its slot positions."""
    from repro_torch.core.fractals import REGISTRY
    from repro_torch.core.fractals3d import REGISTRY3D
    positions = tuple(tuple(int(c) for c in p) for p in frac.positions)
    name = getattr(frac, "name", None)
    reg = REGISTRY.get(name) or REGISTRY3D.get(name)
    if reg is not None and reg.s == frac.s and reg.positions == positions:
        return int(frac.s), frac.name
    return int(frac.s), positions


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """``frac`` is a registry fractal name or a slot-position mask ((x, y)
    or (x, y, z) slots); ``s`` the fractal's scaling factor; ``workload``
    a registry workload name.
    ``fusion_k`` and ``macro_p`` are the tunable knobs (``None`` = the
    heuristic). The dist kinds also take ``exchange`` ('auto', 'p2p' or
    'gather') and ``mesh_shape``, ``(n_shards,)`` (``None`` = one shard
    per visible card)."""

    kind: str
    s: int
    frac: FracId
    r: int
    m: int = 0
    workload: str = "life"
    fusion_k: Optional[int] = None
    macro_p: Optional[int] = None
    exchange: str = "auto"
    mesh_shape: Optional[Tuple[int, ...]] = None

    @classmethod
    def from_args(cls, kind: str, frac, r: int, m: int = 0, workload=None,
                  fusion_k: Optional[int] = None,
                  macro_p: Optional[int] = None, exchange: str = "auto",
                  n_shards: Optional[int] = None) -> "EngineSpec":
        """The identity of a fractal object and workload object (or
        name) plus knobs."""
        s, ident = _frac_identity(frac)
        wl = workload if isinstance(workload, str) else (
            "life" if workload is None else workload.name)
        return cls(kind=kind, s=s, frac=ident, r=int(r), m=int(m),
                   workload=wl, fusion_k=fusion_k, macro_p=macro_p,
                   exchange=exchange,
                   mesh_shape=None if n_shards is None else (int(n_shards),))

    @property
    def is_block(self) -> bool:
        return is_block_kind(self.kind)

    @property
    def is_mxu(self) -> bool:
        return self.kind in MXU_KINDS

    @property
    def is_3d(self) -> bool:
        return self.kind in KINDS_3D

    @property
    def is_dist(self) -> bool:
        return is_dist_kind(self.kind)

    @property
    def n_shards(self) -> Optional[int]:
        """Shards of a dist kind (None = one per visible card)."""
        if self.mesh_shape is None:
            return None
        return math.prod(self.mesh_shape)

    @property
    def rho(self) -> int:
        """Block tile side s**m (1 for non-block kinds)."""
        return self.s ** self.m if self.is_block else 1

    def canonical(self) -> "EngineSpec":
        """Validated, with the alias rewritten ('cuda' -> 'cuda-strips')
        and the knobs that do not apply zeroed: non-block kinds get
        ``m = 0`` and ``fusion_k = 1``; ``macro_p`` only stays on the MXU
        kinds, ``exchange`` and ``mesh_shape`` on the dist kinds."""
        kind = KIND_ALIASES.get(self.kind, self.kind)
        if kind not in KINDS:
            raise ValueError(f"unknown engine kind {self.kind!r}; known: "
                             f"{sorted(KINDS + tuple(KIND_ALIASES))}")
        if kind != self.kind:
            return dataclasses.replace(self, kind=kind).canonical()
        if self.fusion_k is not None and self.fusion_k < 1:
            raise ValueError(f"fusion_k must be >= 1, got {self.fusion_k}")
        if self.macro_p is not None and self.macro_p < 1:
            raise ValueError(f"macro_p must be >= 1, got {self.macro_p}")
        if self.exchange not in EXCHANGES:
            raise ValueError(f"exchange must be one of {EXCHANGES}, got "
                             f"{self.exchange!r}")
        mesh = self.mesh_shape
        if mesh is not None:
            mesh = tuple(int(n) for n in mesh)
            if not mesh or min(mesh) < 1:
                raise ValueError(f"bad mesh_shape {self.mesh_shape!r}")
        block, dist = self.is_block, self.is_dist
        return dataclasses.replace(
            self, m=self.m if block else 0,
            fusion_k=self.fusion_k if block else 1,
            macro_p=self.macro_p if self.is_mxu else None,
            exchange=self.exchange if dist else "auto",
            mesh_shape=mesh if dist else None)

    def normalize(self, table: Any = ACTIVE_TABLE) -> "EngineSpec":
        """``canonical()`` with the tunable knobs resolved, explicit >
        tuning-table hit > heuristic: a table ``fusion_k`` clamped to [1,
        rho], a table ``macro_p`` on the MXU kinds, a table exchange of
        'p2p' or 'gather' on the dist kinds; then the heuristic k, and on
        the single-device MXU kinds the packing P at the resolved k.

        ``table``: the default consults the active table
        (``tuning/table.py``: the shipped ``tables/default.json`` unless
        ``SQUEEZE_TUNING_TABLE`` names another or ``SQUEEZE_TUNING=off``);
        pass a ``TuningTable``, or ``None`` for the heuristic alone (no
        consult, no counter). One ``engine.tune.{hit,miss,fallback}`` is
        counted a consult, and a spec whose knobs are all set passes
        through without one. A dist-mxu engine packs each shard's blocks by
        its own count, so its ``macro_p`` stays as given (or as the table
        gives it), and ``exchange='auto'`` is resolved by the engine from
        its decomposition."""
        spec = self.canonical()
        if not spec.is_block:
            return spec
        k, p, ex = spec.fusion_k, spec.macro_p, spec.exchange
        need_k = k is None
        need_p = p is None and spec.is_mxu
        need_ex = ex == "auto" and spec.is_dist
        if table is not None and (need_k or need_p or need_ex):
            from repro_torch.tuning.table import consult
            entry = consult(spec, None if table is ACTIVE_TABLE else table)
            if entry is not None:
                if need_k and entry.fusion_k is not None:
                    # the fused kernels cap k at rho (one block ring)
                    k = max(1, min(entry.fusion_k, spec.rho))
                if need_p and entry.macro_p is not None:
                    p = entry.macro_p
                if need_ex and entry.exchange in ("p2p", "gather"):
                    ex = entry.exchange
        if k is None:
            from repro_torch.core.stencil import default_fusion_k
            k = default_fusion_k(spec.rho)
        if spec.is_mxu and not spec.is_dist:
            from repro_torch.core.compact import BlockLayout
            from repro_torch.core.compact3d import BlockLayout3D
            layout = (BlockLayout3D if spec.is_3d else BlockLayout)(
                self.build_frac(), spec.r, spec.m)
            p = layout.macro_tiles(k, p=p)[0]
        return dataclasses.replace(spec, fusion_k=k, macro_p=p, exchange=ex)

    def tuning_key(self) -> str:
        """The key of this configuration in a tuning table: the canonical
        identity less the tunable knobs, as sorted, compact JSON (the
        shard count as ``mesh_shape``)."""
        c = self.canonical()
        ident = {
            "kind": c.kind, "s": c.s,
            "frac": c.frac if isinstance(c.frac, str)
            else [list(p) for p in c.frac],
            "r": c.r, "m": c.m, "workload": c.workload,
            "mesh_shape": (list(c.mesh_shape)
                           if c.mesh_shape is not None else None),
        }
        return json.dumps(ident, sort_keys=True, separators=(",", ":"))

    def to_json(self) -> Dict[str, Any]:
        """A plain-JSON dict; ``from_json`` gives this spec back exactly."""
        d = dataclasses.asdict(self)
        if not isinstance(self.frac, str):
            d["frac"] = [list(p) for p in self.frac]
        if self.mesh_shape is not None:
            d["mesh_shape"] = list(self.mesh_shape)
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "EngineSpec":
        frac = d["frac"]
        if not isinstance(frac, str):
            frac = tuple(tuple(int(c) for c in p) for p in frac)
        mesh = d.get("mesh_shape")
        return cls(
            kind=d["kind"], s=int(d["s"]), frac=frac, r=int(d["r"]),
            m=int(d.get("m", 0)), workload=d.get("workload", "life"),
            fusion_k=d.get("fusion_k"), macro_p=d.get("macro_p"),
            exchange=d.get("exchange", "auto"),
            mesh_shape=tuple(int(x) for x in mesh)
            if mesh is not None else None)

    def build_frac(self):
        """The fractal object this spec names."""
        from repro_torch.core.fractals import REGISTRY, NBBFractal
        from repro_torch.core.fractals3d import REGISTRY3D, NBBFractal3D
        if isinstance(self.frac, str):
            frac = REGISTRY.get(self.frac) or REGISTRY3D.get(self.frac)
            if frac is None:
                raise KeyError(f"unknown fractal name {self.frac!r} in "
                               "EngineSpec")
            if frac.s != self.s:
                raise ValueError(f"fractal {self.frac!r} has s={frac.s}, "
                                 f"spec says s={self.s}")
            return frac
        if len(self.frac[0]) == 3:
            return NBBFractal3D(f"nbb3d-s{self.s}-k{len(self.frac)}", self.s,
                                self.frac)
        return NBBFractal(f"nbb-s{self.s}-k{len(self.frac)}", self.s,
                          self.frac)

    def build_workload(self):
        """The registry workload this spec names (2D or 3D)."""
        from repro_torch.workloads.rules import get_workload
        return get_workload(self.workload)
