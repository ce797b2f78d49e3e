"""``EngineSpec`` -- the canonical engine-configuration identity of the port.

One frozen, hashable dataclass names a configuration:
``make_engine(spec)`` builds an engine from it, and the ``BatchedRunner``
keys its engine cache on ``spec.normalize()``. ``canonical()`` validates
the kind, rewrites an alias (``KIND_ALIASES``) and zeroes the knobs that do
not apply to it; ``normalize()``
then resolves the tunable knobs left ``None`` by the rule

    explicit argument  >  static heuristic

(no tuning table: the port has no measurements to fill one yet). Two
configurations share an engine exactly when their normalized specs are
equal.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

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

FracId = Union[str, Tuple[Tuple[int, ...], ...]]


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
        return self.kind in BLOCK_KINDS

    @property
    def is_mxu(self) -> bool:
        return self.kind in MXU_KINDS

    @property
    def is_3d(self) -> bool:
        return self.kind in KINDS_3D

    @property
    def is_dist(self) -> bool:
        return self.kind in DIST_KINDS

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

    def normalize(self) -> "EngineSpec":
        """``canonical()`` with ``fusion_k`` and (single-device MXU kinds)
        ``macro_p`` resolved to concrete values, explicit > heuristic;
        idempotent. A dist-mxu engine packs each shard's blocks by its own
        count, so its ``macro_p`` stays as given, and ``exchange='auto'``
        is resolved by the engine from its decomposition."""
        spec = self.canonical()
        if not spec.is_block:
            return spec
        from repro_torch.core.stencil import default_fusion_k
        k = spec.fusion_k if spec.fusion_k is not None \
            else default_fusion_k(spec.rho)
        p = spec.macro_p
        if spec.is_mxu and not spec.is_dist:
            from repro_torch.core.compact import BlockLayout
            from repro_torch.core.compact3d import BlockLayout3D
            layout = (BlockLayout3D if spec.is_3d else BlockLayout)(
                self.build_frac(), spec.r, spec.m)
            p = layout.macro_tiles(k, p=p)[0]
        return dataclasses.replace(spec, fusion_k=k, macro_p=p)

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
