"""Named sets of configurations to tune.

``default`` is the sweep that produced the shipped table
(``tables/default.json``); ``ci`` is a bounded subset of it. They are the
reference package's sets, each kind its port kind (``REFERENCE_KINDS``:
'pallas-mxu' is 'cuda-mxu', and so on).

No identity here is one that a test pins to the heuristic k (those tests
also set ``SQUEEZE_TUNING=off``), so a stale table cannot hide a change of
the heuristic. Dist kinds are left out: their winners depend on the
shards of the host that tunes, so they are tuned on demand through the
CLI and not shipped.
"""
from __future__ import annotations

from typing import List

from repro_torch.tuning.spec import EngineSpec


def preset_specs(name: str) -> List[EngineSpec]:
    if name == "ci":
        return [
            EngineSpec("block", 2, "sierpinski", 6, 2, "life"),
            EngineSpec("block", 2, "sierpinski", 6, 2, "heat"),
            EngineSpec("cuda-mxu", 2, "sierpinski", 6, 2, "life"),
        ]
    if name == "default":
        return [
            EngineSpec("block", 2, "sierpinski", 6, 2, "life"),
            EngineSpec("block", 2, "sierpinski", 6, 2, "heat"),
            EngineSpec("block", 2, "sierpinski", 6, 2, "gray-scott"),
            EngineSpec("block", 3, "carpet", 4, 1, "life"),
            EngineSpec("block", 3, "vicsek", 4, 1, "life"),
            EngineSpec("cuda-strips", 2, "sierpinski", 6, 2, "life"),
            EngineSpec("cuda-fused", 2, "sierpinski", 6, 2, "life"),
            EngineSpec("cuda-mxu", 2, "sierpinski", 6, 2, "life"),
            EngineSpec("cuda-mxu", 2, "sierpinski", 6, 2, "heat"),
            EngineSpec("cuda-mxu", 3, "carpet", 4, 1, "life"),
        ]
    raise KeyError(f"unknown preset {name!r}; have: ci, default")
