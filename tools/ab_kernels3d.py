"""Time the two 3D stencil kernels of several checkouts on one card, one
process per reading, in the order given, for A/B comparisons of kernel
8 (``stencil3d_step_fused_k``) and kernel 9 (``stencil3d_step_mxu_k``).

    python3 tools/ab_kernels3d.py CHECKOUT [CHECKOUT ...]

Each CHECKOUT is the root of a checkout of this repository (its port under
``src/repro_torch``; its kernels are built into its own ``build/``). Name a
checkout several times, alternating with the other, to see the spread
between processes. Each reading runs both kernels on Menger r=6 m=2 (rho=9,
160,000 blocks), LIFE3D and HEAT3D at the default depth (k=3), as rows 8
and 9 of ``chip_smoke.py`` do: one warm-up launch, then three rounds of 20
launches on CUDA events. It prints one JSON line per reading: the ms per
launch of each round and the sum of each result (the checkouts must agree).
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def measure(checkout: Path) -> dict:
    sys.path.insert(0, str(checkout / "src"))
    import torch
    from repro_torch.core import compact3d, fractals3d
    from repro_torch.core.stencil import default_fusion_k
    from repro_torch.kernels import squeeze_stencil3d as k3
    from repro_torch.workloads import rules

    lay = compact3d.BlockLayout3D(fractals3d.REGISTRY3D["menger"], 6, 2)
    k = default_fusion_k(lay.rho)
    mask = lay.device_table("micro_mask", "cuda")
    out = {"checkout": str(checkout), "k": k,
           "device": torch.cuda.get_device_name(0)}
    for wl in (rules.LIFE3D, rules.HEAT3D):
        g = torch.Generator(device="cuda")
        g.manual_seed(51)
        s = wl.init(g, (lay.n_blocks,) + (lay.rho,) * 3, "cuda")
        s = (s * mask.to(s.dtype)).contiguous()
        o = torch.empty_like(s)
        for name, fn in (("fused", k3.stencil3d_step_fused_k),
                         ("mxu", k3.stencil3d_step_mxu_k)):
            fn(lay, s, wl, k=k, out=o)
            torch.cuda.synchronize()
            out[f"{name}/{wl.name}/sum"] = float(o.double().sum())
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            rounds = []
            for _ in range(3):
                start.record()
                for _ in range(20):
                    fn(lay, s, wl, k=k, out=o)
                end.record()
                torch.cuda.synchronize()
                rounds.append(start.elapsed_time(end) / 20)
            out[f"{name}/{wl.name}"] = rounds
    return out


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(measure(Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for checkout in argv:
        rc |= subprocess.run([sys.executable, __file__, "--one",
                              checkout]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
