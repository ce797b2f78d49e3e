#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port of Squeeze on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository (it imports ``src/repro_torch``, never
jax or the reference package). Phases, each printing one JSON line:

  1. device  -- the card's name and power limit (nvidia-smi), torch/CUDA;
  2. build   -- the kernels built from ``src/repro_torch/kernels/csrc`` by
                nvcc for sm_90a;
  3. kernels against their plain PyTorch versions on the card: v3, v4 (k in
     {2, rho}) and v5 (k in {1, 2}, two packings, B=3) on LIFE, HIGHLIFE,
     HEAT and GRAY_SCOTT over sierpinski (m=2), carpet and vicsek (m=1) at
     about 10^6 compact cells or more, <= 8 steps each; CA bit-exact,
     floats to rtol=1e-5 and atol=1e-5 * min(1, max|plain|), so a field
     that has decayed is still compared at its own scale;
  4. the main path at the paper's size (sierpinski r=16, 3^16 cells):
     ``BatchedRunner.run`` with cuda-mxu (LIFE, B=4, 64 steps) and (HEAT,
     B=2, 64 steps), ``make_engine('cuda-fused').run`` with LIFE and
     GRAY_SCOTT for 63 steps (the v3 remainder runs), each held against the
     plain ``block`` engine on the card, with the kernel launch counts;
  5. the paper's comparison: the expanded bounding-box engine on the
     65536^2 grid against cuda-mxu and cuda-fused for LIFE (the same
     states, checked equal), time per step, speedup, memory;
  6. a ``kernels`` line: each kernel's launches on the main path, largest
     error against its plain version, time, plain time and bound.

It ends with the card's name and power limit, the ``kernels`` line and
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device it exits 2 and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/squeeze_stencil.cu"
REPLACES = {
    "stencil_step_fused": "src/repro/kernels/squeeze_stencil.py:294",
    "stencil_step_fused_k": "src/repro/kernels/squeeze_stencil.py:451",
    "stencil_step_mxu_batched": "src/repro/kernels/squeeze_stencil.py:620",
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


class Checker:
    """Compares a result with its plain version and keeps the largest
    difference seen per kernel."""

    def __init__(self, torch):
        self.torch = torch
        self.max_err = {}

    def check(self, what, kernel, got, want, exact):
        t = self.torch
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{what}: {got.shape}/{got.dtype} vs "
                                 f"{want.shape}/{want.dtype}")
        diff = (got.double() - want.double()).abs()
        err = float(diff.max())
        if not bool(t.isfinite(got).all()):
            raise AssertionError(f"{what}: non-finite values")
        # atol shrinks with a decayed field (HEAT on sierpinski falls to
        # ~1e-10 in 64 steps), so zeros or a wrong rule cannot pass.
        scale = min(1.0, float(want.double().abs().max()))
        bound = 0.0 if exact else (FLOAT_TOL["atol"] * scale
                                   + FLOAT_TOL["rtol"] * want.double().abs())
        if bool((diff > bound).any()):
            raise AssertionError(f"{what}: max |kernel - plain| = {err}")
        if kernel:
            self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), err)
        return err


def cuda_ms(torch, fn, n: int) -> float:
    """Mean ms of ``fn()`` over n calls after one warm-up, CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_kernels_vs_plain(torch, chk, F, R, BlockLayout, sk):
    cases = [(F.SIERPINSKI, 13, 2), (F.CARPET, 7, 1), (F.VICSEK, 9, 1)]
    for frac, r, m in cases:
        lay = BlockLayout(frac, r, m)
        for wl in (R.LIFE, R.HIGHLIFE, R.HEAT, R.GRAY_SCOTT):
            t0 = time.perf_counter()
            exact = wl.dtype == torch.uint8
            g = torch.Generator(device="cuda")
            g.manual_seed(11)
            shape = (lay.n_blocks, lay.rho, lay.rho)
            x = torch.stack([wl.init(g, shape, "cuda") for _ in range(3)])
            mask = lay.device_table("micro_mask", "cuda")
            x = (x * mask.to(x.dtype)).contiguous()
            errs = {}

            def run(name, fn, plain, state, n):
                got, want = state, state
                for _ in range(n):
                    got, want = fn(got), plain(want)
                errs[name] = chk.check(f"{frac.name}/{wl.name}/{name}",
                                       fn.kernel, got, want, exact)

            def tag(fn, kernel):
                fn.kernel = kernel
                return fn
            run("v3", tag(lambda s: sk.stencil_step_fused(lay, s, wl),
                          "stencil_step_fused"),
                lambda s: sk.stencil_step_fused_plain(lay, s, wl), x[0], 8)
            for k in sorted({2, lay.rho}):
                run(f"v4_k{k}",
                    tag(lambda s, k=k: sk.stencil_step_fused_k(
                        lay, s, wl, k=k), "stencil_step_fused_k"),
                    lambda s, k=k: sk.stencil_step_fused_k_plain(
                        lay, s, wl, k=k), x[0], 8 // k)
            for k in (1, 2):
                for p in (None, 7):
                    run(f"v5_k{k}_p{lay.macro_tiles(k, p)[0]}",
                        tag(lambda s, k=k, p=p: sk.stencil_step_mxu_batched(
                            lay, s, wl, k=k, p=p),
                            "stencil_step_mxu_batched"),
                        lambda s, k=k: sk.stencil_step_mxu_batched_plain(
                            lay, s, wl, k=k), x, 8 // k)
            torch.cuda.synchronize()
            emit("kernel_vs_plain", fractal=frac.name, r=r, m=m,
                 compact_cells=frac.volume(r), workload=wl.name,
                 tolerance="exact" if exact else FLOAT_TOL, max_err=errs,
                 seconds=time.perf_counter() - t0)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core import fractals as F
    from repro_torch.core.compact import BlockLayout, shared_layout
    from repro_torch.core.stencil import default_fusion_k, make_engine
    from repro_torch.kernels import build
    from repro_torch.kernels import squeeze_stencil as sk
    from repro_torch.workloads import BatchedRunner
    from repro_torch.workloads import rules as R

    t_start = time.perf_counter()
    card = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(card, flush=True)
    emit("device", nvidia_smi=card, name=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         sources={n: {"path": v["path"], "nvcc_seconds": v["seconds"],
                      "ptxas": [ln.strip() for ln in v["log"].splitlines()
                                if "registers" in ln or "spill" in ln]}
                  for n, v in built.items()})

    # 3. kernels against plain ------------------------------------------
    chk = Checker(torch)
    phase_kernels_vs_plain(torch, chk, F, R, BlockLayout, sk)

    # 4. the main path at the paper's size --------------------------------
    frac, r, m = F.SIERPINSKI, 16, 2
    t0 = time.perf_counter()
    lay = shared_layout(frac, r, m)
    k = default_fusion_k(lay.rho)
    _ = lay.neighbor_table, lay.window_mask(k), lay.window_mask(1)
    emit("layout", fractal=frac.name, r=r, m=m, n_blocks=lay.n_blocks,
         compact_cells=frac.volume(r), host_seconds=time.perf_counter() - t0)
    runner = BatchedRunner()
    life_states = runner.init_batch("cuda-mxu", frac, r, [0, 1, 2, 3], m=m,
                                    workload=R.LIFE)
    heat_states = runner.init_batch("cuda-mxu", frac, r, [4, 5], m=m,
                                    workload=R.HEAT)
    fused = {wl.name: make_engine("cuda-fused", frac, r, m, workload=wl)
             for wl in (R.LIFE, R.GRAY_SCOTT)}
    fused_init = {n: e.init_random(6) for n, e in fused.items()}
    # upload the tables now, so the timed runs below cover stepping only
    lay.device_table("neighbor_table", "cuda")
    for kk in (1, k):
        lay.device_table("window_mask", "cuda", kk)
    torch.cuda.synchronize()

    sk.reset_launches()
    runs = []

    def drive(label, fn, steps, batch):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        runs.append(dict(run=label, steps=steps, batch=batch, seconds=sec,
                         ms_per_step=1e3 * sec / steps,
                         cells_per_s=batch * frac.volume(r) * steps / sec))
        return out
    out_mxu_life = drive("runner cuda-mxu life", lambda: runner.run(
        "cuda-mxu", frac, r, life_states, 64, m=m, workload=R.LIFE), 64, 4)
    out_mxu_heat = drive("runner cuda-mxu heat", lambda: runner.run(
        "cuda-mxu", frac, r, heat_states, 64, m=m, workload=R.HEAT), 64, 2)
    out_fused = {n: drive(f"cuda-fused {n}", lambda n=n: fused[n].run(
        fused_init[n], 63), 63, 1) for n in fused}
    launches = dict(sk.LAUNCHES)
    expect = {"stencil_step_mxu_batched": 64 // k * 2,
              "stencil_step_fused_k": 63 // k * 2,
              "stencil_step_fused": 63 % k * 2}
    if launches != expect:
        raise AssertionError(f"launches {launches}, expected {expect}")

    def plain_run(wl, state, steps):
        eng = make_engine("block", frac, r, m, workload=wl, fusion_k=k)
        return eng.run(state, steps)
    checks = {}
    want = torch.stack([plain_run(R.LIFE, s, 64) for s in life_states])
    checks["runner cuda-mxu life"] = chk.check(
        "main/mxu/life", "stencil_step_mxu_batched", out_mxu_life, want,
        True)
    alive = int(out_mxu_life.sum())
    max_abs_plain = {}
    want = torch.stack([plain_run(R.HEAT, s, 64) for s in heat_states])
    checks["runner cuda-mxu heat"] = chk.check(
        "main/mxu/heat", "stencil_step_mxu_batched", out_mxu_heat, want,
        False)
    max_abs_plain["runner cuda-mxu heat"] = float(want.abs().max())
    for n, wl in (("life", R.LIFE), ("gray-scott", R.GRAY_SCOTT)):
        want = plain_run(wl, fused_init[n], 63)
        checks[f"cuda-fused {n}"] = chk.check(
            f"main/fused/{n}", "stencil_step_fused_k", out_fused[n], want,
            wl.dtype == torch.uint8)
        max_abs_plain[f"cuda-fused {n}"] = float(want.abs().max())
    if alive == 0:
        raise AssertionError("LIFE died out on the main path")
    emit("main_path", fusion_k=k, runs=runs, launches=launches,
         expected_launches=expect, max_err_vs_plain=checks,
         max_abs_plain=max_abs_plain,
         live_cells_after_64_steps=alive,
         state_bytes_life_b4=life_states.numel())
    del out_mxu_life, out_mxu_heat, out_fused, life_states, heat_states
    del fused_init, want
    torch.cuda.empty_cache()

    # 5. the paper's comparison: BB against Squeeze ------------------------
    bb = make_engine("bb", frac, r, workload=R.LIFE)
    mxu = make_engine("cuda-mxu", frac, r, m, workload=R.LIFE)
    fu = fused["life"]
    e0 = bb.init_random(9)
    s0 = lay.from_expanded(e0)
    n_bb = 4
    t = time.perf_counter()
    e1 = bb.run(e0, n_bb)
    torch.cuda.synchronize()
    bb_ms = 1e3 * (time.perf_counter() - t) / n_bb
    sq_mxu = mxu.run(s0, n_bb)
    sq_fu = fu.run(s0, n_bb)
    want = lay.from_expanded(e1)
    chk.check("bb/mxu", None, sq_mxu, want, True)
    chk.check("bb/fused", None, sq_fu, want, True)
    del e0, e1, want
    torch.cuda.empty_cache()
    n_sq = 32
    mxu_ms = cuda_ms(torch, lambda: mxu.run(s0, n_sq), 3) / n_sq
    fu_ms = cuda_ms(torch, lambda: fu.run(s0, n_sq), 3) / n_sq
    emit("bb_vs_squeeze", workload="life", expanded_side=frac.side(r),
         bb_ms_per_step=bb_ms, cuda_mxu_ms_per_step=mxu_ms,
         cuda_fused_ms_per_step=fu_ms, speedup_mxu=bb_ms / mxu_ms,
         speedup_fused=bb_ms / fu_ms, bb_bytes=bb.memory_bytes(),
         squeeze_bytes=lay.memory_bytes(),
         mrf=bb.memory_bytes() / lay.memory_bytes(), paper_mrf=56.1,
         equal_after_steps=n_bb)

    # 6. kernels at the main path's shapes --------------------------------
    # Bounds count the work the function needs, whatever the algorithm:
    # each input read and each output written once, and about 12
    # operations (Moore aggregate and rule) per cell and substep. v5's
    # halo ring, padding slots and zero band entries are not counted.
    s1 = mxu.init_random(3)
    sb = torch.stack([mxu.init_random(i) for i in range(4)])
    table_bytes = lay.n_blocks * 8 * 4
    state_bytes = s1.numel() * s1.element_size()
    p = lay.macro_tiles(k)[0]
    specs = {
        "stencil_step_fused": dict(
            fn=lambda o: sk.stencil_step_fused(lay, s1, R.LIFE, out=o),
            plain=lambda: sk.stencil_step_fused_plain(lay, s1, R.LIFE),
            like=s1, bytes=2 * state_bytes + table_bytes,
            ops=12 * s1.numel()),
        "stencil_step_fused_k": dict(
            fn=lambda o: sk.stencil_step_fused_k(lay, s1, R.LIFE, k=k,
                                                 out=o),
            plain=lambda: sk.stencil_step_fused_k_plain(lay, s1, R.LIFE,
                                                        k=k),
            like=s1, bytes=2 * state_bytes + table_bytes,
            ops=12 * k * s1.numel()),
        "stencil_step_mxu_batched": dict(
            fn=lambda o: sk.stencil_step_mxu_batched(lay, sb, R.LIFE, k=k,
                                                     out=o),
            plain=lambda: sk.stencil_step_mxu_batched_plain(lay, sb, R.LIFE,
                                                            k=k),
            like=sb, bytes=2 * 4 * state_bytes + table_bytes,
            ops=12 * k * sb.numel()),
    }
    rows = []
    for kname, spec in specs.items():
        out = torch.empty_like(spec["like"])
        chk.check(f"timing/{kname}", kname, spec["fn"](out), spec["plain"](),
                  True)
        ms = cuda_ms(torch, lambda: spec["fn"](out), 20)
        plain_ms = cuda_ms(torch, spec["plain"], 3)
        bytes_ms = 1e3 * spec["bytes"] / HBM_BYTES_PER_S
        ops_ms = 1e3 * spec["ops"] / F32_FLOPS
        rows.append(dict(
            name=kname, route="cuda", source=KERNEL_SOURCE,
            replaces=REPLACES[kname], launches=launches[kname],
            max_abs_err=chk.max_err[kname], ms=ms, plain_ms=plain_ms,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=None))
        emit("kernel_timing", name=kname, shape=list(spec["like"].shape),
             workload="life", k=1 if kname == "stencil_step_fused" else k,
             p=p if "mxu" in kname else None, ms=ms, plain_ms=plain_ms,
             bytes=spec["bytes"], bytes_ms=bytes_ms, ops=spec["ops"],
             ops_ms=ops_ms)
    emit("done", seconds=time.perf_counter() - t_start)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
