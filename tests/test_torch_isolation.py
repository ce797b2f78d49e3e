"""The port stands alone: no file of ``src/repro_torch``, not
``chip_smoke.py``, no script under ``tools/`` and no example under
``examples/torch/`` imports jax or the reference package, and the CPU
path (the simulation engines, the kernels' plain versions, the language
models and their server, the examples) runs with neither loaded."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py")) + \
    sorted((ROOT / "examples" / "torch").glob("*.py"))


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "id", None) == "__import__" and \
                node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_neither_jax_nor_reference(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_cpu_path_runs_without_jax_or_reference():
    code = """
import sys
import torch
from repro_torch.core import SIERPINSKI, make_engine
from repro_torch.workloads import GRAY_SCOTT, LIFE, BatchedRunner
for kind in ("cuda-fused", "cuda-mxu", "cuda", "cuda-blocks", "block",
             "cell", "lambda", "bb"):
    eng = make_engine(kind, SIERPINSKI, 4, 1 if kind != "cell" else 0,
                      workload=GRAY_SCOTT, device="cpu")
    s = eng.run(eng.init_random(0), 3)
    assert torch.isfinite(s).all()
from repro_torch.core import MENGER
from repro_torch.workloads import HEAT3D
for kind in ("cuda-3d", "cuda-3d-mxu", "block3d", "cell3d", "bb3d"):
    eng = make_engine(kind, MENGER, 2, 1, workload=HEAT3D, device="cpu")
    assert torch.isfinite(eng.run(eng.init_random(0), 3)).all()
for kind in ("dist-block", "dist-fused", "dist-mxu"):
    for exchange in ("p2p", "gather"):
        eng = make_engine(kind, SIERPINSKI, 5, 1, workload=GRAY_SCOTT,
                          device="cpu", n_shards=3, exchange=exchange)
        out = eng.run(eng.init_random(0), 3)
        assert torch.isfinite(eng.to_dense(out)).all()
from repro_torch.kernels.attention import flash_attention
from repro_torch.kernels.ssd_chunk import ssd_chunk_scan
q = torch.randn(1, 2, 64, 32, dtype=torch.bfloat16)
assert torch.isfinite(flash_attention(q, q, q, window=16,
                                      softcap=20.0).float()).all()
x, bm = torch.randn(1, 40, 2, 8), torch.randn(1, 40, 8)
y = ssd_chunk_scan(x, torch.rand(1, 40, 2), -torch.rand(2), bm, bm, chunk=16)
assert y.shape == x.shape and torch.isfinite(y).all()
runner = BatchedRunner(device="cpu")
states = runner.init_batch("cuda-mxu", SIERPINSKI, 4, [0, 1], m=2)
assert runner.run("cuda-mxu", SIERPINSKI, 4, states, 5, m=2).shape == \\
    states.shape
import numpy as np
from repro_torch import configs
from repro_torch.configs.sierpinski import CONFIG, FRACTAL
from repro_torch.launch.serve import BatchServer, Request
from repro_torch.models import model as lm
assert FRACTAL is SIERPINSKI and CONFIG.m == 4
for arch in configs.ARCHS:
    cfg = configs.get_smoke_config(arch)
    server = BatchServer(cfg, lm.init_params(0, cfg, device="cpu"))
    for r in server.serve([Request(prompt=np.arange(3 + i, dtype=np.int32),
                                   max_new=3) for i in range(2)]):
        assert r.out.shape == (3,) and (r.out < cfg.vocab_padded).all()
import importlib.util
EXAMPLES = sys.argv[1]
small = {"quickstart": ["--r", "4", "--steps", "4"],
         "workloads": ["--r", "4", "--steps", "2", "--batch", "2"],
         "fractal_large": ["--r", "4", "--m", "1", "--steps", "2"],
         "distributed": ["--r", "4", "--steps", "2", "--shards", "2"],
         "serve_fractals": ["--r", "3"], "telemetry": ["--r", "4"],
         "serve_lm": [],
         "train_lm": ["--steps", "80", "--batch", "4", "--seq", "32"]}
for name, args in small.items():
    spec = importlib.util.spec_from_file_location(
        name, f"{EXAMPLES}/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(args + ["--device", "cpu"])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code,
                           str(ROOT / "examples" / "torch")], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")
