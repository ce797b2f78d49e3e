"""The port's examples (``examples/torch/*.py``) run on the CPU at small
sizes (r <= 5, the smoke LM config): each ``main`` is called with
``--device cpu`` and checked on what it returns. On the card they run at
their default arguments in ``chip_smoke.py``."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch"


def _main(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def test_every_example_is_tested():
    tested = {"quickstart", "workloads", "fractal_large", "distributed",
              "serve_fractals", "telemetry", "serve_lm", "train_lm"}
    assert {p.stem for p in EXAMPLES.glob("*.py")} == tested


def test_quickstart():
    pops = _main("quickstart")(["--device", "cpu", "--r", "5", "--steps",
                                "12"])
    assert len(pops) == 4 and len(set(pops.values())) == 1


def test_workloads():
    stats = _main("workloads")(["--device", "cpu", "--r", "4", "--steps",
                                "6", "--batch", "3"])
    assert set(stats) == {"life", "highlife", "heat", "gray-scott",
                          "cuda-mxu"}
    assert all(np.isfinite(v) for v in stats.values())


@pytest.mark.parametrize("extra", [[], ["--distributed", "--shards", "3"]],
                         ids=["single", "distributed"])
def test_fractal_large(extra):
    live = _main("fractal_large")(["--device", "cpu", "--r", "5", "--m",
                                   "2"] + extra)
    assert 0 < live <= 3 ** 5


def test_fractal_large_distributed_equals_single():
    args = ["--device", "cpu", "--r", "5", "--m", "2", "--steps", "4"]
    main = _main("fractal_large")
    assert main(args) == main(args + ["--distributed", "--shards", "2"])


def test_distributed():
    exact = _main("distributed")(["--device", "cpu", "--r", "5", "--steps",
                                  "6", "--shards", "3"])
    assert exact == {1: True, 2: True, 4: True}


def test_serve_fractals():
    same = _main("serve_fractals")(["--device", "cpu", "--r", "4"])
    assert len(same) == 5 and all(same.values())


def test_telemetry():
    root = _main("telemetry")(["--device", "cpu", "--r", "4", "--steps",
                               "4", "--batch", "2", "--shards", "2"])
    assert root.name == "example" and root.children


def test_serve_lm():
    reqs = _main("serve_lm")(["--device", "cpu"])
    assert [len(r.prompt) for r in reqs] == [24, 17, 31, 8]
    assert all(r.out.shape == (12,) for r in reqs)


def test_train_lm():
    first, last = _main("train_lm")(["--device", "cpu", "--steps", "80",
                                     "--batch", "4", "--seq", "32"])
    assert last < first - 0.5
