"""The telemetry layer end to end: run a batch on the distributed-fused
engine with collection enabled, then read the registry back four ways --
pretty table, Prometheus text, JSONL, and a Chrome trace of the span tree
(load it at chrome://tracing or ui.perfetto.dev).

    PYTHONPATH=src python examples/torch/telemetry.py [--device cpu]

Collection is opt-in (SQUEEZE_TELEMETRY=1, or ``obs.enabled_scope`` as
below); disabled, every hook is a bool check. Runs on the card unless
``--device cpu`` is given; the shards of the distributed engine then all
sit on that device.
"""
import argparse
import os
import tempfile

from repro_torch import obs
from repro_torch.core import SIERPINSKI
from repro_torch.tuning import EngineSpec
from repro_torch.workloads import LIFE, BatchedRunner


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--r", type=int, default=5)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    runner = BatchedRunner(device=args.device)
    spec = EngineSpec.from_args("dist-fused", SIERPINSKI, args.r, args.m,
                                LIFE, n_shards=args.shards)
    with obs.enabled_scope(True):
        obs.reset()
        with obs.span("example", r=args.r, batch=args.batch):
            states = runner.init_batch(spec, range(args.batch))
            states = runner.run(spec, states, args.steps)

        # 1. the human-readable table: cache hits, fused launches,
        #    exchanges, memory-bytes gauges, per-run latency histograms
        print(obs.report())

        # 2. Prometheus scrape text (squeeze_* families)
        prom = obs.to_prometheus()
        print("\n".join(line for line in prom.splitlines()
                        if line.startswith("# TYPE"))[:400])

        # 3. JSONL event log (round-trips via obs.load_jsonl)
        jsonl = obs.to_jsonl()
        print(f"\njsonl: {len(jsonl.splitlines())} lines, "
              f"{len(jsonl)} bytes")

        # 4. the span tree as a Chrome trace
        with tempfile.TemporaryDirectory() as tmp:
            path = obs.write_chrome_trace(os.path.join(tmp, "trace.json"))
            size = os.path.getsize(path)
        root = obs.spans()[-1]
        print(f"chrome trace: {size} bytes -- root span '{root.name}' "
              f"{root.dur_us / 1e3:.1f} ms, {len(root.children)} children")
    return root


if __name__ == "__main__":
    main()
