"""``python -m repro_torch.tuning``: re-tune, show and diff tables.

Subcommands:

* ``tune``: run the sweep of a preset (or of specs given as JSON) on a
  device and write the winners to a table file, printing the diff against
  the table that was at that path;
* ``show``: print a table (by default the shipped one);
* ``diff``: key-level diff of two table files (exit 1 on differences).

Examples::

    python -m repro_torch.tuning tune --preset default \\
        --out src/repro_torch/tuning/tables/default.json
    python -m repro_torch.tuning tune --device cpu \\
        --spec '{"kind":"block","s":2,"frac":"sierpinski","r":5,"m":1}'
    python -m repro_torch.tuning diff old.json new.json
    python -m repro_torch.tuning show
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys

from repro_torch.tuning.presets import preset_specs
from repro_torch.tuning.search import tune_many
from repro_torch.tuning.spec import EngineSpec
from repro_torch.tuning.table import DEFAULT_TABLE_PATH, TuningTable


def _card() -> str:
    """The card's name and power limit as nvidia-smi gives them ('' when
    it cannot be asked)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def _cmd_tune(args: argparse.Namespace) -> int:
    specs = []
    if args.preset:
        specs += preset_specs(args.preset)
    for raw in args.spec or []:
        specs.append(EngineSpec.from_json(json.loads(raw)))
    if not specs:
        print("nothing to tune: pass --preset and/or --spec",
              file=sys.stderr)
        return 2
    old = None
    if args.out and os.path.exists(args.out):
        old = TuningTable.load(args.out)
    base = TuningTable(old.entries) if (old and args.merge) else None
    table, results = tune_many(
        specs, steps=args.steps, rounds=args.rounds, seed=args.seed,
        max_candidates=args.max_candidates, table=base, device=args.device)
    for res in results:
        mark = " [SUSPECT]" if res.suspect else ""
        print(f"{res.spec.tuning_key()}\n    best={res.best.label} "
              f"baseline={res.baseline.label} "
              f"speedup={res.speedup:.2f}x{mark}")
        if res.parity_failures:
            print(f"    parity failures: {res.parity_failures}")
    table.meta.setdefault("generator", "python -m repro_torch.tuning")
    table.meta["device"] = args.device or "cuda"
    if table.meta["device"] != "cpu":
        table.meta["card"] = _card()
    table.meta["date"] = datetime.date.today().isoformat()
    if args.out:
        table.save(args.out)
        print(f"wrote {len(table)} entries to {args.out}")
        if old is not None:
            print(json.dumps(table.diff(old), indent=2))
    else:
        print(json.dumps(table.to_json(), indent=2))
    return 0


def _cmd_show(args: argparse.Namespace) -> int:
    print(json.dumps(TuningTable.load(args.path).to_json(), indent=2))
    return 0


def _cmd_diff(args: argparse.Namespace) -> int:
    diff = TuningTable.load(args.new).diff(TuningTable.load(args.old))
    print(json.dumps(diff, indent=2))
    return 1 if (diff["added"] or diff["removed"] or diff["changed"]) \
        else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tuning",
                                 description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("tune", help="run the sweep and write a table")
    t.add_argument("--preset", choices=["ci", "default"], default=None)
    t.add_argument("--spec", action="append",
                   help="EngineSpec as JSON (repeatable)")
    t.add_argument("--out", default=None,
                   help="table path to write (default: print)")
    t.add_argument("--merge", action="store_true",
                   help="merge into the existing table at --out")
    t.add_argument("--steps", type=int, default=8)
    t.add_argument("--rounds", type=int, default=3)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--max-candidates", type=int, default=None)
    t.add_argument("--device", default=None,
                   help="device to tune on (default: the card)")
    t.set_defaults(fn=_cmd_tune)

    s = sub.add_parser("show", help="print a table")
    s.add_argument("path", nargs="?", default=DEFAULT_TABLE_PATH)
    s.set_defaults(fn=_cmd_show)

    d = sub.add_parser("diff",
                       help="diff two tables (exit 1 on differences)")
    d.add_argument("old")
    d.add_argument("new")
    d.set_defaults(fn=_cmd_diff)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
