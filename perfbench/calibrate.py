#!/usr/bin/env python3
"""The two readings that every limit of a cell is set between.

    python3 perfbench/calibrate.py --workload <cell> --seeds <n> ... \
        --control-seeds <n> ... [--out <file.json>]

In one process, for each of ``--seeds``: the pool that a run with that
seed makes, the program on the first ``check_units`` of its datasets (as
many answers as a run compares), and the cell's numbers, each the worst
over those answers, as a run reports them. For each of
``--control-seeds`` the same with the control in the program's place: the
plain reference computed in bfloat16, one precision below the float32
that the configuration states. The lower reading of a number is its
largest over the program's seeds, the upper its smallest over the
control's. The benchmark's runs never run this; its readings set the
limits in ``limits/<cell>.json`` (see PERF.md).

``--device cpu`` runs it on the CPU, for the benchmark's tests.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, ctx, steps, gen, seed, control):
    """The cell's numbers for one seed, each the worst over the answers
    a run would compare."""
    import torch

    from perfbench.run import worst
    ctx.cache.clear()
    pool = gen.make_pool(cell.config, seed, int(cell.mix["pool"]))
    kept = pool[:int(cell.mix["check_units"])]
    out = {}
    for dataset in kept:
        carry, outs = None, {}
        for mod, params in steps:
            state = ctx.states[params["step"]]
            if control:
                carry = mod.control(ctx, state, dataset, carry,
                                    torch.bfloat16)
            else:
                carry = mod.run(ctx, state, dataset, carry, None)
            outs[params["step"]] = carry
        for name in cell.mix["checks"]:
            check = cell.module("checks", name)
            for key, value in check.numbers(ctx, dataset, outs).items():
                out.setdefault(key, []).append(value)
    return {k: worst(v) for k, v in out.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)

    import torch

    from perfbench.lib.manifest import load_cell
    from perfbench.run import Context
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(ROOT, args.workload)
    ctx = Context(config=cell.config, device=args.device)
    gen = cell.module("generators", cell.config["generator"])
    steps = [(cell.module("steps", s["step"]), s) for s in cell.mix["job"]]
    for mod, params in steps:
        ctx.states[params["step"]] = mod.prepare(ctx, params)

    table = {"workload": args.workload, "program": {}, "control": {}}
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        side = "control" if control else "program"
        for seed in seeds:
            t0 = time.perf_counter()
            table[side][seed] = readings(cell, ctx, steps, gen, seed, control)
            print(f"{side} seed {seed} ({time.perf_counter() - t0:.1f} s): "
                  + json.dumps(table[side][seed]), flush=True)
    names = sorted({k for r in table["program"].values() for k in r}
                   | {k for r in table["control"].values() for k in r})
    summary = {}
    for k in names:
        lower = max((r[k] for r in table["program"].values()), default=None)
        upper = min((r[k] for r in table["control"].values()), default=None)
        summary[k] = {"lower": lower, "upper": upper,
                      "limit": cell.limits.get(k)}
        print(f"{k}: lower {lower!r} upper {upper!r} "
              f"limit {cell.limits.get(k)!r}", flush=True)
    table["summary"] = summary
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(table, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
