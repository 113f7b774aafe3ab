#!/usr/bin/env python3
"""One run of one cell of the port's benchmark.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with as many NVIDIA GPUs as
the cell asks for. The run

1. finds the cell in ``BENCHMARK.json`` and the files it names (see
   ``perfbench/README.md``), and fails without a result where CUDA is not
   available, the cell's GPUs are not there, or the port is not in this
   checkout;
2. makes the mix's pool of datasets from ``--seed`` and runs the cell's job
   once on each (the warm-up: the first run of a checkout also builds the
   port's kernels into its fixed build directory); ``setup_s`` ends here;
3. runs the job on the pool's datasets in turn, one after another (a
   closed loop with one client), until ``--seconds`` have passed and the
   dataset in flight has completed;
4. with ``--trace 1``, times the pipeline's stages in those datasets and
   then profiles a stretch of ``trace_units`` more with ``torch.profiler``;
5. reads the peak device memory, frees the program's state, and holds a
   sample of the window's answers (``check_units`` of them, drawn from
   the seed) against the plain reference in ``perfbench/reference/``, then
   fails without a result if JAX or the JAX package has been loaded;
6. prints each number compared beside its limit as the last lines of
   standard error, and one JSON object as the last line of standard
   output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
   end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
   ``device``, with ``--trace 1`` ``breakdown``, and last ``checks``.

``--device cpu`` is for the benchmark's own tests: it skips the look for a
GPU and the check of where the port lives, and runs everything on the CPU.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ptv_interpolation_tpu")
PORT = "ptv_interpolation_tpu_torch"


class NoResult(Exception):
    """The run cannot give a result; the message says why."""


@dataclass
class Context:
    """What steps, checks and generators read: the configuration, the
    device, each step's prepared state, and a cache of reference answers."""

    config: dict
    device: str
    states: dict = field(default_factory=dict)
    cache: dict = field(default_factory=dict)


@dataclass
class Window:
    setup_s: float
    window_s: float
    units: int
    unit_walls: list


@dataclass
class Trace:
    stages: list            # StageTimings.stages of each unprofiled unit
    device: object          # lib.trace.DeviceTrace of the profiled stretch
    sizes: list             # the work of each profiled unit's dataset


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p.parse_args(argv)


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def worst(values):
    """The largest of a number's readings; NaN if any reading is NaN."""
    vals = [float(v) for v in values]
    return math.nan if any(math.isnan(v) for v in vals) else max(vals)


def run(args):
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".perfbench_cache" / "triton")
    from perfbench.lib.manifest import load_cell
    from perfbench.lib.trace import profile_units
    cell = load_cell(ROOT, args.workload)
    import torch
    cuda = args.device == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise NoResult("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.chips:
            raise NoResult(f"the cell asks for {cell.chips} GPUs, "
                           f"{torch.cuda.device_count()} are visible")
    import ptv_interpolation_tpu_torch as port
    from ptv_interpolation_tpu_torch.utils import StageTimings
    if cuda and ROOT not in Path(port.__file__).resolve().parents:
        raise NoResult(f"{PORT} is not in this checkout ({port.__file__})")
    if cuda:
        log(f"card: {card_line()}; torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")

    ctx = Context(config=cell.config, device=args.device)
    gen = cell.module("generators", cell.config["generator"])
    pool = gen.make_pool(cell.config, args.seed, int(cell.mix["pool"]))
    steps = [(cell.module("steps", s["step"]), s) for s in cell.mix["job"]]
    for mod, params in steps:
        ctx.states[params["step"]] = mod.prepare(ctx, params)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def unit(dataset, timings=None):
        carry, outs = None, {}
        for mod, params in steps:
            carry = mod.run(ctx, ctx.states[params["step"]], dataset, carry,
                            timings)
            outs[params["step"]] = carry
        return outs

    for dataset in pool:
        unit(dataset)
    sync()
    setup_s = time.perf_counter() - _T0
    log(f"set-up {setup_s:.4f} s: {len(pool)} datasets made and warmed up")

    n_check = int(cell.mix["check_units"])
    pick = np.random.default_rng([args.seed % 2**64, 2**32])
    kept, walls, stages = [], [], []
    attempted = failed = 0
    i = 0
    t_start = time.perf_counter()
    deadline = t_start + args.seconds
    while time.perf_counter() < deadline:
        dataset = pool[i % len(pool)]
        i += 1
        attempted += 1
        timings = StageTimings() if args.trace else None
        t0 = time.perf_counter()
        try:
            outs = unit(dataset, timings)
        except Exception:                       # noqa: BLE001 - counted
            failed += 1
            traceback.print_exc()
            continue
        walls.append(time.perf_counter() - t0)
        if timings is not None:
            stages.append(dict(timings.stages))
        # a uniform sample of the window's answers, drawn from the seed
        if len(kept) < n_check:
            kept.append((dataset, outs))
        else:
            j = int(pick.integers(len(walls)))
            if j < n_check:
                kept[j] = (dataset, outs)
        del outs
    window_s = time.perf_counter() - t_start
    window = Window(setup_s, window_s, len(walls), walls)
    log(f"window {window_s:.4f} s: {len(walls)} of {attempted} units "
        f"completed, {failed} failed; unit walls (s) "
        + " ".join(f"{w:.4f}" for w in walls))

    device_trace = None
    if args.trace:
        n_trace = int(cell.mix["trace_units"])
        traced = [pool[(i + j) % len(pool)] for j in range(n_trace)]

        def stretch():
            for d in traced:
                unit(d)
            return len(traced)

        device_trace = profile_units(torch, stretch)
        log(f"profiled {n_trace} units: {device_trace.window_s:.4f} s, "
            f"device busy {device_trace.busy_s:.4f} s")
        trace = Trace(stages=stages, device=device_trace,
                      sizes=[gen.sizes(ctx, d) for d in traced])

    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    readings = {}
    for name in cell.mix["checks"]:
        check = cell.module("checks", name)
        for dataset, outs in kept:
            for key, value in check.numbers(ctx, dataset, outs).items():
                readings.setdefault(key, []).append(value)
    log(f"reference and comparison of {len(kept)} units: "
        f"{time.perf_counter() - t0:.4f} s")
    checks = {}
    for key, values in readings.items():
        if key not in cell.limits:
            raise NoResult(f"no limit for the number {key!r} in "
                           f"limits/{cell.name}.json")
        checks[key] = {"value": worst(values), "limit": cell.limits[key]}
    correct = (failed == 0 and bool(kept) and bool(checks)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    for c in checks.values():
        if math.isnan(c["value"]):
            c["value"] = None               # JSON has no NaN

    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = cell.module("metrics", m["name"]).read(trace)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            value = cell.module("endtoend", m["name"]).read(window)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if args.trace:
        device["busy_s"] = device_trace.busy_s
        device["window_s"] = device_trace.window_s
        result["breakdown"] = device_trace.breakdown()
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        raise NoResult(f"modules loaded in this process: {', '.join(found)}")
    return result


def main(argv=None):
    args = parse(argv)
    try:
        result = run(args)
    except NoResult as e:
        log(f"no result: {e}")
        return 2
    for key, c in result["checks"].items():
        log(f"check {key} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
