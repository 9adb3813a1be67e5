"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; everything else
is found by name: its configuration in ``perfbench/configs/<config>.json``,
its traffic mix in ``perfbench/mixes/<traffic>.json``, whose ``driver``
names ``perfbench/traffic/<driver>.py``, the limits of its correctness
check in ``perfbench/limits/<cell>.json``, and each per-layer metric in
``perfbench/metrics/<metric>.py``. With ``--trace 0`` the last line holds
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
and the trace's breakdown. A run with no card, or with fewer cards than
the cell asks, prints no result and exits non-zero; so does a run that has
loaded JAX or the JAX package.

``--calibrate`` (not used by the benchmark's own runs) reads, for each seed
given, the program's numbers against the reference and those of the
controls and faults that set the limits, one JSON line a seed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

from perfbench import common  # noqa: E402

T_START = common.process_start()


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` by file name (a metric's name may
    hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def for_cell(metrics, cell: str, reported=None):
    """The metrics of a list that ``cell`` reports: those that list it, or
    list no cells and move an end-to-end metric that it reports."""
    out = []
    for m in metrics:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif reported is None or m.get("moves") in reported:
            out.append(m)
    return out


class Context:
    """What a traffic driver is handed: the cell, its configuration and
    mix, the run's arguments, and the readers of its per-layer metrics."""

    def __init__(self, bench, cell, args, device, **given):
        self.bench, self.cell, self.args = bench, cell, args
        self.name = cell["name"]
        self.cfg = given.get("cfg") or load_json(
            HERE, "configs", f"{cell['config']}.json")
        self.mix = given.get("mix") or load_json(
            HERE, "mixes", f"{cell['traffic']}.json")
        self.limits = given.get("limits") or load_json(
            HERE, "limits", f"{self.name}.json")
        self.device = device
        self.seed, self.seconds = args.seed, args.seconds
        self.trace = bool(args.trace)
        self.t_start = T_START
        self.scratch = os.path.join(
            os.environ.get("TMPDIR") or os.path.join(ROOT, "build"),
            "perfbench")
        e2e = for_cell(bench["end_to_end"], self.name)
        self.e2e_names = [m["name"] for m in e2e]
        self.per_layer = for_cell(bench["per_layer"], self.name,
                                  set(self.e2e_names))

    def phase(self, name: str) -> None:
        """Note on standard error the seconds since process start at the
        end of a set-up phase."""
        print(f"setup {name} {time.time() - self.t_start:.2f} s",
              file=sys.stderr, flush=True)

    def read_per_layer(self, state):
        """Each per-layer metric's reader on the driver's ``state``; a
        reader that finds nothing to read returns None and is left out."""
        out = {}
        for m in self.per_layer:
            value = load_module("metrics", m["name"]).read(state)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out

    def checks(self, numbers):
        """[(name, value, limit)] of the numbers that the cell's limits
        file names, in its order; a limit of a number not read, or no
        limit at all, raises."""
        read = dict(numbers)
        if not self.limits or not set(self.limits) <= set(read):
            raise KeyError(f"limits {sorted(self.limits)} against numbers "
                           f"read {sorted(read)}")
        return [(k, float(read[k]), float(lim))
                for k, lim in self.limits.items()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--calibrate", type=str, default="",
                   help="comma-separated seeds: limit readings, not a run")
    args = p.parse_args(argv)

    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]

    import torch
    if not torch.cuda.is_available():
        print("no CUDA card visible: nothing measured", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"the cell asks for {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = Context(bench, cell, args, device)
    driver = load_module("traffic", ctx.mix["driver"])
    if args.calibrate:
        seeds = [int(s) for s in args.calibrate.split(",")]
        for readings in driver.calibrate(ctx, seeds):
            print(json.dumps(readings), flush=True)
        return 0
    result = driver.run(ctx)

    found = common.forbidden_modules()
    if found:
        print("loaded in the measuring process: " + ", ".join(found),
              file=sys.stderr)
        return 4
    checks = result.pop("checks")
    correct = bool(result.pop("correct")) and all(
        v == v and v <= lim for _, v, lim in checks)
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(result.pop("memory_peak_bytes"))}
    line = {"correct": correct, "attempted": int(result.pop("attempted")),
            "failed": int(result.pop("failed"))}
    if ctx.trace:
        trace = result.pop("trace")
        device_info.update(busy_s=trace["busy_s"],
                           window_s=trace["window_s"])
        line["metrics"] = result.pop("per_layer")
        line["device"] = device_info
        line["breakdown"] = {"device_ops": trace["device_ops"],
                             "idle_gaps": trace["idle_gaps"]}
    else:
        e2e = result.pop("e2e")
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        line["metrics"] = {k: {"value": float(e2e[k]), "unit": units[k]}
                           for k in ctx.e2e_names}
        line["device"] = device_info
    line["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    print("machine " + json.dumps(common.machine(device.index)))
    for k, v, lim in checks:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
