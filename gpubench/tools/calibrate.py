#!/usr/bin/env python3
"""Readings for a cell's limits: the program's sound runs over many seeds,
and the control (the reference in the nearest precision below the
configuration's) and planted faults in the program's place, in one
process.

    python3 gpubench/tools/calibrate.py --workload CELL --seeds 12 \
        [--first 1000] [--controls tf32,half_batch] [--out FILE]
    python3 gpubench/tools/calibrate.py --judge FILE [FILE ...]

For each seed: one short run of the cell through run.py's run_cell (the
program's timed path compared with the reference), then each control's
numbers against the reference. Prints one JSON line per seed and control,
and a summary: per number, the largest sound reading and the smallest
reading of each control. A limit lies between the two (PERF.md gives the
readings and the limits). Every control's numbers are also judged against
the cell's committed limits by the rule that decides a run's `correct`
(harness/compare.py::judge): each has to come out not correct, and the
exit code is 1 where one does not. `--judge` judges readings kept in
earlier output files the same way, without a card.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def shrink_cell(cell, changes: dict) -> None:
    """Apply {"cli": {...}, "dataset": {...}, other key: value} to a cell's
    configuration (a copy) and {"traffic": {...}} to its traffic."""
    import copy

    cell.config = copy.deepcopy(cell.config)
    cell.traffic = dict(cell.traffic, **changes.get("traffic", {}))
    for k, v in changes.items():
        if k in ("cli", "dataset"):
            cell.config[k].update(v)
        elif k != "traffic":
            cell.config[k] = v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--judge", nargs="*", default=None,
                    help="judge the controls' readings kept in these files")
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=4000000000)
    ap.add_argument("--controls", default="")
    ap.add_argument("--control_seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--same", action="store_true",
                    help="every run on the --first seed (a process's first run against its later)")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda", help="cpu: a rehearsal at the sizes of --shrink")
    ap.add_argument("--shrink", default="", help="JSON of configuration changes (rehearsals)")
    a = ap.parse_args(argv)
    if a.judge is not None:
        return judge_files(a.judge)

    import torch

    from gpubench import run as R
    from gpubench.harness import bench, compare

    R.set_cache_dirs()
    cell = bench.Cell(a.workload)
    if a.shrink:
        shrink_cell(cell, json.loads(a.shrink))
    if a.device == "cuda" and not torch.cuda.is_available():
        bench.log("calibrate needs a CUDA device")
        return 2
    device = torch.device("cuda", 0) if a.device == "cuda" else torch.device(a.device)
    out = open(a.out, "a") if a.out else None
    sound, controls = {}, {}

    def record(kind, seed, numbers):
        entry = {"cell": cell.name, "kind": kind, "seed": seed, "numbers": numbers}
        if kind != "program":
            entry["correct"] = compare.judge(numbers, cell.limits)[0]
        line = json.dumps(entry)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for i in range(a.seeds):
        seed = a.first if a.same else a.first + i
        result, checks = R.run_cell(cell, seed, a.seconds, False, device)
        numbers = {k: v for k, (v, _) in checks.items()}
        sound[(seed, i)] = numbers
        record("program", seed, numbers)
        if i < a.control_seeds:
            for ctl in filter(None, a.controls.split(",")):
                numbers = cell.driver().control(cell, seed, device, ctl)
                controls.setdefault(ctl, {})[seed] = numbers
                record(ctl, seed, numbers)
    summary = {"cell": cell.name, "sound_max": {}, "control_min": {},
               "controls_correct": sorted(
                   f"{ctl} {seed}" for ctl, per_seed in controls.items()
                   for seed, n in per_seed.items() if compare.judge(n, cell.limits)[0])}
    for k in next(iter(sound.values())):
        summary["sound_max"][k] = max(n[k] for n in sound.values())
        for ctl, per_seed in controls.items():
            vals = [n[k] for n in per_seed.values() if k in n]
            if vals:
                summary["control_min"].setdefault(ctl, {})[k] = min(
                    v if math.isfinite(v) else math.inf for v in vals)
    line = json.dumps(summary)
    print(line, flush=True)
    if out:
        out.write(line + "\n")
        out.close()
    return 1 if summary["controls_correct"] else 0


def judge_files(paths) -> int:
    """Judge every control reading (a line whose kind is not "program") kept
    in `paths` against its cell's committed limits, on the numbers the cell
    compares; 1 where one comes out correct."""
    from gpubench.harness import bench, compare

    cells, bad, n = {}, 0, 0
    for path in paths:
        with open(path) as f:
            for line in f:
                try:
                    entry = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(entry, dict) or entry.get("kind") in (None, "program"):
                    continue
                name = entry["cell"]
                if name not in cells:
                    try:
                        cells[name] = bench.Cell(name)
                    except KeyError:
                        continue
                limits = cells[name].limits
                if not set(limits) <= set(entry["numbers"]):
                    continue  # a reading of numbers the cell no longer compares
                correct, checks = compare.judge(
                    {k: entry["numbers"][k] for k in limits}, limits)
                failed = sorted(k for k, (v, lim) in checks.items()
                                if lim is None or not math.isfinite(v) or v > lim)
                n += 1
                bad += correct
                print(json.dumps({"cell": name, "kind": entry["kind"], "seed": entry["seed"],
                                  "correct": correct, "fails": failed}), flush=True)
    print(json.dumps({"judged": n, "came_out_correct": bad}), flush=True)
    return 1 if bad or not n else 0


if __name__ == "__main__":
    sys.exit(main())
