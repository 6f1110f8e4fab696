"""The readings that a cell's limits of ``correct`` are set from, read in
one process: the port's own numbers over many seeds (the lower readings)
and the control's, the configuration's reference put in the port's place
at the precision below (the upper readings of the force gaps); or, with
``--fault``, the numbers of runs with one of ``benchmark/faults.py``'s
faults, or of the configuration's own, planted (the upper readings of the
step's and the trajectory's numbers).

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 --seconds 5 \
        [--fault shake_off] [--out chiprun_out/readings.json]

Each seed is a whole run of the cell (``run.run_cell``) with a window of
``--seconds``.  Prints one JSON line a seed and a summary: for each number
its largest and smallest reading, and the control's smallest; and the
seeds on which the control came out correct by the cell's limits (none,
where the limits hold).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import faults, run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", help="one of faults.NAMES or of the "
                    "configuration's own faults")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("[readings] no CUDA card", file=sys.stderr)
        return 2
    cfg, _ = run.cell_data(run.load_json(run.ROOT, "BENCHMARK.json"),
                           args.workload)
    if args.fault and args.fault not in faults.names(cfg):
        ap.error(f"no fault {args.fault!r} for {args.workload}; the faults "
                 f"are {faults.names(cfg)}")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with (faults.planted(args.fault, cfg) if args.fault
              else contextlib.nullcontext()):
            res = run.run_cell(args.workload, seed, args.seconds, False,
                               control=not args.fault)
        row = dict(seed=seed, fault=args.fault, correct=res["correct"],
                   checks={k: v["value"] for k, v in res["checks"].items()},
                   control=res.get("control_readings", {}),
                   control_correct=res.get("control_correct"),
                   ns_per_day=res["metrics"]["ns_per_day"]["value"],
                   seconds=time.perf_counter() - t0)
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for name in rows[0]["checks"]:
        values = [r["checks"][name] for r in rows]
        summary[name] = dict(largest=max(values), smallest=min(values))
        if name in rows[0]["control"]:
            summary[name]["control_smallest"] = min(r["control"][name]
                                                    for r in rows)
    if not args.fault:
        # the control has to come out not correct on every seed
        summary["control_correct_on"] = [r["seed"] for r in rows
                                         if r["control_correct"]]
    print(json.dumps(dict(workload=args.workload, fault=args.fault,
                          summary=summary)), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(dict(workload=args.workload, fault=args.fault,
                           rows=rows, summary=summary), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
