"""The benchmark of the PyTorch/CUDA port: one cell of BENCHMARK.json, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (``benchmark/configs/<config>.json``) and a
traffic mix (``benchmark/traffic/<traffic>.json``: the reciprocal route
``recip`` and the segment length).  The configuration names its roles,
each a module found by that name: its ``layout`` (the numpy builder of
its tables, ``benchmark/layouts/``), its ``wiring`` (the hand-over of the
tables to the port's public API, ``benchmark/wirings/``), its
``reference`` (plain torch, ``benchmark/references/``) and, where it has
any beyond the six of ``faults.py``, its ``faults``
(``benchmark/extra_faults/``); its ``small`` keys give the size of the
CPU tests.  The traffic's route names ``benchmark/routes/<recip>.py``: the
reference's reciprocal sum on that route and its work count.  A per-layer
metric is the reader ``benchmark/metrics/<name>.py``; a cell's limits of
``correct`` are ``benchmark/limits/<cell>.json``.  Nothing here is edited
to add a configuration, a route, a cell or a metric.  A cell whose files
are all in place but that the benchmark does not measure yet is listed in
``benchmark/queued.json``: it runs here and in the tests as any other, and
has no per-layer metric until BENCHMARK.json names it.

A run: build the tables from ``--seed``; hand them to the port through
the wiring; run the port's first ``CHECK_STEPS`` steps one by
one, recording each state, and one segment (set-up, ``setup_s`` from
process start); then call
``Context.step(segment_steps)`` until ``--seconds`` have passed, ending in
a synchronize (``ns_per_day`` over all the window's steps).  With
``--trace 1`` the same window reads the counters, then ``PROFILE_STEPS``
more steps run under torch.profiler and the reciprocal route is timed, and the
per-layer metrics are printed instead of the end-to-end ones.  Then the
port runs ``CHECK_STEPS`` more steps one by one, and the reference checks
the recorded states (``benchmark/check.py``).  The last line
of standard output is the result's JSON object.

Without a CUDA card the run fails: it never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
# every cache of the run inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import check  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "openmm_velocityverlet_tpu")
NS_PER_PS = 1e-3
# the breakdown's operation names are cut to this many characters
NAME_CHARS = 160
# steps of the traced sub-window: at 6,000 kernels a step, reading the
# trace of a whole 100-step segment took over 8 minutes, past a run's
# time limit; 10 steps hold about one pair-cache rebuild, as the window's
# steps do on average
PROFILE_STEPS = 10


def process_start():
    """The epoch second at which this process started (from /proc), or
    this module's import where /proc cannot say."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fh:
            btime = next(int(line.split()[1]) for line in fh
                         if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return _IMPORTED


_IMPORTED = time.time()


def load_json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def load_file_module(path):
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + os.path.basename(path)[:-3].replace(".", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def queued_cells():
    """The cells of ``benchmark/queued.json``: each with its files in
    place, and not in BENCHMARK.json yet."""
    return load_json(HERE, "queued.json")["workloads"]


def cell_spec(bench, workload):
    """The entry of a cell of BENCHMARK.json or, failing that, of the
    queued cells."""
    for w in bench["workloads"] + queued_cells():
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json or "
                     f"benchmark/queued.json")


def cell_data(bench, workload, config_override=None):
    """(configuration, traffic) of a cell, the configuration's keys
    replaced by ``config_override``."""
    spec = cell_spec(bench, workload)
    cfg = load_json(HERE, "configs", spec["config"] + ".json")
    cfg.update(config_override or {})
    return cfg, load_json(HERE, "traffic", spec["traffic"] + ".json")


def role(kind, name):
    """The module ``benchmark/<kind>/<name>.py``: a configuration's layout,
    wiring, reference or faults, or a traffic's route."""
    return importlib.import_module(f"benchmark.{kind}.{name}")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def counters(ctx):
    return dict(host_syncs=ctx.host_syncs, rebuilds=ctx.rebuilds,
                coverage_rebuilds=ctx.coverage_rebuilds, refits=ctx.refits,
                baro_attempts=ctx.baro_attempts)


def union_seconds(intervals):
    """Seconds covered by (start_us, end_us) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def idle_gaps(dev_events, cpu_events, top=10):
    """The longest gaps between device operations, each named by the
    innermost host operation running at its midpoint."""
    ivs = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    gaps = []
    end = None
    for s, e in ivs:
        if end is not None and s > end:
            gaps.append((s - end, end, s))
        end = e if end is None else max(end, e)
    gaps.sort(reverse=True)
    out = []
    for length, s, e in gaps[:top]:
        mid = 0.5 * (s + e)
        best = None
        for ev in cpu_events:
            tr = ev.time_range
            if tr.start <= mid <= tr.end and (
                    best is None or tr.end - tr.start
                    < best.time_range.end - best.time_range.start):
                best = ev
        out.append([best.name[:NAME_CHARS] if best is not None
                    else "host (no op)", length * 1e-6])
    return out


def profile_segment(ctx, steps, device):
    """``steps`` steps under torch.profiler, cross-checked: the trace's B1
    sweeps must number the port's own count of B1 launches over the same
    steps, and its device-busy time must not fall below B1's summed device
    time.  On a mismatch the steps are profiled once more; a second
    mismatch ends the run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from openmm_velocityverlet_tpu_torch.ops import pair_plist
    reason = None
    for _ in range(2):
        l0 = pair_plist.plist_pair.launches
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ctx.step(steps)
            sync(device)
        wall = time.perf_counter() - t0
        launches = pair_plist.plist_pair.launches - l0
        events = prof.events()
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        kernels = [e for e in dev if not e.name.startswith("Memcpy")
                   and not e.name.startswith("Memset")]
        sweeps = [e for e in dev if "plist_pair_kernel" in e.name]
        b1 = [e for e in dev if "plist_pair_kernel" in e.name
              or "plist_reduce_kernel" in e.name]
        b1_s = sum(e.time_range.end - e.time_range.start for e in b1) * 1e-6
        busy = union_seconds([(e.time_range.start, e.time_range.end)
                              for e in dev])
        if busy > 0 and len(sweeps) == launches and busy >= b1_s:
            by_name = {}
            for e in dev:
                by_name[e.name] = by_name.get(e.name, 0.0) + (
                    e.time_range.end - e.time_range.start) * 1e-6
            ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
            return dict(steps=steps, kernels=len(kernels), busy_s=busy,
                        window_s=wall, b1_launches=launches, b1_s=b1_s,
                        device_ops=[[k[:NAME_CHARS], v] for k, v in ops],
                        idle_gaps=idle_gaps(dev, cpu))
        reason = (f"profiled sub-window of {steps} steps: {len(sweeps)} B1 "
                  f"sweeps in the trace against {launches} launches counted "
                  f"by the port; device busy {busy:.6f} s against B1's "
                  f"{b1_s:.6f} s")
        print(f"[bench] profiler cross-check failed, profiling again: "
              f"{reason}", file=sys.stderr)
    raise SystemExit(f"[bench] the profiler lost records twice ({reason}); "
                     f"no device metric is reported")


def route_ms(ctx, reps=10):
    """Median CUDA-event time of the reciprocal route's energy and
    autograd forces at the current state."""
    import torch
    ev = ctx.evaluator
    fn = ev.smooth_terms(ctx.state.box).get("coul_recip")
    if fn is None:
        return None
    pos = ev.place_vsites(ctx.state.pos)

    def once():
        p = pos.detach().requires_grad_(True)
        with torch.enable_grad():
            torch.autograd.grad(fn(p), p)
    once()
    sync(pos.device)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        once()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def run_cell(workload, seed, seconds, trace, device="cuda", control=False,
             config_override=None, bench=None, log=None, min_steps=0):
    """One run of a cell; returns the result dict (its ``checks`` last).
    ``config_override`` replaces configuration keys (the tests' small
    sizes); ``control`` adds the control's readings under
    ``control_readings`` and, under ``control_correct``, whether they keep
    to the limits of the same names, as the port's must; the window lasts at least ``min_steps`` steps
    (the tests' runs on the CPU)."""
    import torch
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    cfg, traffic = cell_data(bench, workload, config_override)
    limits_path = os.path.join(HERE, "limits", workload + ".json")
    limits = ({k: v["limit"] for k, v in load_json(limits_path).items()}
              if os.path.exists(limits_path) else {})
    device = torch.device(device)
    # one host thread: the step's host work is the launches, and idle
    # worker threads only add to the host's noise
    torch.set_num_threads(1)

    t = role("layouts", cfg["layout"]).tables(cfg, seed)
    ctx, system = role("wirings", cfg["wiring"]).build_context(
        t, traffic, device)
    segment = int(traffic["segment_steps"])
    dt = float(t["integrator"]["dt_ps"])
    start = check.record_steps(ctx)
    ctx.step(segment)
    sync(device)
    setup_s = time.time() - process_start()
    log(f"[bench] {workload} seed {seed}: {system.n_atoms} atoms, set-up "
        f"{setup_s:.3f} s")

    c0 = counters(ctx)
    steps = 0
    marks, rebuilds = [], [ctx.rebuilds]
    t0 = time.perf_counter()
    while True:
        ctx.step(segment)
        steps += segment
        sync(device)
        marks.append(time.perf_counter() - t0)
        rebuilds.append(ctx.rebuilds)
        if marks[-1] >= seconds and steps >= min_steps:
            break
    window_s = marks[-1]
    log("[bench] segment seconds " + " ".join(
        f"{b - a:.3f}" for a, b in zip([0.0] + marks, marks)))
    log("[bench] segment rebuilds " + " ".join(
        str(b - a) for a, b in zip(rebuilds, rebuilds[1:])))
    c1 = counters(ctx)
    delta = {k: c1[k] - c0[k] for k in c0}
    ns_per_day = steps * dt * NS_PER_PS / window_s * 86400.0
    log(f"[bench] window: {steps} steps in {window_s:.4f} s, "
        f"{ns_per_day:.6f} ns/day; counters {delta}")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"[bench] the process holds {found} after the "
                         f"window")

    metrics = {}
    breakdown = None
    dev_info = dict(platform="gpu" if device.type == "cuda" else "cpu",
                    kind=(torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu"),
                    count=1, memory_peak_bytes=int(peak))
    units = {m["name"]: m["unit"] for m in
             bench["end_to_end"] + bench["per_layer"]}
    if trace:
        from benchmark import counts
        prof = (profile_segment(ctx, PROFILE_STEPS, device)
                if device.type == "cuda" else None)
        pos = ctx.evaluator.place_vsites(ctx.state.pos)
        pairs, ops = counts.step_work(
            system, pos, ctx.state.box,
            role("routes", traffic["recip"]).ops(t))
        r = types.SimpleNamespace(
            steps=steps, window_s=window_s, counters=delta, profile=prof,
            work=dict(pairs=pairs, ops=ops), n_atoms=system.n_atoms,
            route_ms=route_ms(ctx) if device.type == "cuda" else None)
        for m in bench["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            value = load_file_module(os.path.join(
                HERE, "metrics", m["name"] + ".py")).read(r)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        if prof is not None:
            dev_info.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
            breakdown = dict(device_ops=prof["device_ops"],
                             idle_gaps=prof["idle_gaps"])
    else:
        for name, value in (("ns_per_day", ns_per_day),
                            ("setup_s", setup_s)):
            metrics[name] = dict(value=value, unit=units[name])

    end = check.record_steps(ctx)
    del ctx
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rows, ctl = check.numbers(role("references", cfg["reference"]), t,
                              traffic, start, end, limits, device,
                              control=control)
    correct = check.is_correct(rows)
    result = dict(correct=correct, attempted=len(rows),
                  failed=sum(1 for row in rows
                             if not check.is_correct([row])),
                  metrics=metrics, device=dev_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control:
        result["control_readings"] = ctl
        limit = {name: lim for name, _, lim in rows}
        result["control_correct"] = check.is_correct(
            [(name, v, limit.get(name)) for name, v in ctl.items()])
    result["checks"] = {name: dict(value=v, limit=lim)
                        for name, v, lim in rows}
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    bench = load_json(ROOT, "BENCHMARK.json")
    chips = cell_spec(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] {args.workload} needs {chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}: no run on the CPU",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), bench=bench)
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"[check] correct {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
