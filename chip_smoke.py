#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     build every hand-written kernel (one nvcc per source, in parallel);
  2. kernel phase: the 19,500-atom polarizable-water system, its plist
     cache, and kernel B1 (force-only and energy) against its plain torch
     version on the same tensors, within the stated tolerances; B1 run
     twice more must be bitwise equal; both timed with CUDA events;
  3. slice phase: Context on the card with VVIntegrator(333, 10, 1, 40,
     0.001), setMaxDrudeDistance(0.02); step(20) warm-up, step(200) timed;
     every energy term and the kinetic energy finite; B1's launch count
     over the timed run >= 200; a 64-molecule system stepped 10 times on
     the card must track the same run on the CPU (plain versions);
  4. one JSON line {"kernels": [...]}, the card line, and as the last line
     {"ok": true, "device": {...}}.

Exits nonzero on any failure, without a CUDA device, or without the
package beside it.  It also profiles 20 steps with torch.profiler and
prints the device's busy time, kernels per step and the top kernels.
"""
import json
import statistics
import subprocess
import sys
import time

N_MOL = 4875            # 19,500 atoms: bench.py's headline system size
R_CUTOFF = 1.2          # bench.py's nonbondedCutoff
# kernel B1 vs its plain version: rsqrtf is ~2 ulp from torch.rsqrt and
# nvcc contracts multiply-adds, so the two agree to float32 rounding; the
# bounds are the JAX package's own pair-sweep tolerances
# (tests/test_pallas.py:179-182)
F_RTOL, F_ATOL = 1e-3, 5e-2
E_RTOL, E_ATOL = 5e-5, 0.05


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps=20):
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_phase(ctx):
    """B1 against its plain version at the main path's shapes."""
    import torch
    from openmm_velocityverlet_tpu_torch.ops import pair_plist as pp
    ev = ctx.evaluator
    st = ctx.state
    cache = ev.make_pair_cache(st.pos, st.box)
    n = st.pos.shape[0]
    pad = cache.perm.shape[0] - n
    pos2d = torch.cat([ev.place_vsites(st.pos),
                       torch.full((pad, 3), 1e6, device=st.pos.device)]
                      )[cache.perm].contiguous()
    kw = dict(ts=ev.pair_ts, t_dim=ev.pair_tables["arows"].shape[1],
              beta=ctx.system.ewald_beta, r_cutoff=ctx.system.r_cutoff,
              r_switch=ctx.system.r_switch, nowrap=ev.plist_nowrap)
    args = (cache.plist, cache.row_ptr, cache.col_ptr, cache.col_idx,
            pos2d, cache.q, cache.ab2, cache.ljt, cache.grp, cache.bits,
            cache.oid, st.box)
    n_active = int(((cache.plist & 1) == 1).sum())
    print(f"[kernel] n_pad={cache.perm.shape[0]} ts={ev.pair_ts} "
          f"sort={ev.plist_sort} nowrap={ev.plist_nowrap} "
          f"cap={cache.plist.shape[0]} active_entries={n_active} "
          f"overflow={bool(cache.overflow)}")
    result = {}
    for want_energy in (False, True):
        tag = "energy" if want_energy else "force"
        rows, colacc = pp.plist_pair(*args, want_energy=want_energy, **kw)
        rows_p, col_p = pp.plist_pair_reference(*args,
                                                want_energy=want_energy, **kw)
        torch.cuda.synchronize()
        err_rows = (rows[:, :3] - rows_p[:, :3]).abs()
        err_cols = (colacc - col_p).abs()
        max_abs = float(torch.maximum(err_rows.max(), err_cols.max()))
        ok_f = bool(torch.all(err_rows <= F_ATOL + F_RTOL
                              * rows_p[:, :3].abs())) and bool(
            torch.all(err_cols <= F_ATOL + F_RTOL * col_p.abs()))
        e_k = [float(rows[:, c].double().sum()) for c in (3, 4, 5)]
        e_p = [float(rows_p[:, c].double().sum()) for c in (3, 4, 5)]
        ok_e = all(abs(a - b) <= E_ATOL + E_RTOL * abs(b)
                   for a, b in zip(e_k, e_p))
        rel = float((err_rows / (rows_p[:, :3].abs() + 1.0)).max())
        print(f"[kernel] {tag}: max_abs_err={max_abs:.3e} "
              f"max_rel_err(|f|+1)={rel:.3e} energies kernel={e_k} "
              f"plain={e_p} (force rtol {F_RTOL} atol {F_ATOL}, energy "
              f"rtol {E_RTOL} atol {E_ATOL})")
        if not (ok_f and ok_e):
            raise AssertionError(f"kernel B1 ({tag}) disagrees with its "
                                 f"plain version beyond tolerance")
        again = [pp.plist_pair(*args, want_energy=want_energy, **kw)
                 for _ in range(2)]
        torch.cuda.synchronize()
        bitwise = all(torch.equal(r, rows) and torch.equal(c, colacc)
                      for r, c in again)
        print(f"[kernel] {tag}: bitwise equal over 3 runs: {bitwise}")
        if not bitwise:
            raise AssertionError("kernel B1 is documented as bitwise "
                                 "deterministic but two runs differ")
        ms = cuda_time_ms(lambda: pp.plist_pair(
            *args, want_energy=want_energy, **kw))
        plain_ms = cuda_time_ms(lambda: pp.plist_pair_reference(
            *args, want_energy=want_energy, **kw))
        print(f"[kernel] {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"(median of 20 CUDA-event timings each)")
        result[tag] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
    return result


def small_agreement():
    """A 64-molecule system, 10 steps on the card against the CPU run of
    the same code (plain versions): positions and energy terms agree."""
    import numpy as np
    from openmm_velocityverlet_tpu_torch import Context, VVIntegrator
    from openmm_velocityverlet_tpu_torch.models.drude_water import \
        drude_water_box
    system, pos, box = drude_water_box(64, r_cutoff=0.7)
    rng = np.random.default_rng(7)
    vel = rng.normal(0.0, 0.3, pos.shape) * (np.asarray(system.masses)
                                              > 0.5)[:, None]
    out = {}
    for dev in ("cpu", "cuda"):
        integ = VVIntegrator(333, 10, 1, 40, 0.001)
        integ.setMaxDrudeDistance(0.02)
        ctx = Context(system, integ, positions=pos, box=box, device=dev)
        ctx.set_velocities(vel)
        ctx.step(10)
        out[dev] = (ctx.get_positions(), ctx.potential_energy_terms())
    dpos = float(np.abs(out["cuda"][0] - out["cpu"][0]).max())
    worst = max(abs(out["cuda"][1][k] - v) / (abs(v) + 1.0)
                for k, v in out["cpu"][1].items())
    print(f"[check] 64-molecule 10-step card vs CPU: max |dpos| = "
          f"{dpos:.3e} nm, max term diff/(|E|+1) = {worst:.3e}")
    if not (dpos < 1e-4 and worst < 1e-3):
        raise AssertionError("card run disagrees with the CPU run")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    from openmm_velocityverlet_tpu_torch import Context, VVIntegrator, kernels
    from openmm_velocityverlet_tpu_torch.models.drude_water import \
        drude_water_box
    from openmm_velocityverlet_tpu_torch.ops import pair_plist as pp
    from openmm_velocityverlet_tpu_torch.units import ns_per_day

    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    report = kernels.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s for "
          f"{sorted(report) or 'cached libraries'}")
    for name, log in report.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    t0 = time.perf_counter()
    system, pos, box = drude_water_box(N_MOL, r_cutoff=R_CUTOFF)
    integ = VVIntegrator(333, 10, 1, 40, 0.001)
    integ.setMaxDrudeDistance(0.02)
    ctx = Context(system, integ, positions=pos, box=box, device="cuda")
    ctx.set_velocities_to_temperature(333.0)
    print(f"[setup] {system.n_atoms} atoms, box {box[0]:.3f} nm, "
          f"kmax {system.kmax}, beta {system.ewald_beta:.4f}, "
          f"{time.perf_counter() - t0:.1f} s")

    kres = kernel_phase(ctx)

    t0 = time.perf_counter()
    ctx.step(20)
    torch.cuda.synchronize()
    print(f"[slice] warm-up step(20) {time.perf_counter() - t0:.3f} s, "
          f"kinetic {ctx.kinetic_energy():.1f}")
    pp.plist_pair.launches = 0
    syncs0, cov0 = ctx.host_syncs, ctx.coverage_rebuilds
    t0 = time.perf_counter()
    ctx.step(200)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = pp.plist_pair.launches
    sps = 200 / elapsed
    print(f"[slice] 200 steps in {elapsed:.4f} s: {sps:.2f} steps/s, "
          f"{ns_per_day(sps, integ.getStepSize()):.3f} ns/day on {card}")
    print(f"[slice] B1 launches {launches}; coverage rebuilds "
          f"{ctx.coverage_rebuilds - cov0} (since start "
          f"{ctx.coverage_rebuilds}); cache rebuilds {ctx.rebuilds}; "
          f"pair-list refits {ctx.refits}; host syncs/step "
          f"{(ctx.host_syncs - syncs0) / 200:.3f}")
    if launches < 200:
        raise AssertionError(f"B1 launched {launches} < 200 times")
    terms = ctx.potential_energy_terms()
    ke = ctx.kinetic_energy()
    print(f"[slice] terms {terms} kinetic {ke}")
    if not (all(np.isfinite(v) for v in terms.values()) and np.isfinite(ke)):
        raise AssertionError("non-finite energy after the timed run")
    pos_now = ctx.get_positions()
    if pos_now.shape != (system.n_atoms, 3) or not np.isfinite(pos_now).all():
        raise AssertionError("bad positions after the timed run")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ctx.step(20)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels_ev = [e for e in events if e.device_type.name == "CUDA"]
    dev_us = sum(e.self_device_time_total for e in kernels_ev)
    n_kernels = sum(e.count for e in kernels_ev)
    busy_ms = dev_us / 1e3 / 20
    step_ms = elapsed / 200 * 1e3
    print(f"[profile] device busy {busy_ms:.3f} ms/step (kernel time of 20 "
          f"profiled steps), {n_kernels / 20:.0f} kernels/step; against the "
          f"unprofiled {step_ms:.3f} ms/step the device idles "
          f"{100 * (1 - busy_ms / step_ms):.1f}% of the step")
    for e in sorted(kernels_ev, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile] {e.self_device_time_total / 20e3:8.4f} ms/step "
              f"{e.count / 20:6.1f}/step  {e.key[:90]}")

    small_agreement()

    f, e = kres["force"], kres["energy"]
    print(json.dumps({"kernels": [{
        "name": "plist_pair", "route": "cuda",
        "source": "openmm_velocityverlet_tpu_torch/csrc/plist_pair.cu",
        "replaces": "openmm_velocityverlet_tpu/ops/pallas_pair.py:1110",
        "launches": launches,
        "max_abs_err": max(f["max_abs_err"], e["max_abs_err"]),
        "ms": f["ms"], "plain_ms": f["plain_ms"],
        "energy_ms": e["ms"], "energy_plain_ms": e["plain_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
