#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     build every hand-written kernel (one nvcc per source, in parallel);
  2. kernel phases at 19,500 atoms, each kernel against its plain torch
     version on the same tensors within the stated tolerances, run twice
     more and required bitwise equal, and timed with CUDA events:
     B1 (plist sweep) on the main path's cache, then at tile sizes 32, 64,
     128 and 256 under both sort keys, on the start configuration and on
     jittered positions (pair evaluations after the column skip beside
     their host-side model, evaluations per pair within the cutoff, time,
     and the fit of time against evaluations and list slots that sizes
     ForceEvaluator's choice), and with its column skip held on a system
     of four-atom molecules with exclusions; B2 (upper-triangle sweep)
     in the band, band + far, odd and even full sweeps and with folded 1-4
     exceptions, on the layout the evaluator builds (the pair evaluations
     its skips leave, per pair within the cutoff), with excluded and 1-4
     pairs moved beyond the skip's reach, and over the admitted tile sizes;
     B4/B5 (fused reciprocal) beside the matmul route, both
     also against a float64 evaluation on 512 atoms; B3 (the
     rectangular sweep) through its path, direct_space_tiled(symmetric=
     False), and against B1's sweep of the same positions; B6-B8 (gathers)
     through their path, the gather tool's main(), then bitwise against
     their plain versions and torch.index_select, timed on the device
     (torch.profiler) beside the library call;
  3. path 1, the main path: Context with VVIntegrator(333, 10, 1, 40,
     0.001), setMaxDrudeDistance(0.02); step(20) warm-up, step(200) timed,
     B1 launched >= 200 times;
  4. path 2, Context(fold_exc14=True) (the z band, kernel B2), and path 3,
     Context(strict_pairs=True, recip="exact_fused") (B1 with B2 as the
     exact fallback, B4/B5): step(20), then step(100) timed, B2 resp. B4
     and B5 launched >= 100 times;
  5. path 4, the middle scheme with partitioned Langevin on the last
     quarter of the molecules and an E-field of 0.5 V/nm on the cores of
     the others (the __graft_entry__._drude_system wiring), and path 5, the
     vanilla VV scheme (setUseMiddleScheme(False)) with cosine acceleration
     0.02 nm/ps^2: step(20), then step(100) timed; B1 launched >= 100 times
     on path 4 and exactly once a step on path 5 (its force carry), once
     more after set_velocities; path 4 then steps on to 1000 steps, its
     Langevin group's kinetic temperature over steps 500-1000 within 10% of
     333 K; get_viscosity() finite;
  6. for each path every energy term and the kinetic energy finite, a
     torch.profiler summary of 20 more steps (device busy time, kernels per
     step, top kernels), and a 64-molecule system stepped 10 times on the
     card tracking the same run on the CPU (plain versions; path 4 without
     its Langevin subset, whose noise streams differ between the two);
  7. one JSON line {"kernels": [...]}, the card line, and as the last line
     {"ok": true, "device": {...}}.

Exits nonzero on any failure, without a CUDA device, or without the
package beside it.
"""
import functools
import json
import statistics
import subprocess
import sys
import time

N_MOL = 4875            # 19,500 atoms: bench.py's headline system size
DEVICE = "cuda"
R_CUTOFF = 1.2          # bench.py's nonbondedCutoff
# pair kernels vs their plain versions: rsqrtf is ~2 ulp from torch.rsqrt
# and nvcc contracts multiply-adds, so the two agree to float32 rounding;
# the bounds are the JAX package's own pair-sweep tolerances: forces
# (tests/test_pallas.py:105-107, 179-182), energies rtol 2e-5 (:105-107;
# 5e-5 with folded 1-4 exceptions, :397-400) with the atol 0.05 its
# summation-order cases allow (:127-131, 179-182)
F_RTOL, F_ATOL = 1e-3, 5e-2
E_RTOL, E_ATOL = 2e-5, 0.05
E14_RTOL = 5e-5
# fused reciprocal vs its plain version (tests/test_ewald_fused.py:36,52-53)
RECIP_E_RTOL, RECIP_F_ATOL_REL, RECIP_F_RTOL = 2e-5, 3e-5, 2e-4
# the card's peaks (NVIDIA H100 SXM data sheet): FP32 outside the tensor
# cores, and HBM bandwidth
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
# FP32 operations per pair of the force-only specialization, counted in
# csrc/plist_pair.cu and csrc/tri_pair.cu (rsqrtf, rintf and min/max count
# one each): minimum image 12, r^2 5, qq 1, LJ 14, Chebyshev polynomial 20,
# Coulomb 5, masks and sums 13
PAIR_OPS = 70
# FP32 operations per (atom, k) phase of the cheapest known form of each
# function, the factorised one (the k list is a lattice, so e^{i k.r} =
# ex[nx] ey[ny] ez[nz] with q folded into the (nx, ny) factor once a
# column; the per-atom tables are O(kmax) and not counted): the phase
# e = exy * ez[nz] is 2 multiplies and 2 multiply-adds (6); then B4 adds it
# to S_re, S_im (2; its kernel folds the product and the sum into four
# multiply-adds, the same 8), and B5 takes g = a c - b s (3), G += g (1) and
# Gz += g nz (2).  A multiply-add counts 2, as in the card's 67 TFLOP/s.
B4_OPS, B5_OPS = 8, 12
# FP32 operations per pair within the cutoff in csrc/rect_pair.cu (the
# count is in its header: each pair from both sides, energy form)
RECT_OPS = 73
# path 4: the Langevin group's kinetic temperature in the frame of the
# group's own drift (the E-field pushes the other molecules along z, which
# drag the Langevin group into a steady drift), averaged over steps 500 to
# 1000, within this fraction of the 333 K target.  Steps 500 on: the lattice
# start melts and heats everything to ~500 K within 100 steps, and the OU
# map relaxes in 1/gamma = 0.2 ps = 200 steps.
LD_T_BAND = 0.1


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


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(ops, n_bytes):
    """(bound_ms, bound_by): the larger of operations over the FP32 peak
    and bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cutoff_pairs(pos, box, r_cutoff, block=1024):
    """Atom pairs i < j within the cutoff under the minimum image: the
    pairs a direct-space sweep must evaluate on these positions, whatever
    tile pairs its enumeration visits.  The pair kernels' bounds count
    these."""
    import torch
    n = pos.shape[0]
    box = box.reshape(1, 1, 3)
    j = torch.arange(n, device=pos.device)[None, :]
    total = 0
    for s in range(0, n, block):
        d = pos[s:s + block, None, :] - pos[None, :, :]
        d = d - box * torch.round(d / box)
        r2 = (d * d).sum(-1)
        i = torch.arange(s, min(s + block, n), device=pos.device)[:, None]
        total += int(((r2 < r_cutoff * r_cutoff) & (j > i)).sum())
    return total


def pair_agreement(tag, out, ref, e_rtol, cols=range(3, 8)):
    """Forces (rows 0..2 and the column reaction) of every atom and the
    energy sums of a pair kernel against its plain version; raises beyond
    tolerance."""
    import torch
    (rows, colacc), (rows_p, col_p) = out, ref
    f, f_p = rows[:, :3], rows_p[:, :3]
    g, g_p = colacc, col_p
    err_rows = (f - f_p).abs()
    err_cols = (g - g_p).abs()
    max_abs = float(torch.maximum(err_rows.max(), err_cols.max()))
    ok_f = bool(torch.all(err_rows <= F_ATOL + F_RTOL * f_p.abs())) \
        and bool(torch.all(err_cols <= F_ATOL + F_RTOL * g_p.abs()))
    e_k = [float(rows[:, c].double().sum()) for c in cols]
    e_p = [float(rows_p[:, c].double().sum()) for c in cols]
    ok_e = all(abs(a - b) <= E_ATOL + e_rtol * abs(b)
               for a, b in zip(e_k, e_p))
    print(f"[kernel] {tag}: max_abs_err={max_abs:.3e} energies kernel="
          f"{[round(e, 4) for e in e_k]} plain={[round(e, 4) for e in e_p]}"
          f" (force rtol {F_RTOL} atol {F_ATOL}, energy rtol {e_rtol} atol "
          f"{E_ATOL})")
    if not (ok_f and ok_e):
        raise AssertionError(f"{tag}: kernel disagrees with its plain "
                             f"version beyond tolerance")
    return max_abs


def check_pair_kernel(tag, kernel, plain, e_rtol, cols=range(3, 8)):
    """Agreement, bitwise repeatability over 3 runs and CUDA-event times of
    one pair-kernel call; returns (max_abs_err, ms, plain_ms)."""
    import torch
    out = kernel()
    ref = plain()
    torch.cuda.synchronize()
    max_abs = pair_agreement(tag, out, ref, e_rtol, cols)
    again = [kernel() for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(r, out[0]) and torch.equal(c, out[1])
               for r, c in again):
        raise AssertionError(f"{tag}: two runs of a kernel documented as "
                             f"bitwise deterministic differ")
    ms, plain_ms = cuda_time_ms(kernel), cuda_time_ms(plain, reps=5)
    print(f"[kernel] {tag}: bitwise equal over 3 runs; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms (median of CUDA-event timings)")
    return max_abs, ms, plain_ms


def b1_case(tag, ev, cache, pos, box, system, timed=True):
    """Kernel B1 over one cache against its plain version, both
    specializations: agreement, bitwise over 3 runs, the pair evaluations
    the kernel made after its column skip; with ``timed`` also CUDA-event
    and device times.  Returns {"force"/"energy": (max_abs_err, ms,
    plain_ms, device_ms)}, evaluations and the call's tensors."""
    import torch
    from openmm_velocityverlet_tpu_torch.ops import pair_plist as pp
    n = pos.shape[0]
    pad = cache.perm.shape[0] - n
    pos2d = torch.cat([ev.place_vsites(pos),
                       torch.full((pad, 3), 1e6, device=pos.device)]
                      )[cache.perm].contiguous()
    kw = dict(ts=ev.pair_ts, t_dim=ev.pair_tables["arows"].shape[1],
              beta=system.ewald_beta, r_cutoff=system.r_cutoff,
              r_switch=system.r_switch, nowrap=ev.plist_nowrap)
    args = (cache.plist, cache.row_ptr, cache.col_ptr, cache.col_idx,
            pos2d, cache.q, cache.ab2, cache.ljt, cache.grp, cache.bits,
            cache.oid, box)
    blocks = (cache.blk_tile, cache.blk_e0, cache.blk_ptr)
    if bool(cache.overflow):
        raise AssertionError(f"{tag}: the list sized for these positions "
                             f"is flagged")
    res = {}
    for want_energy in (False, True):
        spec = "energy" if want_energy else "force"

        def kernel():
            return pp.plist_pair(*args, want_energy=want_energy,
                                 blocks=blocks, **kw)

        def plain():
            return pp.plist_pair_reference(*args, want_energy=want_energy,
                                           **kw)
        if timed:
            err, ms, plain_ms = check_pair_kernel(
                f"{tag} {spec}", kernel, plain, 5e-5, cols=(3, 4, 5))
            res[spec] = (err, ms, plain_ms, device_ms(kernel, calls=20))
        else:
            out, ref = kernel(), plain()
            torch.cuda.synchronize()
            err = pair_agreement(f"{tag} {spec}", out, ref, 5e-5,
                                 cols=(3, 4, 5))
            if not all(torch.equal(r, out[0]) and torch.equal(c, out[1])
                       for r, c in (kernel(), kernel())):
                raise AssertionError(f"{tag} {spec}: two runs differ")
            res[spec] = (err, None, None, None)
    evals = torch.zeros(1, dtype=torch.int64, device=pos.device)
    rows, colacc = pp.plist_pair(*args, blocks=blocks, evals=evals, **kw)
    return res, int(evals), args + (rows, colacc)


def sized_evaluator(system, pos, box, ts, sort=None):
    """A plist ForceEvaluator at tile size ``ts`` with its list sized for
    ``pos`` (numpy); ``sort`` overrides the sort key it would choose."""
    from openmm_velocityverlet_tpu_torch import ForceEvaluator
    from openmm_velocityverlet_tpu_torch.ops import pair_plist as pp
    ev = ForceEvaluator(system, box_hint=box, pos_hint=pos, pair_ts=ts,
                        device=DEVICE)
    if sort is not None and sort != ev.plist_sort:
        rc_cand = system.r_cutoff + ev.skin
        ev.plist_sort = sort
        cnt = pp.count_candidates_np(pos, box, ts, rc_cand, mode=sort,
                                     inert=ev._inert_mask)
        n_tiles = -(-system.n_atoms // ts)
        ev.plist_cap = min(n_tiles * (n_tiles + 1) // 2, int(cnt * 1.6) + 64)
        ev.plist_nowrap = pp.nowrap_axes_np(pos, box, ts, rc_cand, mode=sort)
    return ev


def b1_phase(ctx, system, pos):
    """B1 against its plain version at the main path's shapes; then over
    the admitted tile sizes and both sort keys on the same positions and on
    jittered ones; then its column skip where excluded pairs exist."""
    import numpy as np
    import torch
    from openmm_velocityverlet_tpu_torch.forces import PLIST_SLOT_COST
    from openmm_velocityverlet_tpu_torch.ops import pair_plist as pp
    dev = torch.device(DEVICE)
    ev = ctx.evaluator
    st = ctx.state
    cache = ev.make_pair_cache(st.pos, st.box)
    n_active = int(((cache.plist & 1) == 1).sum())
    print(f"[kernel] B1: n_pad={cache.perm.shape[0]} ts={ev.pair_ts} "
          f"sort={ev.plist_sort} nowrap={ev.plist_nowrap} "
          f"cap={cache.plist.shape[0]} active_entries={n_active} "
          f"overflow={bool(cache.overflow)}")
    res, evals, tensors = b1_case("B1", ev, cache, st.pos, st.box, system)
    pairs = cutoff_pairs(ev.place_vsites(st.pos), st.box, system.r_cutoff)
    b_ms, b_by = bound(pairs * PAIR_OPS, nbytes(*tensors))
    print(f"[kernel] B1: {n_active * ev.pair_ts ** 2 / 1e6:.1f} M pair slots "
          f"in its list, {evals / 1e6:.2f} M pair evaluations after the "
          f"column skip, {pairs / 1e6:.3f} M pairs within the cutoff "
          f"({evals / pairs:.2f} evaluations a pair); device time "
          f"{res['force'][3]:.4f} ms force, {res['energy'][3]:.4f} ms "
          f"energy; bound on the cutoff pairs {b_ms:.4f} ms ({b_by}); on "
          f"its own evaluations {bound(evals * PAIR_OPS, 0)[0]:.4f} ms")

    # the tile sizes and sort keys ForceEvaluator chooses from, on the
    # start configuration and on jittered positions (wide tiles, Drudes off
    # their cores: what the list looks like once the lattice has melted)
    box = np.asarray(ctx.get_box())
    pos_j = jittered_positions(pos)
    pos_jd = torch.as_tensor(pos_j, device=dev)
    pairs_j = cutoff_pairs(pos_jd, st.box, system.r_cutoff)
    worst = max(res["force"][0], res["energy"][0])
    points = []
    for tag, p_np, p_d, n_pairs, cases in (
            ("start", pos, st.pos, pairs,
             ((32, "morton"), (64, "morton"), (64, "z"), (128, "morton"),
              (128, "z"), (256, "z"))),
            ("jittered", pos_j, pos_jd, pairs_j,
             ((32, "morton"), (64, "morton"), (128, "morton"), (128, "z")))):
        for ts, sort in cases:
            ev_s = sized_evaluator(system, p_np, box, ts, sort)
            cache_s = ev_s.make_pair_cache(p_d, st.box)
            entries = int(((cache_s.plist & 1) == 1).sum())
            flagged = int(((cache_s.plist & 3) == 3).sum())
            r, ev_n, _ = b1_case(f"B1 {tag} ts={ts} {sort}", ev_s, cache_s,
                                 p_d, st.box, system)
            model = pp.count_evaluations_np(
                p_np, box, ts, system.r_cutoff + ev_s.skin, system.r_cutoff,
                mode=sort, inert=ev_s._inert_mask)[1]
            print(f"[kernel] B1 sweep: {tag} ts={ts} sort={sort} nowrap="
                  f"{ev_s.plist_nowrap} entries={entries} ({flagged} with "
                  f"exclusions) slots={entries * ts * ts / 1e6:.1f} M "
                  f"evaluations="
                  f"{ev_n / 1e6:.2f} M ({ev_n / n_pairs:.2f} a cutoff pair; "
                  f"the host-side model {model / 1e6:.2f} M) force: "
                  f"{r['force'][1]:.4f} ms by CUDA events, "
                  f"{r['force'][3]:.4f} ms device; energy: "
                  f"{r['energy'][1]:.4f} / {r['energy'][3]:.4f} ms; "
                  f"max_abs_err {max(r['force'][0], r['energy'][0]):.3e}; "
                  f"bitwise equal over 3 runs")
            points.append((ev_n, entries * ts * ts, r["force"][3]))
            worst = max(worst, r["force"][0], r["energy"][0])
    a_fit, b_fit, c_fit = np.linalg.lstsq(
        np.array([[p[0], p[1], 1.0] for p in points]),
        np.array([p[2] for p in points]), rcond=None)[0]
    print(f"[kernel] B1 sweep: device ms = {a_fit * 1e6:.5f} per M "
          f"evaluations + {b_fit * 1e6:.5f} per M slots + {c_fit:.4f}: a "
          f"slot costs {b_fit / a_fit:.3f} evaluations (forces.py takes "
          f"{PLIST_SLOT_COST})")

    # the column skip where excluded pairs exist: four-atom molecules
    s14, pos14, box14 = exc14_system(N_MOL)
    pos14d = torch.as_tensor(pos14, device=dev)
    box14d = torch.as_tensor(box14, dtype=torch.float32, device=dev)
    for ts in (32, 64, 128):
        ev_s = sized_evaluator(s14, pos14, box14, ts)
        cache_s = ev_s.make_pair_cache(pos14d, box14d)
        r, ev_n, _ = b1_case(f"B1 exclusions ts={ts}", ev_s, cache_s, pos14d,
                             box14d, s14, timed=False)
        flagged = int(((cache_s.plist & 3) == 3).sum())
        print(f"[kernel] B1 skip gate: exclusions ts={ts} sort="
              f"{ev_s.plist_sort} nowrap={ev_s.plist_nowrap}: "
              f"{int(((cache_s.plist & 1) == 1).sum())} entries ({flagged} "
              f"with exclusions), {ev_n / 1e6:.2f} M evaluations; both forms "
              f"within tolerance of the plain version, which skips nothing; "
              f"bitwise equal over 3 runs")
        worst = max(worst, r["force"][0], r["energy"][0])
    return res, b_ms, b_by, evals, pairs, worst


def jittered_positions(pos, seed=1):
    """Thermal-like jitter with every Drude particle 0.05 nm from its core.
    drude_water puts it on the core, and the energy form's excluded-pair
    force -qq (erf(beta r)/r - gauss)/r^2 cancels in float32 as r -> 0: its
    rounding is ~0.5 kJ/mol/nm at 0.012 nm and below 0.03 at 0.05 nm (float32
    against float64 of pair_plist.pair_math, beta 2.6-3.8), so at 0.05 nm
    every atom's force is compared within the pair tolerances."""
    import numpy as np
    rng = np.random.default_rng(seed)
    p = pos + rng.normal(0, 0.01, pos.shape)
    d = rng.normal(size=(pos.shape[0] // 4, 3))
    d *= 0.05 / np.linalg.norm(d, axis=1, keepdims=True)
    p[1::4] = p[0::4] + d
    return p.astype(np.float32)


def exc14_system(n_mol, seed=3):
    """n_mol four-atom molecules in the layout of
    tests/test_pallas.py:362-400 (consecutive members, full intramolecular
    exclusions, a regular 1-4 exception on the first and last atom), here
    as chains of 0.12 nm bonds in random directions on the drude_water
    lattice, built with the port's SystemBuilder.  Not a model of the
    package: it exists to run kernel B2 with folded 1-4 exceptions at
    19,500 atoms."""
    import numpy as np
    from openmm_velocityverlet_tpu_torch import SystemBuilder
    rng = np.random.default_rng(seed)
    b = SystemBuilder()
    side = int(np.ceil(n_mol ** (1.0 / 3.0)))
    spacing = 0.55
    box = np.array([side * spacing] * 3)
    sig, eps = [0.30, 0.25, 0.35], [0.5, 0.2, 0.8]
    pos = []
    for m in range(n_mol):
        c = (np.array([m % side, (m // side) % side, m // side ** 2]) + 0.5
             ) * spacing
        types = rng.integers(0, 3, 4)
        qs = rng.normal(0, 0.4, 4)
        ids = [b.add_particle(12.0, charge=float(qs[k]), lj_type=int(types[k]))
               for k in range(4)]
        u = rng.normal(size=3)
        pos += [c + (k - 1.5) * 0.12 * u / np.linalg.norm(u)
                for k in range(4)]
        for i in range(4):
            for j in range(i + 1, 4):
                b.add_exclusion(ids[i], ids[j])
        t0, t3 = sorted((int(types[0]), int(types[3])))
        b.add_exception(ids[0], ids[3], 0.5 * float(qs[0] * qs[3]),
                        0.5 * (sig[t0] + sig[t3]),
                        0.5 * np.sqrt(eps[t0] * eps[t3]))
    b.set_lj_from_type_params(sig, eps)
    system = b.finalize(box, r_cutoff=R_CUTOFF, use_pme=True)
    return system, np.asarray(pos, np.float32), box


def b2_phase(ctx1, system, pos):
    """B2 against its plain version at 19,500 atoms in every enumeration
    the paths take, on the layout the evaluator builds (strips inside each
    z-sorted tile, with its chunk-pair bitmap); the pair evaluations left by
    its skips; a case whose excluded and 1-4 pairs lie beyond the skip's
    reach; the admitted tile sizes beside the host-side model.  Returns the
    bandall force-only numbers (path 2's call) and the worst error over all
    cases."""
    import numpy as np
    import torch
    from openmm_velocityverlet_tpu_torch import ForceEvaluator
    from openmm_velocityverlet_tpu_torch.forces import BAND_TILE_SIZES
    from openmm_velocityverlet_tpu_torch.ops import pair_tri as pt
    dev = torch.device(DEVICE)
    pos = jittered_positions(pos)
    box = np.asarray(ctx1.get_box())
    posd = torch.as_tensor(pos, device=dev)
    boxd = torch.as_tensor(box, dtype=torch.float32, device=dev)
    n = posd.shape[0]
    beta, rc = system.ewald_beta, system.r_cutoff
    ev2 = ForceEvaluator(system, fold_exc14=True, box_hint=box,
                         pos_hint=pos, device=DEVICE)
    ts2, w2 = ev2.pair_ts, ev2.band_w
    print(f"[kernel] B2: the band evaluator picks ts={ts2}, band_w={w2}, "
          f"{pt.padded_size(n, ts2) // ts2} tiles, eligible "
          f"{pt.band_eligible(pt.padded_size(n, ts2), ts2, w2)}")

    def layout(tables, ts, z_sorted, charges, p=posd, b=boxd):
        """(operands, cmap) of one layout of positions ``p``."""
        n_pad = pt.padded_size(p.shape[0], ts)
        st = pt.band_statics(charges, tables, n_pad, dev)
        if z_sorted:
            f = pt.make_pair_cache(p, b, charges, tables, ts, statics=st,
                                   inner_order=True)
            oid, perm = f.oid, f.perm
        else:
            f = pt.BandCache(perm=None, invperm=None, oid=None, **st)
            perm = torch.arange(n_pad, device=dev)
            oid = perm.to(torch.int32)
        p2 = torch.cat([p, torch.full((n_pad - p.shape[0], 3), 1e6,
                                      device=dev)])[perm].contiguous()
        return (p2, f.q, f.ab, f.bits, f.bits14, oid, f.ljt, f.grp, f.grows,
                b), f.cmap

    t_dim = ev2.pair_tables["arows"].shape[1]
    plist_cache = ctx1.evaluator.make_pair_cache(posd, boxd)
    pad1 = plist_cache.perm.shape[0] - n
    p1 = torch.cat([posd, torch.full((pad1, 3), 1e6, device=dev)]
                   )[plist_cache.perm].contiguous()
    ts1 = ctx1.evaluator.pair_ts
    cases = [
        ("bandall", layout(ev2.pair_tables, ts2, True, system.charges),
         ts2, [("bandall", w2, False)], False),
        ("band+far", layout(ev2.pair_tables, ts2, False, system.charges),
         ts2, [("band", 0, False), ("far", 0, False)], False),
        # the strict fallback's call: the plist layout, the bitmap built by
        # the wrapper
        ("full_sweep odd", ((p1, plist_cache.q, plist_cache.ab,
                             plist_cache.bits, plist_cache.bits,
                             plist_cache.oid, plist_cache.ljt,
                             plist_cache.grp, plist_cache.grows, boxd), None),
         ts1, [("bandall", (plist_cache.perm.shape[0] // ts1) // 2, True)],
         False),
        # the unsorted layout: every tile spans the box, so the tile pairs
        # at offset n_tiles / 2, which the dedup guard keeps once, interact
        ("full_sweep even", layout(ev2.pair_tables, 768, False,
                                   system.charges),
         768, [("bandall", (pt.padded_size(n, 768) // 768) // 2, True)],
         False),
    ]
    s14, pos14, box14 = exc14_system(N_MOL)
    ev14 = ForceEvaluator(s14, fold_exc14=True, box_hint=box14,
                          pos_hint=pos14, device=DEVICE)
    if not ev14.pair_tables["has_exc14"]:
        raise AssertionError("the 1-4 system folded no exception")
    box14d = torch.as_tensor(box14, dtype=torch.float32, device=dev)
    # the same chains with each one's last atom 2.5 nm away, at the body
    # centre of a lattice cell 4.5 cells along x (clear of the other chains):
    # its excluded and 1-4 partners lie beyond the cutoff and any chunk's
    # patch, so only the chunk-pair bitmap keeps them in the sweep
    pos14_far = pos14.copy()
    pos14_far[3::4] += np.array([4.5, 0.5, 0.5], np.float32) * 0.55
    for name, p14 in (("has14", pos14), ("has14 beyond reach", pos14_far)):
        cases.append((name, layout(ev14.pair_tables, ev14.pair_ts, True,
                                   s14.charges,
                                   torch.as_tensor(p14, device=dev), box14d),
                      ev14.pair_ts, [("bandall", ev14.band_w, False)], True))
    worst, main = 0.0, None
    for name, (args, cmap), ts, enums, has14 in cases:
        for mode, w, full in enums:
            n_tiles = args[0].shape[0] // ts
            n_pairs = len(pt.tile_pairs(mode, n_tiles, w, full)[0])
            print(f"[kernel] B2 {name}: mode {mode}, ts {ts}, {n_tiles} "
                  f"tiles, band_w {w}, full_sweep {full}, has14 {has14}, "
                  f"{n_pairs} tile pairs")
            for want_energy in (False, True):
                kw = dict(ts=ts, t_dim=t_dim if not has14 else
                          ev14.pair_tables["arows"].shape[1],
                          beta=beta if not has14 else s14.ewald_beta,
                          r_cutoff=rc, mode=mode, band_w=w, full_sweep=full,
                          want_energy=want_energy, has14=has14)
                spec = "energy" if want_energy else "force"
                tag = f"B2 {name}/{mode} {spec}"

                def kernel(evals=None):
                    return pt.tri_pair(*args, cmap=cmap, evals=evals, **kw)

                err, ms, plain_ms = check_pair_kernel(
                    tag, kernel, lambda: pt.tri_pair_reference(*args, **kw),
                    E14_RTOL if has14 else E_RTOL)
                worst = max(worst, err)
                if want_energy:
                    if name == "bandall":
                        main.update(energy_ms=ms, energy_plain_ms=plain_ms,
                                    energy_device_ms=device_ms(kernel,
                                                               calls=20))
                    continue
                evals = torch.zeros(1, dtype=torch.int64, device=dev)
                rows, colacc = kernel(evals)
                pairs = cutoff_pairs(args[0][args[6] >= 0], args[9], rc)
                slots = n_pairs * ts * ts
                t_dev = device_ms(kernel, calls=20)
                print(f"[kernel] B2 {name}/{mode}: {slots / 1e6:.1f} M pair "
                      f"slots in its enumeration, {int(evals) / 1e6:.2f} M "
                      f"pair evaluations after its skips, {pairs / 1e6:.3f} "
                      f"M pairs within the cutoff in the system "
                      f"({int(evals) / pairs:.2f} evaluations a pair); "
                      f"device time {t_dev:.4f} ms")
                if name == "has14 beyond reach":
                    marked = int(pt.chunk_pair_marked(cmap).sum())
                    print(f"[kernel] B2 {name}: each chain's 3 excluded "
                          f"pairs and its 1-4 pair with the moved atom lie "
                          f"2.5 nm apart (cutoff {rc} nm); {marked} of "
                          f"{cmap.shape[0] ** 2} chunk pairs are marked and "
                          f"skip nothing")
                if name == "bandall":
                    b_ms, b_by = bound(pairs * PAIR_OPS,
                                       nbytes(*args, rows, colacc))
                    main = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=b_by, evaluations=int(evals),
                                cutoff_pairs=pairs, tile_size=ts,
                                device_ms=t_dev)
                    print(f"[kernel] B2 bandall: device time "
                          f"{main['device_ms']:.4f} ms force; bound on the "
                          f"cutoff pairs {b_ms:.4f} ms ({b_by}); on its own "
                          f"evaluations "
                          f"{bound(int(evals) * PAIR_OPS, 0)[0]:.4f} ms")
    # the tile sizes the band evaluator chooses from, on the same positions
    for ts in BAND_TILE_SIZES:
        ev_s = ForceEvaluator(system, fold_exc14=True, box_hint=box,
                              pos_hint=pos, pair_ts=ts, device=DEVICE)
        args, cmap = layout(ev_s.pair_tables, ts, True, system.charges)
        kw = dict(ts=ts, t_dim=t_dim, beta=beta, r_cutoff=rc, mode="bandall",
                  band_w=ev_s.band_w, want_energy=False)
        evals = torch.zeros(1, dtype=torch.int64, device=dev)
        out = pt.tri_pair(*args, cmap=cmap, evals=evals, **kw)
        ref = pt.tri_pair_reference(*args, **kw)
        torch.cuda.synchronize()
        worst = max(worst, pair_agreement(f"B2 sweep ts={ts}", out, ref,
                                          E_RTOL))
        t_dev = device_ms(lambda: pt.tri_pair(*args, cmap=cmap, **kw),
                          calls=20)
        print(f"[kernel] B2 sweep: ts={ts} band_w={ev_s.band_w} evaluations="
              f"{int(evals) / 1e6:.2f} M "
              f"({int(evals) / main['cutoff_pairs']:.2f} a cutoff pair; the "
              f"evaluator's cost model {ev_s._band_cost(pos, box, ts, ev_s.band_w) / 1e6:.2f} M) "
              f"force: {t_dev:.4f} ms device")
    main["max_abs_err"] = worst
    return main


def recip_phase(ctx):
    """B4 and B5 against their plain versions on the 19,500-atom system,
    beside the main path's matmul route on the same inputs."""
    import torch
    from openmm_velocityverlet_tpu_torch.ops import ewald, ewald_fused as ef
    s = ctx.system
    pos = ctx.state.pos
    box = ctx.state.box
    q = ctx.evaluator.t.charges
    posp, qp, kvec, w, c0, n_pad, kp, kt = ef._prep(pos, box, q,
                                                    s.ewald_beta, s.kmax, 256)
    k_real = ef.k_tiling(s.kmax)[0]
    print(f"[kernel] B4/B5: n_pad={n_pad}, K={k_real} padded to {kp} "
          f"(k tile {kt}); {pos.shape[0] * k_real / 1e6:.0f} M phases a pass")

    def energy(s_re, s_im):
        return float((c0 * torch.sum(w.double() * (s_re.double() ** 2
                                                   + s_im.double() ** 2))))

    s_k = ef.structure_factor(posp, qp, kvec, s.kmax, box)
    s_p = ef.structure_factor_reference(posp, qp, kvec)
    ab = torch.stack([2.0 * c0 * w * s_k[1], 2.0 * c0 * w * s_k[0]]
                     ).contiguous()

    def b4():
        return ef.structure_factor(posp, qp, kvec, s.kmax, box)

    def b5():
        return ef.recip_forces(posp, qp, kvec, ab, s.kmax, box)

    f_k = b5()
    f_p = ef.recip_forces_reference(posp, qp, kvec, ab)
    torch.cuda.synchronize()
    e_k, e_p = energy(*s_k), energy(*s_p)
    # which of the two is closer to the function: a float64 evaluation of
    # the plain version on the first 512 atoms
    sub = slice(0, 512)
    f64 = ef.recip_forces_reference(posp[sub].double(), qp[sub].double(),
                                    kvec.double(), ab.double())
    s64 = ef.structure_factor_reference(posp[sub].double(), qp[sub].double(),
                                        kvec.double())
    s_sub = [ef.structure_factor(posp[sub].contiguous(),
                                 qp[sub].contiguous(), kvec, s.kmax, box),
             ef.structure_factor_reference(posp[sub], qp[sub], kvec)]
    s_errs = [max(float((t[c] - s64[c]).abs().max()) for c in range(2))
              for t in s_sub]
    print(f"[kernel] B4 against float64 on 512 atoms: max abs S error "
          f"kernel {s_errs[0]:.3e}, plain version {s_errs[1]:.3e} (max|S| "
          f"{float(torch.maximum(s64[0].abs().max(), s64[1].abs().max())):.3f})")
    print(f"[kernel] B5 against float64 on 512 atoms: max abs force error "
          f"kernel {float((f_k[sub] - f64).abs().max()):.3e}, plain version "
          f"{float((f_p[sub] - f64).abs().max()):.3e} (max|F| "
          f"{float(f64.abs().max()):.3f})")

    def f_ok(f, ref):
        scale = float(ref.abs().max())
        err = (f.double() - ref.double()).abs()
        return bool(torch.all(err <= RECIP_F_ATOL_REL * scale
                              + RECIP_F_RTOL * ref.double().abs())), \
            float(err.max())

    ok_e = abs(e_k - e_p) <= RECIP_E_RTOL * abs(e_p)
    ok_f, f_err = f_ok(f_k, f_p)
    print(f"[kernel] B4: energy kernel {e_k:.6f} plain {e_p:.6f} (rtol "
          f"{RECIP_E_RTOL}); B5: max abs force error {f_err:.3e} (atol "
          f"{RECIP_F_ATOL_REL} max|F| {float(f_p.abs().max()):.3f}, rtol "
          f"{RECIP_F_RTOL})")
    s_err = float(torch.maximum((s_k[0] - s_p[0]).abs().max(),
                                (s_k[1] - s_p[1]).abs().max()))
    if not (ok_e and ok_f):
        # float32 summation order alone may break the bounds at this N:
        # hold both against a float64 run of the plain version
        d = [t.double() for t in (posp, qp, kvec)]
        s64 = ef.structure_factor_reference(*d)
        f64 = ef.recip_forces_reference(*d, ab.double())
        e64 = energy(*s64)
        ok64 = all(abs(e - e64) <= RECIP_E_RTOL * abs(e64)
                   for e in (e_k, e_p)) and f_ok(f_k, f64)[0] \
            and f_ok(f_p, f64)[0]
        print(f"[kernel] B4/B5 beyond tolerance of the float32 plain "
              f"version; against a float64 plain run: energy kernel "
              f"{e_k - e64:+.3e}, plain {e_p - e64:+.3e}; forces kernel "
              f"{f_ok(f_k, f64)[1]:.3e}, plain {f_ok(f_p, f64)[1]:.3e}; "
              f"{'both within' if ok64 else 'NOT within'} tolerance")
        if not ok64:
            raise AssertionError("B4/B5 disagree with their plain versions")
    again = [(b4(), b5()) for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a[0], s_k[0]) and torch.equal(a[1], s_k[1])
               and torch.equal(f, f_k) for a, f in again):
        raise AssertionError("B4/B5 documented as bitwise deterministic but "
                             "two runs differ")
    t = dict(
        b4=cuda_time_ms(b4), b4_device=device_ms(b4, calls=20),
        b4_plain=cuda_time_ms(
            lambda: ef.structure_factor_reference(posp, qp, kvec), reps=5),
        b5=cuda_time_ms(b5), b5_device=device_ms(b5, calls=20),
        b5_plain=cuda_time_ms(
            lambda: ef.recip_forces_reference(posp, qp, kvec, ab), reps=5))

    def route(fn):
        def run():
            p = pos.detach().requires_grad_(True)
            e = fn(p)
            torch.autograd.grad(e, p)
        return run

    t["fused_route"] = cuda_time_ms(route(lambda p: ef.reciprocal_energy_fused(
        p, box, q, s.ewald_beta, s.kmax, 256)), reps=10)
    t["matmul_route"] = cuda_time_ms(route(lambda p: ewald.reciprocal_energy(
        p, box, q, s.ewald_beta, s.kmax, chunk=ctx.evaluator.ewald_chunk)),
        reps=10)
    print(f"[kernel] B4/B5: bitwise equal over 3 runs; B4 {t['b4']:.4f} ms "
          f"({t['b4_device']:.4f} ms device time; plain "
          f"{t['b4_plain']:.4f}), B5 {t['b5']:.4f} ms "
          f"({t['b5_device']:.4f} ms device time; plain "
          f"{t['b5_plain']:.4f}); energy + autograd forces: fused route "
          f"{t['fused_route']:.4f} ms, matmul route (ops/ewald.py) "
          f"{t['matmul_route']:.4f} ms")
    phases = pos.shape[0] * k_real
    t["b4_bound"] = bound(phases * B4_OPS, nbytes(posp, qp, kvec, *s_k))
    t["b5_bound"] = bound(phases * B5_OPS, nbytes(posp, qp, kvec, ab, f_k))
    print(f"[kernel] B4 bound {t['b4_bound'][0]:.4f} ms, B5 bound "
          f"{t['b5_bound'][0]:.4f} ms ({t['b4_bound'][1]})")
    t["b4_err"] = s_err
    t["b5_err"] = f_err
    return t


def b3_phase(ctx1, system, pos):
    """B3 through its path, direct_space_tiled(symmetric=False), at 19,500
    atoms (each Drude 0.05 nm from its core): the launch count of that one
    call; the kernel against its plain version on the same operands, bitwise
    over 3 runs and timed; the path's forces and energies against B1's
    energy sweep of the same positions (the same function)."""
    import numpy as np
    import torch
    from openmm_velocityverlet_tpu_torch import ForceEvaluator
    from openmm_velocityverlet_tpu_torch.ops import pair_plist as pp
    from openmm_velocityverlet_tpu_torch.ops import pair_rect as pr
    from openmm_velocityverlet_tpu_torch.ops import pair_tri as pt
    from openmm_velocityverlet_tpu_torch.ops.pair_direct import \
        direct_space_tiled
    dev = torch.device(DEVICE)
    ev = ctx1.evaluator
    tables = ev.pair_tables
    beta, rc = system.ewald_beta, system.r_cutoff
    posd = torch.as_tensor(jittered_positions(pos), device=dev)
    boxd = torch.as_tensor(np.asarray(ctx1.get_box()), dtype=torch.float32,
                           device=dev)
    n = posd.shape[0]

    pr.rect_pair.launches = 0
    out = direct_space_tiled(posd, boxd, system.charges, tables, beta, rc,
                             symmetric=False)
    torch.cuda.synchronize()
    launches = pr.rect_pair.launches
    print(f"[kernel] B3 path: direct_space_tiled(symmetric=False) launched "
          f"B3 {launches} time(s)")
    if launches != 1:
        raise AssertionError("direct_space_tiled(symmetric=False) did not "
                             "launch B3 once")

    blk = 512                      # max(tm, tn) at the defaults
    n_pad = pt.padded_size(n, blk)
    st = pt.band_statics(system.charges, tables, n_pad, dev)
    p2 = torch.cat([posd, torch.full((n_pad - n, 3), 1e6, device=dev)]
                   ).contiguous()
    args = (p2, st["q"], st["ab"], st["bits"], st["ljt"], st["grp"],
            st["grows"], boxd)
    kw = dict(n=n, t_dim=tables["arows"].shape[1], beta=beta, r_cutoff=rc,
              r_switch=system.r_switch)
    z = torch.zeros((8, 1), device=dev)
    print(f"[kernel] B3: n={n} n_pad={n_pad}, "
          f"{n_pad * n_pad / 1e6:.1f} M pair evaluations a call")
    err, ms, plain_ms = check_pair_kernel(
        "B3", lambda: (pr.rect_pair(*args, **kw), z),
        lambda: (pr.rect_pair_reference(*args, **kw), z), E_RTOL,
        cols=(3, 4, 5))

    # B1's list sized for these positions: the main path's list was sized
    # on the lattice, and on the jittered positions it would overflow
    ev1 = ForceEvaluator(system, box_hint=np.asarray(ctx1.get_box()),
                         pos_hint=posd.cpu().numpy(), device=DEVICE)
    cache = ev1.make_pair_cache(posd, boxd)
    if bool(cache.overflow):
        raise AssertionError("B1's list sized for the B3 positions is "
                             "flagged")
    ref = pp.direct_space_plist(
        posd, boxd, ev1.t.charges, ev1.pair_tables, beta, rc, ev1.pair_ts,
        want_energy=True, cache=cache, plist_cap=ev1.plist_cap,
        skin=ev1.skin, plist_sort=ev1.plist_sort, r_switch=system.r_switch,
        strict=False, nowrap=ev1.plist_nowrap, statics=ev1.statics)
    f_err = (out[5] - ref[5]).abs()
    ok_f = bool(torch.all(f_err <= F_ATOL + F_RTOL * ref[5].abs()))
    e_b3 = [float(x) for x in out[:3]]
    e_b1 = [float(x) for x in ref[:3]]
    ok_e = all(abs(a - b) <= E_ATOL + E_RTOL * abs(b)
               for a, b in zip(e_b3, e_b1))
    print(f"[kernel] B3 path against B1's energy sweep (list of "
          f"{ev1.plist_cap} entries, nowrap {ev1.plist_nowrap}): max |dF| "
          f"{float(f_err.max()):.3e} (rtol {F_RTOL} atol {F_ATOL}); "
          f"e_lj/e_coul/e_corr B3 {e_b3} B1 {e_b1} (rtol {E_RTOL} atol "
          f"{E_ATOL})")
    if not (ok_f and ok_e):
        raise AssertionError("B3's sweep disagrees with B1's")

    pairs = cutoff_pairs(posd, boxd, rc)
    fout = pr.rect_pair(*args, **kw)
    b_ms, b_by = bound(pairs * RECT_OPS, nbytes(*args, fout))
    print(f"[kernel] B3: {pairs / 1e6:.3f} M pairs within the cutoff; bound "
          f"on those {b_ms:.4f} ms ({b_by}); on its own "
          f"{n_pad * n_pad / 1e6:.1f} M evaluations "
          f"{bound(n_pad * n_pad * RECT_OPS, 0)[0]:.4f} ms")
    return dict(launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by)


def profiled_device_us(prof):
    """(device microseconds, device events) of a finished torch.profiler
    run: its CUDA kernel time.  The time is 0 where the profiler's device
    tracing recorded nothing, as it does in some sandboxed machines."""
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return sum(e.self_device_time_total for e in events), events


def device_ms(fn, calls=50):
    """Device time of one call: the CUDA kernel time torch.profiler records
    over ``calls`` calls (after a warm-up), divided by ``calls``.  For
    kernels of a few microseconds, where CUDA events around one call would
    time the host's launch gap.  Where the profiler records no device time
    (tried twice), the time is taken with one pair of CUDA events around
    all ``calls`` calls: that includes the launch gaps the device waits
    for, so it is an upper limit of the device time, and a line says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = profiled_device_us(prof)[0]
        if us > 0:
            return us / 1e3 / calls
    if not device_ms.warned:
        device_ms.warned = True
        print("[timing] torch.profiler recorded no device time: the device "
              "times of this run are CUDA-event times around a batch of "
              "calls (launch gaps included, an upper limit)")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


device_ms.warned = False


def gather_phase():
    """B6-B8 through their path, the gather tool's main() (launch counts of
    that run), then each kernel bitwise against its plain version and the
    library call (torch.index_select), bitwise over 3 runs, and its device
    time beside theirs."""
    import torch
    from openmm_velocityverlet_tpu_torch.tools import exp_gather_kernel as gt
    wrappers = {"B6": gt.gather_rows, "B7": gt.gather_lanes,
                "B8": gt.gather_lanes_tiled}
    for fn in wrappers.values():
        fn.launches = 0
    tool = gt.main(["--device", DEVICE])
    launches = {k: fn.launches for k, fn in wrappers.items()}
    print(f"[kernel] gather tool main(): launches {launches}; us/call "
          f"{ {k: round(v[0], 2) for k, v in tool.items()} }")
    if any(v < 1 for v in launches.values()):
        raise AssertionError("the gather tool did not launch every kernel")
    cases = {
        "B6": (gt.variant_sublane, gt.gather_rows_reference,
               lambda blk, idx: torch.index_select(blk, 0, idx[:, 0])),
        "B7": (gt.variant_lane, gt.gather_lanes_reference,
               lambda blk, idx: torch.index_select(blk, 1, idx[0])),
        "B8": (gt.variant_lane_tiled, gt.gather_lanes_tiled_reference,
               lambda blk, idx: torch.index_select(blk, 1, idx[0] % 128))}
    res = {}
    for key, (variant, plain, library) in cases.items():
        fn, (blk, idx) = variant(DEVICE)
        out = fn(blk, idx)
        torch.cuda.synchronize()
        if not (torch.equal(out, plain(blk, idx))
                and torch.equal(out, library(blk, idx))
                and all(torch.equal(fn(blk, idx), out) for _ in range(2))):
            raise AssertionError(f"{key}: the gather kernel is not bitwise "
                                 f"equal to its plain version, the library "
                                 f"call and itself")
        ms = device_ms(lambda: fn(blk, idx))
        plain_ms = device_ms(lambda: plain(blk, idx))
        library_ms = device_ms(lambda: library(blk, idx))
        # of the block, the function reads only the rows (B6) or lanes (B7,
        # B8: idx % 128) that this run's indices name
        used = torch.unique(idx % 128 if key == "B8" else idx).numel()
        blk_bytes = used * blk.shape[1 if key == "B6" else 0] \
            * blk.element_size()
        n_bytes = blk_bytes + nbytes(idx, out)
        b_ms, b_by = bound(0, n_bytes)
        print(f"[kernel] {key} ({fn.__name__}): bitwise equal to its plain "
              f"version, torch.index_select and itself over 3 runs; device "
              f"time kernel {ms:.5f} ms, plain {plain_ms:.5f}, library "
              f"{library_ms:.5f}; bound {b_ms:.5f} ms ({b_by}, "
              f"{n_bytes / 1e6:.3f} MB: {used} of the block's "
              f"{blk.shape[0 if key == 'B6' else 1]} "
              f"{'rows' if key == 'B6' else 'lanes'} read)")
        res[key] = dict(name=fn.__name__, launches=launches[key],
                        max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                        tool_us_per_call=[v[0] for k, v in tool.items()
                                          if f"({key})" in k][0])
    return res


def langevin_temperatures(ctx):
    """(T, drift, T_rel) of the Langevin group: T in K of its atomic motion
    in the frame of the group's mass-weighted mean velocity ``drift``
    (nm/ps), from the kinetic energy of the Drude pairs' centres of mass and
    of the normal particles over their degrees of freedom less the
    constraints inside the group and the 3 of the drift; T_rel in K of the
    pairs' relative motion, over 3 per pair."""
    import numpy as np
    from openmm_velocityverlet_tpu_torch.units import BOLTZ
    d = ctx.data
    m = np.asarray(ctx.system.masses, np.float64)
    v = ctx.get_velocities().astype(np.float64)
    pairs, normal = np.asarray(d.ld_pairs), np.asarray(d.ld_normal)
    group = np.zeros(len(m), bool)
    group[pairs.reshape(-1)] = True
    group[normal] = True
    drift = (m[group, None] * v[group]).sum(0) / m[group].sum()
    i, j = pairs[:, 0], pairs[:, 1]
    mp = m[i] + m[j]
    vcm = (m[i, None] * v[i] + m[j, None] * v[j]) / mp[:, None] - drift
    ke = 0.5 * np.sum(mp[:, None] * vcm ** 2) \
        + 0.5 * np.sum(m[normal, None] * (v[normal] - drift) ** 2)
    cons = np.asarray(ctx.system.constraints).reshape(-1, 2)
    n_cons = int(np.sum(group[cons[:, 0]] & group[cons[:, 1]]))
    dof = 3 * (len(pairs) + len(normal)) - n_cons - 3
    mu = m[i] * m[j] / mp
    ke_rel = 0.5 * np.sum(mu[:, None] * (v[i] - v[j]) ** 2)
    return (2 * ke / (dof * BOLTZ), drift,
            2 * ke_rel / (3 * len(pairs) * BOLTZ))


def langevin_gate(ctx):
    """Path 4's thermostat check: steps on to 1000 in all, sampling the
    Langevin group's temperature every 50 steps from step 500; the mean of
    the samples must lie within LD_T_BAND of 333 K."""
    import numpy as np
    samples = []
    while ctx.current_step < 1000:
        ctx.step(500 - ctx.current_step if ctx.current_step < 500 else 50)
        if ctx.current_step >= 500:
            samples.append(langevin_temperatures(ctx))
    t_mean = float(np.mean([s[0] for s in samples]))
    t_rel = float(np.mean([s[2] for s in samples]))
    print(f"[langevin+efield] Langevin group, steps 500-1000 ("
          f"{len(samples)} samples): {t_mean:.2f} K in its drift frame "
          f"(band 333 K +- {LD_T_BAND:.0%}; samples "
          f"{[round(float(s[0]), 1) for s in samples]}), drift "
          f"{np.round(samples[-1][1], 4).tolist()} nm/ps, its Drude pairs' "
          f"relative motion {t_rel:.3f} K")
    if not abs(t_mean - 333.0) <= LD_T_BAND * 333.0:
        raise AssertionError("the Langevin group's temperature left its "
                             "band")
    check_finite("langevin+efield", ctx, ctx.system)


def vv_carry_gate(ctx, counters):
    """Path 5's force carry: after set_velocities the next step evaluates
    forces twice (the invalidated carry and the step's own), then once a
    step again."""
    import torch
    for fn in counters.values():
        fn.launches = 0
    ctx.set_velocities(ctx.get_velocities())
    ctx.step(1)
    first = counters["B1"].launches
    ctx.step(2)
    torch.cuda.synchronize()
    print(f"[vv+cos] after set_velocities: step(1) launched B1 {first} "
          f"times, the next step(2) {counters['B1'].launches - first}")
    if first != 2 or counters["B1"].launches - first != 2:
        raise AssertionError("the VV force carry launched B1 other than "
                             "once a step plus once after set_velocities")


def check_finite(tag, ctx, system):
    import numpy as np
    terms = ctx.potential_energy_terms()
    ke = ctx.kinetic_energy()
    print(f"[{tag}] terms {terms} kinetic {ke}")
    if not (all(np.isfinite(v) for v in terms.values()) and np.isfinite(ke)):
        raise AssertionError(f"{tag}: non-finite energy after the timed run")
    pos_now = ctx.get_positions()
    if pos_now.shape != (system.n_atoms, 3) or not np.isfinite(pos_now).all():
        raise AssertionError(f"{tag}: bad positions after the timed run")


def drive(tag, ctx, n_steps, counters, card, dt):
    """step(20) warm-up, then the counters set to 0 and step(n_steps)
    timed; returns (steps/s, {counter: launches})."""
    import torch
    from openmm_velocityverlet_tpu_torch.units import ns_per_day
    t0 = time.perf_counter()
    ctx.step(20)
    torch.cuda.synchronize()
    print(f"[{tag}] warm-up step(20) {time.perf_counter() - t0:.3f} s, "
          f"kinetic {ctx.kinetic_energy():.1f}")
    for fn in counters.values():
        fn.launches = 0
    syncs0, cov0, reb0 = ctx.host_syncs, ctx.coverage_rebuilds, ctx.rebuilds
    t0 = time.perf_counter()
    ctx.step(n_steps)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    sps = n_steps / elapsed
    print(f"[{tag}] {n_steps} steps in {elapsed:.4f} s: {sps:.2f} steps/s, "
          f"{ns_per_day(sps, dt):.3f} ns/day on {card}")
    print(f"[{tag}] launches {launches}; coverage trips "
          f"{ctx.coverage_rebuilds - cov0} (since start "
          f"{ctx.coverage_rebuilds}); cache rebuilds {ctx.rebuilds - reb0} "
          f"(since start {ctx.rebuilds}); pair-list refits {ctx.refits}; "
          f"host syncs/step {(ctx.host_syncs - syncs0) / n_steps:.3f}")
    return sps, elapsed, launches


def strict_trip(ctx, counters):
    """Path 3's fallback on the card: a pair cache sorted while a slab of
    a third of the molecules sat a third of the box away in z trips the
    coverage check on the current positions.  Through the evaluator, that
    step's forces (B2's full sweep on the plist layout) and energies agree
    with those of a fresh cache (B1); through Context.step(2), whose first
    segment gets the stale cache, the first step runs the fallback, counts
    one coverage trip and the second step runs B1 on a fresh cache."""
    import torch
    ev, st = ctx.evaluator, ctx.state
    n = st.pos.shape[0]
    stale_pos = st.pos.clone()
    stale_pos[:(n // 3) // 4 * 4, 2] += st.box[2] / 3.0
    stale = ev.make_pair_cache(stale_pos, st.box)
    fresh = ev.make_pair_cache(st.pos, st.box)
    for fn in counters.values():
        fn.launches = 0
    _, f_stale, cov = ev.energy_forces(st.pos, st.box, want_energy=False,
                                       pair_cache=stale, return_cov=True)
    e_stale, _ = ev.energy_forces(st.pos, st.box, pair_cache=stale)
    n_fallback = counters["B2 fallback"].launches
    _, f_fresh, cov_fresh = ev.energy_forces(
        st.pos, st.box, want_energy=False, pair_cache=fresh, return_cov=True)
    e_fresh, _ = ev.energy_forces(st.pos, st.box, pair_cache=fresh)
    err = (f_stale - f_fresh).abs()
    ok_f = bool(torch.all(err <= F_ATOL + F_RTOL * f_fresh.abs()))
    keys = ("lj", "coul_direct", "coul_excl_corr")
    e_err = {k: float(e_stale[k]) - float(e_fresh[k]) for k in keys}
    ok_e = all(abs(e_err[k]) <= E_ATOL + E_RTOL * abs(float(e_fresh[k]))
               for k in keys)
    print(f"[strict+fused] stale cache: coverage flag {cov} (fresh cache "
          f"{cov_fresh}), B2 fallback launches {n_fallback}; against the "
          f"fresh cache's B1 sweep max |dF| {float(err.max()):.3e} (rtol "
          f"{F_RTOL} atol {F_ATOL}), energy differences {e_err} (rtol "
          f"{E_RTOL} atol {E_ATOL})")
    if cov is not True or cov_fresh is not False or n_fallback != 2 \
            or not (ok_f and ok_e):
        raise AssertionError("strict fallback: no trip on the stale cache, "
                             "or its sweep disagrees with B1's")

    real = ctx._fresh_cache
    handed = []

    def stale_once():
        if handed:
            return real()
        handed.append(True)
        ctx.rebuilds += 1
        return stale

    for fn in counters.values():
        fn.launches = 0
    trips0, syncs0 = ctx.coverage_rebuilds, ctx.host_syncs
    ctx._fresh_cache = stale_once
    try:
        ctx.step(2)
    finally:
        del ctx._fresh_cache
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    trips = ctx.coverage_rebuilds - trips0
    print(f"[strict+fused] Context.step(2) from the stale cache: coverage "
          f"trips {trips}, launches {launches}, host syncs "
          f"{ctx.host_syncs - syncs0}")
    if trips != 1 or launches["B2 fallback"] != 1 or launches["B1"] != 1:
        raise AssertionError("strict fallback: Context.step did not take "
                             "B2's full sweep on the tripped step and B1 "
                             "after the rebuild")


def profile(tag, ctx, step_ms, top=12):
    from torch.profiler import ProfilerActivity, profile as tprofile
    import torch
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        ctx.step(20)
        torch.cuda.synchronize()
    dev_us, kernels_ev = profiled_device_us(prof)
    if dev_us <= 0:
        print(f"[profile {tag}] device busy time not measured: "
              f"torch.profiler recorded no device time in 20 steps "
              f"(unprofiled {step_ms:.3f} ms/step)")
        return
    n_kernels = sum(e.count for e in kernels_ev)
    busy_ms = dev_us / 1e3 / 20
    print(f"[profile {tag}] device busy {busy_ms:.3f} ms/step (kernel time "
          f"of 20 profiled steps), {n_kernels / 20:.0f} kernels/step; "
          f"against the unprofiled {step_ms:.3f} ms/step the device idles "
          f"{100 * (1 - busy_ms / step_ms):.1f}% of the step")
    ranked = sorted(kernels_ev, key=lambda e: -e.self_device_time_total)
    # the largest kernels, and the port's own wherever they rank (nvcc
    # puts them in an anonymous namespace)
    for e in ranked[:top] + [
            e for e in ranked[top:] if e.key.removeprefix("void ").startswith(
                "(anonymous namespace)::")]:
        print(f"[profile {tag}] {e.self_device_time_total / 20e3:8.4f} "
              f"ms/step {e.count / 20:6.1f}/step  {e.key[:90]}")


def wire_path4(integ, n_mol, langevin=True):
    """The __graft_entry__._drude_system wiring (:58-66): partitioned
    Langevin on the last quarter of the molecules, an E-field of 0.5 V/nm on
    the cores of the others.  ``langevin=False`` leaves out the Langevin
    subset, whose noise streams differ between the card and the CPU."""
    n_ld = n_mol // 4
    if langevin:
        for m in range(n_mol - n_ld, n_mol):
            for k in range(4):
                integ.addParticleLangevin(4 * m + k)
    for m in range(n_mol - n_ld):
        integ.addParticleElectrolyte(4 * m)
    integ.setElectricField(0.5)


def wire_path5(integ, n_mol):
    """The vanilla VV scheme with cosine acceleration 0.02 nm/ps^2
    (README "--cos 0.02")."""
    integ.setUseMiddleScheme(False)
    integ.setCosAcceleration(0.02)


def small_agreement(tag, wire=None, **opts):
    """A 64-molecule system, 10 steps on the card against the CPU run of
    the same code (plain versions): positions and energy terms agree.
    ``wire(integ, n_mol)`` sets integrator features."""
    import numpy as np
    from openmm_velocityverlet_tpu_torch import Context, VVIntegrator
    from openmm_velocityverlet_tpu_torch.models.drude_water import \
        drude_water_box
    system, pos, box = drude_water_box(64, r_cutoff=0.7)
    rng = np.random.default_rng(7)
    vel = rng.normal(0.0, 0.3, pos.shape) * (np.asarray(system.masses)
                                              > 0.5)[:, None]
    out = {}
    for dev in ("cpu", DEVICE):
        integ = VVIntegrator(333, 10, 1, 40, 0.001)
        integ.setMaxDrudeDistance(0.02)
        if wire is not None:
            wire(integ, 64)
        ctx = Context(system, integ, positions=pos, box=box, device=dev,
                      **opts)
        ctx.set_velocities(vel)
        ctx.step(10)
        out[dev] = (ctx.get_positions(), ctx.potential_energy_terms())
    dpos = float(np.abs(out[DEVICE][0] - out["cpu"][0]).max())
    worst = max(abs(out[DEVICE][1][k] - v) / (abs(v) + 1.0)
                for k, v in out["cpu"][1].items())
    print(f"[check] {tag}: 64-molecule 10-step card vs CPU: max |dpos| = "
          f"{dpos:.3e} nm, max term diff/(|E|+1) = {worst:.3e}")
    if not (dpos < 1e-4 and worst < 1e-3):
        raise AssertionError(f"{tag}: card run disagrees with the CPU run")


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from openmm_velocityverlet_tpu_torch import Context, VVIntegrator, kernels
    from openmm_velocityverlet_tpu_torch.models.drude_water import \
        drude_water_box
    from openmm_velocityverlet_tpu_torch.ops import ewald_fused as ef
    from openmm_velocityverlet_tpu_torch.ops import pair_plist as pp
    from openmm_velocityverlet_tpu_torch.ops import pair_tri as pt

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

    def context(wire=None, **opts):
        integ = VVIntegrator(333, 10, 1, 40, 0.001)
        integ.setMaxDrudeDistance(0.02)
        if wire is not None:
            wire(integ, N_MOL)
        ctx = Context(system, integ, positions=pos, box=box, device=DEVICE,
                      **opts)
        ctx.set_velocities_to_temperature(333.0)
        return ctx, integ.getStepSize()

    ctx1, dt = context()
    print(f"[setup] {system.n_atoms} atoms, box {box[0]:.3f} nm, "
          f"kmax {system.kmax}, beta {system.ewald_beta:.4f}, "
          f"{time.perf_counter() - t0:.1f} s")

    b1, b1_bound, b1_by, b1_evals, b1_pairs, b1_err = b1_phase(ctx1, system,
                                                                pos)
    b2 = b2_phase(ctx1, system, pos)
    rc = recip_phase(ctx1)
    b3 = b3_phase(ctx1, system, pos)
    gat = gather_phase()

    # path 1: the main path
    ev1 = ctx1.evaluator
    print(f"[slice] pair_mode {ev1.pair_mode}, tile size {ev1.pair_ts} "
          f"(chosen from the start configuration), sort {ev1.plist_sort}, "
          f"nowrap {ev1.plist_nowrap}, list capacity {ev1.plist_cap}")
    sps1, el1, l1 = drive("slice", ctx1, 200, {"B1": pp.plist_pair}, card,
                          dt)
    if l1["B1"] < 200:
        raise AssertionError(f"B1 launched {l1['B1']} < 200 times")
    check_finite("slice", ctx1, system)
    profile("path 1", ctx1, el1 / 200 * 1e3)

    # path 2: the z band (kernel B2)
    ctx2, _ = context(fold_exc14=True)
    ev2 = ctx2.evaluator
    print(f"[band] pair_mode {ev2.pair_mode}, ts {ev2.pair_ts}, band_w "
          f"{ev2.band_w}, uses_band {ev2.uses_band}")
    _, el2, l2 = drive("band", ctx2, 100, {"B2": pt.tri_pair}, card, dt)
    if l2["B2"] < 100:
        raise AssertionError(f"B2 launched {l2['B2']} < 100 times")
    check_finite("band", ctx2, system)
    profile("path 2", ctx2, el2 / 100 * 1e3, top=6)

    # path 3: strict pair coverage and the fused reciprocal
    ctx3, _ = context(strict_pairs=True, recip="exact_fused")
    _, el3, l3 = drive("strict+fused", ctx3, 100,
                     {"B1": pp.plist_pair, "B2 fallback": pt.tri_pair,
                      "B4": ef.structure_factor, "B5": ef.recip_forces},
                     card, dt)
    if l3["B4"] < 100 or l3["B5"] < 100:
        raise AssertionError(f"B4/B5 launched {l3['B4']}/{l3['B5']} < 100 "
                             f"times")
    check_finite("strict+fused", ctx3, system)
    profile("path 3", ctx3, el3 / 100 * 1e3, top=6)
    strict_trip(ctx3, {"B1": pp.plist_pair, "B2 fallback": pt.tri_pair})
    check_finite("strict+fused", ctx3, system)

    # path 4: partitioned Langevin and the E-field (middle scheme)
    ctx4, _ = context(wire=wire_path4)
    print(f"[langevin+efield] {ctx4.data.ld_pairs.shape[0]} Langevin Drude "
          f"pairs, {ctx4.data.ld_normal.shape[0]} Langevin particles, "
          f"{ctx4.data.electrolyte.shape[0]} E-field particles")
    _, el4, l4 = drive("langevin+efield", ctx4, 100, {"B1": pp.plist_pair},
                       card, dt)
    if l4["B1"] < 100:
        raise AssertionError(f"B1 launched {l4['B1']} < 100 times")
    check_finite("langevin+efield", ctx4, system)
    profile("path 4", ctx4, el4 / 100 * 1e3, top=6)
    langevin_gate(ctx4)

    # path 5: the vanilla VV scheme with cosine acceleration
    ctx5, _ = context(wire=wire_path5)
    _, el5, l5 = drive("vv+cos", ctx5, 100, {"B1": pp.plist_pair}, card, dt)
    if l5["B1"] != 100:
        raise AssertionError(f"B1 launched {l5['B1']} times in 100 VV steps "
                             f"with a valid force carry (expected 100)")
    check_finite("vv+cos", ctx5, system)
    v_max, inv_vis = ctx5.get_viscosity()
    print(f"[vv+cos] get_viscosity: vMax {v_max:.6e} nm/ps, 1/viscosity "
          f"{inv_vis:.6e} 1/(Pa s)")
    if not (np.isfinite(v_max) and np.isfinite(inv_vis)):
        raise AssertionError("get_viscosity() is not finite")
    profile("path 5", ctx5, el5 / 100 * 1e3, top=6)
    vv_carry_gate(ctx5, {"B1": pp.plist_pair})

    small_agreement("path 1")
    small_agreement("path 2 (fold_exc14, pair_ts 32)", fold_exc14=True,
                    pair_ts=32)
    small_agreement("path 3 (strict_pairs, exact_fused)", strict_pairs=True,
                    recip="exact_fused")
    small_agreement("path 4 without its Langevin subset (E-field)",
                    wire=functools.partial(wire_path4, langevin=False))
    small_agreement("path 5 (vanilla VV, cosine acceleration)",
                    wire=wire_path5)

    f, e = b1["force"], b1["energy"]
    src = "openmm_velocityverlet_tpu_torch/csrc/"
    ref = "openmm_velocityverlet_tpu/ops/"
    print(json.dumps({"kernels": [
        {"name": "plist_pair", "route": "cuda",
         "source": src + "plist_pair.cu",
         "replaces": ref + "pallas_pair.py:1110", "launches": l1["B1"],
         "max_abs_err": b1_err, "ms": f[1], "plain_ms": f[2],
         "bound_ms": b1_bound, "bound_by": b1_by, "library_ms": None,
         "device_ms": f[3], "energy_ms": e[1], "energy_plain_ms": e[2],
         "energy_device_ms": e[3], "tile_size": ctx1.evaluator.pair_ts,
         "evaluations": b1_evals, "cutoff_pairs": b1_pairs},
        {"name": "tri_pair", "route": "cuda", "source": src + "tri_pair.cu",
         "replaces": ref + "pallas_pair.py:561", "launches": l2["B2"],
         "max_abs_err": b2["max_abs_err"], "ms": b2["ms"],
         "plain_ms": b2["plain_ms"], "bound_ms": b2["bound_ms"],
         "bound_by": b2["bound_by"], "library_ms": None,
         "device_ms": b2["device_ms"], "energy_ms": b2["energy_ms"],
         "energy_plain_ms": b2["energy_plain_ms"],
         "energy_device_ms": b2["energy_device_ms"],
         "tile_size": b2["tile_size"], "evaluations": b2["evaluations"],
         "cutoff_pairs": b2["cutoff_pairs"]},
        {"name": "ewald_structure", "route": "cuda",
         "source": src + "ewald_fused.cu",
         "replaces": ref + "ewald_pallas.py:77", "launches": l3["B4"],
         "max_abs_err": rc["b4_err"], "ms": rc["b4"],
         "plain_ms": rc["b4_plain"], "bound_ms": rc["b4_bound"][0],
         "bound_by": rc["b4_bound"][1], "library_ms": None,
         "device_ms": rc["b4_device"], "matmul_route_ms": rc["matmul_route"],
         "fused_route_ms": rc["fused_route"]},
        {"name": "ewald_force", "route": "cuda",
         "source": src + "ewald_fused.cu",
         "replaces": ref + "ewald_pallas.py:99", "launches": l3["B5"],
         "max_abs_err": rc["b5_err"], "ms": rc["b5"],
         "plain_ms": rc["b5_plain"], "bound_ms": rc["b5_bound"][0],
         "bound_by": rc["b5_bound"][1], "library_ms": None,
         "device_ms": rc["b5_device"]},
        {"name": "rect_pair", "route": "cuda", "source": src + "rect_pair.cu",
         "replaces": ref + "pallas_pair.py:454", "launches": b3["launches"],
         "max_abs_err": b3["max_abs_err"], "ms": b3["ms"],
         "plain_ms": b3["plain_ms"], "bound_ms": b3["bound_ms"],
         "bound_by": b3["bound_by"], "library_ms": None,
         "library_ms_why": "no single PyTorch call computes the sweep"}]
        + [{"name": g["name"], "route": "cuda", "source": src + "gather.cu",
            "replaces": "tools/exp_gather_kernel.py:" + line,
            "launches": g["launches"], "max_abs_err": g["max_abs_err"],
            "ms": g["ms"], "plain_ms": g["plain_ms"],
            "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
            "library_ms": g["library_ms"],
            "tool_us_per_call": g["tool_us_per_call"]}
           for g, line in ((gat["B6"], "39"), (gat["B7"], "59"),
                           (gat["B8"], "80"))]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
