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
     also against a float64 evaluation on 512 atoms, and the matmul
     route's closed-form gradient against its autograd twin
     (``matmul_twin_phase``: both timed, the route's call counters
     printed, its chunked calls gated at 0); B3 (the
     rectangular sweep) through its path, direct_space_tiled(symmetric=
     False), and against B1's sweep of the same positions, with its pair
     evaluations per pair within the cutoff (at most B3_MAX_EVALS) beside
     the torch model of its skips, and the device time of its kernel
     alone and of the wrapper with its sort; B6-B8 (gathers) through
     their path, the gather tool's main(), then bitwise against their
     plain versions and torch.index_select, timed on the device
     (torch.profiler, else a CUDA graph of 50 calls between two events)
     beside the library call, B7 against half its bound; the
     constraint-cluster kernels (SHAKE and RATTLE, one launch a bucket)
     on path 1's own constraint data, positions and velocities against
     their plain versions, timed beside them (``constraint_phase``);
  3. path 1, the main path: Context with VVIntegrator(333, 10, 1, 40,
     0.001), setMaxDrudeDistance(0.02); step(20) warm-up, step(200) timed,
     B1 launched >= 200 times, SHAKE's and RATTLE's kernels each once a
     bucket for each of their 200 calls;
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
  6. path 6, constant voltage at edl_Im21's atom counts (a synthetic slab,
     ``edl_system``: 2,496 electrode sites, 18,900 liquid atoms, 18,900
     images, run-edl's wiring at 1 V): step(20), step(100) timed on the
     mirror route, B1 launched >= 100 times; image sync within 1e-5 nm,
     finite terms with |coul_direct| below 1e3 kJ/mol an atom, electrode
     and Drude-wall gates; the mirror reciprocal against the explicit one
     over all atoms; B1 in its group-rows form on the culled list against
     its plain version; a 20-step leg on recip="exact_fused" (B4/B5 over all
     atoms, images included) whose start agrees with the mirror route;
  7. path 7, NPT at 19,500 atoms (BarostatConfig("iso", 1 bar, 333 K,
     frequency 25)): step(20), step(200) timed (8 attempts), attempts,
     acceptances and the volume; then a gate leg in which every accepted
     move leaves finite terms, no coverage trip on its step and the box
     scaled by the move's axis_scale;
  8. path 8, the PME reciprocal (recip="pme", grid (96, 96, 96) for the
     9.35 nm box) at 19,500 atoms: PME against the matmul route (forces
     within 1.5e-3 max|F| on the path's start, whose energy difference is
     printed; energy within 1e-4 and forces as above on random charges at
     the path's atom count and box, tests/test_pme.py's data), step(20),
     step(200) timed, B1 launched >= 200 times; then the route times of
     ops/pme.py's cost model on random charges in 3-12 nm boxes and the fit
     of its costs (the PME route is also timed beside the fused and matmul
     routes at 19,500 atoms and at path 6's EDL shapes); then the mesh
     (A16, ``mesh_phase``) in path 2's configuration: a world of one under
     NCCL beside the unsharded band Context from the same state (max
     |dpos| within 1e-6 nm after one step and 1e-5 after three, step(100)
     timed, B2 launched >= 100 times), then two ranks spawned on the one
     card under gloo, gated against that unsharded run, their final
     positions bitwise alike, each rank's B2 row shard on the step's own
     cache against its plain version and its rows bitwise the unsharded
     kernel's, step(100) timed with the all_reduce's CUDA-event time (two
     ranks sharing one card: not a two-card number);
  9. path 9, the application layer (A14) through the bulk CLI (A17):
     run_bulk.simulation_from_args with run_bulk's defaults (Langevin on
     every particle, the iso barostat every 100 steps, 333 K, dt 0.001) on
     write_charmm_fixture(13, by_species=True), 19,773 atoms with Drudes,
     NBTHOLE and CMAP in a 10.4 nm box; minimize_energy(100) capped at 50
     iterations; sim.step(20); then in turns sim.step(200) with the
     reporters (cut to every 50 / 100 steps, into a temporary directory),
     bare ctx.step(200) twice and sim.step(200) again; B1 launched >= 200
     times in the first window; StateData and DrudeTemperature rows finite,
     the DCD's last frame equal to get_positions() at its step, the GRO
     frame count, and the step-150 checkpoint resumed by a fresh run_bulk
     simulation to step 190 within 1e-4 nm (``bulk_path``);
 10. for each path every energy term and the kinetic energy finite, a
     torch.profiler summary of 20 more steps (device busy time, kernels per
     step, top kernels; on path 9 also 30 steps with the reporters, and
     the device time of its autograd terms), and a 64-molecule system
     stepped 10 times on the
     card tracking the same run on the CPU (plain versions; path 4 without
     its Langevin subset and path 6 without its Langevin electrode, whose
     noise streams differ between the two; path 7 with the same barostat
     draws handed to both, the same accept / reject sequence; path 9 as the
     243-atom fixture through run_bulk with --thermostat nose-hoover
     --barostat no);
 11. A13/A15 on the card against the CPU: a written Drude PSF/PRM/GRO
     fixture carrying NBTHOLE and CMAP through the port's loaders,
     replicated to 4,374 atoms and stepped 10 times on both; GB (OBC2,
     salt, ACE) on the 1,944-atom fixture through createSystem, energy and
     forces on both;
 12. one JSON line {"kernels": [...]}, the card line, and as the last line
     {"ok": true, "device": {...}}.

Exits nonzero on any failure, without a CUDA device, or without the
package beside it.
"""
import functools
import itertools
import json
import os
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
# B3's ordered pair evaluations for each pair within the cutoff at most
# (the full sweep of its first design made 268 at 19,500 atoms; a
# both-sided sweep makes at least 2)
B3_MAX_EVALS = 24
# path 4: the Langevin group's kinetic temperature in the frame of the
# group's own drift (the E-field pushes the other molecules along z, which
# drag the Langevin group into a steady drift), averaged over steps 500 to
# 1000, within this fraction of the 333 K target.  Steps 500 on: the lattice
# start melts and heats everything to ~500 K within 100 steps, and the OU
# map relaxes in 1/gamma = 0.2 ps = 200 steps.
LD_T_BAND = 0.1
# path 6 (tests/test_ewald_mirror.py:48-54): the mirror reciprocal against
# the explicit evaluation over all atoms, energy rtol and real-atom forces
# rtol / atol relative to max|F|; image sync in nm; |coul_direct| per atom
MIRROR_E_RTOL, MIRROR_F_RTOL, MIRROR_F_ATOL_REL = 2e-5, 1e-4, 2e-4
IMAGE_SYNC_ATOL = 1e-5
COUL_PER_ATOM = 1e3
# kcal/mol/A^2 in kJ/mol/nm^2 (run-edl's restraint unit)
KCAL_A2 = 4.184 / 0.01
# path 8: PME against the matmul route, energy rtol (tests/test_pme.py:37)
# and forces atol relative to max|F| (:69)
PME_E_RTOL, PME_F_ATOL_REL = 1e-4, 1.5e-3
# the grid choose_grid gives the 9.35 nm box, and the cubic boxes (nm) of
# the route times that fit ops/pme.py's cost model
PME_GRID = (96, 96, 96)
RECIP_FIT_SIDES = (3.0, 4.5, 6.0, 7.5, 9.35, 12.0)
# GB card against CPU: energy rtol (tests/test_gb.py:111-114) and autograd
# forces atol relative to max|F|
GB_RTOL, GB_F_ATOL_REL = 2e-5, 1e-4
# path 9: run_bulk on write_charmm_fixture(n_side=13, by_species=True),
# 2,197 cells of 9 atoms: 19,773 atoms in a 10.4 nm box, within 1.5% of
# bench.py's 19,500-atom headline
# the mesh phase's trajectory gates: max |dpos| (nm) against the unsharded
# run after 1 and 3 steps (tests/test_multichip.py:58-66)
MESH_DPOS_1, MESH_DPOS_3 = 1e-6, 1e-5
BULK_SIDE = 13
# run_bulk's --min calls minimize_energy(100), up to 500 iterations; path
# 9 stops it after 50
BULK_MIN_ITERATIONS = 50
# path 9's reporter intervals, cut from run_bulk's (checkpoints and DCD
# every 10000 steps, GRO every 1000 with log spacing, StateData every 1000,
# DrudeTemperature every 10000) so that a timed 200-step window holds
# reports: StateData, DCD, DrudeTemperature and checkpoints every 50 steps,
# GRO every 100 (log spacing, as run_bulk's)
BULK_EVERY, BULK_GRO_EVERY = 50, 100
# the constraint-cluster kernels against their plain versions: rows within
# CC_ULPS float32 epsilons of the largest |entry| of the target (nvcc's
# fma contraction moves the last bits; the formulas are the plain
# version's); the card tests' rigid SWM4-NDP waters at the benchmark's
# water19k shapes: 3,900 waters, 19,500 sites, in a 4.914 nm box
CC_ULPS = 32
CC_WATERS, CC_BOX = 3900, 4.914
# the checkpoint resume window: from the step-150 checkpoint to step 190,
# which holds no attempt of run_bulk's barostat (every 100 steps), whose
# state a checkpoint does not carry
RESUME_FROM, RESUME_TO = 150, 190


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


def cutoff_pairs(pos, box, r_cutoff, block=1024, inert=None):
    """Atom pairs i < j within the cutoff under the minimum image: the
    pairs a direct-space sweep must evaluate on these positions, whatever
    tile pairs its enumeration visits.  The pair kernels' bounds count
    these.  ``inert`` (a bool tensor) leaves out pairs of two inert atoms,
    which the step's list culls."""
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
        hit = (r2 < r_cutoff * r_cutoff) & (j > i)
        if inert is not None:
            hit &= ~(inert[s:s + block, None] & inert[None, :])
        total += int(hit.sum())
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
    kw = dict(ts=ev.pairs.ts, t_dim=ev.pair_tables["arows"].shape[1],
              beta=system.ewald_beta, r_cutoff=system.r_cutoff,
              r_switch=system.r_switch, nowrap=ev.pairs.nowrap)
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
    if sort is not None and sort != ev.pairs.sort:
        ev.pairs = pp.PlistSweep.sized(system, ev.pair_tables, DEVICE, pos,
                                       box, ts, sort)
    return ev


def pair_cache(ev, pos, box):
    """The cache of ``ev``'s pair sweep for the raw positions ``pos``, as
    built (a list that overflows comes back flagged)."""
    return ev.pairs.make_cache(ev.place_vsites(pos), box)


def refitted_cache(ev, pos, box):
    """The cache of ``ev``'s pair sweep for the raw positions ``pos``,
    refitted where a build comes back flagged."""
    return ev.pairs.rebuild(ev.place_vsites(pos), box)[0]


def b1_phase(ctx, system, pos):
    """B1 against its plain version at the main path's shapes; then over
    the admitted tile sizes and both sort keys on the same positions and on
    jittered ones; then its column skip where excluded pairs exist."""
    import numpy as np
    import torch
    from openmm_velocityverlet_tpu_torch.ops import pair_plist as pp
    dev = torch.device(DEVICE)
    ev = ctx.evaluator
    st = ctx.state
    cache = pair_cache(ev, st.pos, st.box)
    n_active = int(((cache.plist & 1) == 1).sum())
    print(f"[kernel] B1: n_pad={cache.perm.shape[0]} ts={ev.pairs.ts} "
          f"sort={ev.pairs.sort} nowrap={ev.pairs.nowrap} "
          f"cap={cache.plist.shape[0]} active_entries={n_active} "
          f"overflow={bool(cache.overflow)}")
    res, evals, tensors = b1_case("B1", ev, cache, st.pos, st.box, system)
    pairs = cutoff_pairs(ev.place_vsites(st.pos), st.box, system.r_cutoff)
    b_ms, b_by = bound(pairs * PAIR_OPS, nbytes(*tensors))
    print(f"[kernel] B1: {n_active * ev.pairs.ts ** 2 / 1e6:.1f} M pair slots "
          f"in its list, {evals / 1e6:.2f} M pair evaluations after the "
          f"column skip, {pairs / 1e6:.3f} M pairs within the cutoff "
          f"({evals / pairs:.2f} evaluations a pair); device time "
          f"{res['force'][3]:.4f} ms force, {res['energy'][3]:.4f} ms "
          f"energy; bound on the cutoff pairs {b_ms:.4f} ms ({b_by}); on "
          f"its own evaluations {bound(evals * PAIR_OPS, 0)[0]:.4f} ms")

    # the tile sizes and sort keys PlistSweep chooses from, on the
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
            cache_s = pair_cache(ev_s, p_d, st.box)
            entries = int(((cache_s.plist & 1) == 1).sum())
            flagged = int(((cache_s.plist & 3) == 3).sum())
            r, ev_n, _ = b1_case(f"B1 {tag} ts={ts} {sort}", ev_s, cache_s,
                                 p_d, st.box, system)
            model = pp.count_evaluations_np(
                p_np, box, ts, ev_s.pairs.rc_cand, system.r_cutoff,
                mode=sort, inert=ev_s.pairs.inert)[1]
            print(f"[kernel] B1 sweep: {tag} ts={ts} sort={sort} nowrap="
                  f"{ev_s.pairs.nowrap} entries={entries} ({flagged} with "
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
          f"slot costs {b_fit / a_fit:.3f} evaluations (pair_plist.py takes "
          f"{pp.PLIST_SLOT_COST})")

    # the column skip where excluded pairs exist: four-atom molecules
    s14, pos14, box14 = exc14_system(N_MOL)
    pos14d = torch.as_tensor(pos14, device=dev)
    box14d = torch.as_tensor(box14, dtype=torch.float32, device=dev)
    for ts in (32, 64, 128):
        ev_s = sized_evaluator(s14, pos14, box14, ts)
        cache_s = pair_cache(ev_s, pos14d, box14d)
        r, ev_n, _ = b1_case(f"B1 exclusions ts={ts}", ev_s, cache_s, pos14d,
                             box14d, s14, timed=False)
        flagged = int(((cache_s.plist & 3) == 3).sum())
        print(f"[kernel] B1 skip gate: exclusions ts={ts} sort="
              f"{ev_s.pairs.sort} nowrap={ev_s.pairs.nowrap}: "
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
    ts2, w2 = ev2.pairs.ts, ev2.pairs.band_w
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
    plist_cache = pair_cache(ctx1.evaluator, posd, boxd)
    pad1 = plist_cache.perm.shape[0] - n
    p1 = torch.cat([posd, torch.full((pad1, 3), 1e6, device=dev)]
                   )[plist_cache.perm].contiguous()
    ts1 = ctx1.evaluator.pairs.ts
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
        cases.append((name, layout(ev14.pair_tables, ev14.pairs.ts, True,
                                   s14.charges,
                                   torch.as_tensor(p14, device=dev), box14d),
                      ev14.pairs.ts, [("bandall", ev14.pairs.band_w, False)],
                      True))
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
    # the tile sizes BandSweep chooses from, on the same positions
    for ts in pt.BAND_TILE_SIZES:
        ev_s = ForceEvaluator(system, fold_exc14=True, box_hint=box,
                              pos_hint=pos, pair_ts=ts, device=DEVICE)
        args, cmap = layout(ev_s.pair_tables, ts, True, system.charges)
        w = ev_s.pairs.band_w
        kw = dict(ts=ts, t_dim=t_dim, beta=beta, r_cutoff=rc, mode="bandall",
                  band_w=w, want_energy=False)
        evals = torch.zeros(1, dtype=torch.int64, device=dev)
        out = pt.tri_pair(*args, cmap=cmap, evals=evals, **kw)
        ref = pt.tri_pair_reference(*args, **kw)
        torch.cuda.synchronize()
        worst = max(worst, pair_agreement(f"B2 sweep ts={ts}", out, ref,
                                          E_RTOL))
        t_dev = device_ms(lambda: pt.tri_pair(*args, cmap=cmap, **kw),
                          calls=20)
        model = pt.band_cost(pos, box, ts, w, rc)
        print(f"[kernel] B2 sweep: ts={ts} band_w={w} evaluations="
              f"{int(evals) / 1e6:.2f} M "
              f"({int(evals) / main['cutoff_pairs']:.2f} a cutoff pair; the "
              f"sweep's cost model {model / 1e6:.2f} M) "
              f"force: {t_dev:.4f} ms device")
    main["max_abs_err"] = worst
    return main


def recip_phase(ctx, label=""):
    """B4 and B5 against their plain versions on the inputs that the fused
    route of ``ctx`` hands them (its atoms, its k vectors and B4's result
    as B5's coefficients), beside the matmul route on the same positions
    (with the context's image mirror, if any).  ``label`` tags the lines."""
    import torch
    from openmm_velocityverlet_tpu_torch.ops import ewald, ewald_fused as ef
    from openmm_velocityverlet_tpu_torch.ops import pme
    s = ctx.system
    pos = ctx.state.pos
    box = ctx.state.box
    q = ctx.evaluator.t.charges
    posp, qp, kvec, w, c0, n_pad, kp, kt = ef._prep(pos, box, q,
                                                    s.ewald_beta, s.kmax, 256)
    k_real = ef.k_tiling(s.kmax)[0]
    b4n, b5n = "B4" + label, "B5" + label
    print(f"[kernel] B4/B5{label}: n_pad={n_pad}, kmax {s.kmax}, "
          f"K={k_real} padded to {kp} (k tile {kt}); "
          f"{pos.shape[0] * k_real / 1e6:.0f} M phases a pass")

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
    # the plain version on the first 512 charged atoms
    sub = torch.nonzero(qp != 0)[:512, 0]
    f64 = ef.recip_forces_reference(posp[sub].double(), qp[sub].double(),
                                    kvec.double(), ab.double())
    s64 = ef.structure_factor_reference(posp[sub].double(), qp[sub].double(),
                                        kvec.double())
    s_sub = [ef.structure_factor(posp[sub].contiguous(),
                                 qp[sub].contiguous(), kvec, s.kmax, box),
             ef.structure_factor_reference(posp[sub], qp[sub], kvec)]
    s_errs = [max(float((t[c] - s64[c]).abs().max()) for c in range(2))
              for t in s_sub]
    print(f"[kernel] {b4n} against float64 on 512 atoms: max abs S error "
          f"kernel {s_errs[0]:.3e}, plain version {s_errs[1]:.3e} (max|S| "
          f"{float(torch.maximum(s64[0].abs().max(), s64[1].abs().max())):.3f})")
    print(f"[kernel] {b5n} against float64 on 512 atoms: max abs force error "
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
    print(f"[kernel] {b4n}: energy kernel {e_k:.6f} plain {e_p:.6f} (rtol "
          f"{RECIP_E_RTOL}); {b5n}: max abs force error {f_err:.3e} (atol "
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
        print(f"[kernel] B4/B5{label} beyond tolerance of the float32 plain "
              f"version; against a float64 plain run: energy kernel "
              f"{e_k - e64:+.3e}, plain {e_p - e64:+.3e}; forces kernel "
              f"{f_ok(f_k, f64)[1]:.3e}, plain {f_ok(f_p, f64)[1]:.3e}; "
              f"{'both within' if ok64 else 'NOT within'} tolerance")
        if not ok64:
            raise AssertionError(f"B4/B5{label} disagree with their plain "
                                 f"versions")
    again = [(b4(), b5()) for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a[0], s_k[0]) and torch.equal(a[1], s_k[1])
               and torch.equal(f, f_k) for a, f in again):
        raise AssertionError(f"B4/B5{label} documented as bitwise "
                             f"deterministic but two runs differ")
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
        p, box, q, s.ewald_beta, s.kmax, chunk=ctx.evaluator.ewald_chunk,
        mirror=ctx.image_mirror)), reps=10)
    t["matmul_twin"] = matmul_twin_phase(ctx, route, label)
    grid = pme.choose_grid(box.cpu().numpy())
    pme_route = route(lambda p: pme.reciprocal_energy_pme(
        p, box, q, s.ewald_beta, grid))
    t["pme_route"] = cuda_time_ms(pme_route, reps=10)
    t["pme_route_device"] = device_ms(pme_route, calls=10)
    print(f"[kernel] B4/B5{label}: bitwise equal over 3 runs; B4 "
          f"{t['b4']:.4f} ms ({t['b4_device']:.4f} ms device time; plain "
          f"{t['b4_plain']:.4f}), B5 {t['b5']:.4f} ms "
          f"({t['b5_device']:.4f} ms device time; plain "
          f"{t['b5_plain']:.4f}); energy + autograd forces: fused route "
          f"{t['fused_route']:.4f} ms, matmul route (ops/ewald.py) "
          f"{t['matmul_route']:.4f} ms (its autograd twin "
          f"{t['matmul_twin']:.4f} ms), PME route (ops/pme.py, grid "
          f"{grid}, all atoms) {t['pme_route']:.4f} ms "
          f"({t['pme_route_device']:.4f} ms device time)")
    phases = pos.shape[0] * k_real
    t["b4_bound"] = bound(phases * B4_OPS, nbytes(posp, qp, kvec, *s_k))
    t["b5_bound"] = bound(phases * B5_OPS, nbytes(posp, qp, kvec, ab, f_k))
    print(f"[kernel] {b4n} bound {t['b4_bound'][0]:.4f} ms, {b5n} bound "
          f"{t['b5_bound'][0]:.4f} ms ({t['b4_bound'][1]})")
    t["b4_err"] = s_err
    t["b5_err"] = f_err
    return t


def matmul_twin_phase(ctx, route, label):
    """The matmul route's closed-form gradient against its autograd twin
    (``ewald.reciprocal_energy_reference``, one contraction) at the
    context's positions, with the twin's CUDA-event time; prints the
    route's call counters and gates its chunked calls at 0 (the build-time
    rule keeps every shape the script runs in one contraction)."""
    import torch
    from openmm_velocityverlet_tpu_torch.ops import ewald
    s, ev = ctx.system, ctx.evaluator
    pos, box, q = ctx.state.pos, ctx.state.box, ev.t.charges
    grads = []
    for fn in (ewald.reciprocal_energy, ewald.reciprocal_energy_reference):
        p = pos.detach().requires_grad_(True)
        with torch.enable_grad():
            e = fn(p, box, q, s.ewald_beta, s.kmax, mirror=ctx.image_mirror)
            grads.append((float(e.detach()),
                          torch.autograd.grad(e, p)[0].double()))
    (e_c, g_c), (e_t, g_t) = grads
    scale = float(g_t.abs().max())
    err = float((g_c - g_t).abs().max())
    ms = cuda_time_ms(route(lambda p: ewald.reciprocal_energy_reference(
        p, box, q, s.ewald_beta, s.kmax, mirror=ctx.image_mirror)), reps=10)
    calls = ewald.reciprocal_energy.calls
    chunked = ewald.reciprocal_energy.chunked_calls
    print(f"[recip{label}] matmul route closed form against its autograd "
          f"twin at {pos.shape[0]} atoms: energy {e_c:.6f} / {e_t:.6f}, max "
          f"abs gradient difference {err:.3e} (max|g| {scale:.3f}); twin "
          f"{ms:.4f} ms; evaluator chunk {ev.ewald_chunk}; "
          f"reciprocal_energy calls {calls}, chunked calls {chunked}")
    if abs(e_c - e_t) > RECIP_E_RTOL * abs(e_t) \
            or err > RECIP_F_ATOL_REL * scale:
        raise AssertionError(f"matmul route{label}: the closed form "
                             f"disagrees with its autograd twin")
    if chunked or ev.ewald_chunk:
        raise AssertionError(f"matmul route{label}: {chunked} chunked calls "
                             f"(evaluator chunk {ev.ewald_chunk})")
    return ms


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
    cache = pair_cache(ev1, posd, boxd)
    if bool(cache.overflow):
        raise AssertionError("B1's list sized for the B3 positions is "
                             "flagged")
    sw1 = ev1.pairs
    ref = pp.direct_space_plist(
        posd, boxd, sw1.charges, ev1.pair_tables, beta, rc, sw1.ts,
        want_energy=True, cache=cache, plist_cap=sw1.cap, skin=pp.SKIN,
        plist_sort=sw1.sort, r_switch=system.r_switch, strict=False,
        nowrap=sw1.nowrap, statics=sw1.statics)
    f_err = (out[5] - ref[5]).abs()
    ok_f = bool(torch.all(f_err <= F_ATOL + F_RTOL * ref[5].abs()))
    e_b3 = [float(x) for x in out[:3]]
    e_b1 = [float(x) for x in ref[:3]]
    ok_e = all(abs(a - b) <= E_ATOL + E_RTOL * abs(b)
               for a, b in zip(e_b3, e_b1))
    print(f"[kernel] B3 path against B1's energy sweep (list of "
          f"{sw1.cap} entries, nowrap {sw1.nowrap}): max |dF| "
          f"{float(f_err.max()):.3e} (rtol {F_RTOL} atol {F_ATOL}); "
          f"e_lj/e_coul/e_corr B3 {e_b3} B1 {e_b1} (rtol {E_RTOL} atol "
          f"{E_ATOL})")
    if not (ok_f and ok_e):
        raise AssertionError("B3's sweep disagrees with B1's")

    pairs = cutoff_pairs(posd, boxd, rc)
    fout = pr.rect_pair(*args, **kw)
    torch.cuda.synchronize()
    evals = int(pr.rect_pair.evaluations.sum())
    lay = pr.rect_layout(p2, boxd, n)
    model = pr.culled_evaluations(lay, boxd, rc)
    b_ms, b_by = bound(pairs * RECT_OPS, nbytes(*args, fout))
    print(f"[kernel] B3: {pairs / 1e6:.3f} M pairs within the cutoff; bound "
          f"on those {b_ms:.4f} ms ({b_by}); the kernel made {evals} ordered "
          f"evaluations ({evals / pairs:.2f} a cutoff pair; the torch model "
          f"of its skips {model}), the first design {n_pad * n_pad} "
          f"({n_pad * n_pad / pairs:.1f} a pair)")
    if evals > B3_MAX_EVALS * pairs:
        raise AssertionError(f"B3 made {evals / pairs:.2f} evaluations a "
                             f"cutoff pair (at most {B3_MAX_EVALS})")
    # the kernel alone (the profiler's time of its kernel in the wrapper's
    # calls), and the wrapper with its sort (graph-capturable: no host read)
    dev = device_ms(lambda: pr.rect_pair(*args, **kw), graph=True,
                    kernel="rect_pair_kernel")
    measure = device_ms.measure
    wrap_dev = device_ms(lambda: pr.rect_pair(*args, **kw), graph=True)
    wrap_measure = device_ms.measure
    print(f"[kernel] B3: device time of the kernel {dev:.5f} ms "
          f"({measure}), {100 * b_ms / dev:.2f}% of the bound; the wrapper "
          f"with its sort {wrap_dev:.5f} ms device ({wrap_measure}), "
          f"{ms:.4f} ms by events around one call")
    return dict(launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, device_ms=dev,
                device_measure=measure, wrapper_device_ms=wrap_dev,
                evaluations=evals,
                model_evaluations=model, cutoff_pairs=pairs,
                evals_per_cutoff_pair=evals / pairs)


def profiled_device_us(prof, kernel=None):
    """(device microseconds, device events) of a finished torch.profiler
    run: its CUDA kernel time, of the kernels whose name holds ``kernel``
    only where that is given.  The time is 0 where the profiler's device
    tracing recorded nothing, as it does in some sandboxed machines."""
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
              and (kernel is None or kernel in e.key)]
    return sum(e.self_device_time_total for e in events), events


def device_ms(fn, calls=50, graph=False, kernel=None, profiler=True):
    """Device time of one call: the CUDA kernel time torch.profiler records
    over ``calls`` calls (after a warm-up), divided by ``calls``; with
    ``kernel``, that of the kernels whose name holds it only.  For
    kernels of a few microseconds, where CUDA events around one call would
    time the host's launch gap.  Where the profiler records no device time
    (tried twice), the time is taken with one pair of CUDA events around
    all ``calls`` calls: with ``graph`` (a call that captures: no host read,
    no synchronisation) as one CUDA graph of the ``calls`` calls replayed
    between the events, which leaves out the host's launch gaps; else
    eagerly, which includes them, an upper limit of the device time.
    Those events time the whole call, ``kernel`` or not.  Without
    ``profiler`` the events take the time at once.
    ``device_ms.measure`` names the measure of the last time returned:
    "profiler", "graph events" or "eager events", with "(the whole call)"
    where ``kernel`` could not be kept apart."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    for _ in range(2 if profiler else 0):
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = profiled_device_us(prof, kernel)[0]
        if us > 0:
            device_ms.measure = "profiler"
            return us / 1e3 / calls
    whole = "" if kernel is None else " (the whole call)"
    if profiler and not device_ms.warned:
        device_ms.warned = True
        print("[timing] torch.profiler recorded no device time: the device "
              "times of this run are CUDA-event times around a batch of "
              "calls, replayed as one CUDA graph where a line says \"graph "
              "events\", else eager (launch gaps included, an upper limit)")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        try:
            with torch.cuda.graph(g):
                for _ in range(calls):
                    fn()
        except RuntimeError as exc:
            print(f"[timing] a call did not capture ({exc}); timed eagerly")
        else:
            g.replay()
            torch.cuda.synchronize()
            a.record()
            g.replay()
            b.record()
            b.synchronize()
            device_ms.measure = "graph events" + whole
            return a.elapsed_time(b) / calls
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    device_ms.measure = "eager events" + whole
    return a.elapsed_time(b) / calls


device_ms.warned = False
device_ms.measure = None


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
        # of the block, the function reads only the rows (B6) or lanes (B7,
        # B8: idx % 128) that this run's indices name
        used = torch.unique(idx % 128 if key == "B8" else idx).numel()
        blk_bytes = used * blk.shape[1 if key == "B6" else 0] \
            * blk.element_size()
        n_bytes = blk_bytes + nbytes(idx, out)
        b_ms, b_by = bound(0, n_bytes)

        def timed(call, what):
            """Device time of one call; a time below the byte bound (the
            profiler lost kernel records) is taken again by CUDA-graph
            events."""
            t = device_ms(call, graph=True)
            if t < b_ms:
                print(f"[timing] {key} {what}: {t:.5f} ms by the "
                      f"{device_ms.measure}, below the bound {b_ms:.5f} ms; "
                      f"timed again by CUDA-graph events")
                t = device_ms(call, graph=True, profiler=False)
            return t

        ms = timed(lambda: fn(blk, idx), "kernel")
        measure = device_ms.measure
        plain_ms = timed(lambda: plain(blk, idx), "plain")
        library_ms = timed(lambda: library(blk, idx), "library")
        print(f"[kernel] {key} ({fn.__name__}): bitwise equal to its plain "
              f"version, torch.index_select and itself over 3 runs; device "
              f"time ({measure}) kernel {ms:.5f} ms, plain {plain_ms:.5f}, "
              f"library {library_ms:.5f}; bound {b_ms:.5f} ms ({b_by}, "
              f"{n_bytes / 1e6:.3f} MB: {used} of the block's "
              f"{blk.shape[0 if key == 'B6' else 1]} "
              f"{'rows' if key == 'B6' else 'lanes'} read), "
              f"{100 * b_ms / ms:.1f}% of it")
        res[key] = dict(name=fn.__name__, launches=launches[key],
                        max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                        device_measure=measure,
                        tool_us_per_call=[v[0] for k, v in tool.items()
                                          if f"({key})" in k][0])
    b7 = res["B7"]
    print(f"[kernel] B7 against its targets: half of its bound "
          f"(<= {2 * b7['bound_ms']:.5f} ms) "
          f"{'met' if b7['ms'] <= 2 * b7['bound_ms'] else 'missed'}, no "
          f"slower than index_select ({b7['library_ms']:.5f} ms) "
          f"{'met' if b7['ms'] <= b7['library_ms'] else 'missed'}")
    return res


def _rotation(rng):
    """A uniform random rotation matrix (from a unit quaternion)."""
    import numpy as np
    q = rng.normal(size=4)
    a, b, c, d = q / np.linalg.norm(q)
    return np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d),
         2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a - b * b + c * c - d * d,
         2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b),
         a * a - b * b - c * c + d * d]])


def cluster_molecule(kind):
    """(masses, local coordinates in nm, constraints (i, j)) of one molecule
    of ``kind``: "swm4" the rigid SWM4-NDP water (O, H1, H2 a constrained
    triangle, then its unconstrained M site and Drude, as the benchmark's
    layout orders the sites), "k1" an O-H pair, "k2" a water with its two
    O-H bonds constrained and H-H free (one given as H-O), "ch3" a methyl
    star (K = 3 over 4 atoms, one bond given as H-C), "ch4" methane (K = 4
    over 5 atoms)."""
    import numpy as np
    th = np.deg2rad(104.52) / 2
    oh = 0.09572
    water = np.array([[0.0, 0.0, 0.0], [oh * np.sin(th), oh * np.cos(th), 0],
                      [-oh * np.sin(th), oh * np.cos(th), 0]])
    tet = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]]) \
        / np.sqrt(3.0)
    o, h, c = 15.9994, 1.008, 12.011
    if kind == "swm4":
        m_site = [0.0, 0.024034, 0.0]
        return ([15.5994, h, h, 0.0, 0.4],
                np.vstack([water, [m_site, [0.0, 0.0, 0.0]]]),
                [(0, 1), (0, 2), (1, 2)])
    if kind == "k1":
        return [o, h], water[:2], [(0, 1)]
    if kind == "k2":
        return [o, h, h], water, [(0, 1), (2, 0)]
    if kind == "ch3":
        return ([c, h, h, h], np.vstack([[0.0, 0.0, 0.0], 0.109 * tet[:3]]),
                [(0, 1), (2, 0), (0, 3)])
    if kind == "ch4":
        return ([c, h, h, h, h], np.vstack([[0.0, 0.0, 0.0], 0.109 * tet]),
                [(0, 1), (0, 2), (3, 0), (0, 4)])
    raise ValueError(f"unknown molecule kind {kind!r}")


def cluster_system(seed, counts, box=CC_BOX, edge_share=0.3, disp=0.002,
                   vel_sd=0.5):
    """Molecules of the kinds in ``counts`` (kind -> number, see
    ``cluster_molecule``) in a cubic box of side ``box`` nm, in a seeded
    random order, place and orientation; ``edge_share`` of them centred
    within 0.05 nm of a box face, and every atom wrapped into the box on
    its own, so that those clusters straddle the face and only the minimum
    image joins them.  Returns (pairs, dists, inv_masses, pos, new, vel,
    box) as int32 / float32 arrays: ``pos`` satisfies the constraints,
    ``new`` is ``pos`` moved by about ``disp`` nm a coordinate (a step's
    drift), ``vel`` Gaussian; massless sites have inverse mass 0."""
    import numpy as np
    rng = np.random.default_rng(seed)
    side = np.full(3, float(box))
    kinds = [k for k, n in sorted(counts.items()) for _ in range(n)]
    rng.shuffle(kinds)
    xs, inv_m, pairs, dists = [], [], [], []
    n = 0
    for kind in kinds:
        masses, loc, cons = cluster_molecule(kind)
        centre = rng.uniform(0.0, side)
        if rng.uniform() < edge_share:
            ax = rng.integers(3)
            centre[ax] = rng.uniform(-0.05, 0.05) % side[ax]
        xs.append(centre + loc @ _rotation(rng).T)
        for i, j in cons:
            pairs.append((n + i, n + j))
            dists.append(np.linalg.norm(loc[i] - loc[j]))
        inv_m += [1.0 / m if m > 0 else 0.0 for m in masses]
        n += len(masses)
    pos = np.vstack(xs) % side
    new = pos + rng.normal(0.0, disp, pos.shape)
    vel = rng.normal(0.0, vel_sd, pos.shape)
    f = np.float32
    return (np.asarray(pairs, np.int32), np.asarray(dists, f),
            np.asarray(inv_m, f), pos.astype(f), new.astype(f),
            vel.astype(f), side.astype(f))


def constraint_residuals(pos, vel, pairs, dists, box):
    """(max relative bond-length error, max relative velocity along the
    bonds) in float64 of float32 rows: | |r_ij| - d | / d under the
    minimum image, and |(v_i - v_j) . r_ij| / (|r_ij| rms|v|)."""
    import numpy as np
    p = np.asarray(pos, np.float64)
    dr = p[pairs[:, 0]] - p[pairs[:, 1]]
    dr -= box * np.round(dr / box)
    r = np.linalg.norm(dr, axis=1)
    rel_pos = float(np.max(np.abs(r - dists) / dists))
    if vel is None:
        return rel_pos, None
    v = np.asarray(vel, np.float64)
    rv = np.sum((v[pairs[:, 0]] - v[pairs[:, 1]]) * dr, axis=1)
    return rel_pos, float(np.max(np.abs(rv) / r)
                          / np.sqrt(np.mean(v * v)))


def constraint_agreement(cons, pos, target, box, pairs, dists,
                         velocities):
    """One call of ``constraint_clusters`` (SHAKE with ``target`` the
    unconstrained positions, or RATTLE with ``target`` the velocities)
    against its plain version on the same tensors.  Returns (ok, numbers):
    ok where it launched its kind's kernel once a bucket, its rows lie
    within CC_ULPS float32 epsilons of the largest |entry| of the plain
    version's, its residual (``constraint_residuals``) is at or below the
    plain version's plus the rounding of the rows (one epsilon of the
    largest coordinate over the shortest bond; four of the largest
    |velocity| over their rms), rows outside every cluster are bitwise
    ``target``'s and two more calls are bitwise alike."""
    import numpy as np
    import torch
    from openmm_velocityverlet_tpu_torch.ops import constraints as cc
    plain = (cc.solve_velocity_clusters if velocities
             else cc.solve_position_clusters)
    kind = "rattle_launches" if velocities else "shake_launches"
    before = getattr(cc.constraint_clusters, kind)
    out = cc.constraint_clusters(pos, target, box, cons,
                                 velocities=velocities)
    launches = getattr(cc.constraint_clusters, kind) - before
    ref = plain(pos, target, box, cons)
    torch.cuda.synchronize()
    eps = float(np.finfo(np.float32).eps)
    err = float((out - ref).abs().max())
    tol = CC_ULPS * eps * float(target.abs().max())
    p_np, b_np = pos.cpu().numpy(), box.cpu().numpy()
    if velocities:
        got, want = (constraint_residuals(p_np, v.cpu().numpy(), pairs,
                                          dists, b_np)[1] for v in (out, ref))
        t = target.double()
        slack = 4 * eps * float(t.abs().max() / t.square().mean().sqrt())
    else:
        got, want = (constraint_residuals(x.cpu().numpy(), None, pairs,
                                          dists, b_np)[0] for x in (out, ref))
        slack = eps * float(b_np.max()) / float(np.min(dists))
    inside = cons.atom_in_cluster
    untouched = torch.equal(out[~inside], target[~inside])
    same = all(torch.equal(cc.constraint_clusters(
        pos, target, box, cons, velocities=velocities), out)
        for _ in range(2))
    ok = (launches == len(cons.buckets) and err <= tol
          and got <= want + slack and untouched and same)
    return ok, dict(launches=launches, max_abs_err=err, tolerance=tol,
                    residual=got, plain_residual=want, slack=slack,
                    untouched=untouched, bitwise_alike=same)


def constraint_phase(ctx, dt):
    """The constraint-cluster kernels (csrc/constraint_clusters.cu) at the
    shapes path 1 launches: ``ctx``'s own constraint data (one bucket of
    waters with their two O-H bonds constrained, K = 2, in the smoke's
    ``drude_water_box``), its positions and velocities, and as SHAKE's target
    the positions moved by ``dt`` times the velocities.  SHAKE and RATTLE
    through ``constraint_clusters`` against their plain versions on the
    same CUDA tensors (``constraint_agreement``); then each timed with CUDA
    events around one call (the wrapper's copy and launch, host gaps
    included), the kernel's device time alone (torch.profiler, else
    CUDA-graph events of the whole call) and the plain versions' times."""
    from openmm_velocityverlet_tpu_torch.ops import constraints as cc
    cons = ctx.cons
    if not (cons.use_clusters and cons.buckets):
        raise AssertionError("constraint phase: path 1 has no cluster "
                             "buckets")
    st = ctx.state
    P, V, B = st.pos, st.vel, st.box
    pairs, dists = cons.pairs.cpu().numpy(), cons.dist.cpu().numpy()
    shapes = ", ".join(f"{bk['ncl']} clusters of K = {bk['K']}"
                       for bk in cons.buckets)
    res = {}
    for key, velocities, target, plain in (
            ("shake", False, P + dt * V, cc.solve_position_clusters),
            ("rattle", True, V, cc.solve_velocity_clusters)):
        ok, num = constraint_agreement(cons, P, target, B, pairs, dists,
                                       velocities)
        if not ok:
            raise AssertionError(f"constraint {key} against its plain "
                                 f"version: {num}")
        call = functools.partial(cc.constraint_clusters, P, target, B, cons,
                                 velocities=velocities)
        ms = cuda_time_ms(call)
        device = device_ms(call, graph=True, kernel=f"{key}_kernel")
        measure = device_ms.measure
        plain_ms = cuda_time_ms(lambda: plain(P, target, B, cons))
        # a cluster reads its A rows of ref and of target and writes them,
        # and reads its tables
        n_bytes = nbytes(B) + sum(
            3 * bk["A"] * bk["ncl"] * 3 * P.element_size()
            + nbytes(bk["gid"], bk["w"], bk["invm"])
            + (0 if velocities else nbytes(bk["d2"])) for bk in cons.buckets)
        b_ms, b_by = bound(0, n_bytes)
        print(f"[kernel] constraint {key} ({shapes}; {P.shape[0]} atoms): "
              f"max |kernel - plain| "
              f"{num['max_abs_err']:.3e} (tolerance {num['tolerance']:.3e}), "
              f"residual {num['residual']:.3e} (plain "
              f"{num['plain_residual']:.3e}), {num['launches']} launch a "
              f"call; ms {ms:.4f} (events around one call, copy included), "
              f"device {device:.5f} ({measure}), plain {plain_ms:.4f}; bound "
              f"{b_ms:.5f} ms ({b_by}, {n_bytes / 1e6:.3f} MB)")
        res[key] = dict(num, clusters=shapes, ms=ms, device_ms=device,
                        device_measure=measure, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by)
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


def drive(tag, ctx, n_steps, counters, card, dt, mark=None):
    """step(20) warm-up, then the counters set to 0 and step(n_steps)
    timed; returns (steps/s, {counter: launches}).  ``mark()`` runs between
    the two."""
    import torch
    from openmm_velocityverlet_tpu_torch.units import ns_per_day
    t0 = time.perf_counter()
    ctx.step(20)
    torch.cuda.synchronize()
    print(f"[{tag}] warm-up step(20) {time.perf_counter() - t0:.3f} s, "
          f"kinetic {ctx.kinetic_energy():.1f}")
    if mark is not None:
        mark()
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
    stale = pair_cache(ev, stale_pos, st.box)
    fresh = pair_cache(ev, st.pos, st.box)
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


def profile(tag, ctx, step_ms, top=12, run=None, n=20):
    """torch.profiler over ``n`` steps, ``ctx.step(n)`` unless ``run`` is
    given: prints device busy ms/step, kernels/step, the idle share and the
    top kernels, and returns (busy ms/step, kernels/step), or None where
    the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    import torch
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        (run or ctx.step)(n)
        torch.cuda.synchronize()
    dev_us, kernels_ev = profiled_device_us(prof)
    if dev_us <= 0:
        print(f"[profile {tag}] device busy time not measured: "
              f"torch.profiler recorded no device time in {n} steps "
              f"(unprofiled {step_ms:.3f} ms/step)")
        return None
    n_kernels = sum(e.count for e in kernels_ev)
    busy_ms = dev_us / 1e3 / n
    print(f"[profile {tag}] device busy {busy_ms:.3f} ms/step (torch.profiler"
          f" kernel time of {n} steps), {n_kernels / n:.0f} kernels/step; "
          f"against the unprofiled {step_ms:.3f} ms/step the device idles "
          f"{100 * (1 - busy_ms / step_ms):.1f}% of the step")
    ranked = sorted(kernels_ev, key=lambda e: -e.self_device_time_total)
    # the largest kernels, and the port's own wherever they rank (nvcc
    # puts them in an anonymous namespace)
    for e in ranked[:top] + [
            e for e in ranked[top:] if e.key.removeprefix("void ").startswith(
                "(anonymous namespace)::")]:
        print(f"[profile {tag}] {e.self_device_time_total / n / 1e3:8.4f} "
              f"ms/step {e.count / n:6.1f}/step  {e.key[:90]}")
    return busy_ms, n_kernels / n


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


def small_agreement(tag, wire=None, make=None, prepare=None, **opts):
    """A 64-molecule system, 10 steps on the card against the CPU run of
    the same code (plain versions): positions and energy terms agree.
    ``wire(integ, n_mol)`` sets integrator features; ``make()`` returns
    (system, positions, box, wire, Context options) in place of the
    drude_water box; ``prepare(ctx)`` runs after construction and returns
    a record both runs must share (the barostat's accept sequence).
    Returns the card run's energy terms."""
    import numpy as np
    from openmm_velocityverlet_tpu_torch import Context, VVIntegrator
    from openmm_velocityverlet_tpu_torch.models.drude_water import \
        drude_water_box
    if make is None:
        system, pos, box = drude_water_box(64, r_cutoff=0.7)
    else:
        system, pos, box, wire, more = make()
        opts = dict(opts, **more)
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
        record = prepare(ctx) if prepare is not None else None
        ctx.set_velocities(vel)
        ctx.step(10)
        out[dev] = (ctx.get_positions(), ctx.potential_energy_terms(),
                    record)
    dpos = float(np.abs(out[DEVICE][0] - out["cpu"][0]).max())
    worst = max(abs(out[DEVICE][1][k] - v) / (abs(v) + 1.0)
                for k, v in out["cpu"][1].items())
    print(f"[check] {tag}: {system.n_atoms}-atom 10-step card vs CPU: "
          f"max |dpos| = "
          f"{dpos:.3e} nm, max term diff/(|E|+1) = {worst:.3e}"
          + (f"; record card {out[DEVICE][2]} CPU {out['cpu'][2]}"
             if prepare is not None else ""))
    if not (dpos < 1e-4 and worst < 1e-3
            and out[DEVICE][2] == out["cpu"][2]):
        raise AssertionError(f"{tag}: card run disagrees with the CPU run")
    return out[DEVICE][1]


def edl_system(n_water=4200, n_pairs=700, elec_grid=(16, 26),
               r_cutoff=R_CUTOFF, seed=5):
    """A constant-voltage cell in the layout of tests/test_edl.py:15-78 at
    edl_Im21's counts, built with the port's SystemBuilder and
    models/helper.py as examples/run-edl.py wires it.  Not a model of the
    package: the real edl_Im21 files are not in the repository.

    Two electrodes of three layers of elec_grid neutral LJ sites (0.34 nm
    apart) sit just above the plane z = 0 and just below the mirror plane
    z = Lz/2; between them, on drude_water_box's 0.55 nm grid, n_water
    molecules in its layout and n_pairs ion pairs in build_edl's (a
    polarizable cation and an anion on two sites), the species on sites
    drawn at random but listed in blocks (waters, cations, anions) as a
    topology file lists its residues, which keeps the thermostat's
    contiguous-molecule runs to one a species; then one massless image
    per liquid atom, a trailing block at z' = Lz - z with the negated
    charge, its parent's exclusions (mirror_image_exclusions) and LJ only
    with the liquid (groups [(0,0),(0,2),(2,2),(1,0)]).  Returns (system,
    positions, box, lz, {"elec", "liquid", "drudes", "image_pairs"})."""
    import types
    import numpy as np
    from openmm_velocityverlet_tpu_torch import SystemBuilder
    from openmm_velocityverlet_tpu_torch.models import helper
    rng = np.random.default_rng(seed)
    b = SystemBuilder()
    ex, ey = elec_grid
    lx, ly = ex * 0.34, ey * 0.34
    nx, ny = max(1, round(lx / 0.55)), max(1, round(ly / 0.55))
    n_sites = n_water + 2 * n_pairs
    nz = -(-n_sites // (nx * ny))
    top = 0.85 + (nz - 1) * 0.55                 # the last liquid layer
    zm = top + 0.85                              # the mirror plane
    lz = 2.0 * zm
    box = np.array([lx, ly, lz])
    pos, elec = [], []
    gx, gy = np.meshgrid(np.arange(ex), np.arange(ey), indexing="ij")
    for k, z in enumerate((0.10, 0.25, 0.40, zm - 0.40, zm - 0.25,
                           zm - 0.10)):
        off = 0.17 * (k % 2)
        for x, y in zip(gx.reshape(-1), gy.reshape(-1)):
            elec.append(b.add_particle(95.0, charge=0.0, lj_type=3))
            pos.append([(x + 0.5) * 0.34 + off, (y + 0.5) * 0.34 + off, z])
    sites = [((i % nx + 0.5) * lx / nx, ((i // nx) % ny + 0.5) * ly / ny,
              0.85 + (i // (nx * ny)) * 0.55) for i in range(n_sites)]
    kinds = ["w"] * n_water + ["c"] * n_pairs + ["a"] * n_pairs
    liquid, drudes = [], []
    for site, kind in zip(rng.permutation(n_sites), kinds):
        cx, cy, cz = sites[site]
        if kind == "w":
            o = b.add_particle(15.2, charge=1.2, lj_type=0)
            d = b.add_particle(0.4, charge=-1.0, lj_type=1)
            h1 = b.add_particle(1.008, charge=-0.1, lj_type=1)
            h2 = b.add_particle(1.008, charge=-0.1, lj_type=1)
            mol = [o, d, h1, h2]
            pos += [[cx, cy, cz], [cx + 1e-3, cy, cz],
                    [cx + 0.0957, cy, cz], [cx, cy + 0.0957, cz]]
            b.add_drude(d, o, -1, -1, -1, -1.0, 0.00097, 1.0, 1.0)
            b.add_constraint(o, h1, 0.0957)
            b.add_constraint(o, h2, 0.0957)
            b.add_angle(h1, o, h2, 1.824, 300.0)
            for i in mol:
                for j in mol:
                    if i < j:
                        b.add_exclusion(i, j)
        elif kind == "c":
            c = b.add_particle(39.0, charge=1.8, lj_type=2)
            d = b.add_particle(0.4, charge=-0.8, lj_type=1)
            b.add_drude(d, c, -1, -1, -1, -0.8, 1e-3, 0.0, 0.0)
            b.add_exclusion(c, d)
            mol = [c, d]
            pos += [[cx, cy, cz], [cx + 1e-3, cy, cz]]
        else:
            mol = [b.add_particle(35.0, charge=-1.0, lj_type=2)]
            pos.append([cx, cy, cz])
            d = None
        liquid += mol
        if d is not None:
            drudes.append(d)
    image_pairs = []
    for p in liquid:
        image_pairs.append((p, b.add_particle(1.0, lj_type=4)))
        pos.append([pos[p][0], pos[p][1], lz - pos[p][2]])
    b.set_lj_from_type_params([0.3166, 0.1, 0.35, 0.3, 0.1],
                              [0.65, 0.0, 0.4, 0.6, 0.0])
    built = types.SimpleNamespace(builder=b)
    helper.assign_image_charges(built, image_pairs)
    helper.mirror_image_exclusions(built, image_pairs)
    groups = np.zeros(len(b.masses), np.int32)
    groups[[i for _, i in image_pairs]] = 1
    groups[elec] = 2
    helper.set_lj_interaction_groups(built, groups,
                                     [(0, 0), (0, 2), (2, 2), (1, 0)])
    helper.add_molecule_links(built, image_pairs)
    system = b.finalize(box, r_cutoff=r_cutoff, use_pme=True)
    return system, np.asarray(pos, np.float32), box, lz, dict(
        elec=elec, liquid=liquid, drudes=drudes, image_pairs=image_pairs)


def edl_wiring(integ, lz, groups, langevin=True):
    """examples/run-edl.py's wiring at 1 V (:105-119): Langevin on the
    electrode, the mirror at Lz/2 with every image pair, the field 2 V / Lz
    on the liquid."""
    integ.setMaxDrudeDistance(0.02)
    if langevin:
        for i in groups["elec"]:
            integ.addParticleLangevin(i)
    integ.setMirrorLocation(lz / 2)
    for parent, image in groups["image_pairs"]:
        integ.addImagePair(image, parent)
    integ.setElectricField(1.0 / lz * 2)
    for i in groups["liquid"]:
        integ.addParticleElectrolyte(i)


def edl_externals(pos, lz, groups):
    """run-edl's two external forces: the electrode restraint (:65-67) and
    the liquid Drudes' z-wall (:69-73)."""
    from openmm_velocityverlet_tpu_torch.ops import external
    return [external.spring_self(groups["elec"], pos,
                                 [0.01 * KCAL_A2, 0.01 * KCAL_A2,
                                  5.0 * KCAL_A2]),
            external.wall_lj126(groups["drudes"], 2, (0.0, lz / 2),
                                epsilon=0.5 * 4.184, sigma=0.15)]


def small_edl():
    """make() of the 64-molecule-scale EDL check: edl_system at 48
    molecules and 8 ion pairs between 6 x 6 electrode layers (648 atoms,
    cutoff 0.9 nm as build_edl), wired without the Langevin electrode."""
    system, pos, box, lz, groups = edl_system(48, 8, (6, 6), r_cutoff=0.9)
    return (system, pos, box,
            lambda integ, _n: edl_wiring(integ, lz, groups, langevin=False),
            dict(external_forces=edl_externals(pos, lz, groups)))


def mirror_gate(ctx):
    """The mirror route against the explicit evaluation over all atoms on
    the context's positions: energy, real-atom forces and image rows."""
    import torch
    from openmm_velocityverlet_tpu_torch.ops import ewald
    s, st, ev = ctx.system, ctx.state, ctx.evaluator
    n_real = ctx.image_mirror[0]
    out = []
    for mirror in (ctx.image_mirror, None):
        p = st.pos.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            e = ewald.reciprocal_energy(p, st.box, ev.t.charges,
                                        s.ewald_beta, s.kmax,
                                        chunk=ev.ewald_chunk, mirror=mirror)
            (g,) = torch.autograd.grad(e, p)
        out.append((float(e.detach()), g))
    (e_m, g_m), (e_x, g_x) = out
    scale = float(g_x[:n_real].abs().max())
    err = (g_m[:n_real] - g_x[:n_real]).abs()
    ok_f = bool(torch.all(err <= MIRROR_F_ATOL_REL * scale
                          + MIRROR_F_RTOL * g_x[:n_real].abs()))
    img_max = float(g_m[n_real:].abs().max())
    print(f"[edl] mirror reciprocal {e_m:.6f} against the explicit "
          f"{e_x:.6f} over all {st.pos.shape[0]} atoms (rtol "
          f"{MIRROR_E_RTOL}); real-atom forces max |dF| "
          f"{float(err.max()):.3e} (rtol {MIRROR_F_RTOL}, atol "
          f"{MIRROR_F_ATOL_REL} x {scale:.3f}); image rows max "
          f"{img_max}")
    if not (abs(e_m - e_x) <= MIRROR_E_RTOL * abs(e_x) and ok_f
            and img_max == 0.0):
        raise AssertionError("the mirror reciprocal disagrees with the "
                             "explicit evaluation")
    return e_m


def edl_path(card, dt, counters):
    """Path 6: constant voltage at edl_Im21's counts on the mirror route;
    its gates, B1 on its culled group-rows list, and the fused leg.
    Returns the numbers of the kernels line."""
    import numpy as np
    import torch
    from openmm_velocityverlet_tpu_torch import Context, VVIntegrator
    from openmm_velocityverlet_tpu_torch.ops import pair_plist as pp
    t0 = time.perf_counter()
    system, pos, box, lz, groups = edl_system()
    integ = VVIntegrator(333, 10, 1, 40, 0.001)
    edl_wiring(integ, lz, groups)
    externals = edl_externals(pos, lz, groups)
    t1 = time.perf_counter()
    ctx = Context(system, integ, positions=pos, box=box, device=DEVICE,
                  external_forces=externals)
    ctx.set_velocities_to_temperature(333.0)
    ev = ctx.evaluator
    sw = ev.pairs
    inert = sw.inert
    culled = [pp.count_candidates_np(pos, box, sw.ts, sw.rc_cand,
                                     mode=sw.sort, inert=m)
              for m in (None, inert)]
    print(f"[edl] {system.n_atoms} atoms ({len(groups['elec'])} electrode, "
          f"{len(groups['liquid'])} liquid, {len(groups['image_pairs'])} "
          f"images), box {np.round(box, 3).tolist()} nm, kmax "
          f"{system.kmax}, mirror {ctx.image_mirror}; built in "
          f"{t1 - t0:.1f} s, Context in {time.perf_counter() - t1:.1f} s; "
          f"ts {sw.ts} sort {sw.sort} nowrap {sw.nowrap}, "
          f"list capacity {sw.cap} (energy list {sw.cap_all}); "
          f"the inert cull removes {culled[0] - culled[1]} of "
          f"{culled[0]} candidate tile pairs; thermostat molecule runs "
          f"{ctx._thermo['mol_runs']}")
    if ctx.image_mirror is None:
        raise AssertionError("the EDL layout did not take the mirror route")
    _, el, launches = drive("edl", ctx, 100, counters, card, dt)
    if launches["B1"] < 100:
        raise AssertionError(f"B1 launched {launches['B1']} < 100 times")
    check_finite("edl", ctx, system)
    profile("path 6", ctx, el / 100 * 1e3, top=8)

    p = ctx.get_positions()
    pairs = np.asarray(groups["image_pairs"])
    par, img = pairs[:, 0], pairs[:, 1]
    zm = ctx.data.mirror_location
    sync = max(float(np.abs(p[img, :2] - p[par, :2]).max()),
               float(np.abs(p[img, 2] - (2 * zm - p[par, 2])).max()))
    terms = ctx.potential_energy_terms()
    coul = abs(terms["coul_direct"]) / system.n_atoms
    dz = float(np.abs(p[groups["elec"], 2] - pos[groups["elec"], 2]).max())
    dmax = float(p[groups["drudes"], 2].max())
    print(f"[edl] image sync max error {sync:.3e} nm (atol "
          f"{IMAGE_SYNC_ATOL}); |coul_direct| {coul:.2f} kJ/mol an atom "
          f"(limit {COUL_PER_ATOM}); electrode max |dz| {dz:.4f} nm (limit "
          f"0.2); liquid Drude max z {dmax:.4f} nm (limit Lz/2 + 0.05 = "
          f"{lz / 2 + 0.05:.4f}); external_0 {terms['external_0']:.3f}, "
          f"external_1 {terms['external_1']:.3f}, group 0 "
          f"{ctx.group_energies()[0]:.3f} kJ/mol")
    if not (sync <= IMAGE_SYNC_ATOL and coul < COUL_PER_ATOM and dz < 0.2
            and dmax < lz / 2 + 0.05):
        raise AssertionError("path 6 failed an EDL gate")
    e_mirror = mirror_gate(ctx)

    # B1 in its group-rows form on the step's list (inert tile pairs
    # culled), on the path's positions with every Drude 0.05 nm from its
    # core and the images synced (see jittered_positions: the energy form's
    # excluded-pair force is float32 noise at the path's 0.001-0.02 nm)
    from openmm_velocityverlet_tpu_torch.integrators import stepping
    st = ctx.state
    dp = torch.as_tensor(np.asarray(system.drude_pairs), device=ctx.device)
    g = torch.Generator(device=ctx.device)
    g.manual_seed(1)
    u = torch.randn((dp.shape[0], 3), generator=g, device=ctx.device)
    pos_b = st.pos.clone()
    pos_b[dp[:, 0]] = pos_b[dp[:, 1]] + 0.05 * u / u.norm(dim=1,
                                                            keepdim=True)
    pos_b = stepping.update_image_positions(pos_b, ctx._images, zm)
    cache = refitted_cache(ev, pos_b, st.box)
    stack = cache.ab2.shape[0] // cache.perm.shape[0]
    if stack != 3 or cache.tile_inert is None:
        raise AssertionError("path 6's list is not in group-rows form with "
                             "the inert cull")
    res, evals, tensors = b1_case("B1 edl", ev, cache, pos_b, st.box,
                                  system)
    inert_d = torch.as_tensor(inert, device=ctx.device)
    pairs_f = cutoff_pairs(ev.place_vsites(pos_b), st.box, system.r_cutoff,
                           inert=inert_d)
    b_ms, b_by = bound(pairs_f * PAIR_OPS, nbytes(*tensors))
    n_active = int(((cache.plist & 1) == 1).sum())
    print(f"[kernel] B1 edl: stack {stack} (group rows), {n_active} entries, "
          f"{evals / 1e6:.2f} M evaluations, {pairs_f / 1e6:.3f} M cutoff "
          f"pairs not both images ({evals / pairs_f:.2f} evaluations a "
          f"pair); device {res['force'][3]:.4f} ms force, "
          f"{res['energy'][3]:.4f} ms energy; bound {b_ms:.4f} ms ({b_by})")

    # the fused leg: B4/B5 over all atoms, images included
    ctx_f = Context(system, integ, positions=ctx.get_positions(), box=box,
                    device=DEVICE, external_forces=externals,
                    recip="exact_fused", pair_ts=sw.ts)
    ctx_f.set_velocities(ctx.get_velocities())
    e_fused = ctx_f.potential_energy_terms()["coul_recip"]
    print(f"[edl] fused route coul_recip {e_fused:.6f} at the leg's start, "
          f"mirror route {e_mirror:.6f} (rtol {MIRROR_E_RTOL})")
    if abs(e_fused - e_mirror) > MIRROR_E_RTOL * abs(e_mirror):
        raise AssertionError("the fused route disagrees with the mirror "
                             "route")
    # B4 (its nz groups cut over grid.z at this tall kmax) and B5 mode by
    # mode and atom by atom against their plain versions at the leg's shapes
    recip = recip_phase(ctx_f, " edl")
    from openmm_velocityverlet_tpu_torch.ops import ewald_fused as ef
    fc = {"B1": pp.plist_pair, "B4": ef.structure_factor,
          "B5": ef.recip_forces}
    for fn in fc.values():
        fn.launches = 0
    t0 = time.perf_counter()
    ctx_f.step(20)
    torch.cuda.synchronize()
    lf = {k: fn.launches for k, fn in fc.items()}
    print(f"[edl fused] 20 steps in {time.perf_counter() - t0:.3f} s; "
          f"launches {lf}")
    if lf["B4"] < 20 or lf["B5"] < 20:
        raise AssertionError("the fused leg did not launch B4/B5 each step")
    check_finite("edl fused", ctx_f, system)
    return dict(launches=launches["B1"], fused=lf, b1=res, evals=evals,
                pairs=pairs_f, bound_ms=b_ms, bound_by=b_by, recip=recip)


def npt_gate(ctx, attempts=8, want=2):
    """Up to ``attempts`` more barostat attempts, one step at a time, until
    ``want`` were accepted: each accepted move leaves every term finite,
    its step trips no coverage check, and the State's box after the attempt
    is the one before it scaled alike on every axis (the iso barostat)."""
    import numpy as np
    freq = ctx.barostat.frequency
    taken = 0
    for _ in range(attempts * freq):
        due = ctx.current_step % freq == 0
        box0, acc0, cov0 = ctx.get_box(), ctx.baro_accepts, \
            ctx.coverage_rebuilds
        ctx.step(1)
        if not due or ctx.baro_accepts == acc0:
            continue
        taken += 1
        box1 = ctx.get_box()
        scale = box1.astype(np.float64) / box0
        terms = ctx.potential_energy_terms()
        finite = all(np.isfinite(v) for v in terms.values())
        print(f"[npt] accepted move at step {ctx.current_step - 1}: box "
              f"{box0.tolist()} -> {box1.tolist()}, axis_scale "
              f"{scale.tolist()}, coverage trips on its step "
              f"{ctx.coverage_rebuilds - cov0}, terms finite {finite}")
        if not (finite and ctx.coverage_rebuilds == cov0
                and scale[0] != 1.0
                and np.allclose(scale, scale[0], rtol=1e-6, atol=0.0)):
            raise AssertionError("an accepted barostat move failed its gate")
        if taken >= want:
            return taken
    if not taken:
        raise AssertionError(f"no barostat move accepted in {attempts} "
                             f"attempts")
    return taken


def npt_draws(ctx):
    """prepare() of the small NPT check: the barostat's draws from a numpy
    stream seeded alike on both devices, and its accept sequence logged."""
    import numpy as np
    rng = np.random.default_rng(11)
    ctx._barostat_draws = lambda: {"u_dv": float(rng.uniform()),
                                   "u_acc": float(rng.uniform())}
    log = []
    real = ctx._barostat_attempt

    def logged():
        log.append(real())
        return log[-1]
    ctx._barostat_attempt = logged
    return log


def pme_routes(pos, box, q, beta, kmax, grid, chunk):
    """(E_pme, E_exact, max |F_pme - F_exact|, max |F_exact|): the PME
    route and the matmul route (energy and autograd forces) on the same
    atoms."""
    import torch
    from openmm_velocityverlet_tpu_torch.ops import ewald, pme
    out = []
    for fn in (lambda p: pme.reciprocal_energy_pme(p, box, q, beta, grid),
               lambda p: ewald.reciprocal_energy(p, box, q, beta, kmax,
                                                 chunk=chunk)):
        p = pos.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            e = fn(p)
            (g,) = torch.autograd.grad(e, p)
        out.append((float(e.detach()), g))
    (e_p, g_p), (e_x, g_x) = out
    return e_p, e_x, float((g_p - g_x).abs().max()), float(g_x.abs().max())


def pme_gates(ctx):
    """Path 8's gates of PME against the matmul route (tests/test_pme.py:
    37, 69): forces within PME_F_ATOL_REL max|F| on the path's start
    configuration, whose energy difference is printed beside; energy
    within PME_E_RTOL and forces as above on tests/test_pme.py's
    _random_system data (uniform positions, normal charges of zero sum) at
    the path's atom count and box."""
    import numpy as np
    import torch
    s, st, ev = ctx.system, ctx.state, ctx.evaluator
    args = (s.ewald_beta, s.kmax, ev.pme_grid, ev.ewald_chunk)
    e_p, e_x, df, fmax = pme_routes(st.pos, st.box, ev.t.charges, *args)
    print(f"[pme] start configuration: PME {e_p:.6f} against the matmul "
          f"route {e_x:.6f} kJ/mol (relative {abs(e_p - e_x) / abs(e_x):.3e}"
          f"); forces max |dF| {df:.3e} (atol {PME_F_ATOL_REL} x max|F| "
          f"{fmax:.3f})")
    ok = df <= PME_F_ATOL_REL * fmax
    rng = np.random.default_rng(0)
    n = s.n_atoms
    box = st.box
    pos = torch.as_tensor(rng.uniform(0, 1, (n, 3)) * box.cpu().numpy(),
                          dtype=torch.float32, device=box.device)
    q = rng.normal(0, 1, n)
    q = torch.as_tensor(q - q.mean(), dtype=torch.float32, device=box.device)
    r_p, r_x, r_df, r_fmax = pme_routes(pos, box, q, *args)
    print(f"[pme] random charges at {n} atoms in the same box: PME "
          f"{r_p:.3f} against {r_x:.3f} kJ/mol (relative "
          f"{abs(r_p - r_x) / abs(r_x):.3e}, rtol {PME_E_RTOL}); forces "
          f"max |dF| {r_df:.3e} (atol {PME_F_ATOL_REL} x max|F| "
          f"{r_fmax:.3f})")
    ok = ok and abs(r_p - r_x) <= PME_E_RTOL * abs(r_x) \
        and r_df <= PME_F_ATOL_REL * r_fmax
    if not ok:
        raise AssertionError("PME disagrees with the exact sum")


def recip_fit():
    """The route times of ops/pme.py's cost model: the matmul route and the
    PME route (energy and autograd forces, CUDA events) on random charges
    in cubic boxes of RECIP_FIT_SIDES nm at 24 atoms/nm^3 (the drude_water
    density) with the Ewald parameters of a 1.2 nm cutoff; each route's
    three costs (fixed, and per unit of its model's two terms) fitted by
    non-negative least squares.  Returns the fitted costs and the
    points."""
    import numpy as np
    import torch
    from openmm_velocityverlet_tpu_torch.ops import ewald, pme
    rng = np.random.default_rng(3)
    pts = []
    for side in RECIP_FIT_SIDES:
        box_np = np.full(3, side)
        n = int(24 * side ** 3)
        beta, kmax = ewald.ewald_parameters(1.2, box=box_np)
        grid = pme.choose_grid(box_np)
        box = torch.as_tensor(box_np, dtype=torch.float32, device=DEVICE)
        pos = torch.as_tensor(rng.uniform(0, side, (n, 3)),
                              dtype=torch.float32, device=DEVICE)
        q = torch.as_tensor(rng.normal(0, 1, n), dtype=torch.float32,
                            device=DEVICE)

        def route(fn):
            def run():
                p = pos.detach().requires_grad_(True)
                torch.autograd.grad(fn(p), p)
            return run
        t_x = cuda_time_ms(route(lambda p: ewald.reciprocal_energy(
            p, box, q, beta, kmax, chunk=4096)), reps=5)
        t_p = cuda_time_ms(route(lambda p: pme.reciprocal_energy_pme(
            p, box, q, beta, grid)), reps=10)
        pts.append(dict(side=side, n=n, kmax=kmax, grid=grid,
                        matmul_ms=t_x, pme_ms=t_p))
    a_x = np.array([pme._exact_terms(p["n"], p["kmax"]) for p in pts])
    a_p = np.array([pme._pme_terms(p["n"], p["grid"]) for p in pts])

    def nnls(a, t):
        # non-negative least squares over the three columns: the best of
        # the unconstrained fits on each subset whose terms are all >= 0
        best = None
        for r in (1, 2, 3):
            for cols in itertools.combinations(range(3), r):
                c = np.linalg.lstsq(a[:, cols], t, rcond=None)[0]
                if (c < 0).any():
                    continue
                full = np.zeros(3)
                full[list(cols)] = c
                res = float(np.sum((a @ full - t) ** 2))
                if best is None or res < best[0]:
                    best = (res, full)
        return best[1]
    c_x = nnls(a_x, np.array([p["matmul_ms"] * 1e3 for p in pts]))
    c_p = nnls(a_p, np.array([p["pme_ms"] * 1e3 for p in pts]))
    rates = dict(zip(("EXACT_FIXED_US", "EXACT_US_PER_BYTE",
                      "EXACT_US_PER_FLOP", "PME_FIXED_US", "PME_US_PER_ROW",
                      "PME_US_PER_BUTTERFLY"),
                     [float(c) for c in (*c_x, *c_p)]))
    for p in pts:
        print(f"[recip fit] {p['side']:.2f} nm box, {p['n']} atoms, kmax "
              f"{p['kmax']}, grid {p['grid']}: matmul route "
              f"{p['matmul_ms']:.4f} ms, PME route {p['pme_ms']:.4f} ms "
              f"(the cost model as committed: "
              f"{pme.exact_sum_cost(p['n'], p['kmax']) / 1e3:.4f} / "
              f"{pme.pme_cost(p['n'], p['grid']) / 1e3:.4f} ms)")
    print("[recip fit] fitted: " + ", ".join(
        f"{k} {v:.4g} (committed {getattr(pme, k):.4g})"
        for k, v in rates.items()))
    return dict(rates=rates, points=pts)


def mesh_device():
    """The one card every rank of the mesh phase runs on."""
    return "cuda:0" if DEVICE == "cuda" else DEVICE


def mesh_context(mesh, pair_ts=0):
    """Path 2's configuration (drude_water 19.5k, fold_exc14, TGNH, exact-k
    Ewald) on ``mesh`` (None: unsharded), velocities drawn from seed
    12345."""
    from openmm_velocityverlet_tpu_torch import Context, VVIntegrator
    from openmm_velocityverlet_tpu_torch.models.drude_water import \
        drude_water_box
    system, pos, box = drude_water_box(N_MOL, r_cutoff=R_CUTOFF)
    integ = VVIntegrator(333, 10, 1, 40, 0.001)
    integ.setMaxDrudeDistance(0.02)
    ctx = Context(system, integ, positions=pos, box=box, device=DEVICE,
                  fold_exc14=True, pair_ts=pair_ts, mesh=mesh)
    ctx.set_velocities_to_temperature(333.0)
    return ctx


def row_shard_check(ctx, shard_timed=True):
    """Kernel B2's row shard of this rank on the step's own cache and
    positions (a fresh cache, as a segment's start builds it), force-only
    as the step calls it, against its plain version on the same rows; the
    shard's rows against the unsharded kernel's on the same layout
    (bitwise) and its column accumulator for the caller to sum.  Returns
    (max_abs_err, rows_bitwise, colacc, unsharded colacc, device ms,
    measure)."""
    import torch
    from openmm_velocityverlet_tpu_torch.ops import pair_tri as pt
    ev, mesh = ctx.evaluator, ctx.mesh
    cache = ctx._fresh_cache()
    pos = ev.place_vsites(ctx.state.pos)
    n, n_pad, ts = pos.shape[0], cache.perm.shape[0], ev.pairs.ts
    pos2d = torch.cat([pos, torch.full((n_pad - n, 3), 1e6,
                                       device=pos.device)])[cache.perm]
    args = (pos2d.contiguous(), cache.q, cache.ab, cache.bits, cache.bits14,
            cache.oid, cache.ljt, cache.grp, cache.grows, ctx.state.box)
    sysm = ctx.system
    kw = dict(ts=ts, t_dim=ev.pair_tables["arows"].shape[1],
              beta=sysm.ewald_beta, r_cutoff=sysm.r_cutoff, mode="bandall",
              band_w=ev.pairs.band_w, want_energy=False,
              has14=bool(ev.pair_tables.get("has_exc14", False)),
              r_switch=sysm.r_switch, n_tiles_g=-(-n // ts))
    tiles = n_pad // ts // mesh.size
    shard = dict(kw, row_off=mesh.rank * tiles, n_row_tiles=tiles)
    out = pt.tri_pair(*args, cmap=cache.cmap, **shard)
    ref = pt.tri_pair_reference(*args, **shard)
    torch.cuda.synchronize()
    err = pair_agreement(f"B2 row shard {mesh.rank}/{mesh.size}", out, ref,
                         E_RTOL, cols=())
    rows_u, col_u = pt.tri_pair(*args, cmap=cache.cmap, **kw)
    lo = mesh.rank * tiles * ts
    bitwise = bool(torch.equal(out[0], rows_u[lo:lo + tiles * ts]))
    ms = measure = None
    if shard_timed:
        # one rank at a time: two ranks share the card
        for r in range(mesh.size):
            if r == mesh.rank:
                ms = device_ms(lambda: pt.tri_pair(*args, cmap=cache.cmap,
                                                   **shard), calls=20)
                measure = device_ms.measure
            mesh.barrier()
    return err, bitwise, out[1], col_u, ms, measure


def _mesh_rank(rank, size, store, out_dir, pair_ts):
    """Leg B's rank: two ranks on one card under gloo (NCCL refuses two
    ranks on one device).  Writes its numbers to ``out_dir``; any failure
    raises, which fails the parent."""
    import pickle
    import numpy as np
    import torch
    import torch.distributed as dist
    from openmm_velocityverlet_tpu_torch.ops import pair_tri as pt
    from openmm_velocityverlet_tpu_torch.parallel import mesh as pm
    mesh = pm.make_mesh(size=size, device=mesh_device(), backend="gloo",
                        init_method=store, rank=rank)
    ctx = mesh_context(mesh, pair_ts)
    res = {"ts": ctx.evaluator.pairs.ts,
           "band_w": ctx.evaluator.pairs.band_w}
    ctx.step(1)
    res["pos1"] = ctx.get_positions()
    ctx.step(2)
    res["pos3"] = ctx.get_positions()
    err, bitwise, col, col_u, ms, measure = row_shard_check(ctx)
    mesh.all_reduce(col)
    col_err = float((col - col_u).abs().max())
    col_ok = bool(torch.all((col - col_u).abs()
                            <= F_ATOL + F_RTOL * col_u.abs()))
    res.update(err=err, rows_bitwise=bitwise, col_err=col_err,
               col_ok=col_ok, b2_device_ms=ms, b2_measure=measure)
    # the timed run, with CUDA events around every all_reduce
    ctx.step(20)
    events = []
    plain = pm.Mesh.all_reduce

    def timed(self, t):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        plain(self, t)
        b.record()
        events.append((a, b))
        return t
    pm.Mesh.all_reduce = timed
    pt.tri_pair.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx.step(100)
    torch.cuda.synchronize()
    res["elapsed"] = time.perf_counter() - t0
    pm.Mesh.all_reduce = plain
    res["launches"] = pt.tri_pair.launches
    res["allreduce_ms"] = sum(a.elapsed_time(b) for a, b in events)
    res["allreduces"] = len(events)
    res["rebuilds"], res["trips"] = ctx.rebuilds, ctx.coverage_rebuilds
    res["profile"] = profile(f"mesh B rank {rank}", ctx,
                             res["elapsed"] * 10, top=4)
    # every rank's final positions bitwise alike: the max and min over the
    # ranks of an exact checksum of their bits
    bits = ctx.state.pos.contiguous().view(torch.int32).to(torch.int64)
    check = (bits * torch.arange(1, bits.numel() + 1, device=bits.device)
             .reshape(bits.shape)).sum().reshape(1)
    hi, lo = check.clone(), check.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    res["checksums"] = (int(lo), int(hi))
    res["finite"] = bool(np.isfinite(ctx.get_positions()).all()) and all(
        np.isfinite(v) for v in ctx.potential_energy_terms().values())
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(res, fh)
    dist.destroy_process_group()


def mesh_phase(card, dt):
    """The multi-device mesh (A16) at 19,500 atoms in path 2's
    configuration.  Leg A: a world of one under NCCL beside the unsharded
    band Context from the same state, 1 and 3 steps gated, then step(100)
    timed.  Leg B: two ranks spawned on the one card under gloo, gated
    against leg A's unsharded run, their B2 row shards on the step's own
    cache against the plain version, and step(100) timed.  Returns the
    numbers of the kernels line."""
    import pickle
    import shutil
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from openmm_velocityverlet_tpu_torch.ops import pair_tri as pt
    from openmm_velocityverlet_tpu_torch.parallel.mesh import make_mesh
    from openmm_velocityverlet_tpu_torch.units import ns_per_day
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "mesh")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    # leg A
    mesh = make_mesh(size=1, device=mesh_device(),
                     backend="nccl" if DEVICE == "cuda" else "gloo", rank=0,
                     init_method=f"file://{out_dir}/store_a")
    ref = mesh_context(None)
    ctx = mesh_context(mesh, ref.evaluator.pairs.ts)
    ev = ctx.evaluator
    print(f"[mesh A] {mesh.size} rank, {mesh.backend}, {mesh.device}: "
          f"pair_mode {ev.pairs.mode}, ts {ev.pairs.ts}, band_w "
          f"{ev.pairs.band_w}, "
          f"recip {ev.recip_method}")
    traj = {}
    for n, tag in ((1, 1), (2, 3)):
        ref.step(n)
        ctx.step(n)
        traj[tag] = (ref.get_positions(), ctx.get_positions())
    d1, d3 = (float(np.abs(a - b).max()) for a, b in (traj[1], traj[3]))
    bitwise = all(np.array_equal(a, b) for a, b in traj.values())
    print(f"[mesh A] max |dpos| against the unsharded run: {d1:.3e} nm "
          f"after 1 step, {d3:.3e} after 3; bitwise equal {bitwise}")
    if not (d1 < MESH_DPOS_1 and d3 < MESH_DPOS_3):
        raise AssertionError("mesh leg A: the world of one leaves the "
                             "unsharded trajectory")
    sps_a, _, la = drive("mesh A", ctx, 100, {"B2": pt.tri_pair}, card, dt)
    if la["B2"] < 100:
        raise AssertionError(f"mesh leg A: B2 launched {la['B2']} < 100")
    check_finite("mesh A", ctx, ctx.system)
    profile("mesh A", ctx, 1e3 / sps_a, top=4)
    err_a, bit_a, _, _, _, _ = row_shard_check(ctx, shard_timed=False)
    if not bit_a:
        raise AssertionError("mesh leg A: the shard's rows differ from the "
                             "unsharded kernel's")
    ts = ev.pairs.ts
    del ctx, ref
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    # leg B: two ranks sharing the card
    t0 = time.perf_counter()
    mp.start_processes(_mesh_rank, args=(2, f"file://{out_dir}/store_b",
                                         out_dir, ts),
                       nprocs=2, start_method="spawn")
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as fh:
            ranks.append(pickle.load(fh))
    r0 = ranks[0]
    e1 = float(np.abs(r0["pos1"] - traj[1][0]).max())
    e3 = float(np.abs(r0["pos3"] - traj[3][0]).max())
    same = r0["checksums"][0] == r0["checksums"][1]
    launches = sum(r["launches"] for r in ranks)
    sps = [100 / r["elapsed"] for r in ranks]
    ar_ms = [r["allreduce_ms"] / 100 for r in ranks]
    print(f"[mesh B] 2 ranks sharing one {card} (gloo): ts {r0['ts']}, "
          f"band_w {r0['band_w']}; rank 0 max |dpos| against the unsharded "
          f"run {e1:.3e} nm after 1 step, {e3:.3e} after 3; final "
          f"positions bitwise alike on both ranks {same}")
    for r, res in enumerate(ranks):
        print(f"[mesh B] rank {r}: B2 row shard max_abs_err "
              f"{res['err']:.3e}, rows bitwise the unsharded kernel's "
              f"{res['rows_bitwise']}; summed colacc max diff "
              f"{res['col_err']:.3e} (within F tolerances "
              f"{res['col_ok']}); B2 shard device "
              f"{res['b2_device_ms']:.4f} ms ({res['b2_measure']}); "
              f"launches {res['launches']} in 100 steps; all_reduce "
              f"{res['allreduce_ms'] / 100:.4f} ms/step over "
              f"{res['allreduces']} calls (CUDA events); rebuilds "
              f"{res['rebuilds']}, coverage trips {res['trips']}; device "
              f"busy " + (f"{res['profile'][0]:.3f} ms/step, "
                          f"{res['profile'][1]:.0f} kernels/step"
                          if res["profile"] else "not measured"))
    print(f"[mesh B] 2 ranks sharing one NVIDIA H100 (gloo), not a two-card "
          f"number: {sps[0]:.2f} / {sps[1]:.2f} steps/s over step(100), "
          f"{ns_per_day(sps[0], dt):.3f} ns/day; all_reduce "
          f"{ar_ms[0]:.4f} / {ar_ms[1]:.4f} ms/step; one card unsharded "
          f"(leg A's world of one) {sps_a:.2f} steps/s; spawn to exit "
          f"{spawn_s:.1f} s")
    ok = (e1 < MESH_DPOS_1 and e3 < MESH_DPOS_3 and same
          and all(r["rows_bitwise"] and r["col_ok"] and r["finite"]
                  and r["launches"] >= 100 for r in ranks))
    if not ok:
        raise AssertionError("mesh leg B: a gate failed (see [mesh B])")
    return {"launches_mesh": launches,
            "row_sharded_max_abs_err": max([err_a] + [r["err"]
                                                      for r in ranks]),
            "row_sharded_device_ms": [r["b2_device_ms"] for r in ranks],
            "row_sharded_device_measure": r0["b2_measure"]}


def write_charmm_fixture(directory, n_side=3, spacing=0.8, seed=0,
                         by_species=False):
    """A Drude PSF/PRM pair and a .gro of its start that carry NBTHOLE and
    CMAP, in the manner of tests/test_nbthole.py:79-127 and
    tests/test_cmap.py:98-117: n_side^3 cells of ``spacing`` nm, each with
    a Drude cation (TA, +1 e) and a Drude anion (TB, -1 e) of NBTHOLE
    coefficient 2.6 between the two types, 0.35 nm apart, and a neutral
    five-atom chain (CA-CB-CC-CD-CE) with one CMAP cross-term on a 24 x 24
    map of 0.8 cos(phi) + 0.5 sin(2 psi) kcal/mol.  The residues (IMA,
    IMB, PEN) are listed cell by cell, or with ``by_species`` all IMA, then
    all IMB, then all PEN, as topology files list them (the COM thermostat
    group reduces over contiguous runs of molecules of one size, ROADMAP
    C).  Returns the paths (psf, prm, gro)."""
    import math
    import os
    import numpy as np
    rng = np.random.default_rng(seed)
    atoms, pos, bonds, cmaps = [], [], [], []
    # (name, type, charge, mass, alpha, thole, offset from the cell centre)
    unit = [("N1", "TA", 1.8, 14.007, -1.0, 0.9, (-0.2, -0.2, -0.15)),
            ("DP1", "DP_", -0.8, 0.4, 0.0, 0.0, (-0.18, -0.2, -0.15)),
            ("C1", "TB", 0.2, 12.011, -1.5, 0.9, (0.15, -0.2, -0.15)),
            ("DP2", "DP_", -1.2, 0.4, 0.0, 0.0, (0.15, -0.18, -0.15))]
    chain = [(f"C{k + 2}", t, q, 12.011, 0.0, 0.0,
              (-0.25 + 0.125 * k, 0.1 + (0.044 if k % 2 else -0.044),
               0.15 + z))
             for k, (t, q, z) in enumerate(zip(
                 ("CA", "CB", "CC", "CD", "CE"),
                 (0.1, -0.1, 0.0, 0.1, -0.1),
                 (0.0, 0.03, -0.03, 0.04, 0.0)))]
    resnames = ("IMA", "IMA", "IMB", "IMB") + ("PEN",) * 5
    cell = 0
    for ix in range(n_side):
        for iy in range(n_side):
            for iz in range(n_side):
                c = (np.array([ix, iy, iz]) + 0.5) * spacing
                first = len(atoms)
                for k, a in enumerate(unit + chain):
                    atoms.append(a[:6] + (resnames[k], 3 * cell + 1
                                          + (k >= 2) + (k >= 4)))
                    pos.append(c + np.array(a[6])
                               + rng.normal(0, 0.005, 3))
                i = first + 1
                bonds += [(i, i + 1), (i + 2, i + 3)]
                bonds += [(i + 4 + k, i + 5 + k) for k in range(4)]
                cmaps.append((i + 4, i + 5, i + 6, i + 7,
                              i + 5, i + 6, i + 7, i + 8))
                cell += 1
    if by_species:
        # atoms in species order, cell order within a species; residues
        # renumbered in the new order, bonds and CMAP atoms (1-based) mapped
        order = sorted(range(len(atoms)), key=lambda k: (
            ("IMA", "IMB", "PEN").index(atoms[k][6]), k))
        new_id = {old + 1: new + 1 for new, old in enumerate(order)}
        rid = {}
        atoms = [atoms[k][:7] + (rid.setdefault(atoms[k][7], len(rid) + 1),)
                 for k in order]
        pos = [pos[k] for k in order]
        bonds = [tuple(new_id[a] for a in b) for b in bonds]
        cmaps = [tuple(new_id[a] for a in c) for c in cmaps]
    lines = ["PSF DRUDE", "", "       1 !NTITLE",
             " REMARKS NBTHOLE and CMAP fixture", "",
             f"{len(atoms):8d} !NATOM"]
    for k, (name, typ, q, m, alpha, thole, res, rid) in enumerate(atoms):
        lines.append(f"{k + 1:8d} S    {rid:<6d}{res:<6s}{name:<6s}"
                     f"{typ:<6s}{q:10.6f}{m:12.4f}  0 {alpha:9.4f}"
                     f"{thole:9.4f}")
    lines += ["", f"{len(bonds):8d} !NBOND: bonds"]
    flat = [x for b in bonds for x in b]
    lines += ["".join(f"{x:8d}" for x in flat[j:j + 8])
              for j in range(0, len(flat), 8)]
    for tag in ("NTHETA: angles", "NPHI: dihedrals", "NIMPHI: impropers"):
        lines += ["", f"       0 !{tag}"]
    lines += ["", f"{len(cmaps):8d} !NCRTERM: cross-terms"]
    lines += ["".join(f"{x:8d}" for x in c) for c in cmaps]
    psf = os.path.join(directory, "fixture.psf")
    with open(psf, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    r = 24
    ang = -math.pi + 2 * math.pi * np.arange(r) / r
    grid = 0.8 * np.cos(ang)[:, None] + 0.5 * np.sin(2 * ang)[None, :]
    prm_lines = ["* NBTHOLE and CMAP fixture", "*", "", "ATOMS"]
    for k, (t, m) in enumerate((("TA", 14.007), ("TB", 12.011),
                                ("DP_", 0.0), ("CA", 12.011), ("CB", 12.011),
                                ("CC", 12.011), ("CD", 12.011),
                                ("CE", 12.011))):
        prm_lines.append(f"MASS {k + 1:5d} {t:6s} {m:9.4f}")
    prm_lines += ["", "BONDS", "TA DP_ 500.0 0.0", "TB DP_ 500.0 0.0",
                  "CA CB 300.0 1.53", "CB CC 300.0 1.53",
                  "CC CD 300.0 1.53", "CD CE 300.0 1.53", "",
                  "NONBONDED", "TA 0.0 -0.10 1.6", "TB 0.0 -0.12 1.7",
                  "DP_ 0.0 -0.00 0.0"]
    prm_lines += [f"{t} 0.0 -0.08 1.9 0.0 -0.04 1.8"
                  for t in ("CA", "CB", "CC", "CD", "CE")]
    prm_lines += ["", "NBTHOLE", "TA TB 2.6", "", "CMAP",
                  f"CA CB CC CD CB CC CD CE {r}"]
    prm_lines += [" ".join(f"{v:.5f}" for v in row) for row in grid]
    prm_lines += ["", "END"]
    prm = os.path.join(directory, "fixture.prm")
    with open(prm, "w") as fh:
        fh.write("\n".join(prm_lines) + "\n")
    box = n_side * spacing
    gro_lines = ["NBTHOLE and CMAP fixture", f"{len(atoms)}"]
    for k, (a, p) in enumerate(zip(atoms, pos)):
        gro_lines.append(f"{a[7] % 100000:5d}{a[6]:<5s}{a[0]:>5s}"
                         f"{(k + 1) % 100000:5d}{p[0]:8.3f}{p[1]:8.3f}"
                         f"{p[2]:8.3f}")
    gro_lines.append(f"{box:10.5f}{box:10.5f}{box:10.5f}")
    gro = os.path.join(directory, "fixture.gro")
    with open(gro, "w") as fh:
        fh.write("\n".join(gro_lines) + "\n")
    return psf, prm, gro


def load_fixture(directory, n_side, **create):
    """The fixture through the port's loaders: (BuiltSystem, positions,
    box)."""
    from openmm_velocityverlet_tpu_torch.models.grofile import GroFile
    from openmm_velocityverlet_tpu_torch.models.prmfile import \
        CharmmParameterSet
    from openmm_velocityverlet_tpu_torch.models.psffile import OplsPsfFile
    psf_p, prm_p, gro_p = write_charmm_fixture(directory, n_side)
    gro = GroFile(gro_p)
    psf = OplsPsfFile(psf_p, periodicBoxVectors=gro.getPeriodicBoxVectors())
    built = psf.createSystem(CharmmParameterSet(prm_p), **create)
    return built, gro.positions, gro.box


def charmm_phase():
    """A13 (b)-(d) and A15 on the card against the CPU: the fixture of
    ``write_charmm_fixture`` (27 cells, 243 atoms) through the port's
    GroFile / OplsPsfFile / CharmmParameterSet, replicated (3, 3, 2) to
    4,374 atoms and stepped 10 times on both; then GB (OBC2, 0.15 M salt,
    ACE) on the 6^3-cell fixture (1,944 atoms) through createSystem:
    its energy and autograd forces on both, and the whole evaluation's
    terms."""
    import tempfile
    import numpy as np
    import torch
    from openmm_velocityverlet_tpu_torch import ForceEvaluator
    from openmm_velocityverlet_tpu_torch.models.replicate import replicate
    from openmm_velocityverlet_tpu_torch.ops import gb
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        built, pos, box = load_fixture(d, 3, nonbondedCutoff=1.2,
                                       constraints=None, rigidWater=False)
        s = built.system
        big, bpos, bbox = replicate(s, pos, box, (3, 3, 2))
        print(f"[charmm] fixture {s.n_atoms} atoms ({s.drude_pairs.shape[0]}"
              f" Drude pairs, {int(np.max(s.nbt_idx))} NBTHOLE types, "
              f"{s.cmap_atoms.shape[0]} CMAP terms on "
              f"{s.cmap_coeffs.shape[0]} map), replicated to "
              f"{big.n_atoms} atoms in {bbox.tolist()} nm, kmax "
              f"{big.kmax}; {time.perf_counter() - t0:.1f} s")
        terms = small_agreement(
            f"A13/A15 ({big.n_atoms}-atom replicated CHARMM fixture, "
            f"NBTHOLE + CMAP)", make=lambda: (big, bpos, bbox, None, {}))
        if not (terms.get("nbthole", 0.0) != 0.0
                and terms.get("cmap", 0.0) != 0.0):
            raise AssertionError("the fixture's NBTHOLE or CMAP term is 0")
        gbuilt, gpos, gbox = load_fixture(
            d, 6, nonbondedCutoff=1.2, constraints=None, rigidWater=False,
            use_pme=False, implicitSolvent="OBC2",
            implicitSolventSaltConc=0.15, gbsaModel="ACE")
    gsys = gbuilt.system
    out = {}
    for dev in ("cpu", DEVICE):
        ev = ForceEvaluator(gsys, box_hint=gbox, pos_hint=gpos, device=dev)
        p = torch.as_tensor(np.asarray(gpos, np.float32), device=dev)
        b = torch.as_tensor(np.asarray(gbox, np.float32), device=dev)
        terms, f = ev.energy_forces(p, b)

        def gb_call(p=p, ev=ev):
            x = p.detach().requires_grad_(True)
            with torch.enable_grad():
                e = gb.gb_energy(x, ev.t.charges, ev.gb)
                (g,) = torch.autograd.grad(e, x)
            return e.detach(), g
        e_gb, g_gb = gb_call()
        out[dev] = ({k: float(v) for k, v in terms.items()},
                    f.cpu().numpy(), float(e_gb), g_gb.cpu().numpy())
        if dev == DEVICE:
            ms = cuda_time_ms(gb_call, reps=5)
    (t_c, f_c, e_c, g_c), (t_g, f_g, e_g, g_g) = out["cpu"], out[DEVICE]
    gb_err = float(np.abs(g_g - g_c).max())
    gmax = float(np.abs(g_c).max())
    worst = max(abs(t_g[k] - v) / (abs(v) + 1.0) for k, v in t_c.items())
    f_err = float(np.abs(f_g - f_c).max())
    print(f"[charmm] GB OBC2 + salt + ACE on {gsys.n_atoms} atoms: energy "
          f"card {e_g:.4f} CPU {e_c:.4f} (rtol {GB_RTOL}); autograd forces "
          f"max |dF| {gb_err:.3e} (atol {GB_F_ATOL_REL} x max|F| {gmax:.3f})"
          f"; energy + forces {ms:.3f} ms on the card; whole evaluation: "
          f"terms max diff/(|E|+1) {worst:.3e}, forces max |dF| "
          f"{f_err:.3e}")
    if not (abs(e_g - e_c) <= GB_RTOL * abs(e_c)
            and gb_err <= GB_F_ATOL_REL * gmax and worst < 1e-3
            and f_err <= F_ATOL + F_RTOL * float(np.abs(f_c).max())):
        raise AssertionError("GB on the card disagrees with the CPU")


def close_reporters(sim):
    """Close the reporters that hold a file or a writer thread."""
    for r in sim.reporters:
        if hasattr(r, "close"):
            r.close()


class PositionProbe:
    """A reporter that keeps the positions and the generator state at the
    named steps (a report boundary at each)."""

    def __init__(self, steps):
        self.steps = sorted(steps)
        self.seen = {}

    def describeNextReport(self, simulation):
        later = [s for s in self.steps if s > simulation.current_step]
        return later[0] - simulation.current_step if later else 1 << 40

    def report(self, simulation):
        ctx = simulation.context
        self.seen[simulation.current_step] = (
            ctx.get_positions(), ctx.state.generator.get_state())


def read_dcd(path):
    """(NSET, frames as (n, 3) float32 Angstrom arrays) of a DCD file the
    port's DCDReporter wrote."""
    import numpy as np
    with open(path, "rb") as fh:
        raw = fh.read()
    nset = int(np.frombuffer(raw[8:12], "<i4")[0])
    n = int(np.frombuffer(raw[188:192], "<i4")[0])
    frame = 56 + 3 * (8 + 4 * n)
    body = raw[196:]
    if len(body) % frame:
        raise AssertionError("the DCD's frames are cut short")
    frames = []
    for k in range(len(body) // frame):
        f = body[k * frame + 56:(k + 1) * frame]
        frames.append(np.stack([np.frombuffer(
            f[a * (8 + 4 * n) + 4:a * (8 + 4 * n) + 4 + 4 * n], "<f4")
            for a in range(3)], 1))
    return nset, frames


def bulk_path(card, counters):
    """Path 9: the application layer and the bulk CLI at full width.
    run_bulk.simulation_from_args with run_bulk's defaults (Langevin on
    every particle, 5/ps and the Drude pairs' 20/ps, the iso barostat every
    100 steps, 333 K, dt 0.001) on write_charmm_fixture(BULK_SIDE,
    by_species=True), the reporters cut to BULK_EVERY / BULK_GRO_EVERY and
    writing into a temporary directory; minimize_energy(100) capped at
    BULK_MIN_ITERATIONS; B1 against its plain version on the minimized
    positions (b1_case, 5e-5); sim.step(20) warm-up; then timed in turns
    sim.step(200) with the reporters, bare ctx.step(200) twice, sim.step(200)
    again.  Gates on the first timed window: B1 >= 200 launches, every
    StateData and DrudeTemperature row finite, the DCD's NSET frames with
    the last equal to get_positions() at its step times float32 10, the GRO
    frame count, and the step-150 checkpoint loaded by a fresh
    simulation_from_args(--cpt) stepped to 190 within 1e-4 nm of the run,
    with the same generator state there.  Then torch.profiler over 30 steps
    with the reporters (one report of each) and 20 without, and the device
    time of the step's autograd terms."""
    import contextlib
    import tempfile
    # run_bulk's reporters write into the working directory
    with tempfile.TemporaryDirectory() as d, contextlib.chdir(d):
        return bulk_run(d, card, counters)


def bulk_run(d, card, counters):
    """``bulk_path`` in the working directory ``d``."""
    import numpy as np
    import torch
    from openmm_velocityverlet_tpu_torch import app
    from openmm_velocityverlet_tpu_torch.examples import run_bulk
    from openmm_velocityverlet_tpu_torch.integrators.stepping import \
        mol_runs_from_id
    from openmm_velocityverlet_tpu_torch.units import ns_per_day
    t0 = time.perf_counter()
    psf, prm, gro = write_charmm_fixture(d, BULK_SIDE, by_species=True)
    t_write = time.perf_counter() - t0
    cli = ["--gro", gro, "--psf", psf, "--prm", prm]
    sim = run_bulk.simulation_from_args(run_bulk.parser.parse_args(cli),
                                        device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ctx, system = sim.context, sim.context.system
    ev = ctx.evaluator
    print(f"[bulk] {system.n_atoms} atoms ({system.drude_pairs.shape[0]}"
          f" Drude pairs, {system.cmap_atoms.shape[0]} CMAP terms, "
          f"{system.n_molecules} molecules in "
          f"{len(mol_runs_from_id(np.asarray(system.particle_mol_id)))} "
          f"runs), box {ctx.get_box().tolist()} nm, kmax {system.kmax}; "
          f"fixture written in {t_write:.2f} s, run_bulk's "
          f"gen_simulation done {build_s:.2f} s after the start; "
          f"Langevin on {ctx.data.ld_normal.shape[0]} particles and "
          f"{ctx.data.ld_pairs.shape[0]} Drude pairs, barostat "
          f"{ctx.barostat.kind} every {ctx.barostat.frequency} steps, "
          f"recip {ev.recip_method}, pair_mode {ev.pairs.mode}, tile "
          f"size {ev.pairs.ts}")
    close_reporters(sim)
    probe = PositionProbe([RESUME_TO, 4 * BULK_EVERY])
    sim.reporters[:] = [
        app.CheckpointReporter("cpt.cpt", BULK_EVERY),
        app.GroReporter("dump.gro", BULK_GRO_EVERY, logarithm=True),
        app.DCDReporter("dump.dcd", BULK_EVERY),
        app.StateDataReporter("state.txt", BULK_EVERY, box=False,
                              volume=True),
        app.DrudeTemperatureReporter("T_drude.txt", BULK_EVERY), probe]
    for g, e in ctx.group_energies().items():
        print(f"[bulk] E_{g}: {e:.4f} kJ/mol")
    e0 = ctx.potential_energy()
    t0 = time.perf_counter()
    e_min = sim.minimize_energy(100, max_iterations=BULK_MIN_ITERATIONS)
    torch.cuda.synchronize()
    min_s = time.perf_counter() - t0
    f = ctx.get_forces()
    rms = float(np.sqrt(np.mean(np.sum(f.astype(np.float64) ** 2, -1))))
    print(f"[bulk] minimize_energy(100, max_iterations="
          f"{BULK_MIN_ITERATIONS}): {sim.minimize_iterations} iterations "
          f"in {min_s:.3f} s ({min_s / max(sim.minimize_iterations, 1):.4f}"
          f" s an iteration), energy {e0:.2f} -> {e_min:.2f} kJ/mol, RMS "
          f"force {rms:.2f} kJ/mol/nm")
    if not (np.isfinite(e_min) and e_min <= e0):
        raise AssertionError("path 9: the minimizer did not go downhill")
    # B1 against its plain version at the shapes path 9 gives it: this
    # fixture's bond / 1-4 exclusions, Drude pairs, LJ tables and n_pad
    st = ctx.state
    cache = refitted_cache(ev, st.pos, st.box)
    b1_res, _, _ = b1_case("B1 bulk", ev, cache, st.pos, st.box, system,
                           timed=False)
    b1_err = max(b1_res["force"][0], b1_res["energy"][0])
    t0 = time.perf_counter()
    sim.step(20)
    torch.cuda.synchronize()
    print(f"[bulk] warm-up sim.step(20) {time.perf_counter() - t0:.3f} s,"
          f" kinetic {ctx.kinetic_energy():.1f}")

    dt = ctx.data.dt

    def window(tag, run, n=200):
        for fn in counters.values():
            fn.launches = 0
        syncs0, att0 = ctx.host_syncs, ctx.baro_attempts
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        el = time.perf_counter() - t0
        w = dict(sps=n / el, syncs=(ctx.host_syncs - syncs0) / n,
                 launches={k: fn.launches for k, fn in counters.items()})
        print(f"[bulk] {tag}: {n} steps (to step {ctx.current_step}) in "
              f"{el:.4f} s: {w['sps']:.2f} steps/s, "
              f"{ns_per_day(w['sps'], dt):.3f} ns/day on {card}; "
              f"launches {w['launches']}, host syncs/step "
              f"{w['syncs']:.3f}, barostat attempts "
              f"{ctx.baro_attempts - att0}")
        return w
    w1 = window("sim.step(200) with reporters, turn 1", sim.step)
    if w1["launches"]["B1"] < 200:
        raise AssertionError(f"path 9: B1 launched {w1['launches']['B1']}"
                             f" < 200 times")
    bulk_gates(sim, probe, cli)
    w2 = window("bare ctx.step(200), turn 2", ctx.step)
    w3 = window("bare ctx.step(200), turn 3", ctx.step)
    w4 = window("sim.step(200) with reporters, turn 4", sim.step)
    check_finite("bulk", ctx, system)
    rep = [w1["sps"], w4["sps"]]
    bare = [w2["sps"], w3["sps"]]
    print(f"[bulk] steps/s with the reporters {rep[0]:.2f}, {rep[1]:.2f}"
          f" ({ns_per_day(statistics.mean(rep), dt):.3f} ns/day), bare "
          f"{bare[0]:.2f}, {bare[1]:.2f} "
          f"({ns_per_day(statistics.mean(bare), dt):.3f} ns/day); host "
          f"syncs/step {w1['syncs']:.3f} / {w4['syncs']:.3f} with, "
          f"{w2['syncs']:.3f} / {w3['syncs']:.3f} without")
    # from step 820: 30 steps with the reporters end on a report of each
    # 50-step reporter (step 850)
    prof_rep = profile("path 9 with reporters", ctx,
                       1e3 / statistics.mean(rep), top=6, run=sim.step,
                       n=30)
    prof_bare = profile("path 9", ctx, 1e3 / statistics.mean(bare), top=6)
    autograd_term_times(ctx)
    sim.flush()
    close_reporters(sim)
    return dict(launches=w1["launches"]["B1"], b1_err=b1_err,
                profile=(prof_rep, prof_bare))


def autograd_term_times(ctx):
    """The step's autograd terms on path 9, each energy and its gradient
    at the context's positions, through ``ForceEvaluator.smooth_terms``,
    the functions the step itself sums: on this fixture the dense NBTHOLE
    sweep over the (Na, Na) pairs of its active atoms, the matmul
    reciprocal and CMAP.  Returns {term: (CUDA-event ms of one call,
    device ms of one call by torch.profiler over 5)}: where path 9's
    device time goes."""
    import torch
    ev = ctx.evaluator
    out = {}
    for name, fn in ev.smooth_terms(ctx.state.box).items():
        def run(fn=fn):
            p = ev.place_vsites(ctx.state.pos).detach().requires_grad_(True)
            with torch.enable_grad():
                torch.autograd.grad(fn(p), p)
        out[name] = (cuda_time_ms(run, reps=5), device_ms(run, calls=5))
    n_active = int(ev.nbthole.active.shape[0])
    print("[bulk] autograd terms, energy + gradient, ms (CUDA events / "
          "device): " + ", ".join(f"{k} {v[0]:.3f} / {v[1]:.3f}"
                                  for k, v in out.items())
          + f"; NBTHOLE's dense sweep covers {n_active} active atoms, "
          f"{n_active ** 2 / 1e6:.1f} M pairs")
    return out


def bulk_gates(sim, probe, cli):
    """Path 9's gates on the reporters' files after the first timed window
    (steps 20 to 220), and the checkpoint resume (see ``bulk_path``)."""
    import os
    import numpy as np
    import torch
    from openmm_velocityverlet_tpu_torch.examples import run_bulk
    sim.flush()

    def rows_of(path):
        with open(path) as fh:
            return [line.split("\t") for line in fh
                    if not line.startswith("#")]
    rows, t_rows = rows_of("state.txt"), rows_of("T_drude.txt")
    steps = [int(r[0]) for r in rows]
    want = list(range(BULK_EVERY, 20 + 200 + 1, BULK_EVERY))
    if steps != want or [int(r[0]) for r in t_rows] != want or not all(
            np.isfinite(float(x)) for r in rows + t_rows for x in r):
        raise AssertionError(f"path 9: StateData / DrudeTemperature rows "
                             f"{steps} not the expected {want}, or not finite")
    print(f"[bulk] StateData rows (step, T K, volume nm^3, density g/mL): "
          f"{[(r[0], r[5], r[6], r[7]) for r in rows]}")
    print(f"[bulk] DrudeTemperature rows (step, T_COM, T_Atom, T_Drude): "
          f"{[tuple(r[:4]) for r in t_rows]}")
    nset, frames = read_dcd("dump.dcd")
    last = probe.seen[want[-1]][0]
    exact = bool(np.array_equal(frames[-1], last.astype(np.float32)
                                * np.float32(10.0)))
    err = float(np.abs(frames[-1] / 10.0 - last).max())
    with open("dump.gro") as fh:
        gro_frames = sum(line.startswith("written by") for line in fh)
    print(f"[bulk] DCD: NSET {nset}, {len(frames)} frames; the last (step "
          f"{want[-1]}) equal to get_positions() x float32 10: {exact} (max "
          f"|frame/10 - pos| {err:.2e} nm); GRO frames {gro_frames}")
    if nset != len(want) or len(frames) != nset or not exact \
            or gro_frames != 2:
        raise AssertionError("path 9: the DCD or GRO output is wrong")
    ckpts = sorted(int(p.rsplit("_", 1)[1]) for p in os.listdir(".")
                   if p.startswith("cpt.cpt_"))
    if ckpts != [100, 150, 200]:
        raise AssertionError(f"path 9: checkpoints {ckpts}, expected the "
                             f"last three")
    resumed = run_bulk.simulation_from_args(run_bulk.parser.parse_args(
        cli + ["--cpt", f"cpt.cpt_{RESUME_FROM}"]), device=DEVICE)
    if resumed.current_step != RESUME_FROM:
        raise AssertionError("path 9: the checkpoint's step was not loaded")
    resumed.step(RESUME_TO - RESUME_FROM)
    torch.cuda.synchronize()
    pos, gen = probe.seen[RESUME_TO]
    dpos = float(np.abs(resumed.context.get_positions() - pos).max())
    same_gen = bool(torch.equal(resumed.context.state.generator.get_state(),
                                gen))
    print(f"[bulk] checkpoint resume: step-{RESUME_FROM} checkpoint loaded by "
          f"a fresh run_bulk simulation (--cpt), stepped to {RESUME_TO}: max "
          f"|dpos| {dpos:.3e} nm against the run (gate 1e-4), generator "
          f"state equal: {same_gen}")
    if not (dpos < 1e-4 and same_gen):
        raise AssertionError("path 9: the resumed run left the original")
    close_reporters(resumed)


def bulk_agreement():
    """Path 9 at 27 cells: write_charmm_fixture(3, by_species=True) through
    run_bulk with --thermostat nose-hoover --barostat no (the Langevin
    streams of the card and the CPU differ), the same numpy velocities on
    both, 10 steps on the card against the CPU: |dpos| < 1e-4 nm and the
    terms within 1e-3 relative, as small_agreement."""
    import contextlib
    import tempfile
    import numpy as np
    from openmm_velocityverlet_tpu_torch.examples import run_bulk
    out = {}
    with tempfile.TemporaryDirectory() as d, contextlib.chdir(d):
        psf, prm, gro = write_charmm_fixture(d, 3, by_species=True)
        args = run_bulk.parser.parse_args([
            "--gro", gro, "--psf", psf, "--prm", prm, "--thermostat",
            "nose-hoover", "--barostat", "no"])
        for dev in ("cpu", DEVICE):
            sim = run_bulk.simulation_from_args(args, device=dev)
            masses = np.asarray(sim.context.system.masses)
            vel = np.random.default_rng(7).normal(
                0.0, 0.3, (masses.shape[0], 3)) * (masses > 0.5)[:, None]
            sim.context.set_velocities(vel)
            sim.step(10)
            out[dev] = (sim.context.get_positions(),
                        sim.context.potential_energy_terms())
            close_reporters(sim)
    dpos = float(np.abs(out[DEVICE][0] - out["cpu"][0]).max())
    worst = max(abs(out[DEVICE][1][k] - v) / (abs(v) + 1.0)
                for k, v in out["cpu"][1].items())
    print(f"[check] path 9 (run_bulk, nose-hoover, no barostat, "
          f"{out['cpu'][0].shape[0]} atoms): 10-step card vs CPU: max |dpos|"
          f" = {dpos:.3e} nm, max term diff/(|E|+1) = {worst:.3e}")
    if not (dpos < 1e-4 and worst < 1e-3):
        raise AssertionError("path 9: card run disagrees with the CPU run")


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from openmm_velocityverlet_tpu_torch import Context, VVIntegrator, kernels
    from openmm_velocityverlet_tpu_torch.models.drude_water import \
        drude_water_box
    from openmm_velocityverlet_tpu_torch.ops import constraints as cc
    from openmm_velocityverlet_tpu_torch.ops import ewald_fused as ef
    from openmm_velocityverlet_tpu_torch.ops import pair_plist as pp
    from openmm_velocityverlet_tpu_torch.ops import pair_tri as pt

    t_start = time.perf_counter()

    def stamp(phase):
        # where the script's own time goes, phase by phase
        print(f"[time] {phase} from {time.perf_counter() - t_start:.1f} s")
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

    stamp("kernel phases")
    b1, b1_bound, b1_by, b1_evals, b1_pairs, b1_err = b1_phase(ctx1, system,
                                                                pos)
    b2 = b2_phase(ctx1, system, pos)
    rc = recip_phase(ctx1)
    b3 = b3_phase(ctx1, system, pos)
    gat = gather_phase()
    cons_k = constraint_phase(ctx1, dt)

    stamp("path 1")
    # path 1: the main path
    ev1 = ctx1.evaluator
    print(f"[slice] pair_mode {ev1.pairs.mode}, tile size {ev1.pairs.ts} "
          f"(chosen from the start configuration), sort {ev1.pairs.sort}, "
          f"nowrap {ev1.pairs.nowrap}, list capacity {ev1.pairs.cap}")
    ccf = cc.constraint_clusters

    def zero_cluster_kinds():
        ccf.shake_launches = ccf.rattle_launches = 0

    sps1, el1, l1 = drive("slice", ctx1, 200, {"B1": pp.plist_pair}, card,
                          dt, mark=zero_cluster_kinds)
    if l1["B1"] < 200:
        raise AssertionError(f"B1 launched {l1['B1']} < 200 times")
    # one SHAKE and one RATTLE call a step, each one launch a bucket
    l1["shake"], l1["rattle"] = ccf.shake_launches, ccf.rattle_launches
    print(f"[slice] constraint kernels: shake {l1['shake']}, rattle "
          f"{l1['rattle']} launches in 200 steps")
    for kind in ("shake", "rattle"):
        if l1[kind] != 200 * len(ctx1.cons.buckets):
            raise AssertionError(
                f"the {kind} kernel launched {l1[kind]} times in 200 "
                f"steps, expected {200 * len(ctx1.cons.buckets)}")
    check_finite("slice", ctx1, system)
    prof1 = profile("path 1", ctx1, el1 / 200 * 1e3)

    stamp("paths 2-5")
    # path 2: the z band (kernel B2)
    ctx2, _ = context(fold_exc14=True)
    ev2 = ctx2.evaluator
    print(f"[band] pair_mode {ev2.pairs.mode}, ts {ev2.pairs.ts}, band_w "
          f"{ev2.pairs.band_w}, carries_cache {ev2.pairs.carries_cache}")
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
    del ctx2, ctx3, ctx4, ctx5
    torch.cuda.empty_cache()

    stamp("path 6")
    # path 6: constant voltage at edl_Im21's counts (mirror route)
    edl = edl_path(card, dt, {"B1": pp.plist_pair})
    torch.cuda.empty_cache()

    stamp("path 7")
    # path 7: NPT with the Monte Carlo barostat
    from openmm_velocityverlet_tpu_torch import BarostatConfig
    ctx7, _ = context(barostat=BarostatConfig("iso", 1.0, 333.0,
                                              frequency=25))
    before = {}

    def mark():
        before.update(att=ctx7.baro_attempts, acc=ctx7.baro_accepts,
                      vol=float(np.prod(ctx7.get_box().astype(np.float64))))
    _, el7, l7 = drive("npt", ctx7, 200, {"B1": pp.plist_pair}, card, dt,
                       mark=mark)
    vol0, vol1 = before["vol"], float(np.prod(ctx7.get_box().astype(
        np.float64)))
    att = ctx7.baro_attempts - before["att"]
    acc = ctx7.baro_accepts - before["acc"]
    print(f"[npt] {att} attempts, {acc} accepted in the timed 200 steps "
          f"(all runs: {ctx7.baro_attempts} / {ctx7.baro_accepts}); volume "
          f"{vol0:.4f} -> {vol1:.4f} nm^3; move size "
          f"{float(ctx7.baro_state.volume_scale):.4f} nm^3")
    if att != 8 or l7["B1"] < 200:
        raise AssertionError(f"path 7: {att} attempts (expected 8), B1 "
                             f"launched {l7['B1']} times")
    check_finite("npt", ctx7, system)
    profile("path 7", ctx7, el7 / 200 * 1e3, top=6)
    npt_gate(ctx7)
    del ctx7
    torch.cuda.empty_cache()

    stamp("path 8")
    # path 8: the PME reciprocal
    ctx8, _ = context(recip="pme")
    ev8 = ctx8.evaluator
    print(f"[pme] recip {ev8.recip_method}, grid {ev8.pme_grid} for the "
          f"{box[0]:.3f} nm box; pair_mode {ev8.pairs.mode}, tile size "
          f"{ev8.pairs.ts}")
    if ev8.recip_method != "pme" or ev8.pme_grid != PME_GRID:
        raise AssertionError(f"path 8: grid {ev8.pme_grid}, expected "
                             f"{PME_GRID}")
    pme_gates(ctx8)
    _, el8, l8 = drive("pme", ctx8, 200, {"B1": pp.plist_pair}, card, dt)
    if l8["B1"] < 200:
        raise AssertionError(f"path 8: B1 launched {l8['B1']} < 200 times")
    check_finite("pme", ctx8, system)
    profile("path 8", ctx8, el8 / 200 * 1e3, top=8)
    del ctx8
    torch.cuda.empty_cache()
    stamp("recip_fit")
    fit = recip_fit()

    stamp("mesh phase")
    # the multi-device mesh (A16): a world of one under NCCL, then two
    # ranks sharing the card under gloo
    mesh_k = mesh_phase(card, dt)

    stamp("path 9")
    # path 9: the application layer through run_bulk at 19,773 atoms
    bulk = bulk_path(card, {"B1": pp.plist_pair})
    for tag, prof in (("path 1", prof1), ("path 9 with reporters",
                                          bulk["profile"][0]),
                      ("path 9", bulk["profile"][1])):
        print(f"[bulk] kernels/step, {tag}: "
              + (f"{prof[1]:.0f} (device busy {prof[0]:.3f} ms/step)"
                 if prof else "not measured (no device time recorded)"))
    torch.cuda.empty_cache()

    stamp("card-vs-CPU checks")
    small_agreement("path 1")
    small_agreement("path 2 (fold_exc14, pair_ts 32)", fold_exc14=True,
                    pair_ts=32)
    small_agreement("path 3 (strict_pairs, exact_fused)", strict_pairs=True,
                    recip="exact_fused")
    small_agreement("path 4 without its Langevin subset (E-field)",
                    wire=functools.partial(wire_path4, langevin=False))
    small_agreement("path 5 (vanilla VV, cosine acceleration)",
                    wire=wire_path5)
    small_agreement("path 6 (EDL at 648 atoms, mirror route, without the "
                    "Langevin electrode)", make=small_edl)
    small_agreement("path 7 (barostat every 2 steps, same draws)",
                    prepare=npt_draws,
                    barostat=BarostatConfig("iso", 1.0, 333.0, frequency=2))
    small_agreement("path 8 (pme)", recip="pme")
    bulk_agreement()
    stamp("A13/A15 phase")
    charmm_phase()

    stamp("end")
    f, e = b1["force"], b1["energy"]

    def edl_recip(k):
        # B4 or B5 at path 6's fused leg
        r = edl["recip"]
        return {"edl_max_abs_err": r[k + "_err"], "edl_ms": r[k],
                "edl_device_ms": r[k + "_device"],
                "edl_plain_ms": r[k + "_plain"],
                "edl_bound_ms": r[k + "_bound"][0]}
    src = "openmm_velocityverlet_tpu_torch/csrc/"
    ref = "openmm_velocityverlet_tpu/ops/"
    print(json.dumps({"kernels": [
        {"name": "plist_pair", "route": "cuda",
         "source": src + "plist_pair.cu",
         "replaces": ref + "pallas_pair.py:1110", "launches": l1["B1"],
         "max_abs_err": b1_err, "ms": f[1], "plain_ms": f[2],
         "bound_ms": b1_bound, "bound_by": b1_by, "library_ms": None,
         "device_ms": f[3], "energy_ms": e[1], "energy_plain_ms": e[2],
         "energy_device_ms": e[3], "tile_size": ctx1.evaluator.pairs.ts,
         "evaluations": b1_evals, "cutoff_pairs": b1_pairs,
         "launches_edl": edl["launches"], "launches_npt": l7["B1"],
         "launches_pme": l8["B1"], "launches_bulk": bulk["launches"],
         "bulk_max_abs_err": bulk["b1_err"],
         "edl_device_ms": edl["b1"]["force"][3],
         "edl_max_abs_err": max(edl["b1"]["force"][0],
                                edl["b1"]["energy"][0]),
         "edl_evaluations": edl["evals"], "edl_cutoff_pairs": edl["pairs"],
         "edl_bound_ms": edl["bound_ms"]},
        {"name": "tri_pair", "route": "cuda", "source": src + "tri_pair.cu",
         "replaces": ref + "pallas_pair.py:561", "launches": l2["B2"],
         "max_abs_err": b2["max_abs_err"], "ms": b2["ms"],
         "plain_ms": b2["plain_ms"], "bound_ms": b2["bound_ms"],
         "bound_by": b2["bound_by"], "library_ms": None,
         "device_ms": b2["device_ms"], "energy_ms": b2["energy_ms"],
         "energy_plain_ms": b2["energy_plain_ms"],
         "energy_device_ms": b2["energy_device_ms"],
         "tile_size": b2["tile_size"], "evaluations": b2["evaluations"],
         "cutoff_pairs": b2["cutoff_pairs"], **mesh_k},
        {"name": "ewald_structure", "route": "cuda",
         "source": src + "ewald_fused.cu",
         "replaces": ref + "ewald_pallas.py:77", "launches": l3["B4"],
         "max_abs_err": rc["b4_err"], "ms": rc["b4"],
         "plain_ms": rc["b4_plain"], "bound_ms": rc["b4_bound"][0],
         "bound_by": rc["b4_bound"][1], "library_ms": None,
         "device_ms": rc["b4_device"], "matmul_route_ms": rc["matmul_route"],
         "matmul_twin_ms": rc["matmul_twin"],
         "edl_matmul_twin_ms": edl["recip"]["matmul_twin"],
         "fused_route_ms": rc["fused_route"], "pme_route_ms": rc["pme_route"],
         "pme_route_device_ms": rc["pme_route_device"],
         "edl_matmul_route_ms": edl["recip"]["matmul_route"],
         "edl_fused_route_ms": edl["recip"]["fused_route"],
         "edl_pme_route_ms": edl["recip"]["pme_route"],
         "edl_pme_route_device_ms": edl["recip"]["pme_route_device"],
         "recip_fit": fit["rates"],
         "launches_edl_fused": edl["fused"]["B4"],
         **edl_recip("b4")},
        {"name": "ewald_force", "route": "cuda",
         "source": src + "ewald_fused.cu",
         "replaces": ref + "ewald_pallas.py:99", "launches": l3["B5"],
         "max_abs_err": rc["b5_err"], "ms": rc["b5"],
         "plain_ms": rc["b5_plain"], "bound_ms": rc["b5_bound"][0],
         "bound_by": rc["b5_bound"][1], "library_ms": None,
         "device_ms": rc["b5_device"],
         "launches_edl_fused": edl["fused"]["B5"],
         **edl_recip("b5")},
        {"name": "rect_pair", "route": "cuda", "source": src + "rect_pair.cu",
         "replaces": ref + "pallas_pair.py:454", "launches": b3["launches"],
         "max_abs_err": b3["max_abs_err"], "ms": b3["ms"],
         "plain_ms": b3["plain_ms"], "bound_ms": b3["bound_ms"],
         "bound_by": b3["bound_by"], "library_ms": None,
         "library_ms_why": "no single PyTorch call computes the sweep",
         "device_ms": b3["device_ms"], "device_measure": b3["device_measure"],
         "wrapper_device_ms": b3["wrapper_device_ms"],
         "evaluations": b3["evaluations"],
         "model_evaluations": b3["model_evaluations"],
         "cutoff_pairs": b3["cutoff_pairs"],
         "evals_per_cutoff_pair": b3["evals_per_cutoff_pair"]}]
        + [{"name": "constraint_clusters." + key, "route": "cuda",
            "source": src + "constraint_clusters.cu", "replaces": None,
            "replaces_why": "the JAX package's constraints are plain jnp; "
                            "eager PyTorch ran them as hundreds of launches",
            "launches": l1[key], "clusters": c["clusters"],
            "launches_a_call": c["launches"],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": None,
            "device_ms": c["device_ms"],
            "device_measure": c["device_measure"],
            "residual": c["residual"],
            "plain_residual": c["plain_residual"]}
           for key, c in cons_k.items()]
        + [{"name": g["name"], "route": "cuda", "source": src + "gather.cu",
            "replaces": "tools/exp_gather_kernel.py:" + line,
            "launches": g["launches"], "max_abs_err": g["max_abs_err"],
            "ms": g["ms"], "plain_ms": g["plain_ms"],
            "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
            "library_ms": g["library_ms"],
            "device_measure": g["device_measure"],
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
