"""Molecule-batched bonded/Drude/Thole/exception forces (counterpart of
``openmm_velocityverlet_tpu/ops/mol_terms.py``).

Molecules that are contiguous copies of a repeated species share one
signature ("type"); per type, positions are one gather of the type's atoms
into (m, apm, 3), slot coordinates come from one 0/1 selection matrix
product, the term math of ``term_forces`` runs on (m, nt) component tensors,
and the per-atom forces come back through the transposed selection product
and one indexed copy into (N, 3).  So a call launches a fixed number of ops a
type, however many runs its molecules form (water laid out O, D, H, H, M has
one run a molecule).  The selection products are float32 matrix products of
0/1 matrices, exact with TF32 off.  ``build_mol_tables`` is the JAX module's
host-numpy builder, unchanged.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .term_forces import _TERM_FNS, _mi


class MolType(NamedTuple):
    apm: int                 # atoms per molecule
    runs: tuple              # ((start_atom, n_mol), ...) contiguous blocks
    kinds: tuple             # (name, idx_local (nt,P), prm (nt,Q), which) ...
    select: np.ndarray       # (apm, S_tot) one-hot slot-selection matrix
    offsets: tuple           # per kind: column offset into S_tot
    n_mol: int
    idx: object = None       # (n_mol*apm,) int64 atoms of ``runs``, in order;
                             # set by ``types_to``


def _molecule_ranges(particle_mol_id, n_atoms):
    """Per molecule: (start, end) if its atoms are one contiguous block,
    else None."""
    mid = np.asarray(particle_mol_id)
    order = np.argsort(mid, kind="stable")
    ranges = {}
    sorted_mid = mid[order]
    bounds = np.flatnonzero(np.diff(sorted_mid)) + 1
    groups = np.split(order, bounds)
    for g in groups:
        m = int(mid[g[0]])
        lo, hi = int(g.min()), int(g.max())
        ranges[m] = (lo, hi + 1) if hi - lo + 1 == len(g) else None
    return ranges


def build_mol_tables(system, exc_mask=None):
    """Returns (types, leftover) where ``types`` is a list of MolType and
    ``leftover`` holds, per term kind, the boolean keep-mask of terms NOT
    covered by any type (scattered molecules, cross-molecule terms).

    ``exc_mask``: optional (N, XA) bool — which entries of the system's 1-4
    exception tables this dense path should take over (the ones the pair
    kernel is NOT folding).  leftover["exception"] comes back in the same
    (N, XA) shape for the sparse path.  1-4 pairs are intra-molecular, so
    they batch exactly like bonds and stay out of the pair kernel."""
    s = system
    n = s.n_atoms

    # term kind -> (global idx (NT,P), prm (NT,Q), which or None)
    kind_tables = {}
    nb, nu = s.bonds.shape[0], s.ub_bonds.shape[0]
    if nb + nu:
        idx = np.concatenate([np.asarray(s.bonds, np.int64).reshape(-1, 2),
                              np.asarray(s.ub_bonds,
                                         np.int64).reshape(-1, 2)], 0)
        prm = np.concatenate(
            [np.stack([s.bond_r0, s.bond_k], -1).reshape(-1, 2),
             np.stack([s.ub_r0, s.ub_k], -1).reshape(-1, 2)],
            0).astype(np.float32)
        which = np.concatenate([np.zeros(nb), np.ones(nu)]).astype(np.float32)
        kind_tables["bond"] = (idx, prm, which)
    if s.angles.shape[0]:
        kind_tables["angle"] = (np.asarray(s.angles, np.int64),
                                np.stack([s.angle_theta0, s.angle_k],
                                         -1).astype(np.float32), None)
    nd, ni = s.dihedrals.shape[0], s.impropers.shape[0]
    if nd + ni:
        idx = np.concatenate(
            [np.asarray(s.dihedrals, np.int64).reshape(-1, 4),
             np.asarray(s.impropers, np.int64).reshape(-1, 4)], 0)
        imp_k = np.asarray(s.improper_k, np.float32).reshape(-1)
        prm = np.concatenate(
            [np.stack([s.dihedral_n, s.dihedral_phase,
                       s.dihedral_k], -1).reshape(-1, 3),
             np.stack([np.full(ni, 2.0), np.full(ni, np.pi), imp_k],
                      -1).reshape(-1, 3)], 0).astype(np.float32)
        which = np.concatenate([np.zeros(nd), np.ones(ni)]).astype(np.float32)
        kind_tables["dihedral"] = (idx, prm, which)
    if s.drude_pairs.shape[0]:
        dp = np.asarray(s.drude_pairs, np.int64)
        da = np.asarray(s.drude_aniso, np.int64)
        has = (da[:, 0] >= 0).astype(np.float32)
        da_safe = np.where(da >= 0, da, dp[:, 1:2])
        idx = np.concatenate([dp, da_safe[:, 1:2], da_safe[:, 2:3],
                              da_safe[:, 3:4]], axis=1)      # (D,5)
        prm = np.stack([s.drude_k3, s.drude_k1, s.drude_k2, has],
                       -1).astype(np.float32)
        kind_tables["drude"] = (idx, prm, None)
    if s.thole_sites.shape[0]:
        kind_tables["thole"] = (np.asarray(s.thole_sites, np.int64),
                                np.stack([np.asarray(s.thole_qq),
                                          np.asarray(s.thole_screen)],
                                         -1).astype(np.float32), None)
    exc_flat_pos = None
    if exc_mask is not None and np.asarray(exc_mask).any():
        exc_idx = np.asarray(s.exc_idx)
        xa = exc_idx.shape[1]
        ii = np.repeat(np.arange(n, dtype=np.int64), xa)
        jj = exc_idx.reshape(-1).astype(np.int64)
        sel = (jj >= 0) & (jj > ii) & np.asarray(exc_mask, bool).reshape(-1)
        exc_flat_pos = np.flatnonzero(sel)
        idx = np.stack([ii[sel], jj[sel]], -1)
        prm = np.stack([np.asarray(s.exc_qq).reshape(-1)[sel],
                        np.asarray(s.exc_c6).reshape(-1)[sel],
                        np.asarray(s.exc_c12).reshape(-1)[sel]],
                       -1).astype(np.float32)
        kind_tables["exception"] = (idx, prm, None)

    # Group atoms by TERM-GRAPH connectivity, NOT by the integrator's
    # particle_mol_id: run-edl links every image particle into its
    # parent's molecule (thermostat/periodic-cell semantics), which makes
    # all liquid molecules non-contiguous and would silently disable this
    # whole dense path at EDL scale.  Connected components of
    # the term tables are exactly the unit that repeats per species, and
    # every term is intra-component by construction.  Min-label
    # propagation with pointer jumping converges in O(log diameter).
    mid = np.arange(n, dtype=np.int64)
    if kind_tables:
        for _ in range(64):
            prev = mid
            for idx, _prm, _w in kind_tables.values():
                row_min = mid[idx].min(axis=1)
                for c in range(idx.shape[1]):
                    np.minimum.at(mid, idx[:, c], row_min)
            mid = mid[mid]                       # pointer jump
            if np.array_equal(mid, prev):
                break
    # relabel to dense ids in first-appearance order
    _, mid = np.unique(mid, return_inverse=True)
    ranges = _molecule_ranges(mid, n)

    # assign terms to components; terms whose component is non-contiguous
    # stay sparse
    leftover = {k: np.zeros(v[0].shape[0], bool) for k, v in
                kind_tables.items()}
    per_mol = {}           # mol -> {kind: [term indices]}
    for kind, (idx, _prm, _w) in kind_tables.items():
        t_mid = mid[idx[:, 0]]
        for t in range(idx.shape[0]):
            m = int(t_mid[t])
            rng = ranges.get(m)
            if rng is None or not all(rng[0] <= int(a) < rng[1]
                                      for a in idx[t]):
                leftover[kind][t] = True
                continue
            per_mol.setdefault(m, {}).setdefault(kind, []).append(t)

    # signature per molecule -> type grouping
    sigs = {}
    mol_ids = sorted(m for m, r in ranges.items() if r is not None)
    for m in mol_ids:
        lo, hi = ranges[m]
        parts = [hi - lo]
        payload = {}
        for kind in kind_tables:
            ts = per_mol.get(m, {}).get(kind, [])
            idx, prm, which = kind_tables[kind]
            li = (idx[ts] - lo).astype(np.int32)
            pr = prm[ts]
            wh = which[ts] if which is not None else None
            payload[kind] = (li, pr, wh)
            parts.append((kind, li.tobytes(), pr.tobytes(),
                          wh.tobytes() if wh is not None else b""))
        sig = tuple(parts)
        sigs.setdefault(sig, {"mols": [], "payload": payload,
                              "apm": hi - lo})["mols"].append((m, lo))

    types = []
    for sig, info in sigs.items():
        apm = info["apm"]
        starts = sorted(lo for _m, lo in info["mols"])
        # verify molecules tile back-to-back within runs
        runs = []
        for st in starts:
            if runs and st == runs[-1][0] + runs[-1][1] * apm:
                runs[-1][1] += 1
            else:
                runs.append([st, 1])
        kinds = []
        offsets = []
        cols = 0
        for kind in kind_tables:
            li, pr, wh = info["payload"][kind]
            if li.shape[0] == 0:
                continue
            kinds.append((kind, li, pr, wh))
            offsets.append(cols)
            cols += li.size
        if not kinds:
            continue                       # no bonded content (e.g. images)
        select = np.zeros((apm, cols), np.float32)
        for (kind, li, _pr, _wh), off in zip(kinds, offsets):
            nt, p = li.shape
            for sl in range(p):
                cix = off + sl * nt + np.arange(nt)
                select[li[:, sl], cix] = 1.0
        types.append(MolType(apm=apm, runs=tuple(map(tuple, runs)),
                             kinds=tuple(kinds), select=select,
                             offsets=tuple(offsets),
                             n_mol=len(info["mols"])))
    if exc_flat_pos is not None:
        # re-express the exception leftover as the (N, XA) keep-mask the
        # sparse path consumes (True = still evaluate there)
        keep = np.asarray(exc_mask, bool).copy()
        covered = exc_flat_pos[~leftover.pop("exception")]
        keep.reshape(-1)[covered] = False
        leftover["exception"] = keep
    return types, leftover


def types_to(types, device):
    """MolTypes with ``select``, every per-kind parameter table and the atom
    index ``idx`` of their runs as tensors on ``device``."""
    out = []
    for t in types:
        kinds = tuple(
            (kind, li, torch.as_tensor(pr, device=device),
             None if wh is None else torch.as_tensor(wh, device=device))
            for kind, li, pr, wh in t.kinds)
        idx = np.concatenate([np.arange(st, st + cnt * t.apm)
                              for st, cnt in t.runs])
        out.append(t._replace(kinds=kinds,
                              select=torch.as_tensor(t.select,
                                                     device=device),
                              idx=torch.as_tensor(idx, dtype=torch.int64,
                                                  device=device)))
    return out


def energies_and_forces(pos, box, types, n_atoms):
    """Dense per-type evaluation on the tensors of ``types_to``.  Returns
    (energy dict, forces (N,3))."""
    box3 = (box[0], box[1], box[2])
    energies = {}
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)

    def add_e(name, val):
        energies[name] = energies.get(name, zero) + val

    forces = torch.zeros((n_atoms, 3), dtype=pos.dtype, device=pos.device)
    for t in types:
        m_cnt = t.n_mol
        P = pos[t.idx].reshape(m_cnt, t.apm, 3)
        S = t.select                       # (apm, S_tot)
        P3 = P.permute(2, 0, 1).reshape(3 * m_cnt, t.apm)
        comp3 = torch.matmul(P3, S).reshape(3, m_cnt, -1)
        comp = [comp3[0], comp3[1], comp3[2]]              # (m, S_tot) each
        grads_flat = [[], [], []]
        for (kind, li, pr, wh), off in zip(t.kinds, t.offsets):
            nt, p = li.shape
            fn, _ = _TERM_FNS[kind]

            def delta(a, b, _off=off, _nt=nt):
                out = []
                for c in range(3):
                    da = comp[c][:, _off + a * _nt:_off + (a + 1) * _nt]
                    db = comp[c][:, _off + b * _nt:_off + (b + 1) * _nt]
                    out.append(_mi(da - db, box3[c]))
                return tuple(out)

            e_t, grads = fn(delta, pr)                    # (m, nt)
            if kind == "exception":
                e_c, e_l = e_t
                add_e("exception_coul", torch.sum(e_c))
                add_e("exception_lj", torch.sum(e_l))
                e_t = e_c
            elif wh is not None:
                la, lb = {"bond": ("bond", "urey_bradley"),
                          "dihedral": ("dihedral", "improper")}[kind]
                add_e(la, torch.sum(torch.where(wh < 0.5, e_t, zero)))
                add_e(lb, torch.sum(torch.where(wh >= 0.5, e_t, zero)))
            else:
                add_e(kind, torch.sum(e_t))
            for sl in range(p):
                for c in range(3):
                    g = grads[sl][c]
                    if g.dim() < 2:        # unbatched zero placeholder
                        g = torch.broadcast_to(g, e_t.shape)
                    grads_flat[c].append(g)
        G3 = torch.cat([torch.cat(gl, dim=1) for gl in grads_flat], dim=0)
        F3 = torch.matmul(G3, S.t()).reshape(3, m_cnt, t.apm)
        F = -F3.permute(1, 2, 0).reshape(-1, 3)           # (m*apm, 3)
        forces.index_copy_(0, t.idx, F)    # types' atoms are disjoint
    return energies, forces
