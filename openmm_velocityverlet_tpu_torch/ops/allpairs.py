"""Dense all-pairs direct-space nonbonded sweep (counterpart of
``openmm_velocityverlet_tpu/ops/allpairs.py``): the static pair-table
builder (host numpy, identical output), the shared pair math, and the dense
torch sweep that serves as the CPU oracle of the plist pair kernel, and
``DenseSweep``, that sweep as a ``ForceEvaluator`` holds it.

* pair LJ parameters come from the per-type (T,T) tables (a one-hot
  contraction, exact in float32);
* exclusions are a bit test: partner offsets 1..31 live in a per-atom
  31-bit forward mask, distant leftovers go to the residual adjustment;
* excluded pairs contribute their reciprocal-space correction
  -qq erf(beta r)/r in the same pass.
"""
from __future__ import annotations

import numpy as np
import torch

from ..units import ONE_4PI_EPS0
from ..utils.pbc import minimum_image

_SQRT_PI = 1.7724538509055159

MAX_EXCL_OFFSET = 31
# Direct-space Coulomb force cap, shared by every pair path of the port:
# the bare-Coulomb 1/r^3 force/r factor is clamped at r = 0.045 nm (see the
# JAX allpairs module for the contract).  The energy is not capped.
_COUL_CAP_R = 0.045
_COUL_F_CAP3 = (1.0 / _COUL_CAP_R) ** 3


def build_pair_tables(n_atoms, lj_type, acoef, bcoef, exclusions,
                      lj_group=None, lj_group_allowed=None,
                      exc_idx=None, exc_qq=None, exc_c6=None, exc_c12=None,
                      charges=None, fold_exc14=True):
    """Host-side static tables for the dense kernel.

    Returns dict with:
      arows, brows: (N,T) f32   per-atom rows of the LJ tables
      onehot:       (N,T) f32   one-hot of each atom's LJ type
      excl_bits:    (N,)  i32   bit d set => atom (i+d) is excluded, d in 1..31
      residual:     (R,2) i32   excluded pairs with offset > 31 (adjust path)
      grows/gonehot: optional (N,G) for interaction-group masking
      exc14_bits:   (N,)  i32   bit d set => (i, i+d) is a kernel-handled 1-4
      a14rows/b14rows: (N,T) f32 1-4 LJ table rows (zero when absent)
      exc_term_mask: (N,XA) bool  exceptions left to the sparse term pass

    When the per-atom exception tables are passed, every *regular* 1-4
    exception — Coulomb exactly 0.5 q_i q_j and LJ consistent with a single
    per-type-pair (a14, b14) table (CHARMM rmin_14/eps_14 geometric rule,
    reference oplspsffile.py:1408-1427) — within the 31-offset window is
    folded into the pair sweep itself (``exc14_bits``: the band sweep of
    kernel B2 and the dense sweep evaluate them on the exclusion-correction
    path).  Irregular or distant exceptions stay in the sparse term pass.
    """
    lj_type = np.asarray(lj_type)
    acoef = np.asarray(acoef, np.float64)
    bcoef = np.asarray(bcoef, np.float64)
    arows = acoef[lj_type].astype(np.float32)
    brows = bcoef[lj_type].astype(np.float32)
    T = acoef.shape[0]
    onehot = np.zeros((n_atoms, T), np.float32)
    onehot[np.arange(n_atoms), lj_type] = 1.0

    # The OPLS geometric rule makes the tables multiplicative:
    # a_ij = sa_i sa_j with sa = sqrt(diag).  NBFIX rows break that for a
    # handful of type pairs; represent those as a small per-class correction
    # (the factorized form of the JAX dense sweep).
    sa = np.sqrt(np.maximum(np.diag(acoef), 0.0))
    sb = np.sqrt(np.maximum(np.diag(bcoef), 0.0))
    dA = acoef - np.outer(sa, sa)
    dB = bcoef - np.outer(sb, sb)
    scale = np.maximum(np.abs(acoef), 1e-30)
    fixed = (np.abs(dA) > 1e-6 * scale) | \
            (np.abs(dB) > 1e-6 * np.maximum(np.abs(bcoef), 1e-30))
    nbfix_types = np.where(fixed.any(axis=1))[0]
    # class 0 = "no correction"; classes 1.. = the types with NBFIX rows
    type_class = np.zeros(T, np.int32)
    type_class[nbfix_types] = np.arange(1, len(nbfix_types) + 1)
    NC = len(nbfix_types) + 1
    # per-type correction rows indexed by the partner's class
    corrA = np.zeros((T, NC), np.float32)
    corrB = np.zeros((T, NC), np.float32)
    for c, tj in enumerate(nbfix_types):
        corrA[:, c + 1] = np.where(fixed[:, tj], dA[:, tj], 0.0)
        corrB[:, c + 1] = np.where(fixed[:, tj], dB[:, tj], 0.0)
    # exactness check of the factorized representation
    recA = np.outer(sa, sa) + np.where(fixed, dA, 0.0)
    exact = np.allclose(recA, acoef, rtol=2e-6, atol=1e-30) and \
        np.allclose(np.outer(sb, sb) + np.where(fixed, dB, 0.0), bcoef,
                    rtol=2e-6, atol=1e-30)

    # built as uint32 (bit 31 is a valid offset bit), viewed as int32 for
    # the kernels — the >> k & 1 test is shift-sign agnostic
    excl_bits = np.zeros(n_atoms, np.uint32)
    residual = []
    exclusions = np.asarray(exclusions)
    for i in range(n_atoms):
        for j in exclusions[i]:
            if j < 0 or j <= i:
                continue
            d = int(j) - i
            if d <= MAX_EXCL_OFFSET:
                excl_bits[i] |= np.uint32(1 << d)
            else:
                residual.append((i, int(j)))
    excl_bits = excl_bits.view(np.int32)
    residual = (np.asarray(residual, np.int32).reshape(-1, 2)
                if residual else np.zeros((0, 2), np.int32))

    # Exclusion-closure cluster ranges for the z-banded sorted sweep: merge
    # atoms into contiguous index ranges such that no exclusion crosses a
    # range boundary.  Sorting whole ranges (stable, members keep their
    # internal order) preserves every intra-range index offset, so the
    # 31-bit exclusion masks remain valid in sorted order.
    reach = np.arange(n_atoms, dtype=np.int64)
    for i in range(n_atoms):
        for j in exclusions[i]:
            if j > i:
                reach[i] = max(reach[i], int(j))
    cluster_ref = np.zeros(n_atoms, np.int32)
    start, end = 0, -1
    for i in range(n_atoms):
        if i > end:
            start = i
        end = max(end, int(reach[i]))
        cluster_ref[i] = start

    # ---- kernel-handled 1-4 exceptions ----
    exc14_bits = np.zeros(n_atoms, np.uint32)
    a14 = np.zeros((T, T), np.float64)
    b14 = np.zeros((T, T), np.float64)
    exc_term_mask = None
    if exc_idx is not None and np.asarray(exc_idx).size:
        exc_idx = np.asarray(exc_idx)
        exc_qq = np.asarray(exc_qq, np.float64)
        exc_c6 = np.asarray(exc_c6, np.float64)
        exc_c12 = np.asarray(exc_c12, np.float64)
        q = np.asarray(charges, np.float64)
        exc_term_mask = exc_idx >= 0
        seen = np.zeros((T, T), bool)
        for i in range(n_atoms):
            for k in range(exc_idx.shape[1]):
                j = int(exc_idx[i, k])
                if j < 0 or j <= i:
                    continue
                qq, c6, c12 = exc_qq[i, k], exc_c6[i, k], exc_c12[i, k]
                if qq == 0.0 and c6 == 0.0 and c12 == 0.0:
                    # pure exclusion (lone-pair / Drude attachments): the
                    # exclusion bitmask already covers it — drop the term
                    kk = np.where(exc_idx[j] == i)[0]
                    exc_term_mask[i, k] = False
                    exc_term_mask[j, kk] = False
                    continue
                qq_reg = 0.5 * ONE_4PI_EPS0 * q[i] * q[j]
                regular = fold_exc14 and \
                    abs(qq - qq_reg) <= 1e-5 * max(abs(qq_reg), 1e-6)
                ti, tj = int(lj_type[i]), int(lj_type[j])
                av, bv = np.sqrt(max(c12, 0.0)), c6
                if regular and seen[ti, tj]:
                    regular = (abs(a14[ti, tj] - av)
                               <= 1e-5 * max(a14[ti, tj], 1e-12)
                               and abs(b14[ti, tj] - bv)
                               <= 1e-5 * max(abs(b14[ti, tj]), 1e-12))
                d = int(j) - i
                if regular and 1 <= d <= MAX_EXCL_OFFSET:
                    if not seen[ti, tj]:
                        a14[ti, tj] = av
                        a14[tj, ti] = av
                        b14[ti, tj] = bv
                        b14[tj, ti] = bv
                        seen[ti, tj] = seen[tj, ti] = True
                    exc14_bits[i] |= np.uint32(1 << d)
                    kk = np.where(exc_idx[j] == i)[0]
                    exc_term_mask[i, k] = False
                    exc_term_mask[j, kk] = False
    exc14_bits = exc14_bits.view(np.int32)

    out = dict(arows=arows, brows=brows, onehot=onehot,
               excl_bits=excl_bits, residual=residual,
               cluster_ref=cluster_ref,
               exc14_bits=exc14_bits,
               a14rows=a14[lj_type].astype(np.float32),
               b14rows=b14[lj_type].astype(np.float32),
               exc_term_mask=exc_term_mask,
               has_exc14=bool((exc14_bits != 0).any()),
               grows=None, gonehot=None,
               factorized=bool(exact),
               sa=sa[lj_type].astype(np.float32),
               sb=sb[lj_type].astype(np.float32),
               cls=type_class[lj_type],
               corrA=corrA[lj_type], corrB=corrB[lj_type])
    if lj_group is not None and lj_group_allowed is not None \
            and np.asarray(lj_group_allowed).shape[0] > 1:
        g = np.asarray(lj_group)
        allowed = np.asarray(lj_group_allowed, np.float32)
        G = allowed.shape[0]
        out["grows"] = allowed[g]                      # (N,G)
        goh = np.zeros((n_atoms, G), np.float32)
        goh[np.arange(n_atoms), g] = 1.0
        out["gonehot"] = goh
    # static per-residual-pair coefficients: types and groups never change,
    # so the adjust path needs no (R,T) table gathers at runtime
    if residual.shape[0]:
        ti = lj_type[residual[:, 0]]
        tj = lj_type[residual[:, 1]]
        res_a = acoef[ti, tj].astype(np.float32)
        res_b = bcoef[ti, tj].astype(np.float32)
        if out["grows"] is not None:
            ga = np.asarray(lj_group_allowed, np.float32)[
                np.asarray(lj_group)[residual[:, 0]],
                np.asarray(lj_group)[residual[:, 1]]]
            res_a = res_a * ga
            res_b = res_b * ga
        out["residual_a"] = res_a
        out["residual_b"] = res_b
        if charges is not None:
            # f32 operation order (ONE_4PI_EPS0 * q_i) * q_j, as the
            # sweeps compute qq
            q32 = np.asarray(charges, np.float32)
            out["residual_qq"] = ((np.float32(ONE_4PI_EPS0)
                                   * q32[residual[:, 0]])
                                  * q32[residual[:, 1]])
        # atom-major incidence of the residual pairs (the JAX
        # residual_adjustment accumulates through it; kept so the tables
        # stay identical to the JAX builder's)
        incid = {}
        for p, (pi, pj) in enumerate(np.asarray(residual)):
            incid.setdefault(int(pi), []).append((p, 1.0))
            incid.setdefault(int(pj), []).append((p, -1.0))
        atoms = np.fromiter(sorted(incid), np.int32)
        amax = max(len(v) for v in incid.values())
        res_incid = np.full((atoms.size, amax), -1, np.int32)
        res_sign = np.zeros((atoms.size, amax), np.float32)
        for r_, at in enumerate(atoms):
            for k, (p, sgn) in enumerate(incid[int(at)]):
                res_incid[r_, k] = p
                res_sign[r_, k] = sgn
        out["res_atoms"] = atoms
        out["res_incid"] = res_incid
        out["res_sign"] = res_sign
    return out



def lj_switch(e_lj, f_lj, r, inv_r, r_switch, r_cutoff):
    """OpenMM switching function on the LJ terms: E *= S(r),
    S = 1 - 10x^3 + 15x^4 - 6x^5, x = (r-rs)/(rc-rs) clipped to [0,1]; the
    force scalar (f = -dE/dr / r) becomes S*f - E*dS/dr/r.  r_switch = 0
    disables it."""
    if not r_switch:
        return e_lj, f_lj
    inv_w = 1.0 / (r_cutoff - r_switch)
    x = torch.clamp((r - r_switch) * inv_w, 0.0, 1.0)
    x2 = x * x
    s = 1.0 + x * x2 * (-10.0 + x * (15.0 - 6.0 * x))
    ds = x2 * (-30.0 + x * (60.0 - 30.0 * x)) * inv_w
    return e_lj * s, f_lj * s - e_lj * ds * inv_r


def _pair_terms(r2, qq, a, b, beta, r_cutoff, direct_mask, corr_mask,
                exc14_mask=None, a14=None, b14=None, r_switch=0.0):
    """Shared LJ + Ewald-direct + exclusion-correction math.

    direct pairs:   E = a^2/r^12 - b/r^6 + qq erfc(beta r)/r
    excluded pairs: E = -qq erf(beta r)/r   (reciprocal-space correction)
    folded 1-4 exception pairs (``exc14_mask``, see build_pair_tables):
                    additionally E = 0.5 qq/r + a14^2/r^12 - b14/r^6
    Returns (e_lj, e_coul, e_corr, e14_coul, e14_lj, f_scalar).
    """
    in_range = direct_mask & (r2 < r_cutoff * r_cutoff)
    r2s = torch.clamp(r2, min=1e-10)
    inv_r = torch.rsqrt(r2s)
    inv_r2 = inv_r * inv_r
    r = r2s * inv_r
    inv_r2_lj = 1.0 / torch.clamp(r2, min=1e-6)
    inv_r6 = inv_r2_lj * inv_r2_lj * inv_r2_lj
    inv_r12 = inv_r6 * inv_r6
    e_lj = a * a * inv_r12 - b * inv_r6
    f_lj = (12.0 * a * a * inv_r12 - 6.0 * b * inv_r6) * inv_r2_lj
    e_lj, f_lj = lj_switch(e_lj, f_lj, r, inv_r, r_switch, r_cutoff)
    br = beta * r
    # erfc via Abramowitz-Stegun 7.1.26 (|err| < 1.5e-7), sharing its exp
    # with the Gaussian force term
    expm = torch.exp(-br * br)
    t = 1.0 / (1.0 + 0.3275911 * br)
    erfc_br = (t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
               + t * (-1.453152027 + t * 1.061405429))))) * expm
    gauss = (2.0 * beta / _SQRT_PI) * expm
    e_coul = qq * erfc_br * inv_r
    erf_inv_r = (1.0 - erfc_br) * inv_r
    e_corr = -qq * erf_inv_r
    f_corr = -qq * (erf_inv_r - gauss) * inv_r2
    f_coul = qq * torch.clamp(inv_r * inv_r2, max=_COUL_F_CAP3) + f_corr
    zero = torch.zeros_like(e_lj)
    f_s = torch.where(in_range, f_lj + f_coul, zero) \
        + torch.where(corr_mask, f_corr, zero)
    if exc14_mask is None:
        e14_c = e14_l = zero
    else:
        e14_c = 0.5 * qq * inv_r
        e14_12 = a14 * a14 * inv_r12
        e14_6 = b14 * inv_r6
        f14 = (e14_c + 12.0 * e14_12 - 6.0 * e14_6) * inv_r2
        e14_l = torch.where(exc14_mask, e14_12 - e14_6, zero)
        e14_c = torch.where(exc14_mask, e14_c, zero)
        f_s = f_s + torch.where(exc14_mask, f14, zero)
    return (torch.where(in_range, e_lj, zero),
            torch.where(in_range, e_coul, zero),
            torch.where(corr_mask, e_corr, zero), e14_c, e14_l, f_s)


def residual_tensors(tables, device):
    """The residual pairs' indices (int64) and static coefficients as
    tensors on ``device``; a ForceEvaluator stores them in its tables under
    "residual_dev" so a step copies nothing to the device."""
    res = tables["residual"].astype(np.int64)
    out = dict(i=torch.as_tensor(res[:, 0], device=device),
               j=torch.as_tensor(res[:, 1], device=device),
               a=torch.as_tensor(tables["residual_a"], device=device),
               b=torch.as_tensor(tables["residual_b"], device=device))
    if "residual_qq" in tables:
        out["qq"] = torch.as_tensor(tables["residual_qq"], device=device)
    return out


def residual_pair_terms(pos, box, charges, tables, beta, r_cutoff,
                        r_switch=0.0):
    """Excluded pairs beyond the 31-offset window (``tables["residual"]``):
    the sweeps treated them as plain direct pairs, so return the energy and
    force adjustments (d_e_lj, d_e_coul, d_e_corr, forces (R,3) on the first
    atom of each pair, i) that turn them into excluded pairs, with the same
    formulas so the cancellation is exact to rounding."""
    dev = pos.device
    rt = tables.get("residual_dev")
    if rt is None or rt["i"].device != dev:
        rt = residual_tensors(tables, dev)
    i, j, a, b = rt["i"], rt["j"], rt["a"], rt["b"]
    dr = minimum_image(pos[i] - pos[j], box)
    r2 = torch.sum(dr * dr, -1)
    qq = rt["qq"] if "qq" in rt else ONE_4PI_EPS0 * charges[i] * charges[j]
    ones = torch.ones(r2.shape, dtype=torch.bool, device=dev)
    _, _, e_corr_r, _, _, f_corr_only = _pair_terms(
        r2, qq, a, b, beta, r_cutoff, direct_mask=~ones, corr_mask=ones)
    e_lj_d, e_coul_d, _, _, _, f_direct_only = _pair_terms(
        r2, qq, a, b, beta, r_cutoff, direct_mask=ones, corr_mask=~ones,
        r_switch=r_switch)
    f_adj = (f_corr_only - f_direct_only)[:, None] * dr
    return (-torch.sum(e_lj_d), -torch.sum(e_coul_d), torch.sum(e_corr_r),
            i, j, f_adj)


def direct_space_dense(pos, box, charges, tables, beta, r_cutoff,
                       row_block: int = 1024, r_switch: float = 0.0):
    """All-pairs LJ + Ewald-direct + exclusion-correction sweep over row
    blocks, with the folded 1-4 exceptions when the tables carry them.
    Returns (E_lj, E_coul_direct, E_excl_corr, E_exc14_coul, E_exc14_lj,
    F)."""
    dev = pos.device
    n = pos.shape[0]
    q = charges
    has14 = bool(tables.get("has_exc14", False))

    def dev_t(a, dtype=None):
        return torch.as_tensor(a if dtype is None else a.astype(dtype),
                               device=dev)

    acoef_rows = dev_t(tables["arows"])
    bcoef_rows = dev_t(tables["brows"])
    onehot = dev_t(tables["onehot"])
    excl_bits = dev_t(tables["excl_bits"], np.int64)
    if has14:
        a14_rows = dev_t(tables["a14rows"])
        b14_rows = dev_t(tables["b14rows"])
        exc14_bits = dev_t(tables["exc14_bits"], np.int64)
    grows = (dev_t(tables["grows"]) if tables["grows"] is not None
             else None)
    gonehot = (dev_t(tables["gonehot"]) if tables["grows"] is not None
               else None)
    col_id = torch.arange(n, device=dev)[None, :]
    z = torch.zeros((), dtype=torch.float32, device=dev)
    sums = [z] * 5
    rows = []
    B = min(row_block, n)
    for s in range(0, n, B):
        rid = torch.arange(s, min(s + B, n), device=dev)
        dr = minimum_image(pos[rid][:, None, :] - pos[None, :, :], box)
        r2 = torch.sum(dr * dr, -1)
        delta = col_id - rid[:, None]
        dfwd = torch.clamp(delta, 1, MAX_EXCL_OFFSET)
        dbwd = torch.clamp(-delta, 1, MAX_EXCL_OFFSET)
        fwd = (delta >= 1) & (delta <= MAX_EXCL_OFFSET)
        bwd = (delta <= -1) & (delta >= -MAX_EXCL_OFFSET)

        def bit_test(bits):
            return ((((bits[rid][:, None] >> dfwd) & 1) > 0) & fwd) \
                | ((((bits[None, :] >> dbwd) & 1) > 0) & bwd)

        excl = bit_test(excl_bits)
        alive = delta != 0
        a = acoef_rows[rid] @ onehot.t()
        b = bcoef_rows[rid] @ onehot.t()
        if grows is not None:
            allowed = grows[rid] @ gonehot.t()
            a = a * allowed
            b = b * allowed
        kw14 = {}
        if has14:
            kw14 = dict(exc14_mask=bit_test(exc14_bits) & alive,
                        a14=a14_rows[rid] @ onehot.t(),
                        b14=b14_rows[rid] @ onehot.t())
        qq = ONE_4PI_EPS0 * q[rid][:, None] * q[None, :]
        *energies, f_s = _pair_terms(
            r2, qq, a, b, beta, r_cutoff, direct_mask=alive & ~excl,
            corr_mask=alive & excl, r_switch=r_switch, **kw14)
        rows.append(torch.sum(f_s[..., None] * dr, dim=1))
        sums = [acc + torch.sum(e) for acc, e in zip(sums, energies)]
    forces = torch.cat(rows, 0)
    e_lj, e_coul, e_corr, e14_c, e14_l = [0.5 * e for e in sums]
    if tables["residual"].shape[0]:
        d_lj, d_coul, d_corr, i, j, f_adj = residual_pair_terms(
            pos, box, charges, tables, beta, r_cutoff, r_switch)
        e_lj, e_coul, e_corr = e_lj + d_lj, e_coul + d_coul, e_corr + d_corr
        forces = forces.index_add(0, i, f_adj).index_add(0, j, -f_adj)
    return e_lj, e_coul, e_corr, e14_c, e14_l, forces


class DenseSweep:
    """The dense all-pairs sweep for one System on one device, as a
    ``ForceEvaluator`` holds it: no plan, no cache, and a coverage flag
    that is never set."""
    mode = "dense"
    carries_cache = query_flag = host_flag = False

    def __init__(self, system, tables, device):
        self.system, self.tables = system, tables
        self.charges = torch.as_tensor(
            np.asarray(system.charges).astype(np.float32), device=device)

    def __call__(self, pos, box, cache=None, want_energy: bool = True,
                 full_list: bool = False):
        """(e_lj, e_coul, e_corr, e14_coul, e14_lj, forces, flag) at the
        placed ``pos``."""
        s = self.system
        return direct_space_dense(
            pos, box, self.charges, self.tables, s.ewald_beta, s.r_cutoff,
            r_switch=s.r_switch) + (
                torch.zeros((), dtype=torch.bool, device=pos.device),)
