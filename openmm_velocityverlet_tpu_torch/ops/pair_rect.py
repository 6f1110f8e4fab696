"""The full rectangular pair sweep and kernel B3 (counterpart of
``_pair_kernel`` and ``_run`` of ``openmm_velocityverlet_tpu/ops/
pallas_pair.py``, the ``symmetric=False`` branch of ``direct_space_pallas``).

Every row atom meets every column atom of the padded, unsorted layout, so
each unordered pair is evaluated from both sides: the sweep needs no Newton
reaction, and its per-row energies count each pair twice (the caller halves
their sums).  The output is ``fout (n_pad, 8)``: fx, fy, fz, e_lj, e_coul,
e_corr per row, columns 6-7 zero.

Its pair arithmetic is the JAX kernel's own, which differs from kernels B1
and B2 (``pair_plist.pair_math``): LJ as a*a/r^12 - b/r^6 with
1/max(r^2, 1e-6), the uncapped Coulomb with the A&S erfc (there is no
force-only form), and pads masked by index (``row < n`` and ``col < n``),
not by distance: a pad at 1e6 wraps back into the box under the minimum
image.  The excluded-pair erf correction runs for every excluded pair at
any distance; only the direct terms take the cutoff.

On a CUDA tensor ``rect_pair`` launches kernel B3 (``csrc/rect_pair.cu``)
and counts the launch in ``rect_pair.launches``; on a CPU tensor it takes
the plain torch version ``rect_pair_reference``.  The kernel does not sweep
the padded layout: it sorts the real atoms along a Morton curve
(``rect_layout``), cuts them into 32-atom chunks with bounding boxes, skips
the chunk pairs out of reach (``chunk_reach``) and, in a kept chunk, the
columns out of reach of the row chunk's box (``column_reach``), and adds
the excluded pairs in a band pass over original indices.
``rect_pair_culled`` is that enumeration in plain torch.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..units import ONE_4PI_EPS0
from .allpairs import lj_switch
from .pair_plist import (_REF_BATCH_PAIRS, MAX_EXCL_OFFSET, _kernel_scalars,
                         _morton_key)
from .pair_tri import band_statics

CHUNK = 32          # atoms a chunk: one warp's rows or columns
BOX_SLACK = 1e-3    # nm added to a chunk box's half extent (float32 rounding)
BATCH = 4           # columns a round of the kernel's pair loop


def _pair_terms(dx, dy, dz, r2, qq, a, b, *, beta, r_cutoff, r_switch,
                gauss_pref):
    """B3's per-pair arithmetic: returns (f_direct, e_lj, e_c, f_excl,
    e_excl), the force scalars and energies of a direct pair within the
    cutoff and of an excluded pair (the erf correction)."""
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
    expm = torch.exp(-br * br)
    t = 1.0 / (1.0 + 0.3275911 * br)
    erfc_br = (t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
               + t * (-1.453152027 + t * 1.061405429))))) * expm
    gauss = gauss_pref * expm
    e_c = qq * erfc_br * inv_r
    f_c = qq * (erfc_br * inv_r + gauss) * inv_r2
    erf_inv_r = (1.0 - erfc_br) * inv_r
    return (f_lj + f_c, e_lj, e_c, -qq * (erf_inv_r - gauss) * inv_r2,
            -qq * erf_inv_r)


def _min_image(d, box):
    return d - box * torch.round(d * (1.0 / box))


def _lj_ab(ab, rows, ct, grows, grp, t_dim):
    """LJ coefficients (a, b) of row atoms ``rows`` (R, 1) against column
    types ``ct`` (1, C) (-1: none), times the group-allowed entries."""
    ok = ct >= 0
    idx = torch.clamp(ct, min=0).expand(rows.shape[0], -1)
    zero = torch.zeros(idx.shape, dtype=ab.dtype, device=ab.device)
    a = torch.where(ok, torch.gather(ab[rows[:, 0], :t_dim], 1, idx), zero)
    b = torch.where(ok, torch.gather(ab[rows[:, 0], t_dim:2 * t_dim], 1,
                                     idx), zero)
    if grows is not None:
        allowed = torch.gather(grows[rows[:, 0]], 1, grp.expand(
            rows.shape[0], -1))
        a = a * allowed
        b = b * allowed
    return a, b


def _excluded(ri, cj, bits64):
    """(R, C) bool: original indices ``ri`` (R, 1) and ``cj`` (1, C) form an
    excluded pair, marked in the lower index's mask at bit |j - i| <= 31."""
    delta = cj - ri
    dabs = delta.abs()
    lower = torch.where(delta > 0, ri, cj).expand(delta.shape)
    bit = (bits64[lower] >> torch.clamp(dabs, 1, MAX_EXCL_OFFSET)) & 1
    return (bit > 0) & (dabs >= 1) & (dabs <= MAX_EXCL_OFFSET)


def rect_pair_reference(pos, q, ab, bits, ljt, grp, grows, box, *, n, t_dim,
                        beta, r_cutoff, r_switch=0.0):
    """Plain torch version of kernel B3: the same ``fout (n_pad, 8)`` from
    the same inputs, in blocks of rows against all columns.  ``pos`` etc.
    are the padded original-order columns (``pair_tri.band_statics``);
    ``n`` is the number of real atoms."""
    dev = pos.device
    n_pad = pos.shape[0]
    sc = _kernel_scalars(beta, r_cutoff)
    fout = torch.zeros((n_pad, 8), dtype=torch.float32, device=dev)
    cols = torch.arange(n_pad, device=dev)
    ct = ljt.to(torch.int64)
    colok = (ct >= 0)[None, :]
    cidx = torch.clamp(ct, min=0)[None, :]
    step = max(1, _REF_BATCH_PAIRS // max(n_pad, 1))
    bits64 = bits.to(torch.int64)
    for r0 in range(0, n_pad, step):
        r1 = min(r0 + step, n_pad)
        rows = torch.arange(r0, r1, device=dev)[:, None]
        d = []
        for ax in range(3):
            L = box[ax]
            da = pos[r0:r1, None, ax] - pos[None, :, ax]
            d.append(da - L * torch.round(da * (1.0 / L)))
        dx, dy, dz = d
        r2 = dx * dx + dy * dy + dz * dz
        delta = cols[None, :] - rows
        dfwd = torch.clamp(delta, 1, MAX_EXCL_OFFSET)
        dbwd = torch.clamp(-delta, 1, MAX_EXCL_OFFSET)
        excl = (((bits64[r0:r1, None] >> dfwd) & 1) > 0) \
            & (delta >= 1) & (delta <= MAX_EXCL_OFFSET)
        excl |= (((bits64[None, :] >> dbwd) & 1) > 0) \
            & (delta <= -1) & (delta >= -MAX_EXCL_OFFSET)
        alive = (delta != 0) & (rows < n) & (cols[None, :] < n)
        zero = torch.zeros_like(r2)
        idx = cidx.expand(r1 - r0, -1)
        a = torch.where(colok, torch.gather(ab[r0:r1, :t_dim], 1, idx), zero)
        b = torch.where(colok, torch.gather(ab[r0:r1, t_dim:2 * t_dim], 1,
                                            idx), zero)
        if grows is not None:
            allowed = torch.gather(grows[r0:r1], 1, grp.to(torch.int64)[
                None, :].expand(r1 - r0, -1))
            a = a * allowed
            b = b * allowed
        qq = ONE_4PI_EPS0 * q[r0:r1, None] * q[None, :]
        in_range = alive & ~excl & (r2 < sc["rc2"])
        corr = alive & excl
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
        expm = torch.exp(-br * br)
        t = 1.0 / (1.0 + 0.3275911 * br)
        erfc_br = (t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
                   + t * (-1.453152027 + t * 1.061405429))))) * expm
        gauss = sc["gauss_pref"] * expm
        e_c = qq * erfc_br * inv_r
        f_c = qq * (erfc_br * inv_r + gauss) * inv_r2
        erf_inv_r = (1.0 - erfc_br) * inv_r
        e_x = -qq * erf_inv_r
        f_x = -qq * (erf_inv_r - gauss) * inv_r2
        f_s = torch.where(in_range, f_lj + f_c, zero) \
            + torch.where(corr, f_x, zero)
        fout[r0:r1, 0] = torch.sum(f_s * dx, dim=1)
        fout[r0:r1, 1] = torch.sum(f_s * dy, dim=1)
        fout[r0:r1, 2] = torch.sum(f_s * dz, dim=1)
        fout[r0:r1, 3] = torch.sum(torch.where(in_range, e_lj, zero), dim=1)
        fout[r0:r1, 4] = torch.sum(torch.where(in_range, e_c, zero), dim=1)
        fout[r0:r1, 5] = torch.sum(torch.where(corr, e_x, zero), dim=1)
    return fout


# ------------------------------------------------- the culled enumeration
def skip_r2(r_cutoff):
    """The squared reach of the chunk and column skips, in float32: the
    cutoff's square grown by 1e-4 (with ``BOX_SLACK``, the margin that
    keeps the skips conservative under float32 rounding)."""
    rc2 = np.float32(r_cutoff * r_cutoff)
    return float(rc2 * np.float32(1.0001))


def rect_layout(pos, box, n):
    """The sorted chunk layout of kernel B3 for the first ``n`` (real) rows
    of ``pos``: the real atoms in stable Morton order of their wrapped
    positions (``pair_plist._morton_key``), cut into chunks of ``CHUNK``.
    Pads never enter it.  Returns a dict of
      * ``oid`` (n_s,) int32: each slot's original index, -1 on the slots
        that fill the last chunk (n_s = n rounded up to ``CHUNK``);
      * ``spos`` (n_s, 3) f32: the slots' positions as given (not wrapped),
        a fill slot repeating the last chunk's first atom;
      * ``cbox`` (n_c, 8) f32: each chunk's bounding box over its real
        atoms, in the frame of its first atom (every chunk's first slot is
        real): centre x, y, z, 0, half extent + ``BOX_SLACK`` x, y, z, 0.
    Plain torch on the tensor's device; the kernel's wrapper builds it on
    the card."""
    dev = pos.device
    n_s = -(-n // CHUNK) * CHUNK
    n_c = n_s // CHUNK
    real_pos = pos[:n].to(torch.float32)
    order = torch.argsort(_morton_key(real_pos, box, n), stable=True)
    # the fill slots repeat the last chunk's first atom, which leaves its
    # box as it is
    spos = real_pos[torch.cat([order, order[(n_c - 1) * CHUNK:][:1].expand(
        n_s - n)])] if n else real_pos
    oid = torch.cat([order.to(torch.int32), torch.full(
        (n_s - n,), -1, dtype=torch.int32, device=dev)])
    p = spos.reshape(n_c, CHUNK, 3)
    first = p[:, :1, :]
    w = _min_image(p - first, box)
    lo, hi = torch.amin(w, dim=1), torch.amax(w, dim=1)
    zero = torch.zeros((n_c, 1), dtype=torch.float32, device=dev)
    cbox = torch.cat([first[:, 0, :] + 0.5 * (lo + hi), zero,
                      0.5 * (hi - lo) + BOX_SLACK, zero], dim=1)
    return dict(oid=oid, spos=spos, cbox=cbox.contiguous())


def _box_gap2(u, half, box):
    """Squared gap of displacements ``u`` (..., 3) beyond ``half`` (..., 3)
    after the minimum image: a lower bound of every pair distance the two
    boxes (or the box and the point) hold."""
    u = _min_image(u, box)
    g = torch.clamp(torch.abs(u) - half, min=0.0)
    return torch.sum(g * g, dim=-1)


def chunk_reach(layout, box, r_cutoff):
    """(n_c, n_c) bool: the chunk pairs (row chunk, column chunk) kernel B3
    visits, those whose boxes come within the cutoff."""
    cb = layout["cbox"]
    m, h = cb[:, :3], cb[:, 4:7]
    return _box_gap2(m[None, :, :] - m[:, None, :],
                     h[:, None, :] + h[None, :, :], box) <= skip_r2(r_cutoff)


def column_reach(layout, box, r_cutoff):
    """(n_c, n_s) bool: the column slots the warp vote of each row chunk
    keeps in a visited chunk, the real ones within the cutoff of the row
    chunk's box."""
    cb = layout["cbox"]
    gap2 = _box_gap2(layout["spos"][None, :, :] - cb[:, None, :3],
                     cb[:, None, 4:7], box)
    return (gap2 <= skip_r2(r_cutoff)) & (layout["oid"] >= 0)[None, :]


def _kept_columns(layout, box, r_cutoff):
    """(n_c, n_c, 32) bool: the column slots kernel B3 visits, by row chunk
    and column chunk."""
    reach = chunk_reach(layout, box, r_cutoff)
    return column_reach(layout, box, r_cutoff).reshape(
        reach.shape[0], -1, CHUNK) & reach[:, :, None]


def culled_evaluations(layout, box, r_cutoff):
    """The ordered pair evaluations kernel B3 makes on ``layout``: 32 rows
    times each visited chunk's kept columns, rounded up to whole rounds of
    ``BATCH``."""
    kept = _kept_columns(layout, box, r_cutoff).sum(dim=2)
    return int((-(-kept // BATCH) * BATCH).sum()) * CHUNK


def rect_pair_culled(pos, q, ab, bits, ljt, grp, grows, box, *, n, t_dim,
                     beta, r_cutoff, r_switch=0.0):
    """Kernel B3's enumeration in plain torch, from the same inputs as
    ``rect_pair_reference``: the direct terms over the chunk pairs of
    ``chunk_reach`` and the columns of ``column_reach`` only (excluded
    pairs skipped), then the excluded pairs' erf correction in a band pass
    over original indices.  Returns (fout (n_pad, 8), evaluations), the
    ordered pair evaluations the kernel makes (``culled_evaluations``)."""
    dev = pos.device
    n_pad = pos.shape[0]
    sc = _kernel_scalars(beta, r_cutoff)
    kw = dict(beta=beta, r_cutoff=r_cutoff, r_switch=r_switch,
              gauss_pref=sc["gauss_pref"])
    lay = rect_layout(pos, box, n)
    oid = lay["oid"].to(torch.int64)
    keep = _kept_columns(lay, box, r_cutoff)
    bits64 = bits.to(torch.int64)
    acc = torch.zeros((n_pad, 5), dtype=torch.float32, device=dev)
    for c in range(keep.shape[0]):
        rows = oid[c * CHUNK:(c + 1) * CHUNK]
        rows = rows[rows >= 0][:, None]
        cols = oid.reshape(-1, CHUNK)[keep[c]][None, :]
        if cols.numel() == 0:
            continue
        dx, dy, dz = (_min_image(pos[rows, ax] - pos[cols, ax], box[ax])
                      for ax in range(3))
        r2 = dx * dx + dy * dy + dz * dz
        a, b = _lj_ab(ab, rows, ljt.to(torch.int64)[cols], grows,
                      grp.to(torch.int64)[cols], t_dim)
        qq = ONE_4PI_EPS0 * q[rows] * q[cols]
        f_in, e_lj, e_c, _, _ = _pair_terms(dx, dy, dz, r2, qq, a, b, **kw)
        use = (cols != rows) & ~_excluded(rows, cols, bits64) \
            & (r2 < sc["rc2"])
        zero = torch.zeros_like(r2)
        f_s = torch.where(use, f_in, zero)
        acc[rows[:, 0]] += torch.stack(
            [torch.sum(f_s * dx, 1), torch.sum(f_s * dy, 1),
             torch.sum(f_s * dz, 1), torch.sum(torch.where(use, e_lj, zero), 1),
             torch.sum(torch.where(use, e_c, zero), 1)], dim=1)
    fout = torch.zeros((n_pad, 8), dtype=torch.float32, device=dev)
    fout[:, :5] = acc
    # the band pass: pair (i, i + d) is excluded when bit d of i's mask is
    # set; each side takes its correction
    i = torch.arange(n, device=dev)[:, None]
    d = torch.arange(1, MAX_EXCL_OFFSET + 1, device=dev)[None, :]
    j = i + d
    hit = (j < n) & (((bits64[:n, None] >> d) & 1) > 0)
    ii, jj = i.expand(hit.shape)[hit], j[hit]
    dxyz = torch.stack([_min_image(pos[ii, ax] - pos[jj, ax], box[ax])
                        for ax in range(3)], dim=1)
    r2 = torch.sum(dxyz * dxyz, dim=1)
    qq = ONE_4PI_EPS0 * q[ii] * q[jj]
    zero = torch.zeros_like(r2)
    _, _, _, f_x, e_x = _pair_terms(dxyz[:, 0], dxyz[:, 1], dxyz[:, 2], r2,
                                    qq, zero, zero, **kw)
    for atoms, sign in ((ii, 1.0), (jj, -1.0)):
        fout[:, :3].index_add_(0, atoms, sign * f_x[:, None] * dxyz)
        fout[:, 5].index_add_(0, atoms, e_x)
    return fout, culled_evaluations(lay, box, r_cutoff)


# ------------------------------------------------------------- kernel B3
def _launcher():
    """The kernel library with its C signature declared (pointers and the
    stream as c_void_p, so ctypes never truncates them to 32 bits)."""
    lib = kernels.load("rect_pair")
    if lib.rect_pair_launch.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rect_pair_launch.argtypes = [
            P, P, P, I, I, P, P, P, I, P, P, P, P, I, I, I, F, F, F, F, F,
            F, P, P, P]
        lib.rect_pair_launch.restype = I
        lib.rect_pair_error_string.argtypes = [I]
        lib.rect_pair_error_string.restype = ctypes.c_char_p
    return lib


def _check(t, name, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"rect_pair: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def rect_pair(pos, q, ab, bits, ljt, grp, grows, box, *, n, t_dim, beta,
              r_cutoff, r_switch=0.0):
    """The rectangular sweep: returns ``fout (n_pad, 8)``.

    On a CUDA tensor this sorts the real atoms into ``rect_layout`` on the
    card and launches kernel B3 (``csrc/rect_pair.cu``) on the current
    stream, with no host read; the launch counts in
    ``rect_pair.launches``, and the kernel's ordered pair evaluations a row
    chunk, (n_c,) int64 on the card, are kept in ``rect_pair.evaluations``.
    On a CPU tensor it runs ``rect_pair_reference``.  There is no fallback:
    a CUDA call the kernel cannot take raises."""
    kw = dict(n=n, t_dim=t_dim, beta=beta, r_cutoff=r_cutoff,
              r_switch=r_switch)
    dev = pos.device
    if dev.type == "cpu":
        return rect_pair_reference(pos, q, ab, bits, ljt, grp, grows, box,
                                   **kw)
    if dev.type != "cuda":
        raise ValueError(f"rect_pair: unsupported device {dev}")
    n_pad = pos.shape[0]
    if not 0 <= n <= n_pad:
        raise ValueError(f"rect_pair: n={n} real atoms of {n_pad}")
    i32, f32 = torch.int32, torch.float32
    _check(pos, "pos", f32, (n_pad, 3), dev)
    _check(q, "q", f32, (n_pad,), dev)
    if ab.shape[1] < 2 * t_dim:
        raise ValueError(f"rect_pair: ab needs {2 * t_dim} columns, got "
                         f"{ab.shape[1]}")
    _check(ab, "ab", f32, (n_pad, ab.shape[1]), dev)
    for name, t in (("bits", bits), ("ljt", ljt), ("grp", grp)):
        _check(t, name, i32, (n_pad,), dev)
    if grows is not None:
        _check(grows, "grows", f32, (n_pad, grows.shape[1]), dev)
    _check(box, "box", f32, (3,), dev)
    layout = rect_layout(pos, box, n)
    sc = _kernel_scalars(beta, r_cutoff)
    fout = torch.empty((n_pad, 8), dtype=f32, device=dev)
    n_c = layout["cbox"].shape[0]
    evals = torch.empty((n_c,), dtype=torch.int64, device=dev)
    lib = _launcher()
    err = lib.rect_pair_launch(
        pos.data_ptr(), q.data_ptr(), ab.data_ptr(), ab.shape[1], t_dim,
        ljt.data_ptr(), grp.data_ptr(),
        None if grows is None else grows.data_ptr(),
        0 if grows is None else grows.shape[1], bits.data_ptr(),
        box.data_ptr(), layout["oid"].data_ptr(), layout["cbox"].data_ptr(),
        n_c, n_pad, n, float(beta), sc["rc2"], skip_r2(r_cutoff),
        float(r_cutoff), float(r_switch), sc["gauss_pref"], fout.data_ptr(),
        evals.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("rect_pair kernel launch failed: "
                           + lib.rect_pair_error_string(err).decode())
    rect_pair.launches += 1
    rect_pair.evaluations = evals
    return fout


rect_pair.launches = 0
rect_pair.evaluations = None


def run_rect(pos, box, charges, tables, *, beta, r_cutoff, blk,
             r_switch=0.0, statics=None):
    """The JAX ``_run``: pad ``pos`` (n, 3) with atoms at 1e6 to a whole
    number of ``blk``-atom tiles, take the padded original-order columns
    (``statics`` from ``pair_tri.band_statics`` at that size, built here
    when None) and run ``rect_pair``.  Returns ``fout (n_pad, 8)``."""
    dev = pos.device
    n = pos.shape[0]
    n_pad = -(-n // blk) * blk
    if statics is None or statics["q"].shape[0] != n_pad:
        statics = band_statics(charges, tables, n_pad, dev)
    pos2d = torch.cat([pos.to(torch.float32),
                       torch.full((n_pad - n, 3), 1e6, dtype=torch.float32,
                                  device=dev)]).contiguous()
    return rect_pair(pos2d, statics["q"], statics["ab"], statics["bits"],
                     statics["ljt"], statics["grp"], statics["grows"],
                     box.reshape(3).contiguous(), n=n,
                     t_dim=tables["arows"].shape[1], beta=beta,
                     r_cutoff=r_cutoff, r_switch=r_switch)
