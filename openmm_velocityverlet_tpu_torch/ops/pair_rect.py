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
the plain torch version ``rect_pair_reference``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..units import ONE_4PI_EPS0
from .allpairs import lj_switch
from .pair_plist import _REF_BATCH_PAIRS, MAX_EXCL_OFFSET, _kernel_scalars
from .pair_tri import band_statics


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


def _launcher():
    """The kernel library with its C signature declared (pointers and the
    stream as c_void_p, so ctypes never truncates them to 32 bits)."""
    lib = kernels.load("rect_pair")
    if lib.rect_pair_launch.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rect_pair_launch.argtypes = [
            P, P, P, I, I, P, P, P, I, P, P, I, I, F, F, F, F, F, P, P]
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

    On a CUDA tensor this launches kernel B3 (``csrc/rect_pair.cu``) on the
    current stream and counts the launch in ``rect_pair.launches``; on a
    CPU tensor it runs ``rect_pair_reference``.  There is no fallback: a
    CUDA call the kernel cannot take raises."""
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
    sc = _kernel_scalars(beta, r_cutoff)
    fout = torch.empty((n_pad, 8), dtype=f32, device=dev)
    lib = _launcher()
    err = lib.rect_pair_launch(
        pos.data_ptr(), q.data_ptr(), ab.data_ptr(), ab.shape[1], t_dim,
        ljt.data_ptr(), grp.data_ptr(),
        None if grows is None else grows.data_ptr(),
        0 if grows is None else grows.shape[1], bits.data_ptr(),
        box.data_ptr(), n_pad, n, float(beta), sc["rc2"], float(r_cutoff),
        float(r_switch), sc["gauss_pref"], fout.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("rect_pair kernel launch failed: "
                           + lib.rect_pair_error_string(err).decode())
    rect_pair.launches += 1
    return fout


rect_pair.launches = 0


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
