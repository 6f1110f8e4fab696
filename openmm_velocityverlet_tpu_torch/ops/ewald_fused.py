"""The fused exact-k Ewald reciprocal sum and kernels B4/B5 (counterpart of
``openmm_velocityverlet_tpu/ops/ewald_pallas.py``).

The k grid is flattened to the half-space list of K wave vectors, and the
phases theta_ik = k . r_i are recomputed on the fly, so nothing of size
(N, K) is ever stored:

  forward (B4):  S_re(k) = sum_i q_i cos theta_ik, S_im likewise;
                 E = c0 sum_k w_k |S(k)|^2;
  backward (B5): F_i = -q_i sum_k (a_k cos theta_ik - b_k sin theta_ik) k,
                 (a_k, b_k) = 2 c0 w_k (S_im, S_re).

``reciprocal_energy_fused`` is a ``torch.autograd.Function`` whose forward
runs B4 and whose backward runs B5 (both factorise the phase over the
lattice of the list: e^{i k.r} = ex[nx] ey[ny] ez[nz], per-atom axis tables
of one direct sin/cos an entry).  As in the JAX package, the backward
returns ZERO gradients for the box and the charges (the engine
differentiates positions only); do not use it for box or charge
derivatives.  On a CUDA tensor ``structure_factor`` and ``recip_forces``
launch the kernels (``csrc/ewald_fused.cu``); on a CPU tensor they take
their plain torch versions, chunked over atoms because a whole (N, K)
block is 2.7 GB at 19,500 atoms and K = 34,816.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels
from ..units import ONE_4PI_EPS0, PI

# elements of one (atoms, K) phase block in the plain versions
_REF_BLOCK = 1 << 24


def _half_space_modes(kmax) -> np.ndarray:
    """Integer mode triples (K, 3) covering the kz >= 0 half space with the
    kz = 0 plane reduced to its canonical (ky > 0) | (ky == 0 & kx > 0)
    half: the set ops/ewald.py keeps with weight 2 (conjugate symmetry
    S(-k) = S*(k))."""
    nx = np.arange(-kmax[0], kmax[0] + 1)
    ny = np.arange(-kmax[1], kmax[1] + 1)
    nz = np.arange(0, kmax[2] + 1)
    gx, gy, gz = np.meshgrid(nx, ny, nz, indexing="ij")
    keep = gz > 0
    keep |= (gz == 0) & ((gy > 0) | ((gy == 0) & (gx > 0)))
    modes = np.stack([gx[keep], gy[keep], gz[keep]], axis=1)
    return np.ascontiguousarray(modes.astype(np.float32))


@functools.lru_cache(maxsize=32)
def _k_tiling(kmax):
    k_real = _half_space_modes(kmax).shape[0]
    kt = max(128, -(-k_real // 128) * 128) if k_real <= 2048 else 1024
    return k_real, kt, -(-k_real // kt) * kt


def k_tiling(kmax):
    """(K, kt, kp): the real mode count, the k tile (one tile up to 2048
    modes, else tiles of 1024) and the padded mode count."""
    return _k_tiling(tuple(int(k) for k in kmax))


@functools.lru_cache(maxsize=8)
def _modes_t(kmax, device: str):
    """(3, kp) float32 mode triples on ``device``, zero-padded to kp."""
    modes = _half_space_modes(kmax)
    _, _, kp = k_tiling(kmax)
    out = np.zeros((3, kp), np.float32)
    out[:, :modes.shape[0]] = modes.T
    return torch.as_tensor(out, device=device)


def column_offsets(kmax) -> np.ndarray:
    """Offset into the ``_half_space_modes`` list of each (nx, ny) column,
    ((2 kmx + 1)(2 kmy + 1) + 1,) int32 in the list's own C order (nx
    slowest).  A column holds nz = 0 .. kmz, or nz = 1 .. kmz where its
    (nx, ny) is not in the canonical half of the nz = 0 plane, so it always
    ends at nz = kmz.  Kernel B5 walks the list by these offsets."""
    nx = np.arange(-kmax[0], kmax[0] + 1)[:, None]
    ny = np.arange(-kmax[1], kmax[1] + 1)[None, :]
    plane0 = (ny > 0) | ((ny == 0) & (nx > 0))
    counts = (kmax[2] + plane0.astype(np.int64)).reshape(-1)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


@functools.lru_cache(maxsize=8)
def _column_offsets_t(kmax, device: str):
    return torch.as_tensor(column_offsets(kmax), device=device)


def _prep(pos, box, charges, beta, kmax, ts):
    """Padding and the k-vector / weight setup, with the JAX ``_prep``'s
    K ordering, k tile and padding: returns (posp (n_pad, 3), qp (n_pad,),
    kvec (3, kp), w (kp,), c0, n_pad, kp, kt)."""
    dev = pos.device
    _, kt, kp = k_tiling(kmax)
    n = pos.shape[0]
    n_pad = -(-n // ts) * ts
    posp = torch.nn.functional.pad(pos.to(torch.float32), (0, 0, 0, n_pad - n))
    qp = torch.nn.functional.pad(
        torch.as_tensor(charges, dtype=torch.float32, device=dev),
        (0, n_pad - n))
    box = box.reshape(3).to(torch.float32)
    kvec = (float(np.float32(2.0 * PI)) * _modes_t(tuple(kmax), str(dev))
            / box[:, None]).contiguous()
    k2 = torch.sum(kvec * kvec, dim=0)
    live = k2 > 1e-10
    k2s = torch.where(live, k2, torch.ones_like(k2))
    w = torch.where(live, 2.0 * torch.exp(-k2s / (4.0 * beta * beta)) / k2s,
                    torch.zeros_like(k2))
    c0 = ONE_4PI_EPS0 * 2.0 * PI / (box[0] * box[1] * box[2])
    return posp.contiguous(), qp.contiguous(), kvec, w, c0, n_pad, kp, kt


def _theta(p, kvec):
    return p[:, 0:1] * kvec[0:1, :] + p[:, 1:2] * kvec[1:2, :] \
        + p[:, 2:3] * kvec[2:3, :]


def structure_factor_reference(posp, qp, kvec):
    """Plain torch version of kernel B4: (S_re, S_im), each (kp,)."""
    kp = kvec.shape[1]
    step = max(1, _REF_BLOCK // kp)
    s_re = torch.zeros(kp, dtype=torch.float32, device=posp.device)
    s_im = torch.zeros_like(s_re)
    for s in range(0, posp.shape[0], step):
        th = _theta(posp[s:s + step], kvec)
        q = qp[s:s + step, None]
        s_re = s_re + torch.sum(q * torch.cos(th), dim=0)
        s_im = s_im + torch.sum(q * torch.sin(th), dim=0)
    return s_re, s_im


def recip_forces_reference(posp, qp, kvec, ab):
    """Plain torch version of kernel B5: per-atom forces (n_pad, 3) from
    ab (2, kp) = (a_k, b_k)."""
    kp = kvec.shape[1]
    step = max(1, _REF_BLOCK // kp)
    out = []
    for s in range(0, posp.shape[0], step):
        th = _theta(posp[s:s + step], kvec)
        g = qp[s:s + step, None] * (ab[0:1] * torch.cos(th)
                                    - ab[1:2] * torch.sin(th))
        out.append(torch.stack([-torch.sum(g * kvec[c:c + 1], dim=1)
                                for c in range(3)], dim=1))
    return torch.cat(out, dim=0)


def recip_forces_factorised(posp, qp, ab, kmax, box):
    """Plain torch model of kernel B5's algorithm: e^{i k.r} = ex[nx] ey[ny]
    ez[nz] from per-atom tables of one direct sin/cos each, with the modes
    taken column by column in the list's order through ``column_offsets``
    (a dense (nx, ny, nz) block of (a_k, b_k), zero where the list has no
    mode).  Returns forces (n_pad, 3); agrees with ``recip_forces_reference``
    to float32 rounding.  For small systems: it holds (n_pad, nx, ny, nz)
    blocks."""
    kmax = tuple(int(k) for k in kmax)
    kmx, kmy, kmz = kmax
    k, live = _list_of_dense(kmax, posp.device)
    zero = torch.zeros((), dtype=torch.float32, device=posp.device)
    dense = [torch.where(live, ab[c][k], zero).reshape(
        2 * kmx + 1, 2 * kmy + 1, kmz + 1) for c in range(2)]
    (kx, cx, sx), (ky, cy, sy), (kz, cz, sz) = _axis_tables(posp, kmax, box)
    cxy = cx[:, :, None] * cy[:, None, :] - sx[:, :, None] * sy[:, None, :]
    sxy = cx[:, :, None] * sy[:, None, :] + sx[:, :, None] * cy[:, None, :]
    c3 = cxy[..., None] * cz[:, None, None, :] \
        - sxy[..., None] * sz[:, None, None, :]
    s3 = cxy[..., None] * sz[:, None, None, :] \
        + sxy[..., None] * cz[:, None, None, :]
    g = qp[:, None, None, None] * (dense[0][None] * c3 - dense[1][None] * s3)
    return -torch.stack([
        torch.sum(g * kx[None, :, None, None], dim=(1, 2, 3)),
        torch.sum(g * ky[None, None, :, None], dim=(1, 2, 3)),
        torch.sum(g * kz[None, None, None, :], dim=(1, 2, 3))], dim=1)


def _axis_tables(posp, kmax, box):
    """Per-atom phase tables of the factorised form: for each axis the k
    values (2 pi n) / L in the list's rounding and cos, sin of k_n x, with n
    signed on x and y and n >= 0 on z.  Returns [(kn, cos, sin)] * 3."""
    dev, f32 = posp.device, torch.float32
    two_pi = float(np.float32(2.0 * PI))
    box = box.reshape(3).to(f32)
    out = []
    for c, (km, signed) in enumerate(zip(kmax, (True, True, False))):
        n = torch.arange(-km if signed else 0, km + 1, device=dev).to(f32)
        kn = two_pi * n / box[c]
        th = posp[:, c:c + 1] * kn[None, :]
        out.append((kn, torch.cos(th), torch.sin(th)))
    return out


def _list_of_dense(kmax, device):
    """(k, live): for every place of the dense (nx, ny, nz) block, nz =
    0 .. kmz, its index in the half-space list through ``column_offsets``,
    and whether the list has that mode at all."""
    kmz = int(kmax[2])
    off = torch.as_tensor(column_offsets(kmax).astype(np.int64),
                          device=device)
    nzs = kmz + 1
    cnt = off[1:] - off[:-1]
    nz = torch.arange(nzs, device=device)
    k = off[:-1, None] + nz[None, :] - (nzs - cnt)[:, None]
    live = k >= off[:-1, None]
    return torch.where(live, k, torch.zeros_like(k)), live


def structure_factor_factorised(posp, qp, kmax, box):
    """Plain torch model of kernel B4's algorithm: e^{i k.r} = ex[nx] ey[ny]
    ez[nz] from per-atom axis tables of one direct sin/cos each, S(nx, ny,
    nz) = sum_i (q_i ex_i[nx] ey_i[ny]) ez_i[nz] as a dense block, gathered
    into the list's order through ``column_offsets``.  The half of the
    nz = 0 plane that the list lacks is dropped; the pad modes k >= K take
    the block's (0, 0, 0) element, sum_i q_i, which is what the plain
    version gives there (their kvec is 0).  Returns (S_re, S_im), each
    (kp,); agrees with ``structure_factor_reference`` to float32 rounding.
    For small systems: it holds (n_pad, nx, ny) blocks."""
    kmax = tuple(int(k) for k in kmax)
    (_, cx, sx), (_, cy, sy), (_, cz, sz) = _axis_tables(posp, kmax, box)
    a_re = qp[:, None, None] * (cx[:, :, None] * cy[:, None, :]
                                - sx[:, :, None] * sy[:, None, :])
    a_im = qp[:, None, None] * (cx[:, :, None] * sy[:, None, :]
                                + sx[:, :, None] * cy[:, None, :])
    d_re = torch.einsum("ixy,iz->xyz", a_re, cz) \
        - torch.einsum("ixy,iz->xyz", a_im, sz)
    d_im = torch.einsum("ixy,iz->xyz", a_re, sz) \
        + torch.einsum("ixy,iz->xyz", a_im, cz)
    k_real, _, kp = k_tiling(kmax)
    k, live = _list_of_dense(kmax, posp.device)
    out = []
    for d in (d_re, d_im):
        s = torch.empty(kp, dtype=torch.float32, device=posp.device)
        s[k_real:] = d[kmax[0], kmax[1], 0]
        s[k[live]] = d.reshape(-1, kmax[2] + 1)[live]
        out.append(s)
    return out[0], out[1]


# kernel B4's register tile (ny x nz modes a thread) and the atoms it stages
# at a time; csrc/ewald_fused.cu has the same constants
_B4_TY, _B4_TZ, _B4_ATOMS, _B4_THREADS = 4, 7, 32, 320


def structure_tiling(kmax, n_pad: int, sms: int) -> dict:
    """How kernel B4 cuts its work, from the shapes and the card's SM count
    alone (so the summation order is fixed for a run).  A thread owns a
    4 x 7 tile of (ny, nz) modes of one nx; ``sb`` such tiles along the
    flattened (nx, ny group) axis ("slots") and ``nzb`` nz groups make a
    block: all ``nzg`` of them where sb x nzg threads fit (kmax[2] up to 69),
    else as many as fit, ``nz_blocks`` blocks along grid.z covering them.
    ``blocks_x`` blocks cover the slots, and the atoms are cut into
    ``ranges`` ranges of ``atoms_per`` (two blocks an SM in flight)."""
    kmx, kmy, kmz = (int(k) for k in kmax)
    nyg = -(-(2 * kmy + 1) // _B4_TY)
    nzg = -(-(kmz + 1) // _B4_TZ)
    n_slots = (2 * kmx + 1) * nyg
    # the fewest padded slots, then the widest block
    fit = 32 * nzg <= _B4_THREADS
    sb = min((s for s in (128, 96, 64, 32)
              if not fit or s * nzg <= _B4_THREADS),
             key=lambda s: (-(-n_slots // s) * s, -s))
    nzb = nzg if fit else _B4_THREADS // sb
    nz_blocks = -(-nzg // nzb)
    blocks_x = -(-n_slots // sb)
    n_tab = -(-n_pad // _B4_ATOMS) * _B4_ATOMS
    ranges = max(1, min(n_tab // _B4_ATOMS,
                        (2 * sms) // (blocks_x * nz_blocks)))
    atoms_per = -(-n_tab // (ranges * _B4_ATOMS)) * _B4_ATOMS
    ranges = -(-n_tab // atoms_per)
    nxr = (sb - 1) // nyg + 2
    nxp = ((blocks_x - 1) * sb) // nyg + nxr
    return dict(sb=sb, nyg=nyg, nzg=nzg, nzb=nzb, nz_blocks=nz_blocks,
                blocks_x=blocks_x, stot=blocks_x * sb, nxr=nxr, nxp=nxp,
                ranges=ranges, atoms_per=atoms_per, threads=sb * nzb,
                n_tab=n_tab,
                tab_floats=n_tab * (2 * nxp + 2 * _B4_TZ * nzg
                                    + 2 * _B4_TY * nyg),
                dense=nzg * _B4_TZ * _B4_TY * blocks_x * sb)


@functools.lru_cache(maxsize=8)
def _dense_to_list_t(kmax, stot: int, device: str):
    """(dense,) int32: for each element of kernel B4's dense partial block,
    laid out [nz][ny % 4][slot], the index of its mode in the half-space
    list; -1 where the list has none, -2 for (0, 0, 0), whose value the pad
    modes take."""
    nyg = -(-(2 * kmax[1] + 1) // _B4_TY)
    nzp = -(-(kmax[2] + 1) // _B4_TZ) * _B4_TZ
    modes = _half_space_modes(kmax).astype(np.int64)
    ix, iy, nz = modes[:, 0] + kmax[0], modes[:, 1] + kmax[1], modes[:, 2]
    inv = np.full(nzp * _B4_TY * stot, -1, np.int32)
    inv[(nz * _B4_TY + iy % _B4_TY) * stot + ix * nyg + iy // _B4_TY] = \
        np.arange(modes.shape[0])
    inv[(kmax[1] % _B4_TY) * stot + kmax[0] * nyg + kmax[1] // _B4_TY] = -2
    return torch.as_tensor(inv, device=device)


def _launcher():
    """The kernel library with its C signatures declared (pointers and the
    stream as c_void_p, so ctypes never truncates them to 32 bits)."""
    lib = kernels.load("ewald_fused")
    if lib.ewald_structure_launch.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ewald_structure_launch.argtypes = [P] * 8 + [I] * 15 + [P]
        lib.ewald_force_launch.argtypes = [P, P, P, P, P, I, I, I, I, I, P,
                                           P, P]
        lib.ewald_structure_launch.restype = I
        lib.ewald_force_launch.restype = I
        lib.ewald_force_splits.argtypes = [I, I, I, I]
        lib.ewald_force_splits.restype = I
        lib.ewald_fused_error_string.argtypes = [I]
        lib.ewald_fused_error_string.restype = ctypes.c_char_p
    return lib


def _check(fn, t, name, shape, device):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{fn}: {name} must be a contiguous float32 tensor of shape "
            f"{tuple(shape)} on {device}; got {t.dtype} {tuple(t.shape)} "
            f"on {t.device}")


def _check_inputs(fn, posp, qp, kvec):
    dev = posp.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    n_pad, kp = posp.shape[0], kvec.shape[1]
    _check(fn, posp, "posp", (n_pad, 3), dev)
    _check(fn, qp, "qp", (n_pad,), dev)
    _check(fn, kvec, "kvec", (3, kp), dev)
    return dev, n_pad, kp


def _raise(lib, err, fn):
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: "
                           + lib.ewald_fused_error_string(err).decode())


def _check_list(fn, kvec, kmax, box, dev):
    """``kmax`` as ints and ``box`` (3,), after checking that ``kvec`` has
    the columns of ``_prep``'s padded half-space list for ``kmax``."""
    kp = kvec.shape[1]
    kmax = tuple(int(k) for k in kmax)
    if len(kmax) != 3 or min(kmax) < 0 or k_tiling(kmax)[2] != kp:
        raise ValueError(f"{fn}: kvec has {kp} columns, not the padded "
                         f"half-space list of kmax={kmax}")
    box = box.reshape(3)
    _check(fn, box, "box", (3,), dev)
    return kmax, box


def structure_factor(posp, qp, kvec, kmax, box):
    """(S_re, S_im) over the flattened half-space list of ``kmax`` in the
    box ``box`` (3,): ``kvec`` must be ``_prep``'s list for them.  On a CUDA
    tensor this launches kernel B4, which rebuilds the phases from ``kmax``
    and ``box`` (per-atom axis tables, a register-tiled contraction over the
    atoms, partial sums added in a fixed order) and writes the list's order,
    and counts it in ``structure_factor.launches``; the pad modes k >= K
    take sum_i q_i, as in the plain version.  On a CPU tensor it runs
    ``structure_factor_reference`` on ``kvec``.  No fallback: a CUDA call
    the kernel cannot take raises."""
    if posp.device.type == "cpu":
        return structure_factor_reference(posp, qp, kvec)
    dev, n_pad, kp = _check_inputs("structure_factor", posp, qp, kvec)
    kmax, box = _check_list("structure_factor", kvec, kmax, box, dev)
    t = structure_tiling(
        kmax, n_pad, torch.cuda.get_device_properties(dev).multi_processor_count)
    inv = _dense_to_list_t(kmax, t["stot"], str(dev))
    lib = _launcher()
    f32 = torch.float32
    tab = torch.empty(t["tab_floats"], dtype=f32, device=dev)
    part = torch.empty((t["ranges"], t["dense"], 2), dtype=f32, device=dev)
    s_re = torch.empty(kp, dtype=f32, device=dev)
    s_im = torch.empty_like(s_re)
    _raise(lib, lib.ewald_structure_launch(
        posp.data_ptr(), qp.data_ptr(), box.data_ptr(), tab.data_ptr(),
        part.data_ptr(), inv.data_ptr(), s_re.data_ptr(), s_im.data_ptr(),
        kmax[0], kmax[1], kmax[2], n_pad, kp, k_tiling(kmax)[0], t["sb"],
        t["nyg"], t["nzg"], t["blocks_x"], t["ranges"], t["atoms_per"],
        t["nxr"], t["nxp"], t["nzb"],
        torch.cuda.current_stream(dev).cuda_stream),
        "structure_factor")
    structure_factor.launches += 1
    return s_re, s_im


structure_factor.launches = 0


def recip_forces(posp, qp, kvec, ab, kmax, box):
    """Per-atom reciprocal forces (n_pad, 3) over the half-space list of
    ``kmax`` in the box ``box`` (3,): ``kvec`` must be ``_prep``'s list for
    them.  On a CUDA tensor this launches kernel B5, which rebuilds the
    phases from ``kmax`` and ``box`` and reads ``ab`` in the list's order,
    and counts it in ``recip_forces.launches``; on a CPU tensor it runs
    ``recip_forces_reference`` on ``kvec``."""
    if posp.device.type == "cpu":
        return recip_forces_reference(posp, qp, kvec, ab)
    dev, n_pad, kp = _check_inputs("recip_forces", posp, qp, kvec)
    _check("recip_forces", ab, "ab", (2, kp), dev)
    kmax, box = _check_list("recip_forces", kvec, kmax, box, dev)
    off = _column_offsets_t(kmax, str(dev))
    lib = _launcher()
    part = torch.empty((lib.ewald_force_splits(*kmax, n_pad), 3, n_pad),
                       dtype=torch.float32, device=dev)
    f = torch.empty((n_pad, 3), dtype=torch.float32, device=dev)
    _raise(lib, lib.ewald_force_launch(
        posp.data_ptr(), qp.data_ptr(), ab.data_ptr(), box.data_ptr(),
        off.data_ptr(), kmax[0], kmax[1], kmax[2], n_pad, kp,
        part.data_ptr(), f.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "recip_forces")
    recip_forces.launches += 1
    return f


recip_forces.launches = 0


class _FusedReciprocal(torch.autograd.Function):
    """Energy by B4 forward, position gradient by B5 backward (the JAX
    ``custom_vjp`` pair ``_fused_fwd`` / ``_fused_bwd``)."""

    @staticmethod
    def forward(ctx, pos, box, charges, beta, kmax, ts):
        posp, qp, kvec, w, c0, _, _, _ = _prep(pos, box, charges, beta,
                                               kmax, ts)
        s_re, s_im = structure_factor(posp, qp, kvec, kmax,
                                      box.to(torch.float32))
        ctx.save_for_backward(pos, box, charges, s_re, s_im)
        ctx.params = (beta, kmax, ts)
        return c0 * torch.sum(w * (s_re * s_re + s_im * s_im))

    @staticmethod
    def backward(ctx, g):
        pos, box, charges, s_re, s_im = ctx.saved_tensors
        beta, kmax, ts = ctx.params
        posp, qp, kvec, w, c0, _, _, _ = _prep(pos, box, charges, beta,
                                               kmax, ts)
        # dE/dtheta_ik = 2 c0 w_k (S_im cos - S_re sin) q_i
        ab = torch.stack([2.0 * c0 * w * s_im, 2.0 * c0 * w * s_re])
        dpos = -recip_forces(posp, qp, kvec, ab.contiguous(), kmax,
                             box.to(torch.float32))[:pos.shape[0]]
        return (g * dpos, torch.zeros_like(box), torch.zeros_like(charges),
                None, None, None)


def reciprocal_energy_fused(pos, box, charges, beta, kmax, ts: int = 256):
    """Exact k-space Ewald energy through kernels B4/B5; matches
    ``ewald.reciprocal_energy`` to float32 rounding.  ``torch.autograd``
    with respect to ``pos`` runs B5; the box and charge gradients are zero
    by contract."""
    charges = torch.as_tensor(charges, dtype=torch.float32, device=pos.device)
    return _FusedReciprocal.apply(pos, box, charges, float(beta),
                                  tuple(int(k) for k in kmax), int(ts))
