"""Holonomic distance constraints: SHAKE (positions) and RATTLE
(velocities), solved exactly per constraint cluster (counterpart of
``openmm_velocityverlet_tpu/ops/constraints.py``).

Constraints partition into small connected clusters (CH stars, rigid-water
triangles, K <= 4), bucketed at build time by topology pattern so every
slot index inside a bucket is a Python constant; the RATTLE system is linear
and the SHAKE system is solved by a fixed number of Newton iterations, both
through closed-form Cramer rules on component tensors.  The cluster path
makes no host synchronisation.  Clusters larger than K_CAP fall back to the
iterative pair path, whose tolerance loop reads the residual on the host
once per iteration.

``constraint_clusters`` runs the cluster path: on a CUDA tensor it launches
the kernel of ``csrc/constraint_clusters.cu`` once a bucket, each thread
solving one cluster in registers; on a CPU tensor it takes the plain torch
versions ``solve_position_clusters`` / ``solve_velocity_clusters``, which
compute the same rows from the same tables.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import kernels, trace
from ..system import resolve_device
from ..utils.pbc import minimum_image

K_CAP = 4


@dataclasses.dataclass
class ConstraintData:
    pairs: torch.Tensor          # (C,2) int64
    dist: torch.Tensor           # (C,)
    inv_mass_sum: torch.Tensor   # (C,) 1/mi + 1/mj
    atom_cons: torch.Tensor      # (N,A) int64 incident constraint ids, -1
    atom_sign: torch.Tensor      # (N,A) +1 if atom is pair[...,0], else -1
    # bucketed cluster solver: per bucket the static pattern ``key`` (and
    # its slots as the C int array ``slots`` the kernel's launch takes) and
    # the (K,K,ncl) coupling weights, (K,ncl) squared distances, (A,ncl)
    # inverse masses and (A,ncl) int32 global rows ``gid`` as tensors
    buckets: tuple = ()
    atom_slot: torch.Tensor = None        # (N,) int64
    atom_in_cluster: torch.Tensor = None  # (N,) bool
    gid_all: torch.Tensor = None          # (F,) int64
    use_clusters: bool = False
    tolerance: float = 1e-5
    max_iterations: int = 150
    newton_iters: int = 3

    @property
    def n_constraints(self):
        return self.pairs.shape[0]


def build_constraint_data(pairs, dists, inv_masses, tolerance=1e-5,
                          max_iterations=150,
                          device="cuda") -> ConstraintData:
    device = resolve_device(device)
    pairs = np.asarray(pairs, np.int32).reshape(-1, 2)
    dists = np.asarray(dists, np.float32).reshape(-1)
    n = len(inv_masses)
    c = pairs.shape[0]
    ims = np.asarray(inv_masses, np.float32)
    incid = [[] for _ in range(n)]
    signs = [[] for _ in range(n)]
    for ci, (a, b) in enumerate(pairs):
        incid[a].append(ci)
        signs[a].append(1.0)
        incid[b].append(ci)
        signs[b].append(-1.0)
    a_max = max((len(x) for x in incid), default=0)
    a_max = max(a_max, 1)
    atom_cons = np.full((n, a_max), -1, np.int32)
    atom_sign = np.zeros((n, a_max), np.float32)
    for i in range(n):
        for k, (ci, s) in enumerate(zip(incid[i], signs[i])):
            atom_cons[i, k] = ci
            atom_sign[i, k] = s
    inv_mass_sum = (ims[pairs[:, 0]] + ims[pairs[:, 1]] if c
                    else np.zeros((0,), np.float32))

    # ---- cluster decomposition (union-find over shared atoms) ----
    parent = list(range(c))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    atom_last = {}
    for ci, (a, b) in enumerate(pairs):
        for at in (int(a), int(b)):
            if at in atom_last:
                ra, rb = find(atom_last[at]), find(ci)
                if ra != rb:
                    parent[rb] = ra
            atom_last[at] = ci
    clusters = {}
    for ci in range(c):
        clusters.setdefault(find(ci), []).append(ci)
    use_clusters = c > 0 and all(len(v) <= K_CAP for v in clusters.values())

    buckets = ()
    atom_slot = np.zeros((n,), np.int32)
    atom_in_cluster = np.zeros((n,), bool)
    if use_clusters:
        # canonicalize each cluster: atoms ordered by (degree desc, first
        # appearance); constraints ordered by their local slot pair.  The
        # resulting (slot-pair tuple) is the bucket key, so every bucket has
        # compile-time-constant slot indices.
        grouped = {}
        for members in clusters.values():
            deg = {}
            for m in members:
                for a in (int(pairs[m, 0]), int(pairs[m, 1])):
                    deg[a] = deg.get(a, 0) + 1
            order = {}
            for m in members:
                for a in (int(pairs[m, 0]), int(pairs[m, 1])):
                    if a not in order:
                        order[a] = len(order)
            atoms = sorted(deg, key=lambda a: (-deg[a], order[a]))
            slot = {a: s for s, a in enumerate(atoms)}
            cons = []
            for m in members:
                ai, bi = slot[int(pairs[m, 0])], slot[int(pairs[m, 1])]
                # keep the pair orientation (sign convention follows it)
                cons.append((ai, bi, m))
            cons.sort(key=lambda t: (t[0], t[1]))
            key = tuple((ai, bi) for ai, bi, _ in cons)
            grouped.setdefault(key, []).append(
                (atoms, [m for _, _, m in cons]))

        bucket_list = []
        flat_base = 0
        for key in sorted(grouped):
            entries = grouped[key]
            ncl = len(entries)
            K = len(key)
            A = max(max(ai, bi) for ai, bi in key) + 1
            gid = np.zeros((A, ncl), np.int32)      # global atom per slot
            d2 = np.zeros((K, ncl), np.float32)
            cid = np.zeros((K, ncl), np.int32)
            for r, (atoms, members) in enumerate(entries):
                for a_local, a in enumerate(atoms):
                    gid[a_local, r] = a
                    atom_slot[a] = flat_base + a_local * ncl + r
                    atom_in_cluster[a] = True
                for k, m in enumerate(members):
                    d2[k, r] = float(dists[m]) ** 2
                    cid[k, r] = m
            invm = ims[gid]                          # (A,ncl)
            # coupling weights w[k,l] = sum over shared atoms of
            # sign_k(a) sign_l(a) / m_a — static pattern, per-cluster masses
            w = np.zeros((K, K, ncl), np.float32)
            for k, (ak, bk) in enumerate(key):
                for l, (al, bl) in enumerate(key):
                    acc = np.zeros(ncl, np.float32)
                    for sa, sk in ((ak, 1.0), (bk, -1.0)):
                        for sb, sl in ((al, 1.0), (bl, -1.0)):
                            if sa == sb:
                                acc += sk * sl * invm[sa]
                    w[k, l] = acc
            bucket_list.append(dict(
                key=key, K=K, A=A, ncl=ncl, gid=gid, d2=d2, w=w,
                invm=invm, cid=cid, flat_base=flat_base))
            flat_base += A * ncl
        buckets = tuple(bucket_list)

    gid_all = (np.concatenate([bk["gid"].reshape(-1) for bk in buckets])
               if buckets else np.zeros((0,), np.int32))

    def t(a, dtype=None):
        a = np.asarray(a)
        if dtype is None:
            dtype = np.int64 if np.issubdtype(a.dtype, np.integer) \
                else a.dtype
        return torch.as_tensor(a.astype(dtype), device=device)

    dev_buckets = tuple(
        dict(key=bk["key"], K=bk["K"], A=bk["A"], ncl=bk["ncl"],
             flat_base=bk["flat_base"], w=t(bk["w"]), d2=t(bk["d2"]),
             invm=t(bk["invm"]), gid=t(bk["gid"], np.int32),
             slots=_slots(bk["key"]))
        for bk in buckets)
    return ConstraintData(
        pairs=t(pairs), dist=t(dists), inv_mass_sum=t(inv_mass_sum),
        atom_cons=t(atom_cons), atom_sign=t(atom_sign),
        buckets=dev_buckets, atom_slot=t(atom_slot),
        atom_in_cluster=t(atom_in_cluster), gid_all=t(gid_all),
        use_clusters=bool(use_clusters), tolerance=tolerance,
        max_iterations=max_iterations)
# ------------------------------------------------------- component helpers
def _mi3(px, py, pz, box):
    return (px - box[0] * torch.round(px / box[0]),
            py - box[1] * torch.round(py / box[1]),
            pz - box[2] * torch.round(pz / box[2]))


def _solve(K, J, rhs):
    """Closed-form solve of the K x K systems; J[k][l] and rhs[k] are (ncl,)
    component arrays.  Cramer for K <= 3 (the real workloads)."""
    if K == 1:
        return [rhs[0] / J[0][0]]
    if K == 2:
        det = J[0][0] * J[1][1] - J[0][1] * J[1][0]
        inv = 1.0 / det
        return [(J[1][1] * rhs[0] - J[0][1] * rhs[1]) * inv,
                (J[0][0] * rhs[1] - J[1][0] * rhs[0]) * inv]
    if K == 3:
        c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1]
        c01 = J[1][2] * J[2][0] - J[1][0] * J[2][2]
        c02 = J[1][0] * J[2][1] - J[1][1] * J[2][0]
        det = J[0][0] * c00 + J[0][1] * c01 + J[0][2] * c02
        inv = 1.0 / det
        b0, b1, b2 = rhs
        x0 = (b0 * c00 + J[0][1] * (J[1][2] * b2 - J[2][2] * b1)
              + J[0][2] * (J[2][1] * b1 - J[1][1] * b2)) * inv
        x1 = (J[0][0] * (J[2][2] * b1 - J[1][2] * b2) + b0 * c01
              + J[0][2] * (J[1][0] * b2 - J[2][0] * b1)) * inv
        x2 = (J[0][0] * (J[1][1] * b2 - J[2][1] * b1)
              + J[0][1] * (J[2][0] * b1 - J[1][0] * b2) + b0 * c02) * inv
        return [x0, x1, x2]
    # K = 4: unrolled Gaussian elimination on component arrays (SPD Gram
    # matrix, no pivoting needed)
    M = [[J[k][l] for l in range(K)] for k in range(K)]
    b = list(rhs)
    for k in range(K):
        inv = 1.0 / M[k][k]
        for l in range(k + 1, K):
            f = M[l][k] * inv
            for m in range(k, K):
                M[l][m] = M[l][m] - f * M[k][m]
            b[l] = b[l] - f * b[k]
    x = [None] * K
    for k in reversed(range(K)):
        acc = b[k]
        for l in range(k + 1, K):
            acc = acc - M[k][l] * x[l]
        x[k] = acc / M[k][k]
    return x


def _writeback(target, cons, parts):
    """parts: per-bucket lists of per-slot (ncl,3) tensors in the flat_base
    layout; one (N,3) row gather replaces all scatters."""
    flat = torch.cat([torch.stack(slots, 0).reshape(-1, 3)
                      for slots in parts], dim=0)
    return torch.where(cons.atom_in_cluster[:, None], flat[cons.atom_slot],
                       target)


def _slot(arr, bk, a):
    base, ncl = bk["flat_base"], bk["ncl"]
    return arr[base + a * ncl: base + (a + 1) * ncl]


def solve_position_clusters(pos_ref, pos_new, box, cons: ConstraintData):
    """SHAKE via Newton on the per-cluster system sigma_c = |x_i-x_j|^2 - d^2
    with J_kk' = 2 (delta_k . ref_k') w_kk'; three iterations reach the
    float32 floor."""
    parts = []
    ref_all = pos_ref[cons.gid_all]
    new_all = pos_new[cons.gid_all]
    for bk in cons.buckets:
        K, A = bk["K"], bk["A"]
        w, d2, invm = bk["w"], bk["d2"], bk["invm"]
        key = bk["key"]
        refs = []
        for ak, al in key:
            dr = _slot(ref_all, bk, ak) - _slot(ref_all, bk, al)
            refs.append(_mi3(dr[:, 0], dr[:, 1], dr[:, 2], box))
        x = [_slot(new_all, bk, a) for a in range(A)]
        xc = [[x[a][:, 0], x[a][:, 1], x[a][:, 2]] for a in range(A)]
        for _ in range(cons.newton_iters):
            deltas = []
            sigma = []
            for k, (ak, al) in enumerate(key):
                dx, dy, dz = _mi3(xc[ak][0] - xc[al][0],
                                  xc[ak][1] - xc[al][1],
                                  xc[ak][2] - xc[al][2], box)
                deltas.append((dx, dy, dz))
                sigma.append(dx * dx + dy * dy + dz * dz - d2[k])
            J = [[2.0 * w[k][l] * (deltas[k][0] * refs[l][0]
                                   + deltas[k][1] * refs[l][1]
                                   + deltas[k][2] * refs[l][2])
                  for l in range(K)] for k in range(K)]
            g = _solve(K, J, sigma)
            for a in range(A):
                acc = None
                for k, (ak, al) in enumerate(key):
                    s = 1.0 if ak == a else (-1.0 if al == a else 0.0)
                    if s == 0.0:
                        continue
                    term = (s * g[k] * refs[k][0], s * g[k] * refs[k][1],
                            s * g[k] * refs[k][2])
                    acc = term if acc is None else (
                        acc[0] + term[0], acc[1] + term[1], acc[2] + term[2])
                if acc is not None:
                    xc[a][0] = xc[a][0] - invm[a] * acc[0]
                    xc[a][1] = xc[a][1] - invm[a] * acc[1]
                    xc[a][2] = xc[a][2] - invm[a] * acc[2]
        parts.append([torch.stack([xc[a][0], xc[a][1], xc[a][2]], -1)
                      for a in range(A)])
    return _writeback(pos_new, cons, parts)


def solve_velocity_clusters(pos, vel, box, cons: ConstraintData):
    """Exact RATTLE: one closed-form linear solve per cluster."""
    parts = []
    pos_all = pos[cons.gid_all]
    vel_all = vel[cons.gid_all]
    for bk in cons.buckets:
        K, A = bk["K"], bk["A"]
        w, invm = bk["w"], bk["invm"]
        key = bk["key"]
        vc = []
        for a in range(A):
            v = _slot(vel_all, bk, a)
            vc.append([v[:, 0], v[:, 1], v[:, 2]])
        refs = []
        rv = []
        for ak, al in key:
            dr = _slot(pos_all, bk, ak) - _slot(pos_all, bk, al)
            rx, ry, rz = _mi3(dr[:, 0], dr[:, 1], dr[:, 2], box)
            refs.append((rx, ry, rz))
            rv.append((vc[ak][0] - vc[al][0]) * rx
                      + (vc[ak][1] - vc[al][1]) * ry
                      + (vc[ak][2] - vc[al][2]) * rz)
        J = [[w[k][l] * (refs[k][0] * refs[l][0] + refs[k][1] * refs[l][1]
                         + refs[k][2] * refs[l][2])
              for l in range(K)] for k in range(K)]
        g = _solve(K, J, rv)
        for a in range(A):
            for k, (ak, al) in enumerate(key):
                s = 1.0 if ak == a else (-1.0 if al == a else 0.0)
                if s == 0.0:
                    continue
                vc[a][0] = vc[a][0] - invm[a] * s * g[k] * refs[k][0]
                vc[a][1] = vc[a][1] - invm[a] * s * g[k] * refs[k][1]
                vc[a][2] = vc[a][2] - invm[a] * s * g[k] * refs[k][2]
        parts.append([torch.stack([vc[a][0], vc[a][1], vc[a][2]], -1)
                      for a in range(A)])
    return _writeback(vel, cons, parts)


def _slots(key):
    """A bucket pattern's 2 K slots as the C int array the kernel's launch
    takes: the first slots of the K constraints, then their second slots."""
    return (ctypes.c_int * (2 * len(key)))(*[a for a, _ in key],
                                           *[b for _, b in key])


def _launcher():
    """The kernel library with its C signature declared (pointers and the
    stream as c_void_p, so ctypes never truncates them to 32 bits)."""
    lib = kernels.load("constraint_clusters")
    if lib.constraint_clusters_launch.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.constraint_clusters_launch.argtypes = [
            I, I, I, ctypes.POINTER(I), I, P, P, P, P, P, P, P, P, I, P]
        lib.constraint_clusters_launch.restype = I
        lib.constraint_clusters_error_string.argtypes = [I]
        lib.constraint_clusters_error_string.restype = ctypes.c_char_p
    return lib


def _check(t, name, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"constraint_clusters: {name} must be a contiguous {dtype} "
            f"tensor of shape {tuple(shape)} on {device}; got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


def constraint_clusters(ref, target, box, cons: ConstraintData, *,
                        velocities):
    """The cluster path: SHAKE (``velocities`` False: ``target`` the
    unconstrained positions, moved along the bonds of the
    constraint-satisfying ``ref``) or RATTLE (``velocities`` True:
    ``target`` the velocities, ``ref`` the positions); returns the
    constrained copy of ``target``.

    On a CUDA tensor this launches the kernel of
    ``csrc/constraint_clusters.cu`` once a bucket on the current stream into
    a copy of ``target``, and counts each launch in
    ``constraint_clusters.launches`` and in ``.shake_launches`` or
    ``.rattle_launches``; on a CPU tensor it runs
    ``solve_position_clusters`` / ``solve_velocity_clusters``.  There is no
    fallback: a CUDA call the kernel cannot take raises.  The buckets'
    tables are made once, by ``build_constraint_data``, all on one device
    with fixed dtypes and shapes; a call checks its own tensors, and that
    ``cons`` was built on their device for their number of rows, which
    also puts every ``gid`` in range."""
    dev = target.device
    if dev.type == "cpu":
        if velocities:
            return solve_velocity_clusters(ref, target, box, cons)
        return solve_position_clusters(ref, target, box, cons)
    if dev.type != "cuda":
        raise ValueError(f"constraint_clusters: unsupported device {dev}")
    n = target.shape[0]
    f32 = torch.float32
    _check(ref, "ref", f32, (n, 3), dev)
    _check(target, "target", f32, (n, 3), dev)
    _check(box, "box", f32, (3,), dev)
    built = cons.atom_in_cluster
    if built.device != dev or built.shape[0] != n:
        raise ValueError(
            f"constraint_clusters: the constraint data was built for "
            f"{built.shape[0]} atoms on {built.device}; got {n} rows on "
            f"{dev}")
    lib = _launcher()
    out = target.clone()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rattle = int(bool(velocities))
    for bk in cons.buckets:
        err = lib.constraint_clusters_launch(
            rattle, bk["K"], bk["A"], bk["slots"], bk["ncl"], ref.data_ptr(),
            target.data_ptr(), out.data_ptr(), bk["gid"].data_ptr(),
            bk["d2"].data_ptr(), bk["w"].data_ptr(), bk["invm"].data_ptr(),
            box.data_ptr(), cons.newton_iters, stream)
        if err != 0:
            raise RuntimeError(
                "constraint_clusters kernel launch failed: "
                + lib.constraint_clusters_error_string(err).decode())
        constraint_clusters.launches += 1
        if rattle:
            constraint_clusters.rattle_launches += 1
        else:
            constraint_clusters.shake_launches += 1
    return out


constraint_clusters.launches = 0
constraint_clusters.shake_launches = 0
constraint_clusters.rattle_launches = 0


def _apply_corrections(x, cons: ConstraintData, g, ref, inv_masses):
    """x_a += -inv_m_a * sum_{c incident} sign * g_c * ref_c  (gather form)."""
    cid = torch.clamp(cons.atom_cons, min=0)
    valid = (cons.atom_cons >= 0).to(x.dtype)
    contrib = (g[cid] * valid * cons.atom_sign)[..., None] * ref[cid]
    return x - inv_masses[:, None] * torch.sum(contrib, dim=1)


def apply_position_constraints(pos_ref, pos_new, box, cons: ConstraintData,
                               inv_masses):
    """SHAKE: move pos_new so constrained distances equal their targets,
    along the directions of the constraint-satisfying pos_ref."""
    with trace.span("step.shake"):
        if cons.n_constraints == 0:
            return pos_new
        if cons.use_clusters:
            return constraint_clusters(pos_ref, pos_new, box, cons,
                                       velocities=False)
        i, j = cons.pairs[:, 0], cons.pairs[:, 1]
        ref = minimum_image(pos_ref[i] - pos_ref[j], box)
        d2 = cons.dist * cons.dist
        pos = pos_new
        for _ in range(cons.max_iterations):
            delta = minimum_image(pos[i] - pos[j], box)
            r2 = torch.sum(delta * delta, -1)
            diff = r2 - d2
            denom = 2.0 * cons.inv_mass_sum * torch.sum(delta * ref, -1)
            denom = torch.where(torch.abs(denom) > 1e-12, denom,
                                torch.full_like(denom, 1e-12))
            pos = _apply_corrections(pos, cons, diff / denom, ref, inv_masses)
            # host sync: the residual decides whether to iterate again
            if float(torch.max(torch.abs(diff) / d2)) <= cons.tolerance:
                break
        return pos


def apply_velocity_constraints(pos, vel, box, cons: ConstraintData,
                               inv_masses):
    """RATTLE: project velocities so d/dt of each constrained distance is 0."""
    with trace.span("step.rattle"):
        if cons.n_constraints == 0:
            return vel
        if cons.use_clusters:
            return constraint_clusters(pos, vel, box, cons,
                                       velocities=True)
        i, j = cons.pairs[:, 0], cons.pairs[:, 1]
        ref = minimum_image(pos[i] - pos[j], box)
        d2 = torch.sum(ref * ref, -1)
        denom = cons.inv_mass_sum * d2
        scale = 1.0 / torch.where(denom > 1e-12, denom,
                                  torch.full_like(denom, 1e-12))
        for _ in range(cons.max_iterations):
            rv = torch.sum((vel[i] - vel[j]) * ref, -1)
            vel = _apply_corrections(vel, cons, rv * scale, ref, inv_masses)
            # host sync: relative velocity along the bond over its length
            err = float(torch.max(torch.abs(rv) / torch.clamp(d2, min=1e-12)))
            if err <= cons.tolerance:
                break
        return vel
