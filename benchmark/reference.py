"""Plain reference of the port's timed path, from a cell's tables, in plain
PyTorch, written from the physics and from the reference plugin's
published algorithm, not from the port: it imports nothing of the port
and takes nothing the port derived (Ewald beta and the reciprocal's
lattice or grid, the pair lists, the virtual sites' positions, the
thermostat's degrees of freedom and chain masses are worked out here).
A configuration's reference (``benchmark/references/<name>.py``) builds on
it.

Forces: LJ 12-6 (geometric sigma and epsilon, truncated at the cutoff)
and Ewald direct space (exact erfc) over all pairs within the cutoff under
the minimum image, swept in dense row blocks; the Ewald correction of
every excluded pair; the reciprocal sum of the traffic's route
(``benchmark/routes/<recip>.py``) and the self and neutralising terms;
the isotropic Drude springs.  Virtual sites are placed as the average of
their parents, and their forces go back to the parents by the same
weights.

The step (``step``) is the plugin's middle scheme with its temperature-
grouped Nose-Hoover thermostat (TGNH): the centre-of-mass motion removed,
a full kick, RATTLE, the thermostat, the drift, SHAKE (the constrained
displacement corrects the velocity) and the Drude hard wall.  It starts
from the port's State, chain variables included: the chains are the
port's state, which no independent run could reproduce.

``dtype=torch.float64`` is the reference.  The control is the same code in
float32 with ``control=True``, under which the route rounds what its own
precision below float32 would (TF32 products on the exact-k route, bf16
operands on the PME route).
"""
from __future__ import annotations

import importlib
import math

import numpy as np
import torch

ONE_4PI_EPS0 = 138.935456        # kJ nm / (mol e^2)
BOLTZ = 8.31446261815324e-3      # kJ / (mol K)
SQRT_PI = math.sqrt(math.pi)


def tf32(x):
    """float32 ``x`` rounded to nearest (ties to even) at TF32's 10-bit
    mantissa."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def ewald_parameters(r_cutoff, tolerance, box):
    """beta and per-axis kmax of OpenMM's Ewald error estimate."""
    beta = math.sqrt(-math.log(2.0 * tolerance)) / r_cutoff

    def kmax(length):
        k = 1
        while k < 1000 and k * math.sqrt(length * beta) / 20.0 * math.exp(
                -(math.pi * k / (length * beta)) ** 2) >= tolerance:
            k += 1
        return k
    return beta, tuple(kmax(float(length)) for length in box)


def colours(pairs, n):
    """Rounds of the constraints ``pairs`` in which no two share an atom
    (a Gauss-Seidel sweep updates a round at once), as index arrays."""
    left = list(range(pairs.shape[0]))
    rounds = []
    while left:
        used = np.zeros(n, bool)
        this, rest = [], []
        for k in left:
            i, j = pairs[k]
            if used[i] or used[j]:
                rest.append(k)
            else:
                used[i] = used[j] = True
                this.append(k)
        rounds.append(np.asarray(this, np.int64))
        left = rest
    return rounds


class Reference:
    def __init__(self, t, traffic, device, dtype=torch.float64,
                 control=False, rows=256):
        self.dtype, self.device, self.control = dtype, device, control
        self.rows = rows
        f = dict(dtype=dtype, device=device)
        i64 = dict(dtype=torch.int64, device=device)
        n = t["masses"].shape[0]
        self.n = n
        m = np.asarray(t["masses"], np.float64)
        self.masses = torch.as_tensor(m, **f)
        self.massive = self.masses > 0
        self.inv_m = torch.as_tensor(np.where(m > 0, 1.0 / np.where(
            m > 0, m, 1.0), 0.0), **f)
        self.q = torch.as_tensor(t["charges"], **f)
        self.box = torch.as_tensor(t["box"], **f)
        self.rc = float(t["cutoff"])
        # a pair closer to the cutoff than this may fall on either side of
        # it in a float32 evaluation: 8 float32 ulps of the longest box
        # edge, the rounding of a coordinate difference
        edge = float(np.max(t["box"]))
        self.cutoff_band = 8.0 * 2.0 ** (math.floor(math.log2(edge)) - 23)
        self.beta = ewald_parameters(self.rc, t["ewald_tolerance"],
                                     t["box"])[0]
        # LJ pair tables by type: 4 eps_ij and sigma_ij^2
        sig, eps = np.asarray(t["lj_sigma"]), np.asarray(t["lj_epsilon"])
        nt = sig.shape[0]
        self.nt = nt
        self.eps4 = torch.as_tensor(4.0 * np.sqrt(np.outer(eps, eps)),
                                    **f).reshape(-1)
        self.sig2 = torch.as_tensor(np.outer(sig, sig), **f).reshape(-1)
        self.ty = torch.as_tensor(t["lj_type"], **i64)
        exc = np.sort(np.asarray(t["exclusions"], np.int64).reshape(-1, 2), 1)
        self.exc = torch.as_tensor(exc, **i64)
        both = np.concatenate([exc, exc[:, ::-1]])
        both = both[np.argsort(both[:, 0], kind="stable")]
        self.exc_rows = torch.as_tensor(both, **i64)
        self.exc_ptr = np.searchsorted(both[:, 0], np.arange(n + 1))
        # Drude springs: k = q^2 / (4 pi eps0 alpha)
        dr = np.asarray(t["drudes"], np.int64).reshape(-1, 2)
        self.drudes = torch.as_tensor(dr, **i64)
        self.drude_k = torch.as_tensor(
            ONE_4PI_EPS0 * np.asarray(t["drude_charge"]) ** 2
            / np.asarray(t["drude_alpha"]), **f)
        # virtual sites: weighted averages of their parents
        self.vsites = torch.as_tensor(t["vsites"], **i64)
        self.vparents = torch.as_tensor(t["vsite_parents"], **i64)
        self.vweights = torch.as_tensor(t["vsite_weights"], **f)
        # constraints, in rounds of the Gauss-Seidel sweeps
        cons = np.asarray(t["constraints"], np.int64).reshape(-1, 2)
        self.cons = torch.as_tensor(cons, **i64)
        self.cons_d2 = torch.as_tensor(t["constraint_nm"], **f) ** 2
        self.rounds = [torch.as_tensor(r, **i64) for r in colours(cons, n)]
        self._thermostat_tables(t)
        self.recip = importlib.import_module(
            "benchmark.routes." + traffic["recip"]).Reciprocal(self, t)

    # ------------------------------------------------------------ helpers
    def mi(self, d):
        return d - self.box * torch.round(d / self.box)

    # ------------------------------------------------------------- forces
    def _excluded_block(self, s, e):
        rows = self.exc_rows[self.exc_ptr[s]:self.exc_ptr[e]]
        mask = torch.zeros((e - s, self.n), dtype=torch.bool,
                           device=self.device)
        mask[rows[:, 0] - s, rows[:, 1]] = True
        mask[torch.arange(e - s, device=self.device),
             torch.arange(s, e, device=self.device)] = True
        return mask

    def direct(self, pos):
        """LJ and Ewald direct-space forces and energies of every pair
        within the cutoff that is not excluded.  ``self.band`` gets, for
        each atom, the summed force of its pairs within ``cutoff_band`` of
        the cutoff, which a float32 evaluation may count or not."""
        n, rc2, beta = self.n, self.rc * self.rc, self.beta
        f_out = torch.zeros_like(pos)
        self.band = torch.zeros(n, dtype=pos.dtype, device=pos.device)
        e_lj = e_coul = 0.0
        for s in range(0, n, self.rows):
            e = min(n, s + self.rows)
            d = self.mi(pos[s:e, None, :] - pos[None, :, :])
            r2 = torch.sum(d * d, -1)
            live = (r2 < rc2) & ~self._excluded_block(s, e)
            r2s = torch.where(live, r2, torch.ones_like(r2))
            r = torch.sqrt(r2s)
            qq = ONE_4PI_EPS0 * self.q[s:e, None] * self.q[None, :]
            br = beta * r
            erfc = torch.special.erfc(br)
            ec = qq * erfc / r
            fc = (ec + qq * 2.0 * beta / SQRT_PI * torch.exp(-br * br)) / r2s
            pair_t = self.ty[s:e, None] * self.nt + self.ty[None, :]
            sr6 = (self.sig2[pair_t] / r2s) ** 3
            eps4 = self.eps4[pair_t]
            el = eps4 * (sr6 * sr6 - sr6)
            fl = eps4 * (12.0 * sr6 * sr6 - 6.0 * sr6) / r2s
            zero = torch.zeros_like(r2)
            fs = torch.where(live, fc + fl, zero)
            f_out[s:e] = torch.sum(fs[..., None] * d, 1)
            edge = live & (torch.abs(r - self.rc) < self.cutoff_band)
            self.band[s:e] = torch.sum(torch.where(
                edge, torch.abs(fs) * r, zero), 1)
            e_lj = e_lj + 0.5 * torch.sum(torch.where(live, el, zero))
            e_coul = e_coul + 0.5 * torch.sum(torch.where(live, ec, zero))
        return f_out, {"lj": e_lj, "coul_direct": e_coul}

    def excluded(self, pos):
        """The Ewald correction -qq erf(beta r)/r of every excluded pair,
        at any distance (a series below beta r = 1e-3)."""
        i, j = self.exc[:, 0], self.exc[:, 1]
        d = self.mi(pos[i] - pos[j])
        r = torch.sqrt(torch.sum(d * d, -1))
        qq = ONE_4PI_EPS0 * self.q[i] * self.q[j]
        x = self.beta * r
        small = x < 1e-3
        rs = torch.where(small, torch.ones_like(r), r)
        xs = self.beta * rs
        e = torch.where(small, -qq * 2.0 * self.beta / SQRT_PI
                        * (1.0 - x * x / 3.0),
                        -qq * torch.special.erf(xs) / rs)
        fs = torch.where(
            small, qq * 2.0 / SQRT_PI * self.beta ** 3
            * (-2.0 / 3.0 + 0.4 * x * x),
            qq * (2.0 * self.beta / SQRT_PI * torch.exp(-xs * xs) * rs
                  - torch.special.erf(xs)) / rs ** 3)
        f = fs[:, None] * d
        out = torch.zeros_like(pos)
        out.index_add_(0, i, f)
        out.index_add_(0, j, -f)
        return out, {"coul_excl_corr": torch.sum(e)}

    def self_energy(self):
        """The Ewald self term and the neutralising background's."""
        vol = self.box[0] * self.box[1] * self.box[2]
        self_e = -ONE_4PI_EPS0 * self.beta / SQRT_PI * torch.sum(self.q ** 2)
        back = (-ONE_4PI_EPS0 * math.pi / (2.0 * self.beta ** 2 * vol)
                * torch.sum(self.q) ** 2)
        return self_e + back

    def bonded_energy(self, pos):
        """The Drude springs, a function whose force autograd takes."""
        d, p = self.drudes[:, 0], self.drudes[:, 1]
        dd = self.mi(pos[d] - pos[p])
        return {"drude": 0.5 * torch.sum(self.drude_k
                                         * torch.sum(dd * dd, -1))}

    def place_vsites(self, pos):
        site = torch.einsum("vp,vpx->vx", self.vweights, pos[self.vparents])
        return pos.index_put((self.vsites,), site)

    def forces(self, pos, box=None):
        """(forces (N, 3), energies by term) at ``pos``, virtual sites placed
        here and their forces moved to their parents, in ``box`` where given
        and else in the tables' box."""
        if box is not None:
            self.box = torch.as_tensor(box, dtype=self.dtype,
                                       device=self.device)
        pos = self.place_vsites(pos)
        f_dir, e = self.direct(pos)
        f_exc, e2 = self.excluded(pos)
        f_rec, e3 = self.recip(pos)
        e.update(e2)
        e.update(e3)
        e["coul_self"] = self.self_energy()
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            eb = self.bonded_energy(p)
            (g,) = torch.autograd.grad(sum(eb.values()), p)
        e.update({k: v.detach() for k, v in eb.items()})
        f = f_dir + f_exc + f_rec - g
        f_site = f[self.vsites]
        f = f.index_put((self.vsites,), torch.zeros_like(f_site))
        f.index_add_(0, self.vparents.reshape(-1), (
            self.vweights[:, :, None] * f_site[:, None, :]).reshape(-1, 3))
        return f, e

    # --------------------------------------------------------------- step
    def _thermostat_tables(self, t):
        """The three temperature groups of TGNH: the molecules' centres of
        mass, the motion within the molecules (atoms outside Drude pairs
        and the pairs' centres of mass, relative to their molecule), and
        the Drude pairs' relative motion; their degrees of freedom and
        chain masses (Q_1 = dof kT / w^2, Q_i = kT / w^2)."""
        c = t["integrator"]
        self.dt = float(c["dt_ps"])
        i64 = dict(dtype=torch.int64, device=self.device)
        mol = np.asarray(t["molecule"], np.int64)
        self.mol = torch.as_tensor(mol, **i64)
        self.n_mol = int(mol.max()) + 1
        self.mol_mass = torch.zeros(self.n_mol, dtype=self.dtype,
                                    device=self.device).index_add_(
            0, self.mol, self.masses)
        n_pairs = self.drudes.shape[0]
        in_pair = torch.zeros(self.n, dtype=torch.bool, device=self.device)
        in_pair[self.drudes.reshape(-1)] = True
        self.normal = self.massive & ~in_pair
        n_massive = int(self.massive.sum())
        dof = np.array([3.0 * n_massive - 3.0 * self.n_mol - 3.0 * n_pairs
                        - self.cons.shape[0],
                        3.0 * self.n_mol - 3.0,      # less the CM motion
                        3.0 * n_pairs])
        temps = np.array([c["temperature"], c["temperature"],
                          c["drude_temperature"]])
        freq = np.array([c["frequency"], c["frequency"],
                         c["drude_frequency"]])
        kt = BOLTZ * temps
        chains = int(c["num_nh_chains"])
        q = np.repeat((kt / freq ** 2)[:, None], chains, 1)
        q[:, 0] *= dof
        f = dict(dtype=self.dtype, device=self.device)
        self.dof = torch.as_tensor(dof, **f)
        self.kt = torch.as_tensor(kt, **f)
        self.nkt = torch.as_tensor(dof * kt, **f)
        self.q_chain = torch.as_tensor(q, **f)
        self.chains = chains
        self.loops = int(c["loops_per_step"])
        self.dmax = float(c["max_drude_distance_nm"])
        self.t_drude = float(c["drude_temperature"])

    def groups(self, vel):
        """(V per molecule, u per atom (the motion within its molecule),
        pair centre velocity relative to the molecule, pair relative
        velocity, 2 KE of the three groups)."""
        m = self.masses[:, None]
        mom = torch.zeros((self.n_mol, 3), **self._f()).index_add_(
            0, self.mol, m * vel)
        v_mol = mom / self.mol_mass[:, None]
        u = vel - v_mol[self.mol]
        d, p = self.drudes[:, 0], self.drudes[:, 1]
        md, mp = m[d], m[p]
        u_cm = (md * u[d] + mp * u[p]) / (md + mp)
        u_rel = u[d] - u[p]
        ke_atom = (torch.sum(torch.where(self.normal[:, None], m * u * u, 0.0))
                   + torch.sum((md + mp) * u_cm * u_cm))
        ke_com = torch.sum(self.mol_mass[:, None] * v_mol * v_mol)
        ke_drude = torch.sum(md * mp / (md + mp) * u_rel * u_rel)
        return v_mol, u, u_cm, u_rel, torch.stack([ke_atom, ke_com,
                                                   ke_drude])

    def _f(self):
        return dict(dtype=self.dtype, device=self.device)

    def drude_temperature(self, vel):
        """The Drude pairs' relative kinetic temperature, K."""
        ke2 = self.groups(vel.to(self.dtype))[-1]
        return float(ke2[2] / (BOLTZ * self.dof[2]))

    def _chains(self, ke2, eta_dot, eta_dotdot):
        """One thermostat interval of the three Nose-Hoover chains
        (VVIntegrator::propagateNHChain): the velocity scale of each group
        and the chains' new rates."""
        dt2 = self.dt / self.loops / 2.0
        dt4, dt8 = dt2 / 2.0, dt2 / 4.0
        q = self.q_chain
        ed = [eta_dot[:, i] for i in range(self.chains + 1)]
        edd = [eta_dotdot[:, i] for i in range(self.chains)]
        scale = torch.ones_like(ke2)
        edd[0] = (ke2 - self.nkt) / q[:, 0]
        for _ in range(self.loops):
            for i in range(self.chains - 1, -1, -1):
                x = torch.exp(-dt8 * ed[i + 1])
                ed[i] = (ed[i] * x + edd[i] * dt4) * x
            scale = scale * torch.exp(-dt2 * ed[0])
            edd[0] = (ke2 * scale * scale - self.nkt) / q[:, 0]
            # the plugin reuses the last factor of the downward sweep
            ed[0] = (ed[0] * x + edd[0] * dt4) * x
            for i in range(1, self.chains):
                x = torch.exp(-dt8 * ed[i + 1])
                edd[i] = (q[:, i - 1] * ed[i - 1] ** 2 - self.kt) / q[:, i]
                ed[i] = (ed[i] * x + edd[i] * dt4) * x
        return scale

    def thermostat(self, vel, eta_dot, eta_dotdot):
        v_mol, u, u_cm, u_rel, ke2 = self.groups(vel)
        s_atom, s_com, s_drude = self._chains(ke2, eta_dot, eta_dotdot)
        m = self.masses[:, None]
        out = v_mol[self.mol] * s_com + u * s_atom
        d, p = self.drudes[:, 0], self.drudes[:, 1]
        md, mp = m[d], m[p]
        base = v_mol[self.mol[d]] * s_com + u_cm * s_atom
        out[d] = base + s_drude * u_rel * mp / (md + mp)
        out[p] = base - s_drude * u_rel * md / (md + mp)
        return torch.where(self.massive[:, None], out, vel)

    def _bonds(self, pos, k):
        c = self.cons[k]
        return c[:, 0], c[:, 1], self.mi(pos[c[:, 0]] - pos[c[:, 1]])

    def rattle(self, pos, vel, sweeps=400, tol=1e-12):
        """Velocities with no component along any constraint
        (Gauss-Seidel sweeps; the residual |(v_i - v_j) . r| / |r|^2 is read
        on the host every 8 sweeps)."""
        vel = vel.clone()
        for sweep in range(sweeps):
            worst = torch.zeros((), **self._f())
            for k in self.rounds:
                i, j, r = self._bonds(pos, k)
                r2 = torch.sum(r * r, -1)
                rv = torch.sum((vel[i] - vel[j]) * r, -1)
                g = rv / (r2 * (self.inv_m[i] + self.inv_m[j]))
                vel[i] -= (g * self.inv_m[i])[:, None] * r
                vel[j] += (g * self.inv_m[j])[:, None] * r
                worst = torch.maximum(worst, torch.max(torch.abs(rv) / r2))
            if sweep % 8 == 7 and float(worst) < tol:
                break
        return vel

    def shake(self, ref, pos, sweeps=400, tol=1e-13):
        """``pos`` moved along the bonds of ``ref`` until every constraint
        holds (Gauss-Seidel sweeps; the relative residual is read on the
        host every 8 sweeps)."""
        pos = pos.clone()
        for sweep in range(sweeps):
            worst = torch.zeros((), **self._f())
            for k in self.rounds:
                i, j, s = self._bonds(pos, k)
                r0 = self._bonds(ref, k)[2]
                d2 = self.cons_d2[k]
                diff = d2 - torch.sum(s * s, -1)
                g = diff / (2.0 * torch.sum(s * r0, -1)
                            * (self.inv_m[i] + self.inv_m[j]))
                pos[i] += (g * self.inv_m[i])[:, None] * r0
                pos[j] -= (g * self.inv_m[j])[:, None] * r0
                worst = torch.maximum(worst, torch.max(torch.abs(diff) / d2))
            if sweep % 8 == 7 and float(worst) < tol:
                break
        return pos

    def hard_wall(self, pos, vel):
        """Every Drude pair beyond the wall's distance put back inside it,
        its relative velocity along the bond reversed at the Drude
        temperature's thermal speed (the plugin's applyHardWall)."""
        d, p = self.drudes[:, 0], self.drudes[:, 1]
        md, mp = self.masses[d, None], self.masses[p, None]
        mt = md + mp
        delta = pos[d] - pos[p]
        r = torch.sqrt(torch.sum(delta * delta, -1, keepdim=True))
        out = r[:, 0] > self.dmax
        if not bool(out.any()):
            return pos, vel
        n = delta / r
        over = r - self.dmax
        a_d = torch.sum(vel[d] * n, -1, keepdim=True)
        a_p = torch.sum(vel[p] * n, -1, keepdim=True)
        v_cm = (md * a_d + mp * a_p) / mt
        c_d, c_p = a_d - v_cm, a_p - v_cm
        t_back = torch.clamp(over / torch.abs(c_d - c_p), max=self.dt)
        v_bond = math.sqrt(BOLTZ * self.t_drude) / torch.sqrt(md)
        new_d = -torch.sign(c_d) * v_bond * mp / mt
        new_p = -torch.sign(c_p) * v_bond * md / mt
        pos_d = pos[d] + n * (-over * mp / mt + t_back * new_d)
        pos_p = pos[p] + n * (over * md / mt + t_back * new_p)
        vel_d = vel[d] - n * a_d + n * (new_d + v_cm)
        vel_p = vel[p] - n * a_p + n * (new_p + v_cm)
        pos, vel = pos.clone(), vel.clone()
        keep = out[:, None]
        pos[d] = torch.where(keep, pos_d, pos[d])
        pos[p] = torch.where(keep, pos_p, pos[p])
        vel[d] = torch.where(keep, vel_d, vel[d])
        vel[p] = torch.where(keep, vel_p, vel[p])
        return pos, vel

    def step(self, s, forces):
        """One middle-scheme step from the State ``s`` (float32 ``pos``,
        its carried rounding ``pos_err``, ``vel``, the chains' ``eta_dot``
        and ``eta_dotdot``), given the forces at ``pos``: the new
        (positions, velocities)."""
        dt = self.dt
        pos32 = s["pos"].to(self.dtype)
        x = pos32 + s["pos_err"].to(self.dtype)
        vel = s["vel"].to(self.dtype)
        m = self.masses[:, None]
        v_cm = torch.sum(m * vel, 0) / torch.sum(self.masses)
        vel = torch.where(self.massive[:, None], vel - v_cm, vel)
        vel = vel + dt * self.inv_m[:, None] * forces
        vel = self.rattle(pos32, vel)
        half = 0.5 * dt * vel
        vel = self.thermostat(vel, s["eta_dot"].to(self.dtype),
                              s["eta_dotdot"].to(self.dtype))
        new = x + half + 0.5 * dt * vel
        con = self.shake(pos32, new)
        vel = vel + (con - new) / dt
        return self.hard_wall(con, vel)
