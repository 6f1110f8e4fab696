"""Makes ``benchmark/data/clpol_im21_start.npz``, the full-size start of the
configuration ``clpol_im21``: positions (float32, every site) and box
(nm), at the configuration's density.

The layout's lattice start (``start: "lattice"``, at
``lattice_density_g_cm3``) is run under the cell's own wiring, TGNH at the
configuration's temperature, for ``--stage-steps`` steps; then the box is
made ``--factor`` shorter, each ion moved with its centre of mass (whole,
unwrapped by its first site), and run again, stage by stage, until the box
holds the configuration's density, where it runs ``--equil-steps`` more.
Each stage is a new ``Context`` on the stage's box, the velocities carried
over.  The port does the dynamics; the script only moves the ions and
writes the file.

    python3 benchmark/data/make_clpol_im21_start.py [--seed 2147483647] \\
        [--device cuda] [--out benchmark/data/clpol_im21_start.npz]

``--small`` runs at the configuration's small size (the CPU's rehearsal)
and writes nowhere unless ``--out`` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.layouts import clpol_im21 as layout  # noqa: E402
from benchmark.wirings import clpol_im21 as wiring  # noqa: E402

BOLTZ = 8.31446261815324e-3


def compress(pos, box, t, factor):
    """``pos`` with each ion unwrapped by its first site and moved with its
    centre of mass as the box shrinks by ``factor``."""
    out = pos.copy()
    m = t["masses"]
    for o, n in t["ion_sites"].tolist():
        d = pos[o:o + n] - pos[o]
        d -= box * np.round(d / box)
        x = pos[o] + d
        com = np.sum(m[o:o + n, None] * x, 0) / np.sum(m[o:o + n])
        out[o:o + n] = x + (factor - 1.0) * com
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2147483647)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--stage-steps", type=int, default=300)
    ap.add_argument("--equil-steps", type=int, default=20000)
    ap.add_argument("--factor", type=float, default=0.98)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "clpol_im21.json")) as fh:
        cfg = json.load(fh)
    if args.small:
        cfg.update(cfg["small"])
    out = args.out or (None if args.small else os.path.join(
        ROOT, cfg["start"]))
    device = torch.device(args.device)
    t = layout.tables(dict(cfg, start="lattice"), args.seed)
    target = layout.box_edge(cfg, cfg["density_g_cm3"])
    edge = float(t["box"][0])
    pos = t["positions"].astype(np.float64)
    vel = t["velocities"]
    traffic = dict(recip="exact", segment_steps=100)
    t0, stage, steps_done = time.time(), 0, 0
    while True:
        final = abs(edge - target) < 1e-9
        steps = args.equil_steps if final else args.stage_steps
        ctx, _ = wiring.build_context(
            dict(t, positions=pos.astype(np.float32), box=np.full(3, edge),
                 velocities=vel), traffic, device)
        s0 = time.time()
        ctx.step(steps)
        st = ctx.state
        pos = (st.pos.double() + st.pos_err.double()).cpu().numpy()
        vel = st.vel.cpu().numpy()
        steps_done += steps
        if not (np.isfinite(pos).all() and np.isfinite(vel).all()):
            raise SystemExit(f"stage {stage}: the state is not finite")
        temp = float(np.sum(t["masses"][:, None] * vel.astype(np.float64)
                            ** 2) / (3 * pos.shape[0] * BOLTZ))
        print(f"[start] stage {stage}: edge {edge:.5f} nm, {steps} steps in "
              f"{time.time() - s0:.1f} s, mean kinetic temperature "
              f"{temp:.1f} K", file=sys.stderr, flush=True)
        del ctx
        if final:
            break
        new_edge = max(target, edge * args.factor)
        pos = compress(pos, edge, t, new_edge / edge)
        edge = new_edge
        stage += 1
    box = np.full(3, edge)
    # each ion put back into the box by its first site
    for o, n in t["ion_sites"].tolist():
        pos[o:o + n] -= box * np.floor(pos[o] / box)
    summary = dict(seed=args.seed, stages=stage, steps=steps_done,
                   ps=steps_done * cfg["integrator"]["dt_ps"], edge_nm=edge,
                   seconds=time.time() - t0,
                   device=(torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"), out=out)
    if out:
        np.savez_compressed(out, positions=pos.astype(np.float32), box=box)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
