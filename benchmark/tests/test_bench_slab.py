"""The constant-voltage slab's layout on the CPU: its counts, lengths,
density and concentration, the electrodes' layers about the mirror planes,
and the image block's order, charges, positions and virtual sites.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark import run  # noqa: E402
from benchmark.layouts import edl_swm4_nacl  # noqa: E402


def test_slab_layout():
    cfg = run.load_json(run.HERE, "configs", "edl_swm4_nacl.json")
    t = edl_swm4_nacl.tables(cfg, 3)
    n_e, n_liq = 16 * 10 * 4 * 3 * 2, 2800 * 5 + 50 * 4
    assert t["masses"].shape[0] == n_e + 2 * n_liq == 32240
    assert t["electrode"].size == n_e and t["liquid"].size == n_liq
    # 16 x 10 rectangular cells of 0.142-nm bonds; the planes z = 0, Lz / 2
    lx, ly, lz = t["box"]
    assert (lx, ly) == pytest.approx((16 * 0.142 * np.sqrt(3), 10 * 0.426))
    assert t["mirror_nm"] == pytest.approx(lz / 2)
    pos = t["positions"].astype(np.float64)
    z_e = np.unique(np.round(pos[t["electrode"], 2], 4))
    h = 0.335
    want = [0.5 * h, 1.5 * h, 2.5 * h]
    assert z_e == pytest.approx(want + [lz / 2 - z for z in want[::-1]],
                                abs=1e-4)
    # the liquid between the inner layers, at the solution's density
    z_liq = pos[t["liquid"], 2]
    assert z_e[2] < z_liq.min() and z_liq.max() < z_e[3]
    gap = edl_swm4_nacl.slab(cfg)[2]
    grams = edl_swm4_nacl.solution_mass(cfg)
    assert grams / (lx * ly * gap * 1e-21) == pytest.approx(1.0366)
    assert gap == pytest.approx(5.099, abs=1e-3)
    # 1 mol of NaCl per kg of water to the nearest pair, 0.97 mol per litre
    # of solution
    kg_water = 2800 * (15.9994 + 2 * 1.008) / 6.02214076e23 * 1e-3
    assert 50 / 6.02214076e23 / kg_water == pytest.approx(1.0, abs=0.01)
    assert 0.5 / 6.02214076e23 / kg_water < 0.01
    litres = lx * ly * gap * 1e-24
    assert 50 / 6.02214076e23 / litres == pytest.approx(0.97, abs=0.005)
    # the images: a trailing block in the parents' order, negated charges,
    # massless, mirrored through z = Lz / 2
    par, img = t["image_pairs"].T
    assert np.array_equal(par, t["liquid"])
    assert np.array_equal(img, n_e + n_liq + np.arange(n_liq))
    assert np.array_equal(t["charges"][img], -t["charges"][par])
    assert not t["masses"][img].any() and not t["masses"][:n_e].any()
    assert np.allclose(pos[img], pos[par] * [1, 1, -1] + [0, 0, lz],
                       atol=1e-5)
    assert np.sum(t["charges"]) == pytest.approx(0.0, abs=1e-9)
    assert np.sum(t["charges"][par]) == pytest.approx(0.0, abs=1e-9)
    # an M site's image is a virtual site on the images of O, H1 and H2
    half = t["vsites"].size // 2
    assert np.array_equal(t["vsites"][half:], t["vsites"][:half] + n_liq)
    assert np.array_equal(t["vsite_parents"][half:],
                          t["vsite_parents"][:half] + n_liq)
