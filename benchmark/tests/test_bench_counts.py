"""The yardstick's counts on small boxes worked by hand."""
from __future__ import annotations

import os
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark import counts, run  # noqa: E402
from benchmark.routes import exact, pme  # noqa: E402


def test_cutoff_pairs_minimum_image():
    pos = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [2.5, 0.0, 0.0]])
    # in a 10 nm box only the first two are within 1.2 nm
    assert counts.cutoff_pairs(pos, torch.tensor([10.0] * 3), 1.2) == 1
    # in a 3 nm box the third sits 0.5 nm from the first through the edge
    # and 1.5 nm from the second
    assert counts.cutoff_pairs(pos, torch.tensor([3.0] * 3), 1.2) == 2


def test_cutoff_pairs_blocks_agree():
    g = torch.Generator().manual_seed(0)
    pos = torch.rand((300, 3), generator=g) * 3.0
    box = torch.tensor([3.0] * 3)
    assert counts.cutoff_pairs(pos, box, 0.9, block=7) == \
        counts.cutoff_pairs(pos, box, 0.9, block=1024)


@pytest.mark.parametrize("kmax,modes", [((1, 1, 1), 13), ((0, 0, 1), 1),
                                        ((2, 1, 0), 7), ((20, 20, 20),
                                                         34460)])
def test_kspace_modes(kmax, modes):
    assert exact.kspace_modes(kmax) == modes


def test_ewald_ops_and_bytes():
    assert exact.ops(dict(charges=np.ones(10)), kmax=(1, 1, 1)) == \
        13 * 10 * 20
    assert counts.b1_bytes(10) == 320


def test_bound_is_the_larger_limit():
    assert counts.bound_s(67e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(67e12, 6.7e12) == pytest.approx(2.0)


def _tables(box):
    return dict(charges=np.array([1.0, -1.0, 0.0]), box=np.array(box),
                cutoff=1.2, ewald_tolerance=5e-4)


def test_step_work_counts_ewald_on_the_exact_route_only():
    system = types.SimpleNamespace(r_cutoff=1.2)
    pos = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [0.0, 0.5, 0.0]])
    box = torch.tensor([10.0] * 3)
    t = _tables([10.0] * 3)
    kmax = exact.kmax_of(t)
    # two atoms are charged
    pairs, ops = counts.step_work(system, pos, box, exact.ops(t))
    # all three pairs count, the massless site's too
    assert pairs == 3
    assert ops == 3 * counts.PAIR_OPS + exact.kspace_modes(kmax) * 2 * 20
    # the PME route's count carries no exact-k modes
    k = 100 ** 3
    assert counts.step_work(system, pos, box, pme.ops(t))[1] == \
        3 * counts.PAIR_OPS + 2 * 2 * 64 * 2 + 5 * k * np.log2(k) + k


def test_pme_ops_by_hand():
    # a 4^3 grid (K = 64), 2 charged atoms, order 4: spread and gather
    # 2 x 2 x 64 multiply-adds (512); two FFTs of 2.5 x 64 x 6 (1,920);
    # the convolution 64
    assert pme.ops(dict(charges=np.array([1.0, -1.0, 0.0])),
                   dims=(4, 4, 4)) == 512 + 1920 + 64
    # the cell's 4.914-nm box: a 50^3 grid, 19,500 charged sites
    t = _tables([4.914] * 3)
    t["charges"] = np.ones(19500)
    k = 50 ** 3
    assert pme.ops(t) == pytest.approx(19500 * 64 * 4 + 5 * k * np.log2(k)
                                       + k)


def test_union_seconds():
    assert run.union_seconds([(0, 10), (5, 15), (20, 30)]) == \
        pytest.approx(25e-6)
    assert run.union_seconds([]) == 0.0


def test_idle_gaps_named_by_the_innermost_host_op():
    def ev(name, s, e):
        return types.SimpleNamespace(name=name, time_range=types.
                                     SimpleNamespace(start=s, end=e))
    dev = [ev("k1", 0, 10), ev("k2", 30, 40), ev("k3", 45, 50)]
    cpu = [ev("outer", 0, 100), ev("aten::item", 15, 25)]
    gaps = run.idle_gaps(dev, cpu)
    assert [g[0] for g in gaps] == ["aten::item", "outer"]
    assert [g[1] for g in gaps] == pytest.approx([20e-6, 5e-6])
