"""The harness on the CPU at small sizes: tables from the seed, the
comparison that decides ``correct`` against runs with the timed path
broken, the imports of the harness and its reference, the harness's
sources naming no configuration or cell, the metric readers, and the
refusal to run without a card.  ``test_card_run`` runs a cell on the card
and skips without one.

    python -m pytest benchmark/tests -q
"""
from __future__ import annotations

import ast
import contextlib
import glob
import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

from benchmark import faults, run  # noqa: E402
from benchmark.layouts import swm4_ndp  # noqa: E402

BENCH = run.load_json(ROOT, "BENCHMARK.json")
# the benchmark's cells and the queued ones, whose files are in place
WORKLOADS = BENCH["workloads"] + run.queued_cells()
CELLS = sorted(w["name"] for w in WORKLOADS)
# the fewest steps a window takes at a cell's small size: enough for the
# thermostat to have drawn the Drudes' starting heat
SMALL_STEPS = 100
FORBIDDEN = {"jax", "jaxlib", "flax", "openmm_velocityverlet_tpu"}
# the harness's own files, which name no configuration, role, traffic or
# cell: they find each by the name in BENCHMARK.json
HARNESS = ("run.py", "check.py", "readings.py", "faults.py", "counts.py")
# the plain reference and the yardstick, which import nothing of the port
REFERENCE_SOURCES = sorted(
    ["reference.py", "check.py", "counts.py"]
    + [os.path.relpath(p, run.HERE) for kind in ("references", "routes")
       for p in glob.glob(os.path.join(run.HERE, kind, "*.py"))
       if not p.endswith("__init__.py")])


def config(workload):
    return run.cell_data(BENCH, workload)[0]


def small(workload):
    """The small size of the cell's configuration (a thousand sites), from
    its ``small`` keys."""
    return config(workload)["small"]


def test_every_cell_has_a_small_size():
    for workload in CELLS:
        cfg = config(workload)
        assert cfg["small"] and set(cfg["small"]) <= set(cfg), workload


def small_run(workload, seed=5, **kw):
    return run.run_cell(workload, seed, 0.0, False, device="cpu",
                        config_override=small(workload), bench=BENCH,
                        min_steps=SMALL_STEPS, log=lambda msg: None, **kw)


def tables(workload, seed):
    cfg = run.cell_data(BENCH, workload, small(workload))[0]
    return run.role("layouts", cfg["layout"]).tables(cfg, seed)


def traffic(workload):
    return run.cell_data(BENCH, workload)[1]


@pytest.mark.parametrize("workload", CELLS)
def test_tables_follow_the_seed(workload):
    a, b, c = (tables(workload, s) for s in (11, 11, 12))
    for key in ("positions", "velocities"):
        assert np.array_equal(a[key], b[key])
        assert not np.array_equal(a[key], c[key])
    for key in ("masses", "charges", "exclusions", "drudes", "constraints",
                "vsite_weights"):
        assert np.array_equal(a[key], c[key])


def test_queued_cells_are_not_measured_yet():
    measured = {w["name"] for w in BENCH["workloads"]}
    for w in run.queued_cells():
        assert w["name"] not in measured
        assert run.cell_spec(BENCH, w["name"]) == w
        assert os.path.exists(os.path.join(run.HERE, "limits",
                                           w["name"] + ".json"))


def test_seed_beyond_32_bits():
    t = tables("water19k.tgnh", 2 ** 31 + 77)
    assert np.isfinite(t["positions"]).all()


def test_water_geometry_and_density():
    cfg = run.load_json(run.HERE, "configs", "swm4_ndp_19k.json")
    # 3,900 molecules of 18.0154 g/mol at 0.9832 g/cm3
    assert swm4_ndp.box_edge(cfg) == pytest.approx(4.9140, abs=1e-4)
    t = tables("water19k.tgnh", 3)
    pos = t["positions"].astype(np.float64).reshape(-1, 5, 3)
    o, h1, h2, m = pos[:, 0], pos[:, 2], pos[:, 3], pos[:, 4]
    assert np.linalg.norm(h1 - o, axis=1) == pytest.approx(0.09572, abs=1e-6)
    hh = np.linalg.norm(h1 - h2, axis=1)
    assert hh == pytest.approx(2 * 0.09572 * np.sin(np.radians(52.26)),
                               abs=1e-6)
    # M on the bisector, l_OM from O
    assert np.linalg.norm(m - o, axis=1) == pytest.approx(0.024034, abs=1e-6)
    assert np.sum(t["charges"]) == pytest.approx(0.0, abs=1e-9)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res = small_run(workload)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS for f in faults.names(config(w))])
def test_broken_timed_path_is_not_correct(workload, fault):
    with faults.planted(fault, config(workload)):
        assert not small_run(workload)["correct"]


def test_faults_are_undone():
    from openmm_velocityverlet_tpu_torch.context import Context
    before = Context._thermostat, Context.__init__
    with faults.planted("thermostat_off"):
        assert Context._thermostat is not before[0]
    with faults.planted("dt_doubled"):
        assert Context.__init__ is not before[1]
    assert (Context._thermostat, Context.__init__) == before


def test_a_configuration_brings_its_own_faults(monkeypatch):
    planted = []

    @contextlib.contextmanager
    def plant(name):
        planted.append(name)
        yield

    mod = types.SimpleNamespace(NAMES=("image_sync_off",), planted=plant)
    monkeypatch.setitem(sys.modules, "benchmark.extra_faults.slab", mod)
    cfg = {"faults": "slab"}
    assert faults.names(cfg) == faults.NAMES + ("image_sync_off",)
    assert faults.names(config(CELLS[0])) == faults.NAMES
    with faults.planted("image_sync_off", cfg):
        assert planted == ["image_sync_off"]
    with pytest.raises(ValueError):
        with faults.planted("image_sync_off"):
            pass


def _words(source):
    """Every word of a source, and each dotted word's parts."""
    words = set(re.findall(r"[A-Za-z0-9_]+(?:[.-][A-Za-z0-9_]+)*", source))
    return words | {p for w in words for p in re.split(r"[.-]", w)}


@pytest.mark.parametrize("name", HARNESS)
def test_harness_names_no_configuration_or_cell(name):
    names = set()
    for w in WORKLOADS:
        names |= {w["name"], w["config"], w["traffic"]}
        cfg = config(w["name"])
        names |= {cfg[k] for k in ("layout", "wiring", "reference", "faults")
                  if k in cfg}
    for c in BENCH["configs"]:
        names |= {c["name"], os.path.basename(c["file"])[:-5]}
    with open(os.path.join(run.HERE, name)) as fh:
        found = _words(fh.read()) & names
    assert not found, found


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_imports_no_jax():
    code = ("import json, sys; sys.path.insert(0, '.'); "
            "from benchmark import run; "
            f"run.run_cell({CELLS[0]!r}, 3, 0.2, True, device='cpu', "
            f"config_override={small(CELLS[0])!r}, "
            "log=lambda msg: None); "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    assert not _modules_after(code) & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    mods = ", ".join("benchmark." + p[:-3].replace(os.sep, ".")
                     for p in REFERENCE_SOURCES)
    code = ("import json, sys; sys.path.insert(0, '.'); "
            f"import {mods}; "
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    found = _modules_after(code)
    assert not found & (FORBIDDEN | {"openmm_velocityverlet_tpu_torch"})


@pytest.mark.parametrize("name", REFERENCE_SOURCES)
def test_reference_sources_name_no_port(name):
    with open(os.path.join(run.HERE, name)) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN | {
                "openmm_velocityverlet_tpu_torch"}, n


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "water19k.tgnh",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def _readings(**kw):
    base = dict(steps=200, window_s=8.0, counters={"host_syncs": 212},
                profile=dict(steps=100, kernels=170000, busy_s=0.8,
                             b1_launches=100, b1_s=0.02),
                work=dict(pairs=1_000_000, ops=13.4e9), n_atoms=19500,
                route_ms=15.0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _reader(name):
    return run.load_file_module(os.path.join(run.HERE, "metrics",
                                             name + ".py")).read


def test_metric_readers():
    r = _readings()
    assert _reader("loop.host_syncs_per_step")(r) == pytest.approx(1.06)
    assert _reader("step.kernels_per_step")(r) == pytest.approx(1700.0)
    # 8 ms busy a step against 40 ms a step
    assert _reader("device.idle_share")(r) == pytest.approx(80.0)
    assert _reader("step_mfu")(r) == pytest.approx(
        100 * 13.4e9 / (0.04 * 67e12))
    # bound: 70 MFLOP over 67 TFLOP/s against 0.2 ms a launch
    assert _reader("b1.roofline_share")(r) == pytest.approx(
        100 * 70e6 / 67e12 / 2e-4)
    assert _reader("recip.route_ms")(r) == 15.0


def test_readers_find_nothing_without_a_trace():
    r = _readings(profile=None, route_ms=None)
    for name in ("step.kernels_per_step", "device.idle_share",
                 "b1.roofline_share", "recip.route_ms"):
        assert _reader(name)(r) is None


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_card_run(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", "2147483700", "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
