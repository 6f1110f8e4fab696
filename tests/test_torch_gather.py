"""The plain versions of kernels B6-B8 (the port's gather tool) against the
JAX tool's own Pallas kernels, run in interpret mode at the tool's full size
(131,072 rows or lanes from a block of 1,024), required bitwise equal: a
gather copies, so any difference is a wrong index.  The JAX tool calls
``pl.pallas_call`` without ``interpret``, so the test hands it a ``pl``
whose ``pallas_call`` runs in interpret mode; the tool itself is
unchanged."""
import functools
import types

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from openmm_velocityverlet_tpu_torch.tools import exp_gather_kernel as tool
from tools import exp_gather_kernel as jtool


@pytest.fixture
def jax_tool(monkeypatch):
    monkeypatch.setattr(jtool, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec))
    return jtool


@pytest.mark.parametrize("variant,plain", [
    ("variant_sublane", tool.gather_rows_reference),
    ("variant_lane", tool.gather_lanes_reference),
    ("variant_lane_tiled", tool.gather_lanes_tiled_reference)])
def test_plain_gathers_match_pallas_kernels(jax_tool, variant, plain):
    np.random.seed(0)
    fn, args = getattr(jax_tool, variant)()
    ref = np.asarray(fn(*args))
    blk, idx = (torch.as_tensor(np.array(a)) for a in args)
    got = plain(blk, idx).numpy()
    assert got.shape == ref.shape
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_tool_variants_on_the_cpu(capsys):
    """The port's variants keep the JAX shapes and return (fn, args); on CPU
    tensors each wrapper takes its plain version and launches nothing; the
    tool's main() runs every variant with ``--device cpu``."""
    shapes = {"variant_sublane": ((tool.BLK, 128), (tool.ROWS, 1),
                                  (tool.ROWS, 128)),
              "variant_lane": ((8, tool.BLK), (1, tool.ROWS), (8, tool.ROWS)),
              "variant_lane_tiled": ((8, tool.BLK), (1, tool.ROWS),
                                     (8, tool.ROWS))}
    before = [f.launches for f in (tool.gather_rows, tool.gather_lanes,
                                   tool.gather_lanes_tiled)]
    for name, (sb, si, so) in shapes.items():
        fn, (blk, idx) = getattr(tool, name)(device="cpu")
        assert tuple(blk.shape) == sb and tuple(idx.shape) == si
        assert idx.dtype == torch.int32 and blk.dtype == torch.float32
        out = fn(blk, idx)
        assert tuple(out.shape) == so
    res = tool.main(["--device", "cpu"])
    assert len(res) == 4 and all(us > 0 for us, _ in res.values())
    assert "us/call" in capsys.readouterr().out
    assert [f.launches for f in (tool.gather_rows, tool.gather_lanes,
                                 tool.gather_lanes_tiled)] == before
