"""The gather-throughput experiment on the card: the counterpart of the JAX
package's ``tools/exp_gather_kernel.py``, with its three Pallas kernels
ported as kernels B6-B8 (``csrc/gather.cu``).

Per variant it gathers ROWS = 131,072 rows (or lanes) a call from a block of
BLK = 1,024, 100 calls, and prints microseconds a call and nanoseconds a
row, as the JAX ``main()`` does; the baseline is the torch row gather
``src[idx]`` on a (20000, 3) table in place of the XLA one.

    python -m openmm_velocityverlet_tpu_torch.tools.exp_gather_kernel
    python -m openmm_velocityverlet_tpu_torch.tools.exp_gather_kernel \\
        --device cpu

Each variant's wrapper launches its kernel on a CUDA tensor and counts the
launch in ``<wrapper>.launches``; on a CPU tensor it takes the plain torch
version beside it.  An index outside the block gives zeros on the card,
where the plain version raises an IndexError; the variants draw every index
in range.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
import time

import numpy as np
import torch

from .. import kernels

ROWS = 131072
BLK = 1024


# ------------------------------------------------------- plain versions
def gather_rows_reference(blk, idx):
    """B6: out[i, :] = blk[idx[i, 0], :]."""
    return blk[idx[:, 0]]


def gather_lanes_reference(blk, idx):
    """B7: out[:, j] = blk[:, idx[0, j]]."""
    return blk[:, idx[0]]


def gather_lanes_tiled_reference(blk, idx):
    """B8: out[:, j] = blk[:, idx[0, j] mod 128] (floor modulo)."""
    return blk[:, idx[0] % 128]


# ------------------------------------------------------------ wrappers
def _launcher():
    """The kernel library with its C signatures declared (pointers and the
    stream as c_void_p, so ctypes never truncates them to 32 bits)."""
    lib = kernels.load("gather")
    if lib.gather_rows_launch.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.gather_rows_launch.argtypes = [P, P, P, I, I, I, P]
        lib.gather_rows_launch.restype = I
        lib.gather_lanes_launch.argtypes = [P, P, P, I, I, I, I, P]
        lib.gather_lanes_launch.restype = I
        lib.gather_error_string.argtypes = [I]
        lib.gather_error_string.restype = ctypes.c_char_p
    return lib


def _check(fn, blk, idx, idx_shape):
    dev = blk.device
    if blk.dtype != torch.float32 or blk.dim() != 2 \
            or not blk.is_contiguous() or blk.data_ptr() % 16:
        raise ValueError(f"{fn}: blk must be a contiguous, 16-byte aligned "
                         f"2-D float32 tensor; got {blk.dtype} "
                         f"{tuple(blk.shape)}")
    if idx.dtype != torch.int32 or tuple(idx.shape) != idx_shape \
            or idx.device != dev or not idx.is_contiguous():
        raise ValueError(f"{fn}: idx must be a contiguous int32 tensor of "
                         f"shape {idx_shape} on {dev}; got {idx.dtype} "
                         f"{tuple(idx.shape)} on {idx.device}")


def _raise(lib, err, fn):
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: "
                           + lib.gather_error_string(err).decode())


def gather_rows(blk, idx):
    """B6, the sublane gather: blk (R, W) f32, idx (M, 1) i32 -> (M, W).
    On the card a row index outside [0, R) gives a row of zeros."""
    if blk.device.type == "cpu":
        return gather_rows_reference(blk, idx)
    if blk.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {blk.device}")
    _check("gather_rows", blk, idx, (idx.shape[0], 1))
    out = torch.empty((idx.shape[0], blk.shape[1]), dtype=torch.float32,
                      device=blk.device)
    lib = _launcher()
    _raise(lib, lib.gather_rows_launch(
        blk.data_ptr(), idx.data_ptr(), out.data_ptr(), blk.shape[0],
        blk.shape[1], idx.shape[0],
        torch.cuda.current_stream(blk.device).cuda_stream), "gather_rows")
    gather_rows.launches += 1
    return out


def _gather_lanes(fn, blk, idx, mod128):
    _check(fn.__name__, blk, idx, (1, idx.shape[-1]))
    out = torch.empty((blk.shape[0], idx.shape[1]), dtype=torch.float32,
                      device=blk.device)
    lib = _launcher()
    _raise(lib, lib.gather_lanes_launch(
        blk.data_ptr(), idx.data_ptr(), out.data_ptr(), blk.shape[0],
        blk.shape[1], idx.shape[1], int(mod128),
        torch.cuda.current_stream(blk.device).cuda_stream), fn.__name__)
    fn.launches += 1
    return out


def gather_lanes(blk, idx):
    """B7, the lane gather: blk (8, C) f32, idx (1, M) i32 -> (8, M).
    On the card a lane index outside [0, C) gives a column of zeros."""
    if blk.device.type == "cpu":
        return gather_lanes_reference(blk, idx)
    if blk.device.type != "cuda":
        raise ValueError(f"gather_lanes: unsupported device {blk.device}")
    return _gather_lanes(gather_lanes, blk, idx, False)


def gather_lanes_tiled(blk, idx):
    """B8, the lane gather within the first 128 lanes: blk (8, C) f32 with
    C >= 128, idx (1, M) i32 -> (8, M)."""
    if blk.device.type == "cpu":
        return gather_lanes_tiled_reference(blk, idx)
    if blk.device.type != "cuda":
        raise ValueError(
            f"gather_lanes_tiled: unsupported device {blk.device}")
    return _gather_lanes(gather_lanes_tiled, blk, idx, True)


gather_rows.launches = 0
gather_lanes.launches = 0
gather_lanes_tiled.launches = 0


# ------------------------------------------------------------ variants
def variant_sublane(device="cuda"):
    """Gather rows along the major dim: out[i] = block[idx[i], :]."""
    rng = np.random.default_rng(0)
    blk = torch.as_tensor(rng.standard_normal((BLK, 128), np.float32),
                          device=device)
    idx = torch.as_tensor(rng.integers(0, BLK, (ROWS, 1), np.int32),
                          device=device)
    return gather_rows, (blk, idx)


def variant_lane(device="cuda"):
    """Gather along the minor dim: out[:, j] = block[:, idx[j]]."""
    rng = np.random.default_rng(1)
    blk = torch.as_tensor(rng.standard_normal((8, BLK), np.float32),
                          device=device)
    idx = torch.as_tensor(rng.integers(0, BLK, (1, ROWS), np.int32),
                          device=device)
    return gather_lanes, (blk, idx)


def variant_lane_tiled(device="cuda"):
    """Lane gather with per-128 indices (take_along_axis style):
    out[:, j] = block[:, idx[j] % 128]."""
    rng = np.random.default_rng(2)
    blk = torch.as_tensor(rng.standard_normal((8, BLK), np.float32),
                          device=device)
    idx = torch.as_tensor(rng.integers(0, BLK, (1, ROWS), np.int32),
                          device=device)
    return gather_lanes_tiled, (blk, idx)


def variant_torch_baseline(device="cuda"):
    """The torch whole-array row gather, for comparison."""
    rng = np.random.default_rng(3)
    src = torch.as_tensor(rng.standard_normal((20000, 3), np.float32),
                          device=device)
    idx = torch.as_tensor(rng.integers(0, 20000, (ROWS,)), device=device)
    return (lambda s, i: s[i]), (src, idx)


def bench(fn, *args):
    """(last output, seconds a call) over 100 calls after one warm-up
    call, on the host clock, waiting for the card at both ends."""
    dev = args[0].device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    out = fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(100):
        out = fn(*args)
    sync()
    return out, (time.perf_counter() - t0) / 100


VARIANTS = (("torch_row_gather(20k,3)", variant_torch_baseline),
            ("cuda_sublane (B6)", variant_sublane),
            ("cuda_lane (B7)", variant_lane),
            ("cuda_lane_tiled (B8)", variant_lane_tiled))


def main(argv=None):
    """Run every variant; returns {name: (us a call, ns a row)}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("exp_gather_kernel: no CUDA card; pass --device "
                         "cpu to run the plain versions on the host")
    print("backend:", torch.cuda.get_device_name(dev)
          if dev.type == "cuda" else "cpu")
    results = {}
    for name, maker in VARIANTS:
        fn, fargs = maker(dev)
        _, dt = bench(fn, *fargs)
        per_row = dt / ROWS * 1e9
        results[name] = (dt * 1e6, per_row)
        print(f"{name:24s} {dt * 1e6:9.1f} us/call  {per_row:6.3f} ns/row")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
