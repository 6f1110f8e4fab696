"""Kernel B7 (the lane gather) against the designs it was chosen over, on
the card: device time per call at the gather tool's size (blk (8, 1024)
f32, 131,072 lanes), in several rounds that rotate the order.

    python -m openmm_velocityverlet_tpu_torch.tools.lane_gather_designs \\
        [--rounds 7] [--calls 50]

The designs, each held bitwise against ``gather_lanes_reference``:
  * ``port``: B7 as ``csrc/gather.cu`` has it (one output column a thread,
    the table read through ``__ldg``), through its wrapper ``gather_lanes``;
  * ``staged``: its first design, each of at most 264 blocks staging the
    whole (8, 1024) table (32 KB) in shared memory behind a
    ``__syncthreads()`` and walking the columns with a grid stride;
  * ``four``: four consecutive columns a thread (one 16-byte index load,
    a 16-byte store in each row, a scalar tail), the table through
    ``__ldg``, one wave of the card (8 blocks of 256 threads an SM) walking
    the columns with a grid stride;
  * ``index_select``: ``torch.index_select(blk, 1, idx[0])``.
A time is the CUDA kernel time torch.profiler records over ``--calls``
calls, divided by them.  The two earlier designs are compiled here from
the source below into ``build/kernels/``; nothing of the package runs
them.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys

import torch

from .. import kernels
from . import exp_gather_kernel as gt

SOURCE = r"""
#include <cuda_runtime.h>

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
staged_kernel(const float* __restrict__ blk, const int* __restrict__ idx,
              float* __restrict__ out, int n_rows, int n_cols, int m) {
  extern __shared__ float s_blk[];
  for (int k = threadIdx.x; k < n_rows * n_cols; k += kThreads) {
    const int r = k / n_cols;
    s_blk[k] = blk[(size_t)r * n_cols + (k - r * n_cols)];
  }
  __syncthreads();
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < m;
       j += gridDim.x * kThreads) {
    const int s = idx[j];
    const bool ok = s >= 0 && s < n_cols;
    for (int r = 0; r < n_rows; ++r)
      out[(size_t)r * m + j] = ok ? s_blk[r * n_cols + s] : 0.f;
  }
}

__device__ __forceinline__ float take(const float* row, int s, int n_cols) {
  return s >= 0 && s < n_cols ? __ldg(row + s) : 0.f;
}

// m % 4 == 0 and 16-byte aligned idx and out rows: the wrapper checks.
__global__ void __launch_bounds__(kThreads)
four_kernel(const float* __restrict__ blk, const int* __restrict__ idx,
            float* __restrict__ out, int n_cols, int m) {
  const int quads = m >> 2;
  for (int t = blockIdx.x * kThreads + threadIdx.x; t < quads;
       t += gridDim.x * kThreads) {
    const int4 s = __ldg(reinterpret_cast<const int4*>(idx) + t);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float* row = blk + (size_t)r * n_cols;
      reinterpret_cast<float4*>(out + (size_t)r * m)[t] =
          make_float4(take(row, s.x, n_cols), take(row, s.y, n_cols),
                      take(row, s.z, n_cols), take(row, s.w, n_cols));
    }
  }
}

extern "C" int staged_launch(const float* blk, const int* idx, float* out,
                             int n_rows, int n_cols, int m, void* stream) {
  const int smem = n_rows * n_cols * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int need = (m + kThreads - 1) / kThreads;
  staged_kernel<<<need < 264 ? need : 264, kThreads, smem,
                  (cudaStream_t)stream>>>(blk, idx, out, n_rows, n_cols, m);
  return (int)cudaGetLastError();
}

extern "C" int four_launch(const float* blk, const int* idx, float* out,
                           int n_cols, int m, void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int need = (m / 4 + kThreads - 1) / kThreads;
  const int wave = sms * (2048 / kThreads);
  four_kernel<<<need < wave ? need : wave, kThreads, 0,
                (cudaStream_t)stream>>>(blk, idx, out, n_cols, m);
  return (int)cudaGetLastError();
}
"""


def _library():
    """The two earlier designs, compiled by nvcc for sm_90a (once per
    source) and loaded with ctypes."""
    digest = hashlib.sha1(SOURCE.encode()).hexdigest()[:12]
    path = os.path.join(kernels.BUILD_DIR,
                        f"liblane_gather_designs-{digest}.so")
    if not os.path.exists(path):
        os.makedirs(kernels.BUILD_DIR, exist_ok=True)
        src = path[:-3] + ".cu"
        with open(src, "w") as fh:
            fh.write(SOURCE)
        subprocess.run([kernels._nvcc()] + kernels.NVCC_FLAGS
                       + ["-o", path, src], check=True)
    lib = ctypes.CDLL(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.staged_launch.argtypes = [P, P, P, I, I, I, P]
    lib.four_launch.argtypes = [P, P, P, I, I, P]
    lib.staged_launch.restype = lib.four_launch.restype = I
    return lib


def designs(blk, idx):
    """{name: call} of the four designs on the tool's operands."""
    lib = _library()
    rows, cols = blk.shape
    m = idx.shape[1]
    if rows != 8 or m % 4:
        raise ValueError("the designs take 8 rows and m % 4 == 0")

    def launched(err):
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    def staged():
        out = torch.empty((rows, m), dtype=torch.float32, device=blk.device)
        launched(lib.staged_launch(
            blk.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, cols, m,
            torch.cuda.current_stream().cuda_stream))
        return out

    def four():
        out = torch.empty((rows, m), dtype=torch.float32, device=blk.device)
        launched(lib.four_launch(
            blk.data_ptr(), idx.data_ptr(), out.data_ptr(), cols, m,
            torch.cuda.current_stream().cuda_stream))
        return out

    return {"port": lambda: gt.gather_lanes(blk, idx), "staged": staged,
            "four": four,
            "index_select": lambda: torch.index_select(blk, 1, idx[0])}


def device_ms(fn, calls):
    """CUDA kernel time a call that torch.profiler records over ``calls``
    calls, after one warm-up call; raises where it records none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type.name == "CUDA")
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return us / 1e3 / calls


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    _, (blk, idx) = gt.variant_lane("cuda")
    ref = gt.gather_lanes_reference(blk, idx)
    calls = designs(blk, idx)
    for name, fn in calls.items():
        if not torch.equal(fn(), ref):
            raise AssertionError(f"{name} is not bitwise equal to the plain "
                                 f"version")
    names = list(calls)
    times = {name: [] for name in names}
    for k in range(args.rounds):
        order = names[k % len(names):] + names[:k % len(names)]
        for name in order:
            times[name].append(device_ms(calls[name], args.calls))
        print(f"[round {k}] " + ", ".join(
            f"{name} {times[name][-1]:.5f}" for name in names) + " ms")
    wins = sum(p < s for p, s in zip(times["port"], times["index_select"]))
    summary = {name: dict(median=statistics.median(t), min=min(t),
                          max=max(t), readings=t)
               for name, t in times.items()}
    for name, s in summary.items():
        print(f"[{name}] median {s['median']:.5f} ms, min {s['min']:.5f}, "
              f"max {s['max']:.5f} over {args.rounds} rounds of "
              f"{args.calls} calls")
    print(f"[port] faster than index_select in {wins} of {args.rounds} "
          f"rounds")
    print(json.dumps(dict(device=torch.cuda.get_device_name(0),
                          port_wins=wins, **summary)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
