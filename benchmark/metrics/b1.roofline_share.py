"""Kernel B1's share of its roofline: the least time of one launch (the
larger of the cutoff pairs' operations over the FP32 peak and the bytes
of N atoms over the memory rate) over the profiler's device time of one
launch (its sweep and reduce kernels)."""
from benchmark import counts


def read(r):
    if r.profile is None or not r.profile["b1_launches"] or r.work is None:
        return None
    per_launch = r.profile["b1_s"] / r.profile["b1_launches"]
    bound = counts.bound_s(r.work["pairs"] * counts.PAIR_OPS,
                           counts.b1_bytes(r.n_atoms))
    return 100.0 * bound / per_launch
