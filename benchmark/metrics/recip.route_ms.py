"""The cell's reciprocal route, energy and autograd forces, as the step
reaches it through ``ForceEvaluator.smooth_terms(box)["coul_recip"]``:
the median of CUDA-event times at the window's last state."""


def read(r):
    return r.route_ms
