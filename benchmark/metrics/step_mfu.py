"""The whole step's share of the card's FP32 peak: the float32 operations
the step's physics needs (``counts.step_work``) over the unprofiled wall
seconds of a step times 67 TFLOP/s."""
from benchmark import counts


def read(r):
    if not r.steps or r.work is None:
        return None
    return 100.0 * r.work["ops"] / ((r.window_s / r.steps) * counts.PEAK_FP32)
