"""idle_share.train: the device's idle share of the traced training step.

Layer: device. Moves ``train_pairs_per_s``. 1 − (the union of the device
operations' intervals ÷ the traced window), from the profiler's trace."""


def read(trace, work):
    if trace is None or work.get("kind") != "train" or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
