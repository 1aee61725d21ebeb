"""mfu.train: the whole training step's share of the card's peak.

Layer: train step (``train/step.py``, ``train/module.py``,
``train/optim.py``). Moves ``train_pairs_per_s``. The model operations of
one optimizer step (``flops.train_step_flops``: these inputs' caption
lengths, no padding, no recomputation) over the step's time in the
unprofiled window, against 989 TFLOP/s."""

from benchmark.metrics import flops


def read(trace, work):
    if work.get("kind") != "train" or not work.get("step_s"):
        return None
    return 100.0 * flops.train_step_flops(work) / (
        work["step_s"] * flops.PEAK_FLOPS)
