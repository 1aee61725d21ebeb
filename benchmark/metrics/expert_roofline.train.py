"""expert_roofline.train: the expert-branch kernels' share of their
roofline in training.

Layer: expert branch (``ops/expert_fusion.py``, ``csrc/expert_fusion*.cu``).
Moves ``train_pairs_per_s``. The least time of the profiled step's K1
(projection and attention MLP) and K2 (their input and weight gradients,
twice the forward; K2's recomputed projection and logit product not
counted), each the larger of operations at the peak rate and bytes at the
peak bandwidth, over K1's and K2's device time in the trace."""

from benchmark.metrics import flops


def read(trace, work):
    if trace is None or work.get("kind") != "train":
        return None
    dev_s = trace.device_s(flops.K1_KERNELS + flops.K2_KERNELS)
    if dev_s <= 0:
        return None
    v = work["model"]["vision"]
    b = int(work["micro_batch"]) * int(v["router_top_k"])
    f = flops.expert_forward(v) * b
    least = 0.0
    for _ in work["profiled_cap_lens"]:
        least += max(f / flops.PEAK_FLOPS,
                     flops.expert_bytes(v, b, False) / flops.PEAK_BYTES)
        least += max(2 * f / flops.PEAK_FLOPS,
                     flops.expert_bytes(v, b, True) / flops.PEAK_BYTES)
    return 100.0 * least / dev_s
