"""expert_roofline.serve: K1's share of its roofline in serving.

Layer: expert branch (``ops/expert_fusion.py``, ``csrc/expert_fusion*.cu``).
Moves ``serve_img_per_s``. The least time of K1 over the traced waves'
images (the larger of operations at the peak rate and bytes at the peak
bandwidth) over K1's device time in the trace."""

from benchmark.metrics import flops


def read(trace, work):
    if trace is None or work.get("kind") != "serve":
        return None
    dev_s = trace.device_s(flops.K1_KERNELS)
    if dev_s <= 0:
        return None
    v = work["model"]["vision"]
    waves = work["profiled_images"] // work["wave"]
    b = work["wave"] * int(v["router_top_k"])
    least = waves * max(flops.expert_forward(v) * b / flops.PEAK_FLOPS,
                        flops.expert_bytes(v, b, False) / flops.PEAK_BYTES)
    return 100.0 * least / dev_s
