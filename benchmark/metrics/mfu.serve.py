"""mfu.serve: serving's share of the card's peak.

Layer: serve loop (``cli/serve.py``, ``eval/zero_shot.py``). Moves
``serve_img_per_s``. Swin's forward, the router and one expert's branch
(K1) an image, times the window's images per second, against 989
TFLOP/s."""

from benchmark.metrics import flops


def read(trace, work):
    if work.get("kind") != "serve":
        return None
    v = work["model"]["vision"]
    per_image = flops.swin_forward(v) + flops.router_forward(v) \
        + flops.expert_forward(v) * int(v["router_top_k"])
    return 100.0 * per_image * work["images_per_s"] / flops.PEAK_FLOPS
