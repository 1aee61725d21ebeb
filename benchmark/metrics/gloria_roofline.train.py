"""gloria_roofline.train: the GLoRIA similarity kernels' share of their
roofline.

Layer: GLoRIA similarity (``ops/gloria_attention.py``,
``csrc/gloria_attention{,_bwd}.cu``). Moves ``train_pairs_per_s``. The least
time of the profiled step's K3, prologue, K4a and K4b work
(``flops.local_least_s``, each caption's own length, the prologue's
recomputed F1/F2 not counted) over those kernels' device time in the
trace. Nothing to read where no GLoRIA kernel ran."""

from benchmark.metrics import flops


def read(trace, work):
    if trace is None or work.get("kind") != "train":
        return None
    dev_s = trace.device_s(flops.GLORIA_KERNELS)
    if dev_s <= 0:
        return None
    t = work["model"]["text"]
    v = work["model"]["vision"]
    d, m = int(v["embed_dim"]), flops.swin_stages(v)[0]["n"]
    least = sum(flops.local_least_s(work["micro_batch"], caps, d,
                                    int(t["max_length"]), m,
                                    not t.get("freeze_bert", False))
                for caps in work["profiled_cap_lens"])
    return 100.0 * least / dev_s
