"""dwords_roofline.text: K4b's share of its roofline, where BERT trains.

Layer: GLoRIA similarity (``ops/gloria_attention.py``,
``csrc/gloria_attention_bwd.cu``). Moves ``train_pairs_per_s``. K4b gives
the words' gradient of the local similarity: d_words[c, :, t] = Σ over
images i and regions m of ctx[i, m, :] · Z[i, c, m, t], with Z the
d_scores that K4a's pass writes. The least time of the profiled step's K4b
work, a micro-batch the larger of

- one product at the peak rate: ``flops.local_products``, each caption's
  own words;
- its bytes at the peak bandwidth (``k4b_bytes``): ctx and Z read once in
  bf16, d_words written once in bf16, and the prologue's f32 sums
  Σ_b dnum·wei and Σ_b c2 read once, over each caption's own words;

over the device time of ``DWORDS_KERNELS`` in the trace. Nothing to read
where no K4b kernel ran, or where the program counted no GLoRIA backward
that took the words' gradient (its host counter ``gloria.words``)."""

from typing import Sequence

from benchmark.metrics import flops

DWORDS_KERNELS = ("dwords_wei_kernel", "dwords_gemm_kernel",
                  "dwords_sum_kernel")


def k4b_bytes(b_img: int, cap_lens: Sequence[int], d: int, m: int) -> float:
    """Bytes of one K4b call over ``b_img`` images and the captions of
    ``cap_lens`` (their own words only)."""
    words = float(sum(cap_lens))
    ctx = b_img * m * d * 2.0
    z = b_img * m * words * 2.0
    d_words = d * words * 2.0
    sums = d * words * 4.0 + words * 4.0
    return ctx + z + d_words + sums


def _words_counted() -> bool:
    try:
        from medmoe_torch.utils import trace as program
    except ImportError:
        return False
    counters = getattr(program, "counters", None)
    got = counters() if callable(counters) else {}
    return bool(got.get("gloria.words"))


def read(trace, work):
    if trace is None or work.get("kind") != "train":
        return None
    dev_s = trace.device_s(DWORDS_KERNELS)
    if dev_s <= 0 or not _words_counted():
        return None
    v = work["model"]["vision"]
    b = int(work["micro_batch"])
    d, m = int(v["embed_dim"]), flops.swin_stages(v)[0]["n"]
    least = sum(max(flops.local_products(b, caps, d, m) / flops.PEAK_FLOPS,
                    k4b_bytes(b, caps, d, m) / flops.PEAK_BYTES)
                for caps in work["profiled_cap_lens"])
    return 100.0 * least / dev_s
