"""Operations and bytes the model's work needs, counted from shapes and the
inputs' caption lengths; and the card's published peaks.

Counted: the products (2 operations a multiply-add) that the mathematics
needs for these inputs. Not counted: padding (a caption's words past its
length, BERT's padded positions), recomputation (K2's projection and logit
product, the GLoRIA backward's prologue F1/F2, checkpointed blocks), and
the element-wise work beside the products. Bytes are each input read once
and each output written once.

Peaks: one NVIDIA H100 SXM (80 GB HBM3), dense bfloat16 989 TFLOP/s and
HBM 3.35 TB/s, at its 700 W power limit.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12

GLORIA_KERNELS = ("sim_e_kernel", "sim_wei_kernel", "sim_finish_kernel",
                  "dctx_z_kernel", "dctx_gemm_kernel", "dwords_wei_kernel",
                  "dwords_gemm_kernel", "dwords_sum_kernel")
K1_KERNELS = ("fwd_proj_kernel", "fwd_logit_kernel", "fwd_combine_kernel")
K2_KERNELS = ("bwd_proj_kernel", "bwd_u_kernel", "bwd_act_kernel",
              "bwd_row_kernel", "bwd_du_kernel", "bwd_tlerp_kernel",
              "bwd_dx_kernel", "bwd_wgrad_kernel", "bwd_reduce_kernel")


def swin_stages(v: dict) -> List[dict]:
    """Per stage: tokens N, width C, depth, and whether a patch merging
    follows."""
    res = int(v["image_size"]) // 4
    embed = int(v["swin_embed_dim"])
    depths = list(v["swin_depths"])
    return [{"n": (res >> s) ** 2, "c": embed << s, "depth": d,
             "merge": s < len(depths) - 1} for s, d in enumerate(depths)]


def swin_forward(v: dict) -> float:
    """One image through Swin: the 4×4 patch embedding 2·N0·48·C0; a
    block 24·N·C² (q, k, v, output 8·N·C², MLP 16·N·C²) + 4·N·w²·C
    (scores and their product with v in w² windows); a patch merging
    4·N·C²."""
    st = swin_stages(v)
    w2 = int(v["swin_window_size"]) ** 2
    f = 2.0 * st[0]["n"] * 48 * st[0]["c"]
    for s in st:
        n, c = s["n"], s["c"]
        f += s["depth"] * (24.0 * n * c * c + 4.0 * n * w2 * c)
        if s["merge"]:
            f += 4.0 * n * c * c
    return f


def swin_train(v: dict) -> float:
    """Forward and backward: every product's input and weight gradients
    (twice its forward), but no gradient for the images."""
    st = swin_stages(v)
    return 3.0 * swin_forward(v) - 2.0 * (2.0 * st[0]["n"] * 48 * st[0]["c"])


def router_forward(v: dict) -> float:
    last = swin_stages(v)[-1]["c"]
    return 2.0 * last * 128 + 2.0 * 128 * int(v["num_experts"])


def expert_parts(v: dict):
    """(projection, attention MLP) operations of one expert on one image:
    Σ_s 2·P_s·D_s·E, and 4 scales × (2·P·E·H + 2·P·H), H = E/2."""
    st = swin_stages(v)
    e = int(v["embed_dim"])
    h = e // 2
    p = st[0]["n"]
    pyramid = [(st[0]["n"], st[0]["c"])] + [(s["n"] // 4, s["c"] * 2)
                                            for s in st[:-1]]
    proj = sum(2.0 * ps * ds * e for ps, ds in pyramid)
    mlp = len(pyramid) * (2.0 * p * e * h + 2.0 * p * h)
    return proj, mlp, pyramid


def expert_forward(v: dict) -> float:
    proj, mlp, _ = expert_parts(v)
    return proj + mlp


def expert_bytes(v: dict, images: int, backward: bool) -> float:
    """K1: the pyramid (bf16) and the bank (f32) read once, the fused map
    (f32) written once; K2 also reads the map's cotangent and writes the
    pyramid's (bf16) and the bank's (f32) gradients."""
    _, _, pyramid = expert_parts(v)
    e = int(v["embed_dim"])
    k = int(v["num_experts"])
    p = pyramid[0][0]
    x = images * sum(ps * ds for ps, ds in pyramid) * 2.0
    bank = k * (sum(ds * e + e for _, ds in pyramid) + e * e // 2 + e
                + e // 2 + 1) * 4.0
    out = images * p * e * 4.0
    return (2 * x + 2 * bank + out) if backward else (x + bank + out)


def bert_forward(t: dict, tokens: Sequence[int]) -> float:
    """BERT over each caption's own tokens: a layer 2·L·(4·D² + 2·D·F) +
    4·L²·D."""
    d, f = int(t["hidden_size"]), int(t["intermediate_size"])
    layers = int(t["num_layers"])
    return sum(layers * (2.0 * n * (4 * d * d + 2 * d * f) + 4.0 * n * n * d)
               for n in tokens)


def local_products(b_img: int, cap_lens: Sequence[int], d: int,
                   m: int) -> float:
    """Operations of one product of the GLoRIA local similarity over all
    (image, caption) pairs, ``m`` regions, each caption's valid words only:
    2·M·D·Σ len."""
    return 2.0 * m * d * b_img * float(sum(cap_lens))


def local_least_s(b: int, cap_lens: Sequence[int], d: int, t: int, m: int,
                  words_train: bool) -> float:
    """The least time of one micro-batch's GLoRIA kernels: the forward (two
    products) and the backward (three with frozen words, four otherwise),
    each the larger of its operations at the peak rate and its bytes
    (regions and words in bf16, caption lengths, the [B, B] similarity or
    its cotangent, d_regions in bf16) at the peak bandwidth."""
    one = local_products(b, cap_lens, d, m)
    ctx = b * m * d * 2.0
    words = b * d * t * 2.0
    fwd_bytes = ctx + words + 4.0 * b + 4.0 * b * b
    bwd_bytes = fwd_bytes + ctx + (words if words_train else 0.0)
    fwd = max(2 * one / PEAK_FLOPS, fwd_bytes / PEAK_BYTES)
    bwd = max((4 if words_train else 3) * one / PEAK_FLOPS,
              bwd_bytes / PEAK_BYTES)
    return fwd + bwd


def train_step_flops(work: Dict) -> float:
    """Model operations of one optimizer step of the profiled micro-batches
    (``profiled_cap_lens``, ``profiled_tokens``: per micro-batch lists)."""
    v, t = work["model"]["vision"], work["model"]["text"]
    b = int(work["micro_batch"])
    words_train = not t.get("freeze_bert", False)
    per_image = swin_train(v) + 3.0 * router_forward(v) \
        + 3.0 * expert_forward(v) * int(v["router_top_k"])
    d = int(v["embed_dim"])
    m = swin_stages(v)[0]["n"]
    total = 0.0
    for caps, toks in zip(work["profiled_cap_lens"],
                          work["profiled_tokens"]):
        total += b * per_image
        total += bert_forward(t, toks) * (3.0 if words_train else 1.0)
        total += (5 + (1 if words_train else 0)) * local_products(b, caps,
                                                                  d, m)
        total += 3 * 2.0 * b * b * d                     # the global loss
    return total
