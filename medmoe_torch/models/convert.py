"""Pretrained-weight conversion: HF/MedCLIP torch checkpoints → the port's
towers (counterpart of medmoe_tpu/models/convert.py).

Covers the reference's initialization paths:
  * HF ``microsoft/swin-tiny-patch4-window7-224`` → ``SwinBackbone``
    (reference swin.py:124-126);
  * HF ``emilyalsentzer/Bio_ClinicalBERT`` → ``BertModel``
    (reference text_encoder.py:18-22);
  * MedCLIP ``pytorch_model.bin`` with the reference's key remapping:
    'vision_model.' → vision tower, 'text_model.' → text tower
    (reference med_moe.py:40-62).

The targets are the port's own ``state_dict`` names: the flax tree's names
with ``LayerNorm_0`` dropped, as ``bridge.torch_key`` maps them. HF keeps
``nn.Linear`` weights [out, in] and the patch ``nn.Conv2d`` weight OIHW,
which is what the port's ``Dense`` and ``Conv2d`` hold, so every tensor
copies with no transpose. The merge is shape-checked: a name the model
lacks or a shape that differs is skipped with a warning.

Everything is gated on the checkpoint file existing (there is no network;
random init otherwise — the reference prints the same WARNING and
continues, med_moe.py:48).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Mapping, Optional

import torch
from torch import nn

from medmoe_torch.utils.logging import get_logger

log = get_logger(__name__)

Converted = Dict[str, torch.Tensor]

#: torch state-dict entries that carry no learnable weights — static buffers
#: the port's modules build themselves (swin.py's relative-position index,
#: BERT's position iota) and HF-version-dependent registered buffers.
#: Everything else in a checkpoint MUST be consumed by the conversion.
IGNORABLE_KEY_SUFFIXES = (
    ".relative_position_index",      # Swin static index buffer
    ".position_ids",                 # BERT arange buffer (older HF versions)
    "embeddings.mask_token",         # Swin MIM token (use_mask_token only)
)


def _is_ignorable(key: str) -> bool:
    """The one spelling of the ignore rule, for the unconsumed-key tracking
    and the out-of-prefix check alike."""
    return any(key.endswith(s) or key == s.lstrip(".")
               for s in IGNORABLE_KEY_SUFFIXES)


def _load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    return {k: v.detach() for k, v in state.items()
            if isinstance(v, torch.Tensor)}


class TrackedStateDict(dict):
    """State dict that records which keys the conversion read, so callers
    can assert no checkpoint weight was silently dropped (the reference
    loads with strict=False, med_moe.py:44 — that behaviour is kept for
    MISSING keys, but UNCONSUMED ones surface)."""

    def __init__(self, sd):
        super().__init__(sd)
        self.consumed = set()

    def __getitem__(self, key):
        self.consumed.add(key)
        return super().__getitem__(key)

    def unconsumed(self):
        return sorted(k for k in self
                      if k not in self.consumed and not _is_ignorable(k))


def _report_unconsumed(keys, what: str, strict: bool) -> None:
    if not keys:
        return
    msg = (f"convert: {len(keys)} {what} checkpoint keys were NOT "
           f"consumed by the remap (first 10): {keys[:10]}")
    if strict:
        raise ValueError(msg)
    log.warning(msg)


def _linear(sd, prefix: str, name: str) -> Converted:
    out = {f"{name}.weight": torch.as_tensor(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out[f"{name}.bias"] = torch.as_tensor(sd[f"{prefix}.bias"])
    return out


def _layernorm(sd, prefix: str, name: str) -> Converted:
    return {f"{name}.weight": torch.as_tensor(sd[f"{prefix}.weight"]),
            f"{name}.bias": torch.as_tensor(sd[f"{prefix}.bias"])}


def convert_hf_swin(sd: Mapping, depths=(2, 2, 6, 2)) -> Converted:
    """HF SwinModel state dict → ``SwinBackbone`` state-dict entries."""
    pre = "swin." if any(k.startswith("swin.") for k in sd) else ""
    emb = f"{pre}embeddings"
    p: Converted = {
        **_linear(sd, f"{emb}.patch_embeddings.projection",
                  "patch_embed.proj"),
        **_layernorm(sd, f"{emb}.norm", "patch_embed.norm"),
    }
    for stage in range(len(depths)):
        for blk in range(depths[stage]):
            hf = f"{pre}encoder.layers.{stage}.blocks.{blk}"
            att = f"{hf}.attention"
            ours = f"stage{stage}_block{blk}"
            # 1:1 with HF Swin's separate q/k/v projections
            p.update(_layernorm(sd, f"{hf}.layernorm_before",
                                f"{ours}.norm1"))
            for qkv in ("query", "key", "value"):
                p.update(_linear(sd, f"{att}.self.{qkv}",
                                 f"{ours}.attn.{qkv}"))
            p.update(_linear(sd, f"{att}.output.dense", f"{ours}.attn.proj"))
            p[f"{ours}.attn.relative_position_bias_table"] = torch.as_tensor(
                sd[f"{att}.self.relative_position_bias_table"])
            p.update(_layernorm(sd, f"{hf}.layernorm_after",
                                f"{ours}.norm2"))
            p.update(_linear(sd, f"{hf}.intermediate.dense",
                             f"{ours}.mlp.fc1"))
            p.update(_linear(sd, f"{hf}.output.dense", f"{ours}.mlp.fc2"))
        ds = f"{pre}encoder.layers.{stage}.downsample"
        if f"{ds}.reduction.weight" in sd:
            ours = f"stage{stage}_downsample"
            p.update(_layernorm(sd, f"{ds}.norm", f"{ours}.norm"))
            p[f"{ours}.reduction.weight"] = torch.as_tensor(
                sd[f"{ds}.reduction.weight"])
    p.update(_layernorm(sd, f"{pre}layernorm", "norm"))
    return p


def convert_hf_bert(sd: Mapping, num_layers: int = 12) -> Converted:
    """HF BertModel state dict → the port's ``BertModel`` state-dict
    entries."""
    pre = "bert." if any(k.startswith("bert.") for k in sd) else ""
    e = f"{pre}embeddings"
    p: Converted = {}
    for table in ("word_embeddings", "position_embeddings",
                  "token_type_embeddings"):
        p[f"embeddings.{table}.weight"] = torch.as_tensor(
            sd[f"{e}.{table}.weight"])
    p.update(_layernorm(sd, f"{e}.LayerNorm", "embeddings.norm"))
    for i in range(num_layers):
        hf = f"{pre}encoder.layer.{i}"
        ours = f"layer_{i}"
        for qkv in ("query", "key", "value"):
            p.update(_linear(sd, f"{hf}.attention.self.{qkv}",
                             f"{ours}.attention.{qkv}"))
        p.update(_linear(sd, f"{hf}.attention.output.dense",
                         f"{ours}.attention_output"))
        p.update(_layernorm(sd, f"{hf}.attention.output.LayerNorm",
                            f"{ours}.attention_norm"))
        p.update(_linear(sd, f"{hf}.intermediate.dense",
                         f"{ours}.intermediate"))
        p.update(_linear(sd, f"{hf}.output.dense", f"{ours}.output"))
        p.update(_layernorm(sd, f"{hf}.output.LayerNorm",
                            f"{ours}.output_norm"))
    if f"{pre}pooler.dense.weight" in sd:
        p.update(_linear(sd, f"{pre}pooler.dense", "pooler"))
    return p


@torch.no_grad()
def _merge_into(module: nn.Module, new: Converted) -> int:
    """Shape-checked in-place copy of ``new`` into ``module``'s state;
    returns the number of tensors loaded."""
    have = module.state_dict()
    count = 0
    for k, v in new.items():
        if k not in have:
            log.warning(f"convert: {k} not in the model — skipped")
            continue
        if tuple(have[k].shape) != tuple(v.shape):
            log.warning(f"convert: shape mismatch at {k}: "
                        f"{tuple(have[k].shape)} vs {tuple(v.shape)} — "
                        f"skipped")
            continue
        have[k].copy_(v.to(have[k].dtype))
        count += 1
    return count


def _towers(model: nn.Module):
    """(the Swin backbone or None, the BERT or None) of a MedMoE."""
    swin = getattr(getattr(getattr(model, "image_encoder", None),
                           "swin_moe", None), "swin", None)
    bert = getattr(getattr(model, "text_encoder", None), "bert", None)
    return swin, bert


def _with_prefix(sd: Mapping, prefix: str) -> TrackedStateDict:
    return TrackedStateDict({k[len(prefix):]: v for k, v in sd.items()
                             if k.startswith(prefix)})


def load_medclip_checkpoint(model: nn.Module, checkpoint_path: str,
                            depths=(2, 2, 6, 2), num_layers: int = 12,
                            strict: bool = False) -> nn.Module:
    """Load a MedCLIP pytorch_model.bin into a MedMoE's towers, in place
    (reference med_moe.py:40-62 key remapping: vision_model./text_model.).

    Missing or unmatched keys keep their init (strict=False semantics, like
    the reference). Checkpoint keys the remap did NOT consume (beyond known
    non-weight buffers) are logged — or raise with ``strict=True`` — so a
    layout drift between the checkpoint and the converter cannot silently
    drop weights. A missing file is a no-op with a warning."""
    if not (checkpoint_path and os.path.isfile(checkpoint_path)):
        log.warning(f"WARNING: model weights not loaded from "
                    f"{checkpoint_path!r} (file missing)")
        return model
    sd = _load_torch_state_dict(checkpoint_path)
    vision_sd = _with_prefix(sd, "vision_model.")
    text_sd = _with_prefix(sd, "text_model.")
    # keys under NEITHER tower prefix (a top-level logit_scale or
    # projection head) follow the per-tower leftovers' policy
    other = [k for k in sd
             if not k.startswith(("vision_model.", "text_model."))
             and not _is_ignorable(k)]
    _report_unconsumed(other, "outside the vision_model./text_model. "
                       "prefixes", strict)
    swin, bert = _towers(model)
    n = _load_towers(swin, bert, vision_sd, text_sd, depths, num_layers,
                     strict, ("vision_model", "text_model"))
    log.info(f"loaded {n} arrays from {checkpoint_path}")
    return model


def _load_towers(swin, bert, vision_sd: Optional[TrackedStateDict],
                 text_sd: Optional[TrackedStateDict], depths,
                 num_layers: int, strict: bool, names: Iterable[str]) -> int:
    vision_name, text_name = names
    n = 0
    if vision_sd and swin is not None:
        n += _merge_into(swin, convert_hf_swin(vision_sd, depths))
        _report_unconsumed(vision_sd.unconsumed(), vision_name, strict)
    if text_sd and bert is not None:
        n += _merge_into(bert, convert_hf_bert(text_sd, num_layers))
        _report_unconsumed(text_sd.unconsumed(), text_name, strict)
    return n


def load_hf_pretrained(model: nn.Module, swin_path: Optional[str] = None,
                       bert_path: Optional[str] = None,
                       depths=(2, 2, 6, 2), num_layers: int = 12,
                       strict: bool = False) -> nn.Module:
    """Load plain HF pytorch_model.bin files (Swin and/or BERT) into a
    MedMoE's towers, in place."""
    swin, bert = _towers(model)
    vision_sd = text_sd = None
    if swin_path and os.path.isfile(swin_path):
        vision_sd = TrackedStateDict(_load_torch_state_dict(swin_path))
    if bert_path and os.path.isfile(bert_path):
        text_sd = TrackedStateDict(_load_torch_state_dict(bert_path))
    n = _load_towers(swin, bert, vision_sd, text_sd, depths, num_layers,
                     strict, ("swin", "bert"))
    log.info(f"loaded {n} arrays from {swin_path!r} / {bert_path!r}")
    return model
