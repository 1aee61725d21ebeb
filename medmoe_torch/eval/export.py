"""Serving export: the deployed encoders as ``torch.export`` programs
(counterpart of medmoe_tpu/eval/export.py).

Two programs per device, each saved with ``torch.export.save``:

  * ``encode_image.<device>.pt2`` — f32[b, H, W, 3] (host-normalized,
    NHWC) → L2-normalized f32[b, D] global embeddings;
  * ``encode_text.<device>.pt2`` — (input_ids, attention_mask,
    token_type_ids, segment_ids) int32[b, T] → L2-normalized f32[b, D]
    sentence embeddings (tokenization stays on the host: the manifest
    records max_length so the serving host reproduces it);

plus ``manifest.json`` (shapes, dtypes, normalization stats, prompt
template, devices). The batch dim ``b`` is symbolic (``torch.export.Dim``)
unless ``batch`` pins it, so one program serves any wave size.

``bake_weights=False`` exports the function of ``(weights, inputs)``
through ``torch.func.functional_call``, so the program holds no weights;
they ship beside it as ``weights.npz``, keyed by the model's
``state_dict`` names (``load_weights``/``call_exported`` reassemble them).

Devices. A program is traced on real tensors of its device, so it runs on
that device only: ``platforms`` lists the devices to export for (``cpu``,
``cuda``), each of which must be present. The expert branch enters the
graph as the registered op ``medmoe::expert_fusion_gather``: a program
exported for the card launches kernel K1, one for the CPU runs the plain
version. (The JAX exporter instead forces its expert branch onto the XLA
path so that one artifact holds no Mosaic call and runs on every
platform.)
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from medmoe_torch.utils.logging import get_logger

log = get_logger(__name__)

_WEIGHTS_NAME = "weights.npz"
_MANIFEST = "manifest.json"
_DEVICES = ("cpu", "cuda")
#: outputs are unit-norm embeddings: 2e-3 abs admits reassociation noise
#: between the program and the live module, while wrong or permuted
#: weights give O(1) errors (the JAX exporter's bound)
ROUNDTRIP_ATOL = 2e-3


def _l2(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-12)


#: the tower of the MedMoE that each program calls
_TOWERS = {"image": "image_encoder", "text": "text_encoder"}


def _tower_only(model: nn.Module, which: str) -> nn.Module:
    """A shallow copy of ``model`` whose module tree holds only the tower
    that program ``which`` calls, so that the program holds none of the
    other tower's weights."""
    shell = copy.copy(model)
    shell._modules = {k: v for k, v in model._modules.items()
                      if k == _TOWERS[which]}
    return shell


def _tower_weights(weights: Dict[str, torch.Tensor], which: str
                   ) -> Dict[str, torch.Tensor]:
    prefix = _TOWERS[which] + "."
    return {k: v for k, v in weights.items() if k.startswith(prefix)}


class ImageProgram(nn.Module):
    """What ``encode_image.*.pt2`` computes: images → unit-norm [b, D]."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = _tower_only(model, "image")

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        g, _, _ = self.model.encode_image(images)
        return _l2(g)


class TextProgram(nn.Module):
    """What ``encode_text.*.pt2`` computes: four int32 [b, T] token
    tensors → unit-norm [b, D]."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = _tower_only(model, "text")

    def forward(self, ids, mask, types, segs) -> torch.Tensor:
        _, sent = self.model.encode_text(ids.long(), mask.long(),
                                         types.long(), segs.long())
        return _l2(sent)


class _Unbaked(nn.Module):
    """``program`` as a function of ``(weights, *inputs)``: the weights
    (its tower's ``state_dict`` names) replace the model's own through
    ``functional_call``. The program is held outside the module tree, so
    an export of this wrapper lifts none of its parameters."""

    def __init__(self, program: nn.Module):
        super().__init__()
        object.__setattr__(self, "_program", program)

    def forward(self, weights: Dict[str, torch.Tensor], *inputs):
        return torch.func.functional_call(
            self._program, {f"model.{k}": v for k, v in weights.items()},
            inputs)


def program_file(which: str, device: str) -> str:
    return f"encode_{which}.{device}.pt2"


def _check_platforms(platforms: Sequence[str]) -> list:
    out = []
    for p in platforms:
        if p == "tpu":
            raise ValueError(
                "export.platforms: 'tpu' is the JAX exporter's target; the "
                "PyTorch port exports torch.export programs for 'cpu' and "
                "'cuda' (python -m medmoe_tpu.cli.export writes TPU "
                "artifacts)")
        if p not in _DEVICES:
            raise ValueError(f"export.platforms takes {list(_DEVICES)}, got "
                             f"{p!r}")
        if p == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "export.platforms lists cuda and no CUDA device is "
                "available: a program is traced on its device's tensors; "
                "export on a machine with a card, or list cpu only")
        if p not in out:
            out.append(p)
    return out


def _inputs(which: str, b: int, size: int, t_len: int, vocab: int,
            device, seed: int = 0):
    """Random inputs of one program at batch ``b``, from a numpy seed."""
    rng = np.random.RandomState(seed)
    if which == "image":
        return (torch.from_numpy(
            rng.rand(b, size, size, 3).astype(np.float32)).to(device),)
    ids = rng.randint(1, vocab, size=(b, t_len)).astype(np.int32)
    mask = np.ones((b, t_len), np.int32)
    types = np.zeros((b, t_len), np.int32)
    segs = np.tile(np.arange(t_len, dtype=np.int32), (b, 1))
    return tuple(torch.from_numpy(a).to(device)
                 for a in (ids, mask, types, segs))


def _weights_of(model: nn.Module, device) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to(device)
            for k, v in model.state_dict().items()}


def _export_one(program: nn.Module, inputs, batch: Optional[int],
                bake_weights: bool, weights=None):
    dim = None if batch is not None else torch.export.Dim("b", min=1,
                                                          max=65536)
    spec = tuple({0: dim} if dim is not None else None for _ in inputs)
    if bake_weights:
        args, dynamic = inputs, spec
    else:
        program = _Unbaked(program)
        args = (weights,) + tuple(inputs)
        dynamic = ({k: None for k in weights}, spec)     # *inputs: a tuple
    with torch.no_grad():
        return torch.export.export(program, args, dynamic_shapes=dynamic,
                                   strict=False)


def export_encoders(model: nn.Module, out_dir: str,
                    platforms: Optional[Sequence[str]] = None,
                    batch: Optional[int] = None,
                    bake_weights: bool = True,
                    check: bool = True) -> Dict[str, Any]:
    """Write the two encoder programs for every device of ``platforms``
    (default: the model's own) + the manifest to ``out_dir``; returns the
    manifest.

    ``batch=None`` exports a symbolic batch dimension; an int pins it.
    ``bake_weights=False`` writes programs of ``(weights, inputs)`` and
    the weights beside them as ``weights.npz``. ``check=True`` loads each
    program back and holds it against the live module on the same random
    inputs on its device (max abs ≤ ``ROUNDTRIP_ATOL``); the manifest
    records each error."""
    own = next(model.parameters()).device
    devices = _check_platforms(platforms or [own.type])
    os.makedirs(out_dir, exist_ok=True)
    vision, text = model.vision, model.text
    size = int(vision["image_size"])
    t_len = int(text["max_length"])
    vocab = int(text.get("vocab_size", 64))
    trace_b = int(batch) if batch is not None else 2
    model = model.eval()

    files: Dict[str, Dict[str, str]] = {}
    for dev in devices:
        live = model if own.type == dev else \
            copy.deepcopy(model).to(dev).eval()
        weights = None if bake_weights else _weights_of(live, dev)
        files[dev] = {}
        for which, cls in (("image", ImageProgram), ("text", TextProgram)):
            ep = _export_one(cls(live),
                             _inputs(which, trace_b, size, t_len, vocab, dev),
                             batch, bake_weights,
                             weights and _tower_weights(weights, which))
            if which == "image":
                out = ep.graph_signature.user_outputs[0]
                embed_dim = int(next(
                    n for n in ep.graph.nodes if n.name == out
                ).meta["val"].shape[-1])
            name = program_file(which, dev)
            ep.example_inputs = None    # (they hold the weights when unbaked)
            torch.export.save(ep, os.path.join(out_dir, name))
            files[dev][which] = name
        if live is not model:
            del live
    if not bake_weights:
        np.savez(os.path.join(out_dir, _WEIGHTS_NAME),
                 **{k: v.detach().float().cpu().numpy()
                    for k, v in model.state_dict().items()})
    else:
        # a baked re-export into a dir that held an unbaked one must not
        # leave the stale weights behind
        stale = os.path.join(out_dir, _WEIGHTS_NAME)
        if os.path.exists(stale):
            os.remove(stale)

    b_name = "b" if batch is None else str(batch)
    manifest = {
        "format": "torch.export ExportedProgram (.pt2), one per device",
        "platforms": devices,
        "embed_dim": embed_dim,
        "image": {
            "file": {d: f["image"] for d, f in files.items()},
            "input": f"float32[{b_name},{size},{size},3]",
            "layout": "NHWC, host-normalized",
            "norm_stats": vision.get("norm_stats", "imagenet"),
            "output": "float32[b, D] L2-normalized",
        },
        "text": {
            "file": {d: f["text"] for d, f in files.items()},
            "inputs": ["input_ids", "attention_mask", "token_type_ids",
                       "segment_ids"],
            "input_shape": f"int32[{b_name},{t_len}]",
            "max_length": t_len,
            "tokenizer": "WordPiece + merged-word segment_ids "
                         "(medmoe_torch/data/tokenizer.py)",
            "output": "float32[b, D] L2-normalized",
        },
        "weights": "baked" if bake_weights else _WEIGHTS_NAME,
        "prompt_template": "this is a photo of {}",
        "torch_version": torch.__version__,
    }
    _write_manifest(out_dir, manifest)
    if check:
        manifest["roundtrip_max_abs_err"] = {
            dev: _roundtrip_check(model, out_dir, dev, size, t_len, vocab,
                                  trace_b) for dev in devices}
        _write_manifest(out_dir, manifest)
    log.info(f"exported encoders to {out_dir} (D={embed_dim}, "
             f"devices={devices})")
    return manifest


def _write_manifest(export_dir: str, manifest: Dict[str, Any]) -> None:
    with open(os.path.join(export_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)


def read_manifest(export_dir: str) -> Dict[str, Any]:
    with open(os.path.join(export_dir, _MANIFEST)) as f:
        return json.load(f)


def load_weights(export_dir: str, device="cpu") -> Dict[str, torch.Tensor]:
    """weights.npz → the ``state_dict``-named tensors on ``device``, in the
    order the program was exported with."""
    with np.load(os.path.join(export_dir, _WEIGHTS_NAME)) as data:
        return {k: torch.from_numpy(data[k]).to(device) for k in data.files}


def call_exported(export_dir: str, which: str,
                  device: Optional[str] = None) -> Callable:
    """Load one program as a plain callable (images → emb, or the four
    token tensors → emb) for ``device`` (default: the first the manifest
    lists). The manifest's ``weights`` field says whether the program
    takes the weights of ``weights.npz`` as its first argument. Loading
    needs ``medmoe_torch`` importable: the image program calls its
    registered expert-branch op."""
    # the programs call the registered op medmoe::expert_fusion_gather
    import medmoe_torch.ops.expert_fusion  # noqa: F401

    manifest = read_manifest(export_dir)
    device = device or manifest["platforms"][0]
    name = manifest[which]["file"][device]
    program = torch.export.load(os.path.join(export_dir, name)).module()
    program.requires_grad_(False)
    if manifest["weights"] == _WEIGHTS_NAME:
        weights = _tower_weights(load_weights(export_dir, device), which)
        return lambda *inputs: program(weights, *inputs)
    return program


def _roundtrip_check(model: nn.Module, export_dir: str, device: str,
                     size: int, t_len: int, vocab: int,
                     check_b: int) -> Dict[str, float]:
    """Load both programs of ``device`` and hold them against the live
    module on the same random inputs; returns each one's max abs error."""
    live = model if next(model.parameters()).device.type == device else \
        copy.deepcopy(model).to(device).eval()
    errs = {}
    for which, cls in (("image", ImageProgram), ("text", TextProgram)):
        inputs = _inputs(which, check_b, size, t_len, vocab, device, seed=1)
        with torch.no_grad():
            want = cls(live)(*inputs)
            got = call_exported(export_dir, which, device)(*inputs)
        err = float((got.float() - want).abs().max())
        if not err <= ROUNDTRIP_ATOL:
            raise AssertionError(
                f"exported {which} encoder on {device} diverges from the "
                f"live module (max abs err {err:.2e})")
        errs[which] = err
    return errs
