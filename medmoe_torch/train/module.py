"""Pretraining task module: the losses around the MedMoE model
(counterpart of medmoe_tpu/train/module.py; reference
src/models/medmoe_module.py:172-339).

    loss = local_w · (local.loss0 + local.loss1)
         + global_w · global_loss
         + classifier_w · CE(router_probs, modality_label)

Freezing (``freeze_bert`` / ``freeze_cnn``) sets ``requires_grad=False`` on
the tower: autograd then skips its backward, and the optimizer holds no
state for it. ``block_size`` computes the contrastive losses on blocks of
the batch and averages them — the per-rank losses of the reference's DDP
runs; ``global_negatives`` uses the whole batch instead.

Under a process group of n ranks (data-parallel training, ``train/loop.py``)
the losses are the JAX package's over the global batch, the ranks' batches
in rank order:

- without blocks (``global_negatives``, or a ``block_size`` that covers the
  global batch), the codes, the words and the caption lengths are gathered
  from every rank (GLOBAL backprop, ``parallel/collectives.py``); each rank
  computes its own images' rows of the local similarity against all
  captions (K3 on a [B/n, B] shape on the card), gathers the rows into the
  [B, B] matrix and takes both cross entropies on it. Every rank computes
  the same loss; the gathers' backward sums the ranks' cotangents, and the
  data-parallel mean of the gradients is then the global batch's gradient;
- with blocks, each rank computes its own blocks, with no gather. A block
  must lie within one rank: a ``block_size`` that does not divide the
  per-rank batch raises.

Under expert parallelism (a d × e grid, ``parallel/mesh.py``) the n above
is d: the gathers and their GLOBAL backward run over the rank's data
group, since the e ranks of an expert group hold the same rows (a gather
over every rank would repeat each row e times and scale the gradients
by e).

Soft labels (``soft_label: true``, reference medmoe_module.py:207-282): a
tool BERT scores the batch's captions against each other — the CLS row of
its last hidden state, float32, L2-normalized, f·fᵀ — and the losses that
read these scores (``reads_scores``: the soft global and local losses)
split each anchor's candidates by ``threshold0``/``threshold1``. The tool
runs with dropout off, even inside a training step, and without
gradients. With ``freeze_bert: false`` it is a snapshot of the initial
BERT (``capture_tool_params``, taken by the trainer right after the seeded
init and before a checkpoint restore), kept outside ``model``: in no
``state_dict``, checkpoint, optimizer or DDP wrapper. With
``freeze_bert: true`` it is the live, frozen BERT. Under a process group
each rank's CLS features are gathered over the data group, so every rank
scores the global batch. The scores span the whole batch the loss sees,
so blocks smaller than it raise (JAX fails there with a shape error).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch

from medmoe_torch.config import DotDict
from medmoe_torch.models.bert import BertModel
from medmoe_torch.models.layers import safe_norm
from medmoe_torch.models.medmoe import (MedMoE, check_tower_widths,
                                        init_weights)
from medmoe_torch.models.moe import ExpertBank
from medmoe_torch.ops import expert_fusion, gloria_attention
from medmoe_torch.ops import losses as L
from medmoe_torch.parallel import collectives as C
from medmoe_torch.parallel.mesh import get_grid
from medmoe_torch.train.optim import Adam, adam
from medmoe_torch.utils.instantiate import instantiate
from medmoe_torch.utils.trace import span

_LOSS_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


class MedMoEPretrainingModule:
    def __init__(self, model: Any, loss: Any, optimizer: Any = None,
                 scheduler: Any = None):
        # `model` arrives instantiated (the config's nested `_target_`) or
        # as a config node with vision/text groups; `optimizer` and
        # `scheduler` arrive as partials
        self.loss_cfg = loss if isinstance(loss, DotDict) else DotDict(loss)
        self.optimizer_factory = optimizer
        self.scheduler_factory = scheduler
        if isinstance(model, MedMoE):
            self.model = model
        else:
            cfg = model if isinstance(model, DotDict) else DotDict(model)
            self.model = MedMoE(vision=cfg.vision if "vision" in cfg else cfg,
                                text=cfg.text)
        self.vision_cfg = self.model.vision
        self.text_cfg = self.model.text
        check_tower_widths(self.model, "pretraining", local=True)

        self.global_loss = instantiate(self.loss_cfg.get("global_loss")) \
            or L.GLORIAGlobalContrastiveLoss()
        self.local_loss = instantiate(self.loss_cfg.get("local_loss")) \
            or L.GLORIALocalContrastiveLoss()
        self.local_w = float(self.loss_cfg.get("local_loss_weight", 0.4))
        self.global_w = float(self.loss_cfg.get("global_loss_weight", 0.4))
        self.classifier_w = float(self.loss_cfg.get("classifier_loss_weight",
                                                    0.2))
        self.temp1 = float(self.loss_cfg.get("temp1", 4.0))
        self.temp2 = float(self.loss_cfg.get("temp2", 5.0))
        self.temp3 = float(self.loss_cfg.get("temp3", 10.0))
        self.agg = self.loss_cfg.get("agg", "sum")
        self.soft_label = bool(self.loss_cfg.get("soft_label", False))
        self.thresholds = (float(self.loss_cfg.get("threshold0", 0.98)),
                           float(self.loss_cfg.get("threshold1", 0.97)))
        #: the tool BERT's scores are computed only for a loss that reads
        #: them (JAX's XLA drops them as dead code otherwise)
        self.reads_scores = self.soft_label and any(
            getattr(fn, "reads_scores", False)
            for fn in (self.global_loss, self.local_loss))
        #: when BERT trains, a snapshot of its initial weights scores
        self.uses_tool_bert = self.soft_label and not bool(
            self.text_cfg.get("freeze_bert", False))
        self.tool_bert: Optional[BertModel] = None
        self.block_size = self.loss_cfg.get("block_size", None)
        if bool(self.loss_cfg.get("global_negatives", False)):
            self.block_size = None
        #: the data-parallel wrapper of ``model`` that training steps run
        #: through (set by the trainer under a process group)
        self.ddp = None
        # local-loss inputs ride in the towers' compute dtype unless
        # loss.loss_dtype overrides it (null → float32)
        ldt = self.loss_cfg.get("loss_dtype",
                                self.vision_cfg.get("dtype", "bfloat16"))
        if isinstance(ldt, torch.dtype):
            ldt = str(ldt).replace("torch.", "")
        self.loss_dtype = _LOSS_DTYPES.get(ldt)
        self._freeze()

    # ------------------------------------------------------------------
    def init_params(self, seed: int) -> None:
        """Fill the model's parameters from ``seed`` (flax's initializer
        distributions; ``models.medmoe.init_weights``)."""
        init_weights(self.model, seed)

    def _freeze(self) -> None:
        if self.text_cfg.get("freeze_bert", False):
            self.model.text_encoder.bert.requires_grad_(False)
        if self.vision_cfg.get("freeze_cnn", False):
            self.model.image_encoder.requires_grad_(False)

    def capture_tool_params(self, device=None) -> None:
        """Snapshot the BERT weights as the soft-label tool (when BERT
        trains; once): a copy outside ``model``, without gradients, in
        eval mode, moved to ``device``. The trainer calls it right after
        the seeded init, before a checkpoint restore."""
        if not self.uses_tool_bert or self.tool_bert is not None:
            return
        live = self.model.text_encoder.bert
        tool = BertModel(live.config)
        tool.load_state_dict(live.state_dict())
        tool.requires_grad_(False).eval()
        self.tool_bert = tool if device is None else tool.to(device)

    def soft_targets(self, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Tuple[float, float]]:
        """(scores [B, B] float32, (threshold0, threshold1)): the tool
        BERT's CLS cosines over the batch the losses see (under a process
        group the data group's global batch), with dropout off and no
        gradient (medmoe_tpu/train/module.py:136-160). The tool is the
        snapshot, or the live BERT when there is none."""
        bert = self.tool_bert if self.tool_bert is not None \
            else self.model.text_encoder.bert
        with torch.no_grad(), _eval_mode(bert):
            last, _, _ = bert(batch["input_ids"], batch["attention_mask"],
                              batch["token_type_ids"])
            f = last[:, 0].float()
            f = f / safe_norm(f)
            if self._gathers(f.shape[0]):
                f = C.gather_tensor(f, C.BackpropType.NONE,
                                    get_grid().data_group)
            return f @ f.T, self.thresholds

    def check_blocks(self, batch_size: Optional[int]) -> None:
        """Raise ValueError when a loss that reads the soft-label scores
        would run on blocks smaller than the batch it sees (per-rank or
        per-micro blocks): the scores span that whole batch."""
        if not self.reads_scores or batch_size is None:
            return
        bs = self.block_size
        seen = batch_size * get_grid().data
        if bs and not self._gathers(batch_size) and int(bs) < seen:
            raise ValueError(
                f"loss.block_size={bs} cuts the batch of {seen} pairs the "
                f"losses see into blocks, but a soft-label loss scores the "
                f"whole batch (its [B, B] tool-BERT targets): set "
                f"block_size >= {seen} or global_negatives: true")

    def check_kernel_limits(self, batch_size: Optional[int] = None) -> None:
        """Raise ValueError before the first step on a card when a kernel
        that the step would launch does not take the model's shapes: the
        expert branch's K1/K2 (bf16 expert banks) at the banks' widths, and
        the GLoRIA kernels, when the local loss would take its fused path
        at this batch size (None: any), at the local map's width, the text
        ``max_length`` and the loss's temp1."""
        for m in self.model.modules():
            if isinstance(m, ExpertBank) and m.config.dtype == torch.bfloat16:
                e = m.config.output_dim
                expert_fusion.check_kernel_limits(e, e // 2,
                                                  m.config.hidden_dims)
        if not isinstance(self.local_loss, L.GLORIALocalContrastiveLoss):
            return
        batch = batch_size
        if batch is not None:
            if self._gathers(batch):
                batch *= get_grid().data
            elif self.block_size:
                batch = min(batch, int(self.block_size))
        if self.local_loss.impl_for(self.agg, batch, True) == "pallas":
            d = self.model.image_encoder.feature_dims[1]
            gloria_attention.check_kernel_limits(
                d, int(self.text_cfg.get("max_length", 25)), self.temp1)

    def trainable_mask(self) -> Dict[str, bool]:
        """Parameter name → trainable (False on frozen towers)."""
        return {n: p.requires_grad for n, p in self.model.named_parameters()}

    def _gathers(self, batch: int) -> bool:
        """True when, under a process group, the losses of a per-rank batch
        of ``batch`` pairs span the global batch (gathered from every rank
        of the data group); False outside a group and for per-rank blocks.
        Raises for a block that would span two data ranks."""
        if not C.in_group():
            return False
        bs = self.block_size
        if not bs or int(bs) >= batch * get_grid().data:
            return True
        if batch % int(bs):
            raise ValueError(
                f"loss.block_size={bs} does not divide the per-rank batch "
                f"{batch}: a block must lie within one rank's rows (a block "
                f"across ranks is not supported)")
        return False

    def _global_losses(self, img_g, img_l, txt_g, txt_l, cap_lens, local_fn,
                       global_fn, scores=None, thresholds=None):
        """(local, global) loss over the global batch under a process
        group: each rank's image rows of the local similarity against
        every data rank's captions, gathered into the [B, B] matrix and
        scored by the local loss's ``pair_losses``."""
        G = C.BackpropType.GLOBAL
        group = get_grid().data_group

        def gather(x, kind=G):
            return C.gather_tensor(x, kind, group)

        words = gather(txt_l)
        caps = gather(cap_lens, C.BackpropType.NONE)
        if hasattr(self.local_loss, "similarities"):
            with span("medmoe#loss.local"):
                rows = self.local_loss.similarities(
                    img_l, words, caps, temp1=self.temp1, temp2=self.temp2,
                    temp3=self.temp3, agg=self.agg, batch=words.shape[0])
                sim = gather(rows)                           # [B, B]
                loss0, loss1 = self.local_loss.pair_losses(sim, scores,
                                                           thresholds)
                l_loss = loss0 + loss1
        else:
            l_loss = local_fn(gather(img_l), words, caps)
        g_loss = global_fn(gather(img_g), gather(txt_g))
        return l_loss, g_loss

    def _blocked(self, fn, *tensors):
        """A loss over blocks of ``block_size`` rows, averaged (per-rank DDP
        loss semantics); the whole batch when unset or not smaller."""
        bs = self.block_size
        b = tensors[0].shape[0]
        if not bs or bs >= b:
            return fn(*tensors)
        nb = b // bs
        blocked = [t.reshape((nb, bs) + tuple(t.shape[1:])) for t in tensors]
        return torch.stack([fn(*[t[i] for t in blocked])
                            for i in range(nb)]).mean()

    # ------------------------------------------------------------------
    def loss_fn(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Forward + losses. Train or eval mode (dropout, drop-path) is the
        model's own ``training`` flag. Returns (loss, metrics), every metric
        a 0-d device tensor. A step that needs gradients runs through the
        data-parallel wrapper when the trainer set one."""
        run = self.ddp if self.ddp is not None and torch.is_grad_enabled() \
            else self.model
        img_g, img_l, txt_g, txt_l, router_probs = run(batch)
        cap_lens = batch["cap_lens"]
        scores = thresholds = None
        if self.reads_scores:
            self.check_blocks(img_l.shape[0])
            scores, thresholds = self.soft_targets(batch)

        def local_fn(il, tl, cl):
            with span("medmoe#loss.local"):
                out = self.local_loss(il, tl, cl, temp1=self.temp1,
                                      temp2=self.temp2, temp3=self.temp3,
                                      agg=self.agg, scores=scores,
                                      thresholds=thresholds)
                return out.loss0 + out.loss1

        def global_fn(ig, tg):
            with span("medmoe#loss.global"):
                return self.global_loss(ig, tg, temp3=self.temp3,
                                        scores=scores, thresholds=thresholds)

        if self.loss_dtype is not None:
            img_l = img_l.to(self.loss_dtype)
            txt_l = txt_l.to(self.loss_dtype)
        if self._gathers(img_l.shape[0]):
            l_loss, g_loss = self._global_losses(img_g, img_l, txt_g, txt_l,
                                                 cap_lens, local_fn,
                                                 global_fn, scores,
                                                 thresholds)
        else:
            l_loss = self._blocked(local_fn, img_l, txt_l, cap_lens)
            g_loss = self._blocked(global_fn, img_g, txt_g)

        if router_probs is not None and "label" in batch:
            with span("medmoe#loss.router"):
                c_loss = L.router_classification_loss(router_probs,
                                                       batch["label"])
                c_acc = L.router_accuracy(router_probs, batch["label"])
        else:
            c_loss = torch.zeros((), device=img_g.device)
            c_acc = torch.zeros((), device=img_g.device)

        loss = (self.local_w * l_loss + self.global_w * g_loss
                + self.classifier_w * c_loss)
        metrics = {"loss": loss, "l_loss": l_loss, "g_loss": g_loss,
                   "c_loss": c_loss, "c_acc": c_acc}
        return loss, {k: v.detach() for k, v in metrics.items()}

    # ------------------------------------------------------------------
    def make_optimizer(self, gradient_clip_val: Optional[float] = None
                       ) -> Adam:
        if self.optimizer_factory is None:
            return adam(gradient_clip_val=gradient_clip_val)
        return self.optimizer_factory(gradient_clip_val=gradient_clip_val)

    def make_scheduler(self):
        return self.scheduler_factory() if self.scheduler_factory else None


@contextlib.contextmanager
def _eval_mode(module: torch.nn.Module):
    """``module`` in eval mode (dropout off) inside the block, its own mode
    restored after."""
    was = module.training
    module.eval()
    try:
        yield
    finally:
        module.train(was)
