"""Plain reference of MedMoE for the benchmark's correctness check.

Float32 PyTorch with TF32 off: the Swin-T image tower, the router and the
expert branch (gather and top-k capacity dispatch), BERT with the last
layers summed and word pieces merged, the GLoRIA global and local losses
and the router loss. It follows the published MedMoE / GLoRIA description
as the port's plain modules compute it; its parameter names match the
port's, so one seeded weight dict fills both. It imports nothing of the
program.

``Numerics`` rounds the operands of every product: float32 (the
reference), or one precision below the configuration's bfloat16 (the
control): float8 e4m3 or int8, each with a per-tensor scale.

``Noise`` stands in for the program's training-mode noise (BERT's dropout,
Swin's drop-path): it draws each mask from a generator in the order the
program's forward draws them, keeps them, and replays them for a block of
rows, so the reference can recompute the forward in blocks.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
FP8_MAX = 448.0


class Numerics:
    """Operand rounding of the products: none (float32), "fp8" (e4m3 with
    a per-tensor scale) or "int8" (symmetric, a per-tensor scale)."""

    def __init__(self, low: Optional[str] = None):
        self.low = low

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.low is None:
            return x
        amax = x.detach().abs().amax().clamp(min=1e-30)
        if self.low == "int8":
            scale = amax / 127.0
            r = torch.round(x.detach() / scale).clamp(-127, 127) * scale
        else:
            scale = amax / FP8_MAX
            r = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (r - x).detach()

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor):
        return torch.einsum(eq, self.q(a), self.q(b))


class Noise:
    """Masks of the training-mode noise, drawn once in the program's order
    (``record``) and replayed for a block of rows (``replay``). Each tower
    keeps its own list; ``tower`` selects it."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.gen = generator
        self.masks: Dict[str, List[torch.Tensor]] = {"text": [], "image": []}
        self.rows: Optional[slice] = None
        self.tower = "text"
        self.i = 0

    def start(self, tower: str, rows: Optional[slice] = None) -> None:
        self.tower, self.rows, self.i = tower, rows, 0

    def keep(self, shape, p: float, device) -> torch.Tensor:
        if self.rows is None:
            m = torch.rand(shape, generator=self.gen, device=device) < 1.0 - p
            self.masks[self.tower].append(m)
            return m
        m = self.masks[self.tower][self.i]
        self.i += 1
        return m[self.rows]


def _dropout(x, p, noise: Optional[Noise]):
    if noise is None or p == 0.0:
        return x
    m = noise.keep(x.shape, p, x.device)
    return torch.where(m, x / (1.0 - p), torch.zeros_like(x))


def _drop_path(x, rate, noise: Optional[Noise]):
    if noise is None or rate == 0.0:
        return x
    m = noise.keep((x.shape[0],) + (1,) * (x.ndim - 1), rate, x.device)
    return torch.where(m, x / (1.0 - rate), torch.zeros_like(x))


def _ln(x, mod, eps):
    return F.layer_norm(x, (x.shape[-1],), mod.weight, mod.bias, eps)


class Linear(nn.Module):
    def __init__(self, num: Numerics, i: int, o: int, bias: bool = True):
        super().__init__()
        self.num = num
        self.weight = nn.Parameter(torch.empty(o, i))
        self.bias = nn.Parameter(torch.empty(o)) if bias else None

    def forward(self, x):
        return F.linear(self.num.q(x), self.num.q(self.weight), self.bias)


class Norm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))


# ---------------------------------------------------------------------------
# Swin-T
# ---------------------------------------------------------------------------

def _rel_index(w: int) -> torch.Tensor:
    c = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    c = c.reshape(2, -1)
    r = (c[:, :, None] - c[:, None, :]).transpose(1, 2, 0) + (w - 1)
    return torch.from_numpy(r[..., 0] * (2 * w - 1) + r[..., 1]).reshape(-1)


def _shift_mask(h: int, w: int, win: int, shift: int) -> torch.Tensor:
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    img = img.reshape(h // win, win, w // win, win).transpose(0, 2, 1, 3)
    img = img.reshape(-1, win * win)
    return torch.from_numpy(np.where(img[:, None, :] != img[:, :, None],
                                     -100.0, 0.0).astype(np.float32))


def _windows(x, win):
    b, h, w, c = x.shape
    x = x.reshape(b, h // win, win, w // win, win, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, win * win, c)


def _unwindows(x, win, h, w):
    b = x.shape[0] // ((h // win) * (w // win))
    x = x.reshape(b, h // win, w // win, win, win, -1)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


class WindowAttention(nn.Module):
    def __init__(self, num, dim, heads, win):
        super().__init__()
        self.num, self.heads = num, heads
        self.query = Linear(num, dim, dim)
        self.key = Linear(num, dim, dim)
        self.value = Linear(num, dim, dim)
        self.proj = Linear(num, dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * win - 1) ** 2, heads))
        self.register_buffer("index", _rel_index(win), persistent=False)

    def forward(self, x, mask):
        nb, n, d = x.shape
        nh = self.heads
        hd = d // nh
        q = (self.query(x) * hd ** -0.5).reshape(nb, n, nh, hd)
        k = self.key(x).reshape(nb, n, nh, hd)
        v = self.value(x).reshape(nb, n, nh, hd)
        a = self.num.einsum("bqhd,bkhd->bhqk", q, k)
        bias = self.relative_position_bias_table[self.index]
        a = a + bias.reshape(n, n, nh).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            a = (a.reshape(nb // nw, nw, nh, n, n)
                 + mask[None, :, None]).reshape(nb, nh, n, n)
        a = torch.softmax(a, dim=-1)
        out = self.num.einsum("bhqk,bkhd->bqhd", a, v).reshape(nb, n, d)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, num, dim, hidden):
        super().__init__()
        self.fc1 = Linear(num, dim, hidden)
        self.fc2 = Linear(num, hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, num, dim, heads, win, shift, res, rate, eps):
        super().__init__()
        h, w = res
        self.res, self.win, self.rate, self.eps = res, win, rate, eps
        self.shift = shift if min(h, w) > win else 0
        self.norm1 = Norm(dim)
        self.attn = WindowAttention(num, dim, heads, win)
        self.norm2 = Norm(dim)
        self.mlp = Mlp(num, dim, 4 * dim)
        self.register_buffer(
            "mask", _shift_mask(h, w, win, self.shift) if self.shift else None,
            persistent=False)

    def forward(self, x, noise):
        h, w = self.res
        b, n, c = x.shape
        s = self.shift
        y = _ln(x, self.norm1, self.eps).reshape(b, h, w, c)
        if s:
            y = torch.roll(y, (-s, -s), (1, 2))
        y = _unwindows(self.attn(_windows(y, self.win), self.mask),
                       self.win, h, w)
        if s:
            y = torch.roll(y, (s, s), (1, 2))
        x = x + _drop_path(y.reshape(b, n, c), self.rate, noise)
        y = self.mlp(_ln(x, self.norm2, self.eps))
        return x + _drop_path(y, self.rate, noise)


class PatchMerging(nn.Module):
    def __init__(self, num, dim, res, eps):
        super().__init__()
        self.res, self.eps = res, eps
        self.norm = Norm(4 * dim)
        self.reduction = Linear(num, 4 * dim, 2 * dim, bias=False)

    def forward(self, x, noise):
        h, w = self.res
        b, _, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c)
        x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0],
                       x[:, :, 0, :, 1], x[:, :, 1, :, 1]], dim=-1)
        x = x.reshape(b, (h // 2) * (w // 2), 4 * c)
        return self.reduction(_ln(x, self.norm, self.eps))


class PatchEmbed(nn.Module):
    def __init__(self, num, dim, patch):
        super().__init__()
        self.num, self.patch = num, patch
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)
        self.norm = Norm(dim)


class Swin(nn.Module):
    def __init__(self, num, v):
        super().__init__()
        self.num = num
        self.eps = 1e-5
        embed = int(v["swin_embed_dim"])
        depths = list(v["swin_depths"])
        heads = list(v["swin_num_heads"])
        win = int(v["swin_window_size"])
        self.dims = [embed * 2 ** i for i in range(len(depths))]
        self.patch_embed = PatchEmbed(num, embed, 4)
        res = int(v["image_size"]) // 4
        total, idx = sum(depths), 0
        self.layout = []
        for s, depth in enumerate(depths):
            r = res // 2 ** s
            names = []
            for d in range(depth):
                rate = float(v["drop_path_rate"]) * idx / max(total - 1, 1)
                name = f"stage{s}_block{d}"
                self.add_module(name, SwinBlock(
                    num, self.dims[s], heads[s], win,
                    0 if d % 2 == 0 else win // 2, (r, r), rate, self.eps))
                names.append(name)
                idx += 1
            if s < len(depths) - 1:
                name = f"stage{s}_downsample"
                self.add_module(name, PatchMerging(num, self.dims[s], (r, r),
                                                   self.eps))
                names.append(name)
            self.layout.append(names)
        self.norm = Norm(self.dims[-1])

    def forward(self, x, noise):
        pe = self.patch_embed
        y = F.conv2d(self.num.q(x.permute(0, 3, 1, 2)),
                     self.num.q(pe.proj.weight), pe.proj.bias, stride=pe.patch)
        b, c, h, w = y.shape
        x = _ln(y.permute(0, 2, 3, 1).reshape(b, h * w, c), pe.norm, self.eps)
        pyramid = [x]
        for s, names in enumerate(self.layout):
            for name in names:
                x = getattr(self, name)(x, noise)
            if s < len(self.layout) - 1:
                pyramid.append(x)
        return pyramid, _ln(x, self.norm, self.eps)


# ---------------------------------------------------------------------------
# router and expert branch
# ---------------------------------------------------------------------------

class Experts(nn.Module):
    """``proj_w{s}`` [K, D_s, E], ``proj_b{s}`` [K, E], ``attn_w1`` [K, E,
    H], ``attn_b1`` [K, H], ``attn_w2`` [K, H, 1], ``attn_b2`` [K, 1]."""

    def __init__(self, num, k, dims, e):
        super().__init__()
        self.num = num
        self.n = len(dims)
        for s, d in enumerate(dims):
            self.register_parameter(f"proj_w{s}",
                                    nn.Parameter(torch.empty(k, d, e)))
            self.register_parameter(f"proj_b{s}",
                                    nn.Parameter(torch.empty(k, e)))
        self.attn_w1 = nn.Parameter(torch.empty(k, e, e // 2))
        self.attn_b1 = nn.Parameter(torch.empty(k, e // 2))
        self.attn_w2 = nn.Parameter(torch.empty(k, e // 2, 1))
        self.attn_b2 = nn.Parameter(torch.empty(k, 1))

    def branch(self, e: int, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Expert ``e`` on rows xs[s] [n, P_s, D_s] → the fused map [n, P,
        E]: each scale projected (+ReLU), linearly upsampled to the largest
        patch count, scored by the attention MLP, softmax over scales,
        weighted sum."""
        q = self.num.q
        p = max(x.shape[1] for x in xs)
        feats = []
        for s, x in enumerate(xs):
            w = getattr(self, f"proj_w{s}")[e]
            h = torch.relu(torch.matmul(q(x), q(w))
                           + getattr(self, f"proj_b{s}")[e])
            if h.shape[1] != p:
                h = F.interpolate(h.transpose(1, 2), size=p, mode="linear",
                                  align_corners=False).transpose(1, 2)
            feats.append(h)
        logits = []
        for h in feats:
            a = torch.relu(torch.matmul(q(h), q(self.attn_w1[e]))
                           + self.attn_b1[e])
            logits.append(torch.matmul(q(a), q(self.attn_w2[e]))[..., 0]
                          + self.attn_b2[e, 0])
        att = torch.softmax(torch.stack(logits, dim=-1), dim=-1)
        return sum(h * att[..., s, None] for s, h in enumerate(feats))


class MoE(nn.Module):
    def __init__(self, num, v, dims):
        super().__init__()
        self.k = int(v["num_experts"])
        self.top_k = int(v["router_top_k"])
        self.mode = str(v["moe_mode"])
        self.capacity_factor = float(v["capacity_factor"])
        e = int(v["embed_dim"])
        self.router_fc1 = Linear(num, dims[-1], 128)
        self.router_fc2 = Linear(num, 128, self.k)
        self.experts = Experts(num, self.k, dims, e)

    def plan(self, probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(expert ids [B, k], kept [B, k]): the top-k experts, equal
        probabilities in ascending expert order, and ``kept``."""
        _, order = torch.sort(probs, dim=-1, descending=True, stable=True)
        idx = order[:, :self.top_k]
        return idx, self.kept(idx)

    def kept(self, idx: torch.Tensor) -> torch.Tensor:
        """[B, k]: every assignment under ``gather``; under ``topk`` an
        assignment is kept while its expert's count of earlier assignments
        (sample-major) is under the capacity ceil(B·k·factor / K)."""
        if self.mode == "gather":
            return torch.ones_like(idx, dtype=torch.bool)
        b = idx.shape[0]
        cap = max(1, math.ceil(b * self.top_k * self.capacity_factor
                               / self.k))
        flat = F.one_hot(idx.reshape(-1), self.k)
        pos = ((torch.cumsum(flat, 0) - flat) * flat).sum(1)
        return (pos < cap).reshape(idx.shape)

    def follow_ties(self, probs: torch.Tensor, plan, other: torch.Tensor,
                    tie: float):
        """``plan`` (the reference's own), except in the rows where
        ``other`` (another side's expert ids [B, k]) picks, slot by slot,
        experts whose probabilities lie within ``tie`` of the reference's
        picks: a route that rounding may tip either way. There ``other``'s
        route is taken and the capacity worked out again. Returns (plan,
        the rows whose routes differ beyond the tie; all of them where
        ``other`` routes another number of rows)."""
        idx = plan[0]
        if other.shape != idx.shape:
            return plan, idx.shape[0]
        other = other.to(device=idx.device, dtype=idx.dtype)
        differ = (other != idx).any(dim=1)
        tied = ((torch.gather(probs, 1, idx) - torch.gather(probs, 1, other))
                .abs() <= tie).all(dim=1)
        idx = torch.where((differ & tied)[:, None], other, idx)
        return (idx, self.kept(idx)), int((differ & ~tied).sum())

    def forward(self, pyramid, final, plan=None):
        x = torch.relu(self.router_fc1(final.mean(dim=1)))
        probs = torch.softmax(self.router_fc2(x), dim=-1)
        idx, kept = self.plan(probs) if plan is None else plan
        vals = torch.gather(probs, 1, idx)
        weights = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
        b, p, e = pyramid[0].shape[0], pyramid[0].shape[1], \
            self.experts.attn_w1.shape[1]
        fused = pyramid[0].new_zeros(b, p, e)
        for j in range(idx.shape[1]):
            for ex in range(self.k):
                rows = torch.nonzero((idx[:, j] == ex) & kept[:, j])[:, 0]
                if rows.numel() == 0:
                    continue
                out = self.experts.branch(ex, [f[rows] for f in pyramid])
                if self.top_k > 1:
                    out = out * weights[rows, j, None, None]
                fused = fused.index_add(0, rows, out)
        hw = int(round(p ** 0.5))
        local = fused.permute(0, 2, 1).reshape(b, e, hw, hw)
        return fused.mean(dim=1), local, probs, (idx, kept)


class ImageTower(nn.Module):
    def __init__(self, num, v):
        super().__init__()
        self.swin = Swin(num, v)
        self.moe = MoE(num, v, self.swin.dims)

    def forward(self, images, noise, plan=None):
        mean, std = (torch.tensor(t, device=images.device) for t in IMAGENET)
        x = (images.float() / 255.0 - mean) / std
        pyramid, final = self.swin(x, noise)
        return self.moe(pyramid, final, plan)


# ---------------------------------------------------------------------------
# BERT and the text tower
# ---------------------------------------------------------------------------

class BertEmbeddings(nn.Module):
    def __init__(self, t):
        super().__init__()
        d = int(t["hidden_size"])
        self.word_embeddings = nn.Embedding(int(t["vocab_size"]), d)
        self.position_embeddings = nn.Embedding(
            int(t["max_position_embeddings"]), d)
        self.token_type_embeddings = nn.Embedding(2, d)
        self.norm = Norm(d)


class BertSelfAttention(nn.Module):
    def __init__(self, num, d, heads):
        super().__init__()
        self.num, self.heads = num, heads
        self.query = Linear(num, d, d)
        self.key = Linear(num, d, d)
        self.value = Linear(num, d, d)


class BertLayer(nn.Module):
    def __init__(self, num, t):
        super().__init__()
        d, f = int(t["hidden_size"]), int(t["intermediate_size"])
        self.attention = BertSelfAttention(num, d, int(t["num_heads"]))
        self.attention_output = Linear(num, d, d)
        self.attention_norm = Norm(d)
        self.intermediate = Linear(num, d, f)
        self.output = Linear(num, f, d)
        self.output_norm = Norm(d)


class Bert(nn.Module):
    def __init__(self, num, t):
        super().__init__()
        self.num = num
        self.eps = 1e-12
        self.p_hidden = float(t["hidden_dropout_prob"])
        self.p_attn = float(t["attention_probs_dropout_prob"])
        self.layers = int(t["num_layers"])
        self.embeddings = BertEmbeddings(t)
        for i in range(self.layers):
            self.add_module(f"layer_{i}", BertLayer(num, t))
        d = int(t["hidden_size"])
        self.pooler = Linear(num, d, d)

    def forward(self, ids, mask, types, noise):
        e = self.embeddings
        t = ids.shape[1]
        x = (e.word_embeddings(ids.long())
             + e.position_embeddings.weight[None, :t]
             + e.token_type_embeddings(types.long()))
        x = _dropout(_ln(x, e.norm, self.eps), self.p_hidden, noise)
        add = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).float()
        states = [x]
        for i in range(self.layers):
            layer = getattr(self, f"layer_{i}")
            sa = layer.attention
            b, _, d = x.shape
            nh = sa.heads
            hd = d // nh
            q = sa.query(x).reshape(b, t, nh, hd)
            k = sa.key(x).reshape(b, t, nh, hd)
            v = sa.value(x).reshape(b, t, nh, hd)
            a = self.num.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd) + add
            a = _dropout(torch.softmax(a, dim=-1), self.p_attn, noise)
            ctx = self.num.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, t, d)
            y = _dropout(layer.attention_output(ctx), self.p_hidden, noise)
            x = _ln(x + y, layer.attention_norm, self.eps)
            y = layer.output(F.gelu(layer.intermediate(x)))
            x = _ln(x + _dropout(y, self.p_hidden, noise), layer.output_norm,
                    self.eps)
            states.append(x)
        return states


class TextTower(nn.Module):
    def __init__(self, num, t):
        super().__init__()
        self.last_n = int(t["last_n_layers"])
        self.bert = Bert(num, t)

    def forward(self, ids, mask, types, segs, noise):
        """(words [B, D, T], sentence [B, D]): the last layers stacked,
        word pieces summed into their word's slot, summed over layers; the
        sentence the mean over all T slots."""
        states = self.bert(ids, mask, types, noise)
        stacked = torch.stack(states[-self.last_n:], dim=1)        # [B,L,T,D]
        t = ids.shape[1]
        onehot = (segs[:, :, None] == torch.arange(t, device=segs.device)
                  ).float()
        merged = torch.einsum("bts,bltd->blsd", onehot, stacked)
        return merged.sum(1).permute(0, 2, 1), merged.mean(2).sum(1)


class MedMoE(nn.Module):
    """Parameters named as the port's ``MedMoE``: ``image_encoder.swin_moe``
    and ``text_encoder``."""

    def __init__(self, config: dict, low: Optional[str] = None):
        super().__init__()
        self.num = Numerics(low)
        self.image_encoder = nn.Module()
        self.image_encoder.swin_moe = ImageTower(self.num, config["vision"])
        self.text_encoder = TextTower(self.num, config["text"])

    def image(self, images, noise=None, rows=None, plan=None):
        if noise is not None:
            noise.start("image", rows)
        return self.image_encoder.swin_moe(images, noise, plan)

    def text(self, batch, noise=None, rows=None):
        if noise is not None:
            noise.start("text", rows)
        sl = slice(None) if rows is None else rows
        return self.text_encoder(
            batch["input_ids"][sl], batch["attention_mask"][sl],
            batch["token_type_ids"][sl], batch["segment_ids"][sl], noise)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _safe_norm(x, dim=-1, keepdim=True):
    return torch.sqrt(torch.clamp(torch.sum(x * x, dim=dim, keepdim=keepdim),
                                  min=1e-24))


def _xent_diag(logits):
    return -torch.diagonal(torch.log_softmax(logits, dim=-1)).sum() \
        / logits.shape[0]


def global_loss(img_g, txt_g, temp3, num: Numerics):
    s = num.q(img_g) @ num.q(txt_g).T
    s = s / torch.clamp(_safe_norm(img_g) @ _safe_norm(txt_g).T, min=1e-8)
    s = s * temp3
    return _xent_diag(s) + _xent_diag(s.T)


def _local_block(ctx, words, mask, t1, t2, t3, num):
    """ctx [Bi, D, M], words [c, D, T], mask [c, T] → [c, Bi]: temp3 · log
    Σ_valid exp(temp2 · cos(word, its attended context))."""
    s = num.einsum("bdm,idt->ibmt", ctx, words)
    s = torch.where(mask[:, None, None, :], s, -1e30)
    a = torch.softmax(s, dim=-1)
    a = torch.softmax(a * t1, dim=-2)
    wei = num.einsum("bdm,ibmt->ibdt", ctx, a)
    w = words[:, None]
    cos = torch.sum(w * wei, dim=2) / torch.clamp(
        _safe_norm(w, 2, False) * _safe_norm(wei, 2, False), min=1e-8)
    r = torch.where(mask[:, None, :], torch.exp(cos * t2), 0.0)
    return torch.log(r.sum(-1)) * t3


def local_loss(img_l, words, cap_lens, t1, t2, t3, num,
               budget: int = 160 << 20):
    """The symmetric cross entropy of the [B, B] local similarity. Captions
    go in order of length, in blocks of at most ``budget`` elements of the
    [c, B, M, T] scores, each block cut to its longest caption (the words
    past a caption's length take no part) and checkpointed."""
    from torch.utils.checkpoint import checkpoint

    bi, d, h, w = img_l.shape
    t = words.shape[-1]
    ctx = img_l.reshape(bi, d, h * w)
    mask = torch.arange(t, device=cap_lens.device)[None, :] < cap_lens[:, None]
    order = torch.argsort(cap_lens, stable=True)
    lens = cap_lens[order].tolist()
    blocks, i = [], 0
    while i < len(lens):
        j = i + 1
        while j < len(lens) and (j + 1 - i) * bi * h * w * lens[j] <= budget:
            j += 1
        rows, tm = order[i:j], max(1, lens[j - 1])
        blocks.append(checkpoint(
            lambda wc, mc: _local_block(ctx, wc, mc, t1, t2, t3, num),
            words[rows][:, :, :tm], mask[rows][:, :tm], use_reentrant=False))
        i = j
    sim = torch.cat(blocks, 0)[torch.argsort(order)].T            # [img, txt]
    return _xent_diag(sim) + _xent_diag(sim.T)


def router_loss(probs, labels):
    """Cross entropy over the already-softmaxed router outputs (the
    reference MedMoE's double softmax); a label past the experts selects
    nothing."""
    lp = torch.log_softmax(probs, dim=-1)
    onehot = (labels.long()[:, None]
              == torch.arange(lp.shape[1], device=lp.device)).float()
    return -torch.mean(torch.sum(lp * onehot, dim=1))


def total_loss(outs, batch, loss_cfg, num):
    img_g, img_l, probs, txt_l, txt_g = outs
    t1, t2, t3 = (float(loss_cfg[k]) for k in ("temp1", "temp2", "temp3"))
    ll = local_loss(img_l, txt_l, batch["cap_lens"], t1, t2, t3, num)
    gl = global_loss(img_g, txt_g, t3, num)
    cl = router_loss(probs, batch["label"])
    return (float(loss_cfg["local_loss_weight"]) * ll
            + float(loss_cfg["global_loss_weight"]) * gl
            + float(loss_cfg["classifier_loss_weight"]) * cl)
