"""The port's LoRA layers (medmoe_torch/models/lora.py) against the JAX
package's (medmoe_tpu/models/lora.py) on the CPU.

Every layer, with r > 0 and r = 0, takes the same numpy inputs and the same
weights: JAX initializes, every leaf is then redrawn from a numpy seed (so
the zero-initialized ``lora_b`` is live) and carried over by
``bridge.from_jax_params`` with the strict check. ``merge_lora`` is held
against JAX's on the same factors (merged equals unmerged, the raise
without a scale, the merged-linear factors left intact), and
``lora_param_mask`` as a name set.

Tolerance: float32 throughout, rtol 1e-5 and atol 1e-5 — the two sides
sum the same products in different orders (one conv, one einsum), a few
ulps at these sizes.
"""

import jax
import numpy as np
import pytest
import torch

from medmoe_tpu.models import lora as jlora
from medmoe_torch import bridge
from medmoe_torch.models import lora as tlora

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def redraw(tree, seed):
    """Every leaf redrawn from ``seed``: kernels at 1/sqrt(fan_in), LoRA
    factors at 0.3 (so B @ A is live), the rest at 0.1."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = np.shape(leaf)
        scale = 0.1
        if name in ("kernel", "embedding"):
            scale = 1.0 / np.sqrt(max(int(np.prod(shape[:-1])), 1))
        elif name.startswith("lora_"):
            scale = 0.3
        return np.asarray(rng.randn(*shape) * scale, np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def carried(jmodule, tmodule, inputs, seed=0, **kw):
    """(JAX params redrawn, the port module loaded from them)."""
    params = redraw(jax.device_get(jmodule.init(jax.random.PRNGKey(0),
                                                *inputs, **kw)["params"]),
                    seed)
    bridge.load_jax_params(tmodule, flat(params))
    return params, tmodule.eval()


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("r", [0, 3])
def test_linear(r):
    x = np.random.RandomState(1).randn(4, 6, 5).astype(np.float32)
    jm = jlora.LoRALinear(7, r=r, alpha=6)
    params, tm = carried(jm, tlora.LoRALinear(5, 7, r=r, alpha=6), (x,))
    want = jm.apply({"params": params}, x)
    np.testing.assert_allclose(tm(t(x)).detach().numpy(), want, **TOL)


@pytest.mark.parametrize("r", [0, 3])
def test_embedding(r):
    ids = np.random.RandomState(2).randint(0, 11, (3, 5)).astype(np.int32)
    jm = jlora.LoRAEmbedding(num_embeddings=11, features=6, r=r, alpha=6)
    params, tm = carried(jm, tlora.LoRAEmbedding(11, 6, r=r, alpha=6), (ids,))
    want = jm.apply({"params": params}, ids)
    got = tm(t(ids).long()).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)


# (kernel, strides, padding, input side): SAME on an even input at stride
# 2 pads (0, 1) around a 3×3 and (2, 3) around a 7×7; an odd input pads
# symmetrically; explicit padding as flax takes it
CONVS = [((3, 3), (2, 2), "SAME", 8), ((7, 7), (2, 2), "SAME", 10),
         ((3, 3), (1, 1), "SAME", 7), ((1, 1), (2, 2), "SAME", 6),
         ((3, 3), (2, 2), ((1, 1), (1, 1)), 8)]


@pytest.mark.parametrize("r", [0, 2])
@pytest.mark.parametrize("kernel,strides,padding,side", CONVS)
def test_conv(r, kernel, strides, padding, side):
    x = np.random.RandomState(3).randn(2, side, side, 3).astype(np.float32)
    jm = jlora.LoRAConv(5, kernel, strides, padding=padding, r=r, alpha=4)
    tm = tlora.LoRAConv(3, 5, kernel, strides, padding=padding, r=r, alpha=4)
    params, tm = carried(jm, tm, (x,))
    want = np.asarray(jm.apply({"params": params}, x)).transpose(0, 3, 1, 2)
    got = tm(t(x).permute(0, 3, 1, 2)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_same_padding_is_xla_s():
    """The pads themselves: ceil(in / stride) outputs, the odd pixel
    after (what nn.Conv2d(padding=k // 2) gets wrong on even inputs)."""
    assert tlora.same_padding((38, 38), (3, 3), (2, 2)) == (0, 1, 0, 1)
    assert tlora.same_padding((64, 64), (7, 7), (2, 2)) == (2, 3, 2, 3)
    assert tlora.same_padding((299, 299), (7, 7), (2, 2)) == (3, 3, 3, 3)
    assert tlora.same_padding((75, 75), (3, 3), (2, 2)) == (1, 1, 1, 1)
    assert tlora.same_padding((5, 6), (1, 1), (2, 2)) == (0, 0, 0, 0)


@pytest.mark.parametrize("r,enable", [(0, (True, False, True)),
                                      (2, (True, False, True)),
                                      (2, (False, True, False))])
def test_merged_linear(r, enable):
    x = np.random.RandomState(4).randn(3, 5).astype(np.float32)
    jm = jlora.LoRAMergedLinear(12, enable_lora=enable, r=r, alpha=3)
    params, tm = carried(jm, tlora.LoRAMergedLinear(5, 12, enable, r=r,
                                                    alpha=3), (x,))
    want = jm.apply({"params": params}, x)
    np.testing.assert_allclose(tm(t(x)).detach().numpy(), want, **TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("r", [0, 4])
def test_multihead_attention(r, masked):
    rng = np.random.RandomState(5)
    q = rng.randn(2, 5, 8).astype(np.float32)
    kv = rng.randn(2, 7, 8).astype(np.float32)
    mask = rng.rand(2, 1, 5, 7) > 0.3 if masked else None
    jm = jlora.LoRAMultiheadAttention(8, 2, r=r, alpha=8)
    params, tm = carried(jm, tlora.LoRAMultiheadAttention(8, 2, r=r, alpha=8),
                         (q, kv, kv))
    want = jm.apply({"params": params}, q, kv, kv, mask)
    got = tm(t(q), t(kv), t(kv), None if mask is None else t(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


class Adapted(torch.nn.Module):
    """Every LoRA kind under the JAX tree's names."""

    def __init__(self):
        super().__init__()
        self.lin = tlora.LoRALinear(5, 7, r=2, alpha=6)
        self.emb = tlora.LoRAEmbedding(11, 6, r=3, alpha=6)
        self.conv = tlora.LoRAConv(3, 4, (3, 3), (2, 2), r=2, alpha=6)
        self.merged = tlora.LoRAMergedLinear(5, 12, r=2, alpha=6)


def _adapted_pair():
    """The JAX params of each kind (redrawn) and the port's ``Adapted``."""
    rng = np.random.RandomState(6)
    x = rng.randn(3, 5).astype(np.float32)
    ids = rng.randint(0, 11, (2, 4)).astype(np.int32)
    img = rng.randn(1, 8, 8, 3).astype(np.float32)
    mods = {"lin": (jlora.LoRALinear(7, r=2, alpha=6), x),
            "emb": (jlora.LoRAEmbedding(11, 6, r=3, alpha=6), ids),
            "conv": (jlora.LoRAConv(4, (3, 3), (2, 2), r=2, alpha=6), img),
            "merged": (jlora.LoRAMergedLinear(12, r=2, alpha=6), x)}
    params = {k: redraw(jax.device_get(m.init(jax.random.PRNGKey(i), inp)[
        "params"]), 10 + i) for i, (k, (m, inp)) in enumerate(mods.items())}
    tm = Adapted()
    bridge.load_jax_params(tm, flat(params))
    return mods, params, tm


class TestMerge:
    @pytest.mark.parametrize("by", ["state_dict", "module"])
    def test_merged_equals_jax_merge_and_unmerged(self, by):
        mods, params, tm = _adapted_pair()
        # the adapters share alpha / r only per kind: fold each alone
        for name, scale in (("lin", 3.0), ("emb", 2.0), ("conv", 3.0)):
            sub = getattr(tm, name)
            merged = tlora.merge_lora(sub if by == "module"
                                      else sub.state_dict(), scale)
            assert not any("lora_" in k for k in merged)
            want = bridge.from_jax_params(flat(jlora.merge_lora(
                params[name], alpha_over_r=scale)))
            assert set(merged) == set(want)
            for k in want:
                np.testing.assert_allclose(merged[k].numpy(),
                                           want[k].numpy(), **TOL)
            jm, inp = mods[name]
            live = np.asarray(jm.apply({"params": params[name]}, inp))
            if name == "lin":
                plain = np.asarray(inp) @ merged["base.weight"].numpy().T \
                    + merged["base.bias"].numpy()
            elif name == "emb":
                plain = merged["base.weight"].numpy()[inp]
            else:                   # SAME at stride 2 on 8²: pads (0, 1)
                x = torch.nn.functional.pad(t(inp).permute(0, 3, 1, 2),
                                            (0, 1, 0, 1))
                plain = torch.nn.functional.conv2d(
                    x, merged["weight"], merged["bias"], 2).permute(
                    0, 2, 3, 1).numpy()
            np.testing.assert_allclose(plain, live, rtol=1e-4, atol=1e-5)

    def test_requires_the_scale(self):
        _, params, tm = _adapted_pair()
        with pytest.raises(ValueError, match="alpha_over_r"):
            jlora.merge_lora(params["lin"])
        with pytest.raises(ValueError, match="alpha_over_r"):
            tlora.merge_lora(tm.lin.state_dict())
        with pytest.raises(ValueError, match="alpha_over_r"):
            tlora.merge_lora(tm)

    def test_merged_linear_factors_stay(self):
        mods, params, tm = _adapted_pair()
        merged = tlora.merge_lora(tm.merged.state_dict(), 1.0)
        jmerged = jlora.merge_lora(params["merged"], alpha_over_r=1.0)
        assert "lora_a" in jmerged and "lora_b" in jmerged
        assert set(merged) == set(tm.merged.state_dict())
        x = t(mods["merged"][1])
        before = tm.merged(x)
        tm.merged.load_state_dict(merged)
        np.testing.assert_array_equal(tm.merged(x).detach().numpy(),
                                      before.detach().numpy())

    def test_square_table_needs_the_module(self):
        """A square LoRAEmbedding's factors fit a LoRALinear's shapes too:
        a bare state_dict raises, the module decides."""
        emb = tlora.LoRAEmbedding(6, 6, r=2, alpha=4)
        with torch.no_grad():
            for p in emb.parameters():
                p.copy_(torch.randn(p.shape))
        with pytest.raises(ValueError, match="pass the model"):
            tlora.merge_lora(emb.state_dict(), 2.0)
        merged = tlora.merge_lora(emb, 2.0)
        ids = torch.tensor([[0, 5, 3]])
        np.testing.assert_allclose(merged["base.weight"][ids].numpy(),
                                   emb(ids).detach().numpy(), **TOL)


def test_param_mask_is_jax_s():
    _, params, tm = _adapted_pair()
    jmask = flat(jax.tree_util.tree_map(
        lambda v: np.asarray(v), jlora.lora_param_mask(params)))
    shapes = flat(params)
    want = {bridge.torch_key(k, shapes[k].ndim)
            for k, v in jmask.items() if bool(v)}
    mask = tlora.lora_param_mask(tm.state_dict())
    assert set(mask) == set(tm.state_dict())
    assert {k for k, v in mask.items() if v} == want
    assert len(want) == 8


def test_init_distributions():
    """init_weights draws flax's distributions: he-normal LoRAConv kernel,
    he-uniform lora_a, zero lora_b; an embedding's zero lora_a and
    normal(1) lora_b."""
    from medmoe_torch.models.medmoe import init_weights

    m = Adapted()
    m.conv = tlora.LoRAConv(64, 96, (3, 3), r=8, alpha=16)
    init_weights(m, 0)
    fan_in = 3 * 3 * 64
    w = m.conv.weight.detach()
    assert abs(float(w.std()) / np.sqrt(2.0 / fan_in) - 1) < 0.05
    assert float(w.abs().max()) <= 2 * np.sqrt(2.0 / fan_in) \
        / .87962566103423978 + 1e-6
    limit = np.sqrt(6.0 / 8)
    a = m.conv.lora_a.detach()
    assert float(a.abs().max()) <= limit and float(a.abs().max()) > 0.9 * limit
    assert not m.conv.lora_b.any() and not m.lin.lora_b.any()
    assert not m.emb.lora_a.any() and m.emb.lora_b.abs().sum() > 0
