"""The port's transformer components (medmoe_torch/models/transformer.py)
against the JAX package's (medmoe_tpu/models/transformer.py) on the CPU.

Weights: JAX initializes, every leaf is redrawn from a numpy seed, and
``bridge.from_jax_params`` carries them over with the strict check.

  * ``scaled_dot_product_attention`` with boolean attention masks (a fully
    masked row included) and head masks; split/merge and ``shift_dim``;
  * the encoder, pre- and post-norm, with a padding mask, every hidden
    state and attention map; ``SelfAttention`` over a 2-d grid, causal;
  * the decoder: the whole sequence under a causal mask against JAX's,
    and decoding token by token through the explicit cache against both
    (JAX's through its flax ``cache`` collection);
  * ``FLAVATransformerWithoutEmbeddings`` (CLS, final norm, pooler).

Tolerance: float32, rtol 1e-5 and atol 1e-5 (two layers of width 16: the
same sums in another order; flax's LayerNorm takes a one-pass variance);
token-by-token decoding against the whole sequence 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medmoe_tpu.models import transformer as jt
from medmoe_torch import bridge
from medmoe_torch.models import transformer as tt
from tests.test_torch_lora import flat, redraw

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
D, H = 16, 4


def t(x):
    return torch.from_numpy(np.array(x))


def load(jmodule, tmodule, *inputs, seed=0, **kw):
    params = redraw(jax.device_get(jmodule.init(jax.random.PRNGKey(0),
                                                *inputs, **kw)["params"]),
                    seed)
    bridge.load_jax_params(tmodule, flat(params))
    return params, tmodule.eval()


def seq(b, n, seed):
    return np.random.RandomState(seed).randn(b, n, D).astype(np.float32)


@pytest.mark.parametrize("masks", ["none", "attention", "both"])
def test_scaled_dot_product_attention(masks):
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(2, H, 5, 4).astype(np.float32) for _ in range(3))
    am = hm = None
    if masks != "none":
        am = rng.rand(2, 1, 5, 5) > 0.4
        am[0, 0, 2] = False                       # a fully masked row
    if masks == "both":
        hm = rng.rand(1, H, 1, 1).astype(np.float32)
    out, attn = jt.scaled_dot_product_attention(q, k, v, am, hm)
    tout, tattn = tt.scaled_dot_product_attention(
        t(q), t(k), t(v), None if am is None else t(am),
        None if hm is None else t(hm))
    np.testing.assert_allclose(tout.numpy(), out, **TOL)
    np.testing.assert_allclose(tattn.numpy(), attn, **TOL)


def test_heads_and_shift():
    x = np.random.RandomState(2).randn(2, 5, D).astype(np.float32)
    split = jt.split_multihead(jnp.asarray(x), H)
    np.testing.assert_array_equal(tt.split_multihead(t(x), H).numpy(), split)
    np.testing.assert_array_equal(tt.merge_multihead(t(np.asarray(split)))
                                  .numpy(), x)
    y = np.zeros((2, 3, 4, 5), np.float32)
    for src, dest in ((1, -1), (-1, 1), (0, 2), (3, 0)):
        assert tuple(tt.shift_dim(t(y), src, dest).shape) == \
            jt.shift_dim(jnp.asarray(y), src, dest).shape


@pytest.mark.parametrize("norm_first", [True, False])
def test_encoder(norm_first):
    x = seq(2, 6, 3)
    mask = np.ones((2, 1, 6, 6), bool)
    mask[1, :, :, 4:] = False                     # padding of the second row
    jm = jt.TransformerEncoder(num_layers=2, dim=D, num_heads=H,
                               norm_first=norm_first)
    params, tm = load(jm, tt.TransformerEncoder(2, D, H,
                                                norm_first=norm_first),
                      x, mask)
    want = jm.apply({"params": params}, x, mask)
    got = tm(t(x), t(mask))
    assert len(got.hidden_states) == len(want.hidden_states) == 3
    for a, b in zip(got.hidden_states + got.attentions,
                    want.hidden_states + want.attentions):
        np.testing.assert_allclose(a.detach().numpy(), b, **TOL)


def test_self_attention_over_a_grid():
    x = np.random.RandomState(4).randn(2, 3, 4, D).astype(np.float32)
    jm = jt.SelfAttention(D, H, causal=True)
    params, tm = load(jm, tt.SelfAttention(D, H, causal=True), x)
    want = jm.apply({"params": params}, x)
    np.testing.assert_allclose(tm(t(x)).detach().numpy(), want, **TOL)


def test_encoder_drop_path_in_train_mode():
    """Stochastic depth: per-sample masks in train mode, the identity in
    eval mode, and the same masks for the same generator."""
    x = t(seq(8, 3, 5))
    layer = tt.TransformerEncoderLayer(D, H, drop_path=0.5).train()
    outs = []
    for _ in range(2):
        layer.generator = torch.Generator().manual_seed(0)
        outs.append(layer(x)[0])
    assert torch.equal(outs[0], outs[1])
    layer.generator = torch.Generator().manual_seed(1)
    assert not torch.equal(outs[0], layer(x)[0])
    layer.eval()
    layer.drop_path = 0.0
    want = layer(x)[0]
    layer.drop_path = 0.5
    assert torch.equal(layer(x)[0], want)


class TestDecoder:
    T_LEN = 5

    def _pair(self):
        x, mem = seq(2, self.T_LEN, 6), seq(2, 3, 7)
        causal = np.tril(np.ones((self.T_LEN, self.T_LEN), bool))[None, None]
        full = jt.TransformerDecoder(num_layers=2, dim=D, num_heads=H)
        params, tm = load(full, tt.TransformerDecoder(2, D, H), x, mem,
                          self_mask=causal)
        want = np.asarray(full.apply({"params": params}, x, mem,
                                     self_mask=causal))
        return x, mem, causal, params, tm, want

    def test_full_sequence(self):
        x, mem, causal, _, tm, want = self._pair()
        np.testing.assert_allclose(tm(t(x), t(mem), t(causal)).detach()
                                   .numpy(), want, **TOL)

    def test_token_by_token_through_the_cache(self):
        x, mem, _, params, tm, want = self._pair()
        cached = tt.TransformerDecoder(2, D, H, use_cache=True,
                                       max_cache_length=self.T_LEN + 2)
        cached.load_state_dict(tm.state_dict())
        jdec = jt.TransformerDecoder(num_layers=2, dim=D, num_heads=H,
                                     use_cache=True,
                                     max_cache_length=self.T_LEN + 2)
        jcache = jdec.init(jax.random.PRNGKey(0), x[:, :1], mem,
                           decode_step=jnp.asarray(0))["cache"]
        cache = cached.init_cache(2)
        got, jgot = [], []
        for i in range(self.T_LEN):
            y, cache = cached(t(x[:, i:i + 1]), t(mem), decode_step=i,
                              cache=cache)
            got.append(y.detach().numpy()[:, 0])
            jy, mut = jdec.apply({"params": params, "cache": jcache},
                                 x[:, i:i + 1], mem,
                                 decode_step=jnp.asarray(i),
                                 mutable=["cache"])
            jcache = mut["cache"]
            jgot.append(np.asarray(jy)[:, 0])
        got, jgot = np.stack(got, 1), np.stack(jgot, 1)
        np.testing.assert_allclose(got, jgot, **TOL)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        # the returned cache holds what JAX's collection holds
        for name in ("layer_0", "layer_1"):
            for kv in ("k", "v"):
                np.testing.assert_allclose(
                    cache[name]["self_attention"][kv].detach().numpy(),
                    jcache[name]["self_attention"][kv], **TOL)


def test_flava_transformer():
    x = seq(3, 4, 8)
    mask = np.ones((3, 1, 5, 5), bool)
    mask[2, :, :, 3:] = False
    jm = jt.FLAVATransformerWithoutEmbeddings(num_layers=2, dim=D,
                                              num_heads=H)
    params, tm = load(jm, tt.FLAVATransformerWithoutEmbeddings(2, D, H), x,
                      mask)
    assert "cls_token" in params
    want = jm.apply({"params": params}, x, mask)
    got = tm(t(x), t(mask))
    assert tuple(got.last_hidden_state.shape) == (3, 5, D)
    np.testing.assert_allclose(got.last_hidden_state.detach().numpy(),
                               want.last_hidden_state, **TOL)
    np.testing.assert_allclose(got.pooler_output.detach().numpy(),
                               want.pooler_output, **TOL)
    for a, b in zip(got.hidden_states, want.hidden_states):
        np.testing.assert_allclose(a.detach().numpy(), b, **TOL)


def test_flava_defaults_are_published_widths():
    """12 × 768, 12 heads, eps 1e-6 (built on the meta device)."""
    with torch.device("meta"):
        m = tt.FLAVATransformerWithoutEmbeddings()
    assert m.encoder.num_layers == 12 and m.dim == 768
    layer = m.encoder.layer_0
    assert layer.attention.num_heads == 12 and layer.norm1.eps == 1e-6
    assert m.final_norm.eps == 1e-6
    assert layer.mlp.fc1.out_features == 3072
