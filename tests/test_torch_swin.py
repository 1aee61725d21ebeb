"""Parity of the port's layers and Swin backbone with the JAX package's.

Inputs come from numpy with a fixed seed; weights go JAX → weights.npz →
medmoe_torch.bridge. Tolerances as in tests/test_torch_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medmoe_tpu.models import layers as jlayers
from medmoe_tpu.models import swin as jswin
from medmoe_torch.models import layers as tlayers
from medmoe_torch.models import swin as tswin
from tests.test_torch_models import assert_close, carry

torch.set_num_threads(1)


class TestLayers:
    def test_fp32_layernorm(self):
        x = np.random.RandomState(0).randn(3, 5, 16).astype(np.float32) * 3 + 1
        ln = jlayers.Fp32LayerNorm(epsilon=1e-5)
        p = ln.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
        scale = np.linspace(0.5, 1.5, 16).astype(np.float32)
        bias = np.linspace(-1, 1, 16).astype(np.float32)
        p = {"LayerNorm_0": {"scale": scale, "bias": bias}}
        want = ln.apply({"params": p}, jnp.asarray(x))
        t = tlayers.Fp32LayerNorm(16, 1e-5)
        t.weight.data = torch.from_numpy(scale)
        t.bias.data = torch.from_numpy(bias)
        got = t(torch.from_numpy(x).to(torch.bfloat16))
        assert got.dtype == torch.bfloat16
        assert_close(t(torch.from_numpy(x)).detach(), want, "float32")

    def test_gelu_exact_and_l2(self):
        x = np.random.RandomState(1).randn(4, 8).astype(np.float32)
        assert_close(tlayers.gelu_exact(torch.from_numpy(x)),
                     jlayers.gelu_exact(jnp.asarray(x)), "float32")
        x[0] = 0.0                                 # zero vector stays finite
        got = tlayers.l2_normalize(torch.from_numpy(x), dim=-1)
        assert_close(got, jlayers.l2_normalize(jnp.asarray(x), axis=-1),
                     "float32")
        assert torch.isfinite(got).all()

    def test_mlp(self, tmp_path):
        x = np.random.RandomState(2).randn(3, 8).astype(np.float32)
        jm = jlayers.Mlp(16, 8, dtype=jnp.float32)
        p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
        tm = carry(p, tmp_path, tlayers.Mlp(8, 16, 8, dtype=torch.float32))
        assert_close(tm(torch.from_numpy(x)).detach(),
                     jm.apply({"params": p}, jnp.asarray(x)), "float32")


class TestSwin:
    def test_static_tables_match(self):
        np.testing.assert_array_equal(tswin._relative_position_index(7),
                                      jswin._relative_position_index(7))
        np.testing.assert_array_equal(
            tswin._shift_attention_mask(56, 56, 7, 3),
            jswin._shift_attention_mask(56, 56, 7, 3))

    @pytest.mark.parametrize("dt", ["float32", "bfloat16"])
    def test_backbone_pyramid_and_final(self, dt, tmp_path):
        jdt, tdt = jnp.dtype(dt), getattr(torch, dt)
        kw = dict(image_size=64, embed_dim=8, depths=(2, 1, 1, 1),
                  num_heads=(1, 2, 2, 4), window_size=2, drop_path_rate=0.0)
        jb = jswin.SwinBackbone(jswin.SwinConfig(dtype=jdt, **kw))
        x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32)
        p = jax.jit(jb.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
        tb = carry(p, tmp_path, tswin.SwinBackbone(
            tswin.SwinConfig(dtype=tdt, **kw)))
        jpyr, jfinal = jax.jit(jb.apply)({"params": p}, jnp.asarray(x))
        with torch.no_grad():
            tpyr, tfinal = tb(torch.from_numpy(x))
        assert [tuple(t.shape) for t in tpyr] == \
            [(2, 256, 8), (2, 64, 16), (2, 16, 32), (2, 4, 64)]
        for a, b in zip(tpyr, jpyr):
            assert a.dtype == tdt
            assert_close(a.float(), b, dt)
        assert_close(tfinal.float(), jfinal, dt)
