"""The JAX → PyTorch parameter bridge and the port's random init.

Every key ``medmoe_tpu.eval.export._save_weights`` writes for a MedMoE maps
to exactly one port parameter and every port parameter is set; anything
else raises. Layout conversions are checked against the JAX layers'
outputs (float32, rtol 1e-5: one op each, same summation)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from medmoe_tpu.config import DotDict as JDotDict
from medmoe_tpu.eval.export import _save_weights
from medmoe_tpu.models.medmoe import MedMoE as JMedMoE
from medmoe_torch import bridge
from medmoe_torch.config import DotDict
from medmoe_torch.models.medmoe import MedMoE as TMedMoE
from medmoe_torch.models.medmoe import init_weights
from medmoe_torch.models.moe import ExpertBank
from medmoe_torch.models.swin import WindowAttention
from tests.test_torch_models import TEXT, VISION

torch.set_num_threads(1)


def _flat(params):
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_leaves_with_path(params)}


@pytest.fixture(scope="module")
def jax_flat():
    v, t = dict(VISION, dtype="float32"), dict(TEXT, dtype="float32")
    jm = JMedMoE(vision=JDotDict(v), text=JDotDict(t))
    batch = {"image": np.zeros((1, 64, 64, 3), np.float32)}
    for k in ("input_ids", "attention_mask", "token_type_ids", "segment_ids"):
        batch[k] = np.zeros((1, 10), np.int32)
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0),
                               "dropout": jax.random.PRNGKey(0)},
                              batch)["params"]
    return _flat(params)


def _model():
    return TMedMoE(DotDict(dict(VISION, dtype="float32")),
                   DotDict(dict(TEXT, dtype="float32")))


class TestKeyCoverage:
    def test_every_key_maps_and_every_parameter_is_set(self, jax_flat):
        model = _model()
        sd = bridge.from_jax_params(jax_flat, model)
        assert set(sd) == set(model.state_dict())
        assert len(sd) == len(jax_flat)
        bridge.load_jax_params(model, jax_flat)
        for key, arr in jax_flat.items():
            got = model.state_dict()[bridge.torch_key(key, arr.ndim)]
            assert got.numel() == arr.size

    def test_npz_roundtrip(self, jax_flat, tmp_path):
        path = str(tmp_path / "weights.npz")
        np.savez(path, **jax_flat)
        loaded = bridge.load_npz(path)
        assert set(loaded) == set(jax_flat)
        model = bridge.load_jax_params(_model(), loaded)
        table = "image_encoder/swin_moe/swin/stage0_block1/attn/" \
                "relative_position_bias_table"
        np.testing.assert_array_equal(
            model.image_encoder.swin_moe.swin.stage0_block1.attn
            .relative_position_bias_table.detach().numpy(), jax_flat[table])

    def test_unmapped_key_raises(self, jax_flat):
        flat = dict(jax_flat)
        flat["image_encoder/swin_moe/moe/extra/kernel"] = np.zeros((2, 2))
        with pytest.raises(KeyError, match="unmapped"):
            bridge.from_jax_params(flat, _model())

    def test_unset_parameter_raises(self, jax_flat):
        flat = dict(jax_flat)
        del flat["image_encoder/swin_moe/moe/experts/attn_w1"]
        with pytest.raises(KeyError, match="attn_w1"):
            bridge.from_jax_params(flat, _model())

    def test_shape_mismatch_raises(self, jax_flat):
        flat = dict(jax_flat)
        key = "image_encoder/swin_moe/moe/router_fc1/bias"
        flat[key] = np.zeros(flat[key].shape[0] + 1, np.float32)
        with pytest.raises(ValueError, match="shape"):
            bridge.from_jax_params(flat, _model())

    @pytest.mark.parametrize("key,ndim", [
        ("a/norm/LayerNorm_0/mean", 1), ("a/conv3d/kernel", 5)])
    def test_no_rule_raises(self, key, ndim):
        with pytest.raises(KeyError, match="unmapped"):
            bridge.torch_key(key, ndim)


class TestLayouts:
    def test_dense_kernel_transposes(self):
        x = np.random.RandomState(0).randn(3, 5).astype(np.float32)
        d = nn.Dense(4)
        p = d.init(jax.random.PRNGKey(0), x)["params"]
        sd = bridge.from_jax_params({"kernel": p["kernel"], "bias": p["bias"]})
        got = F.linear(torch.from_numpy(x), sd["weight"], sd["bias"])
        np.testing.assert_allclose(got.numpy(), d.apply({"params": p}, x),
                                   rtol=1e-5, atol=1e-6)

    def test_conv_kernel_hwio_to_oihw(self):
        x = np.random.RandomState(1).randn(2, 8, 8, 3).astype(np.float32)
        c = nn.Conv(5, (4, 4), strides=(4, 4))
        p = c.init(jax.random.PRNGKey(0), x)["params"]
        sd = bridge.from_jax_params({"kernel": p["kernel"], "bias": p["bias"]})
        got = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), sd["weight"],
                       sd["bias"], stride=4).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), c.apply({"params": p}, x),
                                   rtol=1e-5, atol=1e-5)


class TestInit:
    def test_seeded_and_deterministic(self):
        a = init_weights(_model(), seed=3).state_dict()
        b = init_weights(_model(), seed=3).state_dict()
        c = init_weights(_model(), seed=4).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert not all(torch.equal(a[k], c[k]) for k in a)

    def test_distributions_like_flax(self):
        model = init_weights(_model(), seed=0)
        fc = model.text_encoder.bert.layer_0.intermediate.weight   # [64, 32]
        assert abs(fc.std().item() - 32 ** -0.5) < 0.2 * 32 ** -0.5
        assert fc.abs().max().item() <= 2 * 32 ** -0.5 / .87962566103423978
        bank = next(m for m in model.modules() if isinstance(m, ExpertBank))
        w1 = bank.attn_w1                                     # [K=3, 32, 16]
        fan_in = 3 * 32
        assert abs(w1.std().item() - fan_in ** -0.5) < 0.2 * fan_in ** -0.5
        assert torch.count_nonzero(bank.proj_b0) == 0
        attn = next(m for m in model.modules()
                    if isinstance(m, WindowAttention))
        assert attn.relative_position_bias_table.abs().max() <= 0.04
        ln = model.image_encoder.swin_moe.swin.norm
        assert torch.all(ln.weight == 1) and torch.all(ln.bias == 0)

    def test_embedding_std_matches_flax_default(self):
        emb = nn.Embed(200, 32)
        p = jax.jit(functools.partial(emb.init))(
            jax.random.PRNGKey(0), jnp.zeros((1,), jnp.int32))["params"]
        flax_std = float(np.asarray(p["embedding"]).std())
        model = init_weights(_model(), seed=0)
        torch_std = model.text_encoder.bert.embeddings.word_embeddings \
            .weight.std().item()
        assert abs(torch_std - flax_std) < 0.1 * flax_std
