"""Parity of the port's MoE block (router, top-1 routing, gather-mode
experts) with the JAX package's.

Inputs come from numpy with a fixed seed; weights go JAX → weights.npz →
medmoe_torch.bridge. Tolerances as in tests/test_torch_models.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medmoe_tpu.models import moe as jmoe
from medmoe_torch.models import moe as tmoe
from tests.test_torch_models import assert_close, carry

torch.set_num_threads(1)


class TestMoE:
    def test_topk_ties_go_to_lower_index(self):
        probs = np.array([[0.2, 0.4, 0.4], [0.5, 0.5, 0.0],
                          [0.1, 0.2, 0.7]], np.float32)
        jidx, jw = jmoe.topk_routing(jnp.asarray(probs), 1)
        tidx, tw = tmoe.topk_routing(torch.from_numpy(probs), 1)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        assert tidx.dtype == torch.int32

    def test_top_two_not_ported(self):
        """Top-2 routing is ported (this test held its refusal before):
        the two most probable experts, renormalized weights, as JAX."""
        probs = np.array([[0.2, 0.5, 0.3], [0.4, 0.4, 0.2]], np.float32)
        jidx, jw = jmoe.topk_routing(jnp.asarray(probs), 2)
        tidx, tw = tmoe.topk_routing(torch.from_numpy(probs), 2)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
        assert tmoe.MoE(tmoe.MoEConfig(top_k=2)).config.top_k == 2

    @pytest.mark.parametrize("dt", ["float32", "bfloat16"])
    def test_router_and_gather_outputs(self, dt, tmp_path):
        jdt, tdt = jnp.dtype(dt), getattr(torch, dt)
        kw = dict(num_experts=3, hidden_dims=(8, 16, 32, 64), output_dim=32,
                  router_input_dim=64, router_hidden_dim=16)
        jm = jmoe.MoE(jmoe.MoEConfig(dtype=jdt, **kw))
        rng = np.random.RandomState(6)
        pyramid = [rng.randn(4, p, d).astype(np.float32)
                   for p, d in zip((64, 16, 4, 1), kw["hidden_dims"])]
        feat = rng.randn(4, 64).astype(np.float32)
        jargs = ([jnp.asarray(x, jdt) for x in pyramid], jnp.asarray(feat))
        p = jax.jit(jm.init)(jax.random.PRNGKey(2), *jargs)["params"]
        tm = carry(p, tmp_path, tmoe.MoE(tmoe.MoEConfig(dtype=tdt, **kw)))
        os.environ["MEDMOE_EXPERT_IMPL"] = "xla"
        try:
            jg, jl, jr = jm.apply({"params": p}, *jargs)
        finally:
            os.environ.pop("MEDMOE_EXPERT_IMPL", None)
        with torch.no_grad():
            tg, tl, tr = tm([torch.from_numpy(x).to(tdt) for x in pyramid],
                            torch.from_numpy(feat))
        assert tuple(tl.shape) == (4, 32, 8, 8)
        assert_close(tr, jr, "float32")          # router is f32 in both
        assert_close(tg, jg, dt)
        assert_close(tl, jl, dt)

    def test_other_modes_not_ported(self, tmp_path):
        """Every mode of the JAX package is ported (this test held the
        refusal of ``ep`` before): ``ep`` with the expert axis of 1 is
        ``topk``, bit for bit, and equals JAX's ``ep`` block on the same
        weights (top-2, capacity factor 0.75, so assignments drop)."""
        kw = dict(num_experts=3, hidden_dims=(8, 16, 32, 64), output_dim=32,
                  router_input_dim=64, router_hidden_dim=16, top_k=2,
                  capacity_factor=0.75)
        rng = np.random.RandomState(9)
        pyramid = [rng.randn(4, p, d).astype(np.float32)
                   for p, d in zip((64, 16, 4, 1), kw["hidden_dims"])]
        feat = rng.randn(4, 64).astype(np.float32)
        jm = jmoe.MoE(jmoe.MoEConfig(dtype=jnp.float32, mode="ep", **kw))
        jargs = ([jnp.asarray(x) for x in pyramid], jnp.asarray(feat))
        p = jax.jit(jm.init)(jax.random.PRNGKey(2), *jargs)["params"]
        jg, jl, jr = jax.jit(jm.apply)({"params": p}, *jargs)
        outs = {}
        for mode in ("ep", "topk", "dense"):
            tm = carry(p, tmp_path, tmoe.MoE(tmoe.MoEConfig(
                dtype=torch.float32, mode=mode, **kw)))
            assert tm.config.mode == mode
            with torch.no_grad():
                outs[mode] = tm([torch.from_numpy(x) for x in pyramid],
                                torch.from_numpy(feat))
        for a, b in zip(outs["ep"], outs["topk"]):
            assert torch.equal(a, b)
        tg, tl, tr = outs["ep"]
        assert_close(tr, jr, "float32")
        assert_close(tg, jg, "float32")
        assert_close(tl, jl, "float32")
