"""The port's remaining MoE modes against the JAX package's (mirrors
tests/test_moe.py): top-k routing (k = 1, 2, ties), the GShard dispatch
tensors (top-1, top-2, overflow dropped), the expert bank's ``topk``
(capacity dispatch), ``dense`` and top-2 ``gather`` forms, forward and
gradients, and the MoE block dispatching on its mode.

Inputs come from numpy with a fixed seed; weights go JAX → weights.npz →
medmoe_torch.bridge. Tolerances as in tests/test_torch_models.py: float32
rtol 1e-4 / atol 1e-5; bfloat16 rtol 2e-2 with an atol of 2e-2·max|ref|.
``gather`` at top-2 on the CPU runs K1's plain version once a slot.
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

B = 4
KW = dict(num_experts=3, hidden_dims=(8, 16, 32, 64), output_dim=32,
          router_input_dim=64, router_hidden_dim=16)
LENS = (64, 16, 4, 1)


def _inputs(seed=6):
    rng = np.random.RandomState(seed)
    pyramid = [rng.randn(B, p, d).astype(np.float32)
               for p, d in zip(LENS, KW["hidden_dims"])]
    feat = rng.randn(B, KW["router_input_dim"]).astype(np.float32)
    cot = rng.randn(B, LENS[0], KW["output_dim"]).astype(np.float32)
    return pyramid, feat, cot


@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    """(JAX params, port MoE) per dtype, the same weights."""
    out = {}
    pyramid, feat, _ = _inputs()
    for dt in ("float32", "bfloat16"):
        jdt = jnp.dtype(dt)
        jm = jmoe.MoE(jmoe.MoEConfig(dtype=jdt, top_k=2, **KW))
        p = jax.jit(jm.init)(jax.random.PRNGKey(2),
                             [jnp.asarray(x, jdt) for x in pyramid],
                             jnp.asarray(feat))["params"]
        tm = carry(p, tmp_path_factory.mktemp(dt), tmoe.MoE(tmoe.MoEConfig(
            dtype=getattr(torch, dt), top_k=2, **KW)))
        out[dt] = (p, tm)
    return out


@pytest.fixture(autouse=True)
def _jax_expert_path():
    """The JAX expert branch on its XLA path (no Pallas) on the CPU."""
    os.environ["MEDMOE_EXPERT_IMPL"] = "xla"
    yield
    os.environ.pop("MEDMOE_EXPERT_IMPL", None)


class TestTopkRouting:
    @pytest.mark.parametrize("k", [1, 2])
    def test_matches_jax(self, k):
        rng = np.random.RandomState(k)
        probs = rng.dirichlet(np.ones(5), size=7).astype(np.float32)
        jidx, jw = jmoe.topk_routing(jnp.asarray(probs), k)
        tidx, tw = tmoe.topk_routing(torch.from_numpy(probs), k)
        assert tidx.dtype == torch.int32 and tuple(tidx.shape) == (7, k)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
        np.testing.assert_allclose(tw.numpy().sum(-1), 1.0, rtol=1e-6)

    def test_ties_follow_lax_top_k(self):
        probs = np.array([[0.4, 0.4, 0.2], [0.2, 0.4, 0.4],
                          [1 / 3, 1 / 3, 1 / 3], [0.1, 0.6, 0.3]],
                         np.float32)
        for k in (1, 2, 3):
            jidx, jw = jmoe.topk_routing(jnp.asarray(probs), k)
            tidx, tw = tmoe.topk_routing(torch.from_numpy(probs), k)
            np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
            np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))

    def test_k_beyond_the_experts_raises(self):
        with pytest.raises(ValueError, match="top-4"):
            tmoe.topk_routing(torch.full((2, 3), 1 / 3), 4)


class TestDispatchTensors:
    @pytest.mark.parametrize("case", ["top1", "top2", "overflow"])
    def test_matches_jax(self, case):
        idx = {"top1": [[0], [2], [1], [2]],
               "top2": [[0, 1], [2, 0], [1, 2], [0, 2]],
               "overflow": [[0, 1], [0, 2], [0, 1], [0, 2]]}[case]
        idx = np.asarray(idx, np.int32)
        w = np.random.RandomState(3).rand(*idx.shape).astype(np.float32)
        capacity = {"top1": 2, "top2": 3, "overflow": 2}[case]
        jd, jc = jmoe.make_dispatch_tensors(jnp.asarray(idx), jnp.asarray(w),
                                            3, capacity)
        td, tc = tmoe.make_dispatch_tensors(torch.from_numpy(idx),
                                            torch.from_numpy(w), 3, capacity)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)
        if case == "overflow":       # expert 0 holds its first 2 samples
            assert td.numpy()[0].sum() == 2 and td.numpy()[0, :, 2:].sum() == 0


def _bank_call(kind, bank_apply, pyramid, idx, w, combine):
    if kind == "dispatched":
        return bank_apply("apply_dispatched", pyramid, idx, 0.75, w)
    if kind == "dense":
        return bank_apply("apply_dense", pyramid, combine)
    return bank_apply("apply_gathered", pyramid, idx, w)


class TestExpertBank:
    @pytest.mark.parametrize("dt", ["float32", "bfloat16"])
    @pytest.mark.parametrize("kind", ["dispatched", "dense", "gathered"])
    def test_forward_and_gradients(self, banks, kind, dt):
        """apply_dispatched (capacity factor 0.75: 2 slots an expert for
        3 assignments to experts 1 and 2, so one of each drops),
        apply_dense and apply_gathered at k = 2: the output and the
        gradients of Σ out·cot with respect to the pyramid and every bank
        parameter."""
        p, tm = banks[dt]
        jdt, tdt = jnp.dtype(dt), getattr(torch, dt)
        pyramid, _, cot = _inputs(7)
        rng = np.random.RandomState(8)
        idx = np.stack([rng.permutation(3)[:2] for _ in range(B)]) \
            .astype(np.int32)
        w = rng.dirichlet(np.ones(2), size=B).astype(np.float32)
        combine = np.zeros((B, 3), np.float32)
        np.put_along_axis(combine, idx, w, axis=1)

        bank = jmoe.ExpertBank(jmoe.MoEConfig(dtype=jdt, top_k=2, **KW))

        def jloss(bank_params, pyr):
            def apply(method, *a):
                return bank.apply({"params": bank_params}, *a,
                                  method=getattr(jmoe.ExpertBank, method))
            out = _bank_call(kind, apply, pyr, jnp.asarray(idx),
                             jnp.asarray(w), jnp.asarray(combine))
            return jnp.sum(out * cot), out

        jpyr = [jnp.asarray(x, jdt) for x in pyramid]
        (_, jout), (jg_bank, jg_pyr) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(p["experts"], jpyr)

        tpyr = [torch.from_numpy(x).to(tdt).requires_grad_() for x in pyramid]
        tb = tm.experts
        tb.zero_grad()
        out = _bank_call(kind, lambda m, *a: getattr(tb, m)(*a), tpyr,
                         torch.from_numpy(idx), torch.from_numpy(w),
                         torch.from_numpy(combine))
        assert out.dtype == torch.float32        # the fused map stays f32
        (out * torch.from_numpy(cot)).sum().backward()
        assert_close(out.detach(), jout, dt)
        for x, g in zip(tpyr, jg_pyr):
            assert_close(x.grad.float(), g, dt)
        named = dict(tb.named_parameters())
        for name, g in jg_bank.items():
            t = named[name].grad
            assert t is not None, name
            if name == "attn_b2":
                continue         # zero in exact arithmetic (a softmax shift)
            assert_close(t, g, dt)

    def test_gathered_top2_requires_weights(self, banks):
        _, tm = banks["float32"]
        pyramid, _, _ = _inputs()
        with pytest.raises(ValueError, match="combine weights"):
            tm.experts.apply_gathered([torch.from_numpy(x) for x in pyramid],
                                      torch.zeros((B, 2), dtype=torch.int32))

    def test_dispatched_without_drops_equals_gathered(self, banks):
        """Capacity ≥ B: no assignment drops, and topk equals top-2
        gather."""
        _, tm = banks["float32"]
        pyramid, feat, _ = _inputs()
        pyr = [torch.from_numpy(x) for x in pyramid]
        probs = torch.softmax(torch.from_numpy(feat[:, :3]), -1)
        idx, w = tmoe.topk_routing(probs, 2)
        with torch.no_grad():
            a = tm.experts.apply_gathered(pyr, idx, w)
            b = tm.experts.apply_dispatched(pyr, idx, 3.0, w)
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-5)


class TestMoEModes:
    @pytest.mark.parametrize("dt", ["float32", "bfloat16"])
    @pytest.mark.parametrize("mode", ["gather", "dense", "topk"])
    def test_block_matches_jax(self, banks, tmp_path, mode, dt):
        """The MoE block at top-2 in each mode (``topk`` at capacity
        factor 1.0) on the same weights: router probabilities, global and
        local features."""
        p, _ = banks[dt]
        jdt, tdt = jnp.dtype(dt), getattr(torch, dt)
        cfg = dict(KW, top_k=2, mode=mode, capacity_factor=1.0)
        pyramid, feat, _ = _inputs()
        jg, jl, jr = jax.jit(jmoe.MoE(jmoe.MoEConfig(dtype=jdt, **cfg)).apply)(
            {"params": p}, [jnp.asarray(x, jdt) for x in pyramid],
            jnp.asarray(feat))
        tm = carry(p, tmp_path, tmoe.MoE(tmoe.MoEConfig(dtype=tdt, **cfg)))
        with torch.no_grad():
            tg, tl, tr = tm([torch.from_numpy(x).to(tdt) for x in pyramid],
                            torch.from_numpy(feat))
        assert_close(tr, jr, "float32")
        assert_close(tg, jg, dt)
        assert_close(tl, jl, dt)

    @pytest.mark.parametrize("dt", ["float32", "bfloat16"])
    def test_ep_raises_naming_a_live_queue(self, banks, tmp_path, dt):
        """``ep`` is ported (this test held its refusal, which named a
        ROADMAP queue): on one rank it is JAX's ``ep`` block (top-2,
        capacity factor 0.75, so assignments drop), forward and the
        gradients of the pyramid; an unknown mode still raises."""
        p, _ = banks[dt]
        jdt, tdt = jnp.dtype(dt), getattr(torch, dt)
        cfg = dict(KW, top_k=2, mode="ep", capacity_factor=0.75)
        pyramid, feat, cot = _inputs(4)
        jm = jmoe.MoE(jmoe.MoEConfig(dtype=jdt, **cfg))

        def jloss(pyr):
            _, loc, _ = jm.apply({"params": p}, pyr, jnp.asarray(feat))
            return jnp.sum(loc.reshape(B, KW["output_dim"], -1)
                           * jnp.asarray(cot).transpose(0, 2, 1)), loc

        (_, jl), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            [jnp.asarray(x, jdt) for x in pyramid])
        tm = carry(p, tmp_path, tmoe.MoE(tmoe.MoEConfig(dtype=tdt, **cfg)))
        tpyr = [torch.from_numpy(x).to(tdt).requires_grad_() for x in pyramid]
        _, tl, _ = tm(tpyr, torch.from_numpy(feat))
        (tl.reshape(B, KW["output_dim"], -1)
         * torch.from_numpy(cot).transpose(1, 2)).sum().backward()
        assert_close(tl.detach(), jl, dt)
        for x, g in zip(tpyr, jgrad):
            assert_close(x.grad.float(), g, dt)
        with pytest.raises(ValueError, match="unknown moe mode"):
            tmoe.MoE(tmoe.MoEConfig(mode="sparse"))
