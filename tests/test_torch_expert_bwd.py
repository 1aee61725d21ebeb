"""K2, the fused expert branch's backward, in the PyTorch port: its plain
version (what ``expert_fusion_gather_bwd`` runs for CPU tensors) against
the Pallas TPU kernel ``_bwd_pallas`` in interpret mode, and the gradient
of ``FusedExpertGather`` (the autograd Function the expert bank calls)
against ``jax.grad`` of the JAX ``ExpertBank`` on its XLA path. Shapes: a
4-scale pyramid with the flagship's 1/4/16/64 upsample ratios, every
expert used.

Tolerances:
  * plain K2 vs ``_bwd_pallas``: both sides are bf16 with the same
    rounding points, so the bound is tight — 1e-3·max|ref| absolute per
    output (a different f32 summation order can flip one bf16 rounding of
    dz_a or dz_h; measured ≤ 6e-5·max);
  * gradients at float32: rtol 1e-4, atol 1e-5·max|ref| (algorithm only);
  * gradients at bfloat16: the JAX package's own fused-vs-XLA bound,
    5e-2·max|ref| (tests/test_pallas_expert.py), since the two sides
    round the recomputed chain at different points.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from medmoe_tpu.models import moe as jmoe
from medmoe_tpu.ops.pallas import expert_fusion as jef
from medmoe_torch.models import moe as tmoe
from medmoe_torch.ops import expert_fusion as ef

torch.set_num_threads(1)

P_LIST = (64, 16, 4, 1)
D_LIST = (8, 16, 32, 64)
E, K, B = 32, 3, 4
H = E // 2
IDX = np.array([0, 1, 2, 1], np.int32)             # every expert used
OUT_NAMES = ("d_x", "d_wp", "d_bp", "d_w1", "d_b1", "d_w2")


def _params(rng):
    p = {}
    for s, d in enumerate(D_LIST):
        p[f"proj_w{s}"] = (rng.randn(K, d, E) / np.sqrt(d)).astype(np.float32)
        p[f"proj_b{s}"] = (0.1 * rng.randn(K, E)).astype(np.float32)
    p["attn_w1"] = (rng.randn(K, E, H) / np.sqrt(E)).astype(np.float32)
    p["attn_b1"] = (0.1 * rng.randn(K, H)).astype(np.float32)
    p["attn_w2"] = (rng.randn(K, H, 1) / np.sqrt(H)).astype(np.float32)
    p["attn_b2"] = (0.1 * rng.randn(K, 1)).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    pyramid = [rng.randn(B, p, d).astype(np.float32)
               for p, d in zip(P_LIST, D_LIST)]
    params = _params(rng)
    d_out = rng.randn(B, P_LIST[0], E).astype(np.float32)
    return pyramid, params, d_out


def _torch_args(pyramid, params, dtype=torch.bfloat16):
    t = {k: torch.from_numpy(v) for k, v in params.items()}
    n = len(pyramid)
    return (tuple(torch.from_numpy(x).to(dtype) for x in pyramid),
            tuple(t[f"proj_w{s}"] for s in range(n)),
            tuple(t[f"proj_b{s}"] for s in range(n)),
            t["attn_w1"], t["attn_b1"], t["attn_w2"])


def _flat(outs):
    d_xs, d_wp, d_bp, d_w1, d_b1, d_w2 = outs
    return {"d_x": list(d_xs), "d_wp": list(d_wp), "d_bp": list(d_bp),
            "d_w1": [d_w1], "d_b1": [d_b1], "d_w2": [d_w2]}


@pytest.fixture(scope="module")
def bwd_pair(data):
    pyramid, params, d_out = data
    n = len(P_LIST)
    with pltpu.force_tpu_interpret_mode():
        outs = jef._bwd_pallas(
            [jnp.asarray(x, jnp.bfloat16) for x in pyramid],
            [jnp.asarray(params[f"proj_w{s}"]) for s in range(n)],
            [jnp.asarray(params[f"proj_b{s}"]) for s in range(n)],
            jnp.asarray(params["attn_w1"]), jnp.asarray(params["attn_b1"]),
            jnp.asarray(params["attn_w2"]), jnp.asarray(IDX),
            jef._interp_mats(P_LIST, P_LIST[0]), jnp.asarray(d_out))
    outs = [np.asarray(o, np.float32) for o in outs]
    want = {"d_x": outs[:n], "d_wp": outs[n:2 * n], "d_bp": outs[2 * n:3 * n],
            "d_w1": [outs[3 * n]], "d_b1": [outs[3 * n + 1]],
            "d_w2": [outs[3 * n + 2]]}
    got = ef.expert_fusion_gather_bwd(
        *_torch_args(pyramid, params), torch.from_numpy(IDX),
        torch.from_numpy(d_out))
    return _flat(got), want


class TestPlainBackwardAgainstPallas:
    @pytest.mark.parametrize("name", OUT_NAMES)
    def test_matches_bwd_pallas_interpret(self, bwd_pair, name):
        got, want = bwd_pair
        for g, w in zip(got[name], want[name]):
            g = g.float().numpy().reshape(w.shape)
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-3 * np.abs(w).max())

    def test_cpu_backward_counts_no_launch(self, data):
        pyramid, params, d_out = data
        before = (ef.LAUNCHES, ef.BWD_LAUNCHES)
        ef.expert_fusion_gather_bwd(*_torch_args(pyramid, params),
                                    torch.from_numpy(IDX),
                                    torch.from_numpy(d_out))
        assert (ef.LAUNCHES, ef.BWD_LAUNCHES) == before

    def test_rejects_bad_cotangent(self, data):
        pyramid, params, d_out = data
        with pytest.raises(ValueError, match="d_out"):
            ef.expert_fusion_gather_bwd(
                *_torch_args(pyramid, params), torch.from_numpy(IDX),
                torch.from_numpy(d_out[:, :8]))
        with pytest.raises(IndexError):
            ef.expert_fusion_gather_bwd(
                *_torch_args(pyramid, params),
                torch.tensor([0, 1, 2, K], dtype=torch.int32),
                torch.from_numpy(d_out))


def _jax_grads(pyramid, params, d_out, dtype):
    cfg = jmoe.MoEConfig(num_experts=K, hidden_dims=D_LIST, output_dim=E,
                         router_input_dim=64, router_hidden_dim=8, dtype=dtype)
    bank = jmoe.ExpertBank(cfg)
    os.environ["MEDMOE_EXPERT_IMPL"] = "xla"
    try:
        def loss(p, pyr):
            out = bank.apply({"params": p}, pyr, jnp.asarray(IDX),
                             method=jmoe.ExpertBank.apply_gathered)
            return jnp.sum(out.astype(jnp.float32) * d_out)

        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            {k: jnp.asarray(v) for k, v in params.items()},
            [jnp.asarray(x) for x in pyramid])
    finally:
        os.environ.pop("MEDMOE_EXPERT_IMPL", None)
    return ({k: np.asarray(v, np.float32) for k, v in gp.items()},
            [np.asarray(x, np.float32) for x in gx])


def _torch_grads(pyramid, params, d_out, dtype):
    cfg = tmoe.MoEConfig(num_experts=K, hidden_dims=D_LIST, output_dim=E,
                         router_input_dim=64, router_hidden_dim=8, dtype=dtype)
    bank = tmoe.ExpertBank(cfg)
    bank.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    pyr = [torch.from_numpy(x).requires_grad_() for x in pyramid]
    out = bank.apply_gathered(pyr, torch.from_numpy(IDX))
    (out * torch.from_numpy(d_out)).sum().backward()
    return ({k: p.grad.numpy() for k, p in bank.named_parameters()},
            [x.grad.float().numpy() for x in pyr])


class TestGradientAgainstJax:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_bank_and_pyramid_grads(self, data, dtype):
        pyramid, params, d_out = data
        wp, wx = _jax_grads(pyramid, params, d_out, jnp.dtype(dtype))
        gp, gx = _torch_grads(pyramid, params, d_out, getattr(torch, dtype))
        pairs = [(gp[k], wp[k], k) for k in wp if k != "attn_b2"] + \
            [(g, w, f"pyramid[{s}]") for s, (g, w) in enumerate(zip(gx, wx))]
        for g, w, name in pairs:
            scale = max(np.abs(w).max(), 1e-6)
            if dtype == "float32":
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * scale,
                                           err_msg=name)
            else:
                err = np.abs(g - w).max() / scale
                assert err < 5e-2, f"{name}: rel err {err}"
        # attn_b2 cancels in the softmax over scales: zero up to rounding
        assert np.abs(gp["attn_b2"]).max() < 1e-4

    def test_bf16_bank_goes_through_fused_function(self, data, monkeypatch):
        pyramid, params, d_out = data
        calls = []
        real = ef.FusedExpertGather.apply
        monkeypatch.setattr(ef.FusedExpertGather, "apply",
                            lambda *a: calls.append(1) or real(*a))
        _torch_grads(pyramid, params, d_out, torch.bfloat16)
        assert calls == [1]

    def test_autograd_matches_plain_k2_and_scatter(self, data):
        """What the CPU backward computes (autograd through the plain
        forward) against what the CUDA backward computes (K2's math, here
        its plain version, plus the bank scatter)."""
        pyramid, params, d_out = data
        gp, gx = _torch_grads(pyramid, params, d_out, torch.bfloat16)
        args = _torch_args(pyramid, params)
        idx = torch.from_numpy(IDX)
        d_xs, d_wp, d_bp, d_w1, d_b1, d_w2 = ef.expert_fusion_gather_bwd(
            *args, idx, torch.from_numpy(d_out))
        valid = torch.ones(B, dtype=torch.bool)
        want = {"attn_w1": ef._bank_scatter(d_w1, args[3], idx, valid),
                "attn_b1": ef._bank_scatter(d_b1, args[4], idx, valid),
                "attn_w2": ef._bank_scatter(d_w2, args[5], idx, valid)}
        for s in range(len(P_LIST)):
            want[f"proj_w{s}"] = ef._bank_scatter(d_wp[s], args[1][s], idx,
                                                  valid)
            want[f"proj_b{s}"] = ef._bank_scatter(d_bp[s], args[2][s], idx,
                                                  valid)
        for name, w in want.items():
            w = w.numpy()
            err = np.abs(gp[name] - w).max() / max(np.abs(w).max(), 1e-6)
            assert err < 5e-2, f"{name}: rel err {err}"
        for s, (g, w) in enumerate(zip(gx, d_xs)):
            w = w.float().numpy()
            err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-6)
            assert err < 5e-2, f"pyramid[{s}]: rel err {err}"

    def test_scatter_drops_out_of_range_samples(self):
        per = torch.tensor([[1.0], [float("nan")], [2.0]])
        param = torch.zeros(2, 1)
        idx = torch.tensor([1, 5, 1])
        out = ef._bank_scatter(per, param, idx, (idx >= 0) & (idx < 2))
        assert out.tolist() == [[0.0], [3.0]]
