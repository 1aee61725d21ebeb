"""K1, the fused expert branch, in the PyTorch port: the wrapper's plain
version (what it runs for CPU tensors) against both JAX arms — the XLA
gather path of ``ExpertBank.apply_gathered`` and the Pallas kernel in
interpret mode — on a 4-scale pyramid with the flagship's 4×/16×/64×
upsample ratios, plus the wrapper's input contract.

Tolerances: float32 checks the algorithm, so it is tight (rtol 1e-4,
atol 1e-5: only the f32 summation order differs). bfloat16 checks the
rounding points with the JAX package's own fused-vs-XLA tolerance
(tests/test_pallas_expert.py, rtol 2e-2, atol 2e-3): both sides round at
the same points, and a different summation order can flip one bf16 ulp.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from medmoe_tpu.models import moe as jmoe
from medmoe_tpu.ops.pallas import expert_fusion as jef
from medmoe_torch.models import moe as tmoe
from medmoe_torch.ops import expert_fusion as ef

torch.set_num_threads(1)

P_LIST = (64, 16, 4, 1)            # ratios 1, 4, 16, 64 like 3136/784/196/49
D_LIST = (8, 16, 32, 64)
E, K, B = 32, 3, 6
TIGHT = dict(rtol=1e-4, atol=1e-5)
LOOSE = dict(rtol=2e-2, atol=2e-3)


def _jax_bank(dtype):
    cfg = jmoe.MoEConfig(num_experts=K, hidden_dims=D_LIST, output_dim=E,
                         router_input_dim=64, router_hidden_dim=8,
                         dtype=dtype)
    return jmoe.ExpertBank(cfg)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    pyramid = [rng.randn(B, p, d).astype(np.float32)
               for p, d in zip(P_LIST, D_LIST)]
    idx = np.array([0, 1, 2, 2, 1, 0], np.int32)       # every expert used
    params = jax.jit(functools.partial(
        _jax_bank(jnp.float32).init, method=jmoe.ExpertBank.apply_gathered))(
            jax.random.PRNGKey(0), [jnp.asarray(x) for x in pyramid],
            jnp.asarray(idx))["params"]
    # nonzero biases so every bias path is exercised
    params = {k: (np.asarray(v) + 0.1 * rng.randn(*v.shape).astype(np.float32)
                  if "_b" in k else np.asarray(v)) for k, v in params.items()}
    return pyramid, idx, params


def _jax_run(pyramid, idx, params, dtype, impl):
    bank = _jax_bank(dtype)
    os.environ["MEDMOE_EXPERT_IMPL"] = impl
    try:
        args = ({"params": params}, [jnp.asarray(x) for x in pyramid],
                jnp.asarray(idx))
        if impl == "pallas":
            with pltpu.force_tpu_interpret_mode():
                out = bank.apply(*args, method=jmoe.ExpertBank.apply_gathered)
        else:
            out = bank.apply(*args, method=jmoe.ExpertBank.apply_gathered)
    finally:
        os.environ.pop("MEDMOE_EXPERT_IMPL", None)
    return np.asarray(out, np.float32)


def _torch_args(pyramid, idx, params, dtype):
    t = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    xs = tuple(torch.from_numpy(x).to(dtype) for x in pyramid)
    n = len(pyramid)
    return (xs, tuple(t[f"proj_w{s}"] for s in range(n)),
            tuple(t[f"proj_b{s}"] for s in range(n)), t["attn_w1"],
            t["attn_b1"], t["attn_w2"], t["attn_b2"],
            torch.from_numpy(idx))


class TestPlainVersionAgainstJax:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_xla_gather(self, data, dtype):
        pyramid, idx, params = data
        jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
        want = _jax_run(pyramid, idx, params, jdt, "xla")
        args = _torch_args(pyramid, idx, params, tdt)
        got = ef.expert_fusion_gather_reference(*args, dtype=tdt).numpy()
        assert got.shape == (B, P_LIST[0], E)
        np.testing.assert_allclose(got, want,
                                   **(TIGHT if dtype == "float32" else LOOSE))

    def test_wrapper_matches_pallas_interpret_bf16(self, data):
        """The wrapper on CPU tensors (its plain version) against the TPU
        kernel itself, run in interpret mode as the JAX package's own
        tests run it."""
        pyramid, idx, params = data
        want = _jax_run(pyramid, idx, params, jnp.bfloat16, "pallas")
        got = ef.expert_fusion_gather(
            *_torch_args(pyramid, idx, params, torch.bfloat16)).numpy()
        np.testing.assert_allclose(got, want, **LOOSE)

    def test_pallas_arm_float32_takes_plain_path(self, data):
        """In float32 the JAX gate sends even MEDMOE_EXPERT_IMPL=pallas to
        XLA, and the port's gate sends the bank to its plain version: the
        two agree tightly."""
        pyramid, idx, params = data
        assert not ef.use_fused_expert(P_LIST, P_LIST[0], torch.float32)
        want = _jax_run(pyramid, idx, params, jnp.float32, "pallas")
        cfg = tmoe.MoEConfig(num_experts=K, hidden_dims=D_LIST, output_dim=E,
                             router_input_dim=64, router_hidden_dim=8,
                             dtype=torch.float32)
        bank = tmoe.ExpertBank(cfg)
        bank.load_state_dict({k: torch.from_numpy(np.array(v))
                              for k, v in params.items()})
        with torch.no_grad():
            got = bank.apply_gathered(
                [torch.from_numpy(x) for x in pyramid],
                torch.from_numpy(idx)).numpy()
        np.testing.assert_allclose(got, want, **TIGHT)

    def test_bank_bf16_goes_through_wrapper(self, data):
        pyramid, idx, params = data
        cfg = tmoe.MoEConfig(num_experts=K, hidden_dims=D_LIST, output_dim=E,
                             router_input_dim=64, router_hidden_dim=8)
        bank = tmoe.ExpertBank(cfg)
        bank.load_state_dict({k: torch.from_numpy(np.array(v))
                              for k, v in params.items()})
        calls = []
        real = ef.expert_fusion_gather
        ef.expert_fusion_gather = lambda *a: calls.append(a) or real(*a)
        try:
            with torch.no_grad():
                got = bank.apply_gathered(
                    [torch.from_numpy(x) for x in pyramid],
                    torch.from_numpy(idx)).numpy()
        finally:
            ef.expert_fusion_gather = real
        assert len(calls) == 1
        want = _jax_run(pyramid, idx, params, jnp.bfloat16, "xla")
        np.testing.assert_allclose(got, want, **LOOSE)

    def test_cpu_run_counts_no_launch(self, data):
        pyramid, idx, params = data
        before = ef.LAUNCHES
        ef.expert_fusion_gather(*_torch_args(pyramid, idx, params,
                                             torch.bfloat16))
        assert ef.LAUNCHES == before


class TestInterpolation:
    @pytest.mark.parametrize("src,dst", [(49, 3136), (196, 3136), (784, 3136),
                                         (4, 64), (5, 15), (6, 10)])
    def test_matches_torch_interpolate(self, src, dst):
        x = torch.from_numpy(np.random.RandomState(src).randn(2, src, 3)
                             .astype(np.float32))
        got = tmoe.interp_patches(x, dst, dim=1)
        want = F.interpolate(x.permute(0, 2, 1), size=dst, mode="linear",
                             align_corners=False).permute(0, 2, 1)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("src,dst", [(16, 64), (1, 64), (5, 15)])
    def test_matches_jax_interp_patches_bf16(self, src, dst):
        x = np.random.RandomState(dst).randn(2, src, 4).astype(np.float32)
        want = np.asarray(jmoe.interp_patches(
            jnp.asarray(x, jnp.bfloat16), dst, axis=1), np.float32)
        got = tmoe.interp_patches(torch.from_numpy(x).to(torch.bfloat16), dst,
                                  dim=1).float().numpy()
        np.testing.assert_array_equal(got, want)

    def test_interp_matrix_matches_jax(self):
        np.testing.assert_array_equal(tmoe.linear_interp_matrix(196, 3136),
                                      jmoe.linear_interp_matrix(196, 3136))

    def test_gate_matches_jax(self):
        for p_list in ([64, 16, 4, 1], [64, 24], [3136, 784, 196, 49]):
            assert ef.expert_fusion_supported(p_list, max(p_list)) == \
                jef.expert_fusion_supported(p_list, max(p_list))


def _good_args():
    rng = np.random.RandomState(1)
    pyramid = [rng.randn(2, p, d).astype(np.float32)
               for p, d in zip(P_LIST, D_LIST)]
    idx = np.array([0, 2], np.int32)
    params = {}
    for s, d in enumerate(D_LIST):
        params[f"proj_w{s}"] = rng.randn(K, d, E).astype(np.float32)
        params[f"proj_b{s}"] = rng.randn(K, E).astype(np.float32)
    params.update(attn_w1=rng.randn(K, E, E // 2).astype(np.float32),
                  attn_b1=rng.randn(K, E // 2).astype(np.float32),
                  attn_w2=rng.randn(K, E // 2, 1).astype(np.float32),
                  attn_b2=rng.randn(K, 1).astype(np.float32))
    return list(_torch_args(pyramid, idx, params, torch.bfloat16))


def _pyramid_f32(a):
    a[0] = tuple(x.float() for x in a[0])


def _ratio_5(a):
    a[0] = (a[0][0][:, :60], a[0][1][:, :16])
    a[1], a[2] = a[1][:2], a[2][:2]


def _bad_expert_id(a):
    a[7] = torch.tensor([0, K], dtype=torch.int32)


def _hidden_too_wide(a):
    k, e, _ = a[3].shape
    a[3] = torch.zeros(k, e, 400)
    a[4] = torch.zeros(k, 400)
    a[5] = torch.zeros(k, 400, 1)


def _non_contiguous(a):
    a[3] = a[3].transpose(1, 2).contiguous().transpose(1, 2)


def _params_bf16(a):
    a[3] = a[3].to(torch.bfloat16)


def _five_scales(a):
    a[0] = a[0] + a[0][-1:]
    a[1] = a[1] + a[1][-1:]
    a[2] = a[2] + a[2][-1:]


class TestWrapperContract:
    def test_good_args_run(self):
        out = ef.expert_fusion_gather(*_good_args())
        assert out.shape == (2, P_LIST[0], E) and out.dtype == torch.float32

    @pytest.mark.parametrize("breaker,exc", [
        (_pyramid_f32, TypeError), (_ratio_5, ValueError),
        (_bad_expert_id, IndexError), (_hidden_too_wide, ValueError),
        (_non_contiguous, ValueError), (_params_bf16, TypeError),
        (_five_scales, ValueError)])
    def test_raises_on_what_the_kernel_does_not_take(self, breaker, exc):
        a = _good_args()
        breaker(a)
        with pytest.raises(exc):
            ef.expert_fusion_gather(*a)

    def test_smem_mirror_fits_flagship(self):
        assert ef._attn_smem_bytes(768, 384) == 150528 <= ef._SMEM_LIMIT
