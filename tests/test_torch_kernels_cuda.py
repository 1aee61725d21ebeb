"""The port's CUDA kernels on the card, each against its plain PyTorch
version. Marked ``cuda``: without a card every test skips (a CUDA kernel
has no CPU mode; its plain version's parity with JAX is tested in
tests/test_torch_expert_fusion.py). This file imports neither JAX nor the
JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

Tolerances: K1 rtol 2e-2, atol 2e-3 — both sides round at the same bf16
points; a different f32 summation order can flip one bf16 ulp. K2 and
``FusedExpertGather``'s gradients (against autograd through the plain
forward): 5e-2·max|ref| per output, the JAX package's own fused-vs-XLA
gradient bound — a ReLU mask (a > 0, h > 0) whose pre-activation lies
within f32 summation error of zero can differ between two summation
orders, and each such flip moves a whole gradient term. Since such flips
are rare, K2 must also keep all but 1% of each output's elements within
2e-3·max|ref|.
"""

import pytest
import torch

from medmoe_torch.ops import expert_fusion as ef

LOOSE = dict(rtol=2e-2, atol=2e-3)


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, p_list, d_list, e, k, idx, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    h = e // 2

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    xs = tuple(randn(b, p, d).to(torch.bfloat16)
               for p, d in zip(p_list, d_list))
    return (xs, tuple(randn(k, d, e, std=d ** -0.5) for d in d_list),
            tuple(randn(k, e, std=0.1) for _ in d_list),
            randn(k, e, h, std=e ** -0.5), randn(k, h, std=0.1),
            randn(k, h, 1, std=h ** -0.5), randn(k, 1, std=0.1),
            torch.tensor(idx, dtype=torch.int32, device=dev))


@pytest.mark.cuda
class TestExpertFusionKernel:
    @pytest.mark.parametrize("b,p_list,d_list,e,k,idx", [
        (3, (64, 16, 4, 1), (8, 16, 32, 64), 32, 3, [2, 0, 1]),
        (2, (100, 25), (32, 24), 64, 2, [1, 0]),
        (2, (3136, 784, 196, 49), (96, 192, 384, 768), 768, 6, [5, 2]),
    ])
    def test_matches_plain_version(self, dev, b, p_list, d_list, e, k, idx):
        args = _inputs(dev, b, p_list, d_list, e, k, idx)
        before = ef.LAUNCHES
        out = ef.expert_fusion_gather(*args)
        torch.cuda.synchronize()
        assert ef.LAUNCHES == before + 1
        ref = ef.expert_fusion_gather_reference(*args)
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, ref, **LOOSE)

    def test_out_of_range_expert_poisons_only_its_sample(self, dev):
        args = list(_inputs(dev, 2, (64, 16), (8, 16), 32, 3, [1, 3]))
        out = ef.expert_fusion_gather(*args)
        torch.cuda.synchronize()
        assert torch.isnan(out[1]).all() and torch.isfinite(out[0]).all()
        args[7] = args[7][:1]
        args[0] = tuple(x[:1] for x in args[0])
        torch.testing.assert_close(
            out[:1], ef.expert_fusion_gather_reference(*args), **LOOSE)

    def test_empty_batch(self, dev):
        args = list(_inputs(dev, 1, (64, 16), (8, 16), 32, 3, [0]))
        args[0] = tuple(x[:0] for x in args[0])
        args[7] = args[7][:0]
        assert ef.expert_fusion_gather(*args).shape == (0, 64, 32)


def _bwd_close(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        scale = w.abs().max().item()
        torch.testing.assert_close(g, w, rtol=0, atol=5e-2 * scale)
        share = ((g - w).abs() > 2e-3 * scale).float().mean().item()
        assert share <= 0.01, f"output {i}: {share:.2%} beyond 2e-3*max|ref|"


def _bwd_outs(outs):
    d_xs, d_wp, d_bp, d_w1, d_b1, d_w2 = outs
    return list(d_xs) + list(d_wp) + list(d_bp) + [d_w1, d_b1, d_w2]


@pytest.mark.cuda
class TestExpertFusionBackwardKernel:
    @pytest.mark.parametrize("b,p_list,d_list,e,k,idx", [
        (3, (64, 16, 4, 1), (8, 16, 32, 64), 64, 3, [2, 0, 1]),
        (2, (100, 25), (32, 24), 64, 2, [1, 0]),
        (2, (3136, 784, 196, 49), (96, 192, 384, 768), 768, 6, [5, 2]),
    ])
    def test_matches_plain_version(self, dev, b, p_list, d_list, e, k, idx):
        xs, wp, bp, w1, b1, w2, _, ids = _inputs(dev, b, p_list, d_list, e, k,
                                                 idx)
        g = torch.Generator(device=dev).manual_seed(7)
        d_out = torch.randn((b, max(p_list), e), generator=g, device=dev)
        before = ef.BWD_LAUNCHES
        out = ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2, ids, d_out)
        torch.cuda.synchronize()
        assert ef.BWD_LAUNCHES == before + 1
        ref = ef.expert_fusion_gather_bwd_reference(xs, wp, bp, w1, b1, w2,
                                                    ids, d_out)
        got = _bwd_outs(out)
        assert all(torch.isfinite(t).all() for t in got)
        _bwd_close(got, _bwd_outs(ref))

    def test_out_of_range_expert_poisons_only_its_sample(self, dev):
        xs, wp, bp, w1, b1, w2, _, ids = _inputs(dev, 2, (64, 16), (8, 16),
                                                 64, 3, [1, 3])
        d_out = torch.randn((2, 64, 64), device=dev)
        got = _bwd_outs(ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2,
                                                    ids, d_out))
        torch.cuda.synchronize()
        assert all(torch.isnan(t[1]).all() and torch.isfinite(t[0]).all()
                   for t in got)
        ref = _bwd_outs(ef.expert_fusion_gather_bwd_reference(
            tuple(x[:1] for x in xs), wp, bp, w1, b1, w2, ids[:1],
            d_out[:1].contiguous()))
        _bwd_close([t[:1] for t in got], ref)

    def test_fused_function_grads_match_autograd_of_plain(self, dev):
        args = _inputs(dev, 3, (64, 16, 4, 1), (8, 16, 32, 64), 64, 3,
                       [2, 0, 1])
        xs, wp, bp, w1, b1, w2, b2, ids = args
        g = torch.randn((3, 64, 64), device=dev)

        def grads(fn):
            leaves = [t.detach().clone().requires_grad_()
                      for t in (w1, b1, w2, b2, *xs, *wp, *bp)]
            n = len(xs)
            lx, lw, lb = leaves[4:4 + n], leaves[4 + n:4 + 2 * n], leaves[4 + 2 * n:]
            out = fn(lx, lw, lb, *leaves[:4])
            return torch.autograd.grad(out, leaves, g)

        before = (ef.LAUNCHES, ef.BWD_LAUNCHES)
        got = grads(lambda x, w, b, w1_, b1_, w2_, b2_:
                    ef.FusedExpertGather.apply(ids, w1_, b1_, w2_, b2_,
                                               *x, *w, *b))
        assert (ef.LAUNCHES, ef.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
        want = grads(lambda x, w, b, w1_, b1_, w2_, b2_:
                     ef.expert_fusion_gather_reference(x, w, b, w1_, b1_, w2_,
                                                       b2_, ids))
        assert torch.count_nonzero(got[3]) == 0          # attn_b2
        for i, (a, w) in enumerate(zip(got, want)):
            if i == 3:
                continue
            err = (a.float() - w.float()).abs().max() / w.abs().max().clamp(min=1e-6)
            assert err < 5e-2, f"input {i}: rel err {err}"
