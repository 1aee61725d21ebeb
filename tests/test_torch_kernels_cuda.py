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

The GLoRIA kernels (K3, K4a, K4b) against their plain versions: K3 within
1e-3·max|ref| (the same bf16 inputs, f32 sums in another order, and the
softmax over regions offset by max(temp1, 0) instead of its maximum); K4a
and K4b every element within 1e-2·max|ref| and at most 1% of the elements
beyond 2e-3·max|ref| — bf16(a2), bf16(d_wei) and bf16(d_scores) feed the
cotangent products, and a value that lands on the other side of a bf16
rounding boundary moves its term by one bf16 step. Worst measured on the
H100 at B=256 flagship and on the odd shapes with the single-pass K4a:
K3 2.4e-7·max|ref|; d_img 3.2e-3·max|ref| and d_words 3.6e-3·max|ref|,
with at most 4.6e-4 of the elements beyond 2e-3·max|ref|. Expert-branch
widths the kernels do not take (``check_kernel_limits``: E % 32, H % 8,
H <= 2048) raise before K1 launches.

The kernels sum without atomics, so two calls agree bit for bit; K1 and
K2 run over chunks of images agree bit for bit with one chunk (a sample's
outputs are its own). K4b sums over images chunk by chunk, so its chunks
reorder that sum: d_words over other chunk sizes agrees within the
tolerance above, not bit for bit.
"""

import hashlib
import subprocess

import numpy as np
import pytest
import torch

from medmoe_torch.ops import expert_fusion as ef
from medmoe_torch.ops import gloria_attention as ga
from medmoe_torch.ops import _scratch

LOOSE = dict(rtol=2e-2, atol=2e-3)
# (nvcc release, card) that test_gemm_core_a_layout_leaves_gloria_bits's
# digests were recorded with
DIGESTS_RECORDED_WITH = ("12.9", "NVIDIA H100 80GB HBM3")


def _nvcc_release() -> str:
    """The "release X.Y" of the nvcc that builds the kernels."""
    from medmoe_torch.ops import _build

    out = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.split("release ")[1].split(",")[0]


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, p_list, d_list, e, k, idx, seed=0, h=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    h = h or e // 2

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
        (3, (64, 16, 4, 1), (8, 16, 32, 64), 64, 3, [2, 0, 1]),
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

    @pytest.mark.parametrize("b", [0, 2])
    def test_registered_op_is_the_wrapper(self, dev, b):
        """``medmoe::expert_fusion_gather`` (training, serving and exported
        programs enter K1 through it) launches K1 once (none for an empty
        batch) and gives the wrapper's bits; its fake implementation gives
        the same shape."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        xs, wp, bp, *rest = _inputs(dev, 2, (3136, 784, 196, 49),
                                    (96, 192, 384, 768), 768, 6, [5, 2])
        xs = [x[:b] for x in xs]
        rest[-1] = rest[-1][:b]
        want = ef.expert_fusion_gather(xs, wp, bp, *rest)
        before = ef.LAUNCHES
        got = torch.ops.medmoe.expert_fusion_gather(list(xs), list(wp),
                                                    list(bp), *rest)
        torch.cuda.synchronize()
        assert ef.LAUNCHES == before + (b > 0) and torch.equal(got, want)
        with FakeTensorMode() as mode:
            fake = torch.ops.medmoe.expert_fusion_gather(
                *[[mode.from_tensor(t) for t in ts] for ts in (xs, wp, bp)],
                *[mode.from_tensor(t) for t in rest])
        assert fake.shape == want.shape and fake.dtype == want.dtype
        assert fake.device == want.device

    def test_out_of_range_expert_poisons_only_its_sample(self, dev):
        args = list(_inputs(dev, 2, (64, 16), (8, 16), 64, 3, [1, 3]))
        out = ef.expert_fusion_gather(*args)
        torch.cuda.synchronize()
        assert torch.isnan(out[1]).all() and torch.isfinite(out[0]).all()
        args[7] = args[7][:1]
        args[0] = tuple(x[:1] for x in args[0])
        torch.testing.assert_close(
            out[:1], ef.expert_fusion_gather_reference(*args), **LOOSE)

    def test_empty_batch(self, dev):
        args = list(_inputs(dev, 1, (64, 16), (8, 16), 64, 3, [0]))
        args[0] = tuple(x[:0] for x in args[0])
        args[7] = args[7][:0]
        assert ef.expert_fusion_gather(*args).shape == (0, 64, 64)

    def test_width_k2_cannot_take_raises_before_k1_launches(self, dev):
        # E = 80: neither K1 nor K2 (the limits are joint, E % 32) takes
        # it, so the forward refuses it before it runs
        args = _inputs(dev, 2, (64, 16), (8, 16), 80, 3, [1, 0])
        before = ef.LAUNCHES
        with pytest.raises(ValueError):
            ef.expert_fusion_gather(*args)
        assert ef.LAUNCHES == before

    @pytest.mark.parametrize("e,h", [(64, 2056), (64, 36)])
    def test_hidden_width_the_limits_refuse_raises_before_k1_launches(
            self, dev, e, h):
        # H past K2's row step (2048) or not a multiple of 8
        args = _inputs(dev, 2, (64, 16), (8, 16), e, 3, [1, 0], h=h)
        before = ef.LAUNCHES
        with pytest.raises(ValueError):
            ef.expert_fusion_gather(*args)
        assert ef.LAUNCHES == before

    @pytest.mark.parametrize("h", [8, 160, 392])
    def test_matches_plain_version_odd_hidden(self, dev, h):
        # one, two (the second ragged) and four 128-wide tiles of H
        args = _inputs(dev, 3, (100, 25), (32, 24), 64, 2, [1, 0, 1], seed=6,
                       h=h)
        out = ef.expert_fusion_gather(*args)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, ef.expert_fusion_gather_reference(*args),
                                   **LOOSE)

    def test_chunks_of_images_match_plain_version(self, dev, monkeypatch):
        # B = 5 over chunks of 2 images (2, 2, 1): the same bits as one
        # chunk, and the plain version across each chunk boundary
        args = _inputs(dev, 5, (64, 16, 4), (8, 16, 32), 64, 3,
                       [2, 0, 1, 1, 0], seed=4)
        whole = ef.expert_fusion_gather(*args)
        per_image = ef.fwd_scratch_bytes((64, 16, 4), 64, 32)
        monkeypatch.setattr(_scratch, "CHUNK_BYTES", 2 * per_image + 1)
        assert ef.fwd_image_chunk(5, (64, 16, 4), 64, 32)[0] == 2
        before = ef.LAUNCHES
        chunked = ef.expert_fusion_gather(*args)
        torch.cuda.synchronize()
        assert ef.LAUNCHES == before + 1
        assert torch.equal(chunked, whole)
        torch.testing.assert_close(chunked,
                                   ef.expert_fusion_gather_reference(*args),
                                   **LOOSE)

    def test_is_the_same_on_every_run(self, dev):
        args = _inputs(dev, 2, (3136, 784, 196, 49), (96, 192, 384, 768), 768,
                       6, [5, 2], seed=5, h=384)
        runs = [ef.expert_fusion_gather(*args) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1])

    def test_undersized_logit_scratch_is_rejected(self, dev, monkeypatch):
        # the C entry holds the partial-logit scratch against its own
        # 128-wide tiles of H: sized for 256-wide tiles (one tile at H =
        # 160, two needed), it raises before any pass runs
        args = _inputs(dev, 2, (64, 16), (8, 16), 64, 3, [1, 0], h=160)
        monkeypatch.setattr(ef, "_TM", 256)
        before = ef.LAUNCHES
        with pytest.raises(RuntimeError, match="launch failed"):
            ef.expert_fusion_gather(*args)
        assert ef.LAUNCHES == before


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

    @pytest.mark.parametrize("b,p_list,d_list,e,h,idx", [
        # P and P_s not multiples of the 128-row tiles or the 8-row bands
        (2, (200, 100, 50, 25), (24, 24, 24, 24), 64, 48, [1, 0]),
        # E % 64 != 0 (the lifted limit), H = 16, one scale
        (3, (100,), (16,), 96, 16, [0, 1, 1]),
        # D_s = 136: two 128-wide d_x and dWp tiles, the second ragged
        (2, (50, 25), (136, 8), 64, 32, [1, 1]),
    ])
    def test_matches_plain_version_odd_tiles(self, dev, b, p_list, d_list, e,
                                             h, idx):
        xs, wp, bp, w1, b1, w2, _, ids = _inputs(dev, b, p_list, d_list, e, 2,
                                                 idx, seed=3, h=h)
        g = torch.Generator(device=dev).manual_seed(8)
        d_out = torch.randn((b, max(p_list), e), generator=g, device=dev)
        out = ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2, ids, d_out)
        torch.cuda.synchronize()
        ref = ef.expert_fusion_gather_bwd_reference(xs, wp, bp, w1, b1, w2,
                                                    ids, d_out)
        got = _bwd_outs(out)
        assert all(torch.isfinite(t).all() for t in got)
        _bwd_close(got, _bwd_outs(ref))

    def test_chunks_of_images_give_the_same_bits(self, dev, monkeypatch):
        # B = 5 over chunks of 2 images (2, 2, 1) against one chunk of 5
        args = _inputs(dev, 5, (64, 16, 4), (8, 16, 32), 64, 3,
                       [2, 0, 1, 1, 0], seed=4)
        xs, wp, bp, w1, b1, w2, _, ids = args
        d_out = torch.randn((5, 64, 64), device=dev)
        whole = _bwd_outs(ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2,
                                                      ids, d_out))
        per_image = ef.bwd_scratch_bytes((64, 16, 4), 64, 32)
        monkeypatch.setattr(_scratch, "CHUNK_BYTES", 2 * per_image + 1)
        assert ef.bwd_image_chunk(5, (64, 16, 4), 64, 32)[0] == 2
        before = ef.BWD_LAUNCHES
        chunked = _bwd_outs(ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1,
                                                        w2, ids, d_out))
        torch.cuda.synchronize()
        assert ef.BWD_LAUNCHES == before + 1
        for a, b in zip(chunked, whole):
            assert torch.equal(a, b)
        ref = ef.expert_fusion_gather_bwd_reference(xs, wp, bp, w1, b1, w2,
                                                    ids, d_out)
        _bwd_close(chunked, _bwd_outs(ref))

    def test_is_the_same_on_every_run(self, dev):
        # every sum over P and over tiles in a fixed order, without atomics
        xs, wp, bp, w1, b1, w2, _, ids = _inputs(
            dev, 2, (3136, 784, 196, 49), (96, 192, 384, 768), 768, 6, [5, 2],
            seed=5, h=384)
        d_out = torch.randn((2, 3136, 768), device=dev)
        runs = [_bwd_outs(ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2,
                                                      ids, d_out))
                for _ in range(2)]
        torch.cuda.synchronize()
        for a, b in zip(*runs):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("short", [0, 1, ef.MAX_SCALES,
                                       ef.MAX_SCALES + 1])
    def test_undersized_scratch_is_rejected(self, dev, monkeypatch, short):
        # the C entry holds the wrapper's partial-sum scratch against its
        # own tiles: one count short (dbp of scale 0 or 1, the logit
        # tiles, the row-step tiles) raises before any pass runs
        xs, wp, bp, w1, b1, w2, _, ids = _inputs(dev, 2, (200, 100, 50),
                                                 (24, 24, 24), 64, 2, [1, 0],
                                                 h=48)
        d_out = torch.randn((2, 200, 64), device=dev)
        real = ef._bwd_parts

        def fewer(p_list, h):
            parts = real(p_list, h)
            parts[short] -= 1
            return parts

        monkeypatch.setattr(ef, "_bwd_parts", fewer)
        before = ef.BWD_LAUNCHES
        with pytest.raises(RuntimeError, match="backward launch failed"):
            ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2, ids, d_out)
        assert ef.BWD_LAUNCHES == before

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

    def test_empty_batch(self, dev):
        xs, wp, bp, w1, b1, w2, _, ids = _inputs(dev, 1, (64, 16), (8, 16),
                                                 64, 3, [0])
        xs = tuple(x[:0] for x in xs)
        before = ef.BWD_LAUNCHES
        out = ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2, ids[:0],
                                          torch.empty((0, 64, 64), device=dev))
        assert ef.BWD_LAUNCHES == before
        assert [tuple(t.shape) for t in _bwd_outs(out)] == [
            (0, 64, 8), (0, 16, 16), (0, 8, 64), (0, 16, 64), (0, 64),
            (0, 64), (0, 64, 32), (0, 32), (0, 32)]

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


def _gloria_inputs(dev, b_img, b_txt, d, h, w, t, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    img = torch.randn((b_img, d, h, w), generator=g, device=dev)
    words = torch.randn((b_txt, d, t), generator=g, device=dev)
    cap = torch.randint(3, t + 1, (b_txt,), generator=g, device=dev)
    cot = torch.randn((b_img, b_txt), generator=g, device=dev)
    return img.to(torch.bfloat16), words.to(torch.bfloat16), cap, cot


def _gloria_close(got, want):
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-2 * scale)
    share = ((got - want).abs() > 2e-3 * scale).float().mean().item()
    assert share <= 0.01, f"{share:.2%} beyond 2e-3*max|ref|"


GLORIA_SHAPES = [
    (3, 5, 48, 5, 7, 9),        # B_img != B_txt, odd M, D % 64 != 0, T = 9
    (4, 3, 80, 9, 9, 32),       # one full word tile, M = 81
    (2, 2, 768, 56, 56, 25),    # flagship widths
    (3, 5, 48, 5, 7, 40),       # two word tiles
    (2, 3, 64, 9, 9, 128),      # T at its limit: four word tiles
    (3, 5, 48, 12, 11, 9),      # M = 132: two M tiles, the last ragged;
                                # B_txt·TPAD = 160: a ragged word tile
]


@pytest.mark.cuda
class TestGloriaKernels:
    @pytest.mark.parametrize("shape", GLORIA_SHAPES)
    def test_forward_matches_plain_version(self, dev, shape):
        img, words, cap, _ = _gloria_inputs(dev, *shape)
        before = ga.LAUNCHES
        out = ga.gloria_similarity_forward(img, words, cap)
        torch.cuda.synchronize()
        assert ga.LAUNCHES == before + 1
        ref = ga.gloria_similarity_reference(img, words, cap)
        assert torch.isfinite(out).all() and out.shape == ref.shape
        torch.testing.assert_close(out, ref, rtol=0,
                                   atol=1e-3 * ref.abs().max().item())

    @pytest.mark.parametrize("shape", GLORIA_SHAPES)
    def test_backward_matches_plain_version(self, dev, shape):
        img, words, cap, cot = _gloria_inputs(dev, *shape, seed=1)
        before = (ga.DCTX_LAUNCHES, ga.DWORDS_LAUNCHES)
        d_img, d_words = ga.gloria_similarity_backward(img, words, cap, cot)
        torch.cuda.synchronize()
        assert (ga.DCTX_LAUNCHES, ga.DWORDS_LAUNCHES) == (before[0] + 1,
                                                          before[1] + 1)
        ref_img, ref_words = ga.gloria_similarity_bwd_reference(
            img, words, cap, cot)
        assert d_img.shape == img.shape and d_words.shape == words.shape
        assert d_img.dtype == d_words.dtype == torch.bfloat16
        for a, b in ((d_img, ref_img), (d_words, ref_words)):
            assert torch.isfinite(a).all()
            _gloria_close(a, b)

    @pytest.mark.parametrize("bad", [
        dict(t=129), dict(d=40), dict(d=784), dict(temp1=81.0)])
    def test_wrapper_raises_on_what_the_kernels_do_not_take(self, dev, bad):
        img, words, cap, cot = _gloria_inputs(dev, 2, 2, bad.get("d", 32), 4,
                                              4, bad.get("t", 9))
        temp1 = bad.get("temp1", 4.0)
        with pytest.raises(ValueError):
            ga.gloria_similarity_forward(img, words, cap, temp1)
        with pytest.raises(ValueError):
            ga.gloria_similarity_backward(img, words, cap, cot, temp1)

    @pytest.mark.parametrize("shape", [
        (2, 2, 768, 56, 56, 25),    # flagship widths
        (3, 5, 48, 5, 7, 40),       # two word tiles
        (2, 3, 64, 9, 9, 128),      # T at its limit
        (3, 5, 48, 12, 11, 9),      # M = 132, ragged captions, B_img != B_txt
    ])
    def test_dwords_alone_matches_plain_version(self, dev, shape):
        # K4b without K4a's second pass (the words' cotangent only)
        img, words, cap, cot = _gloria_inputs(dev, *shape, seed=6)
        before = (ga.DCTX_LAUNCHES, ga.DWORDS_LAUNCHES)
        d_img, d_words = ga.gloria_similarity_backward(img, words, cap, cot,
                                                       need_img=False)
        torch.cuda.synchronize()
        assert d_img is None
        assert (ga.DCTX_LAUNCHES, ga.DWORDS_LAUNCHES) == (before[0],
                                                          before[1] + 1)
        _, ref = ga.gloria_similarity_bwd_reference(img, words, cap, cot,
                                                    need_img=False)
        assert torch.isfinite(d_words).all()
        _gloria_close(d_words, ref)

    def test_dwords_is_the_same_on_every_run(self, dev):
        # K4b sums over images in chunk order, without atomics
        img, words, cap, cot = _gloria_inputs(dev, 3, 5, 48, 12, 11, 40, seed=7)
        runs = [ga.gloria_similarity_backward(img, words, cap, cot)[1]
                for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1])

    @pytest.mark.parametrize("images", [1, 2])
    def test_dwords_over_chunks_of_images(self, dev, monkeypatch, images):
        # five images over chunks of 1 or 2: the sum over images reordered,
        # so within the tolerance of the whole-batch run, not bit for bit
        img, words, cap, cot = _gloria_inputs(dev, 5, 3, 48, 12, 11, 40,
                                              seed=8)
        whole = ga.gloria_similarity_backward(img, words, cap, cot)
        per_image = ga.image_chunk(5, 3, 132, 40)[1] // 5
        monkeypatch.setattr(_scratch, "CHUNK_BYTES", images * per_image + 1)
        assert ga.image_chunk(5, 3, 132, 40)[0] == images
        chunked = ga.gloria_similarity_backward(img, words, cap, cot)
        torch.cuda.synchronize()
        ref = ga.gloria_similarity_bwd_reference(img, words, cap, cot)
        for a, w, r in zip(chunked, whole, ref):
            _gloria_close(a, w)
            _gloria_close(a, r)

    def test_dctx_is_the_same_on_every_run(self, dev):
        # K4a sums over captions in a fixed order, without atomics
        img, words, cap, cot = _gloria_inputs(dev, 3, 5, 48, 5, 7, 40, seed=3)
        runs = [ga.gloria_similarity_backward(img, words, cap, cot,
                                              need_words=False)[0]
                for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1])

    def test_forward_is_the_same_on_every_run(self, dev):
        # K3 sums over M, D and words in a fixed order, without atomics
        img, words, cap, _ = _gloria_inputs(dev, 3, 5, 48, 12, 11, 40, seed=4)
        runs = [ga.gloria_similarity_forward(img, words, cap) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1])

    def test_prologue_is_the_same_on_every_run(self, dev):
        # the prologue's bf16(d_wei) and per-word vectors, bit for bit
        img, words, cap, cot = _gloria_inputs(dev, 3, 5, 48, 12, 11, 40, seed=5)
        runs = [ga.pair_cotangents(img, words, cap, cot, 4.0, 5.0, 10.0)
                for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0].dwei, runs[1].dwei)
        assert torch.equal(runs[0].vecs, runs[1].vecs)

    @pytest.mark.parametrize("shape,digest", [
        ((3, 5, 48, 12, 11, 40),
         "089f2196ef513c0b02618c8bfe33cb9b49580ddc23be1b5a73b1db14597a4eab"),
        ((2, 3, 768, 56, 56, 25),
         "0fca8689b6c931ab11c85ebd0fd8406a0a0ca1d99d31b620be129ece0b60d530"),
    ])
    def test_gemm_core_a_layout_leaves_gloria_bits(self, dev, shape, digest):
        """The bits of K3, the prologue and K4a on numpy inputs, as the
        kernels gave them before the GEMM core took an M-contiguous A
        (scripts/ab_torch_gloria.py prints the same digest for two trees on
        one card). Bits depend on the compiler and the card, so the digests
        hold only for the toolkit and card they were recorded with
        (``DIGESTS_RECORDED_WITH``) and the test skips on any other; record
        them anew whenever the GLoRIA kernels change on purpose."""
        found = (_nvcc_release(), torch.cuda.get_device_name(0))
        if found != DIGESTS_RECORDED_WITH:
            pytest.skip(f"digests recorded with nvcc and card "
                        f"{DIGESTS_RECORDED_WITH}, found {found}")
        b_img, b_txt, d, h, w, t = shape
        rng = np.random.RandomState(0)
        img = torch.from_numpy(rng.randn(b_img, d, h, w).astype(np.float32))
        words = torch.from_numpy(rng.randn(b_txt, d, t).astype(np.float32))
        cap = torch.from_numpy(rng.randint(3, t + 1, b_txt).astype(np.int32))
        cot = torch.from_numpy(rng.randn(b_img, b_txt).astype(np.float32))
        img, words = (x.to(torch.bfloat16).to(dev) for x in (img, words))
        cap, cot = cap.to(dev), cot.to(dev)
        temps = (4.0, 5.0, 10.0)
        sim = ga.gloria_similarity_forward(img, words, cap, *temps)
        pairs = ga.pair_cotangents(img, words, cap, cot, *temps)
        dctx, _ = ga.cotangents_of(pairs)
        got = hashlib.sha256()
        for out in (sim, pairs.dwei, pairs.vecs, dctx):
            got.update(out.float().cpu().numpy().tobytes())
        assert got.hexdigest() == digest

    def test_wrapper_raises_on_mixed_devices_and_dtypes(self, dev):
        img, words, cap, _ = _gloria_inputs(dev, 2, 2, 32, 4, 4, 9)
        with pytest.raises(ValueError):
            ga.gloria_similarity_forward(img, words.cpu(), cap)
        with pytest.raises(TypeError):
            ga.gloria_similarity_forward(img, words, cap.float())

    @pytest.mark.parametrize("words_grad", [False, True])
    def test_function_counts_its_launches(self, dev, words_grad):
        img, words, cap, cot = _gloria_inputs(dev, 3, 3, 32, 4, 4, 9, seed=2)
        i = img.clone().requires_grad_()
        w = words.clone().requires_grad_(words_grad)
        counts = ("LAUNCHES", "PROLOGUE_LAUNCHES", "DCTX_LAUNCHES",
                  "DWORDS_LAUNCHES")
        before = [getattr(ga, c) for c in counts]
        out = ga.gloria_similarity(i, w, cap)
        (out * cot).sum().backward()
        torch.cuda.synchronize()
        assert [getattr(ga, c) for c in counts] == [
            before[0] + 1, before[1] + 1, before[2] + 1,
            before[3] + int(words_grad)]
        assert (w.grad is not None) == words_grad
        ref_img, _ = ga.gloria_similarity_bwd_reference(img, words, cap, cot)
        _gloria_close(i.grad, ref_img)
