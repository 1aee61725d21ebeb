"""The port's fused GLoRIA similarity (medmoe_torch/ops/gloria_attention.py)
against the JAX package's ``gloria_similarity_pallas``, whose Pallas
kernels run in interpret mode on the CPU (as tests/test_pallas.py runs
them). On CPU tensors the port runs its plain versions of K3/K4, so these
tests hold that arithmetic; tests/test_torch_kernels_cuda.py holds the
kernels against it on the card.

Tolerances. Forward: rtol 1e-4 — both sides round the inputs to bf16 and
take every product and sum in f32 (a bf16·bf16 product is exact in f32),
so only f32 summation order differs. Backward: 2e-3·max|ref| per output —
the cotangent products take bf16(d_wei), bf16(a2) and bf16(d_scores) on
both sides, and an f32 difference of one ulp can put a value on the other
side of a bf16 rounding boundary, a change of 2^-8 relative in one term.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from medmoe_tpu.ops import losses as JL
from medmoe_tpu.ops.pallas.gloria_attention import (_sim_forward,
                                                    gloria_similarity_pallas)
from medmoe_torch.ops import gloria_attention as ga
from medmoe_torch.ops import losses as TL

torch.set_num_threads(1)

# (b_img, b_txt, d, h, w, t): the JAX package's own kernel test shape, and a
# rectangular case with more than one of the TPU kernel's text blocks
SHAPES = [(4, 4, 128, 8, 8, 25), (8, 16, 32, 4, 4, 9)]
TEMPS = (4.0, 5.0, 10.0)
# ((b_img, b_txt, d, h, w, t), temp1) beyond the kernels' single word tile
# and temp1 range, which the plain versions take as the JAX functions do:
# captions of 40 words (two tiles of 32), square and rectangular, and
# temp1 = 100 (the kernels take |temp1| <= 80)
WIDE = [((4, 4, 64, 6, 6, 40), 4.0), ((6, 10, 32, 4, 4, 40), 4.0),
        ((4, 4, 128, 8, 8, 25), 100.0)]


def _inputs(b_img, b_txt, d, h, w, t, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b_img, d, h, w).astype(np.float32),
            rng.randn(b_txt, d, t).astype(np.float32),
            rng.randint(3, t + 1, size=b_txt).astype(np.int32),
            rng.randn(b_img, b_txt).astype(np.float32))


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.fixture(scope="module", params=SHAPES, ids=["square", "rectangular"])
def case(request):
    img, words, cap, wgt = _inputs(*request.param)

    def loss(i, w_):
        return jnp.sum(jnp.asarray(wgt) * gloria_similarity_pallas(
            i, w_, jnp.asarray(cap), *TEMPS))

    with pltpu.force_tpu_interpret_mode():
        sim = gloria_similarity_pallas(jnp.asarray(img), jnp.asarray(words),
                                       jnp.asarray(cap), *TEMPS)
        grads = jax.grad(loss, argnums=(0, 1))(jnp.asarray(img),
                                               jnp.asarray(words))
    return (img, words, cap, wgt, np.asarray(sim),
            [np.asarray(g) for g in grads])


def _close(got, want, scale):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=scale * np.abs(want).max())


@pytest.fixture(scope="module", params=WIDE,
                ids=["square-T40", "rectangular-T40", "temp1-100"])
def wide_case(request):
    shape, temp1 = request.param
    temps = (temp1,) + TEMPS[1:]
    img, words, cap, wgt = _inputs(*shape, seed=5)

    def loss(i, w_):
        return jnp.sum(jnp.asarray(wgt) * gloria_similarity_pallas(
            i, w_, jnp.asarray(cap), *temps))

    with pltpu.force_tpu_interpret_mode():
        sim = gloria_similarity_pallas(jnp.asarray(img), jnp.asarray(words),
                                       jnp.asarray(cap), *temps)
        grads = jax.grad(loss, argnums=(0, 1))(jnp.asarray(img),
                                               jnp.asarray(words))
    return (img, words, cap, wgt, temps, np.asarray(sim),
            [np.asarray(g) for g in grads])


class TestWideAgainstJax:
    """The plain versions past the kernels' limits, against the JAX
    kernel, at the tolerances of TestAgainstJax."""

    def test_forward(self, wide_case):
        img, words, cap, _, temps, sim, _ = wide_case
        out = ga.gloria_similarity_forward(*_torch(img, words, cap), *temps)
        np.testing.assert_allclose(out.numpy(), sim, rtol=1e-4, atol=1e-5)

    def test_backward(self, wide_case):
        img, words, cap, wgt, temps, _, (g_img, g_words) = wide_case
        d_img, d_words = ga.gloria_similarity_backward(
            *_torch(img, words, cap, wgt), *temps)
        _close(d_img, g_img, 2e-3)
        _close(d_words, g_words, 2e-3)


class TestAgainstJax:
    def test_forward(self, case):
        img, words, cap, _, sim, _ = case
        before = ga.LAUNCHES
        out = ga.gloria_similarity_forward(*_torch(img, words, cap), *TEMPS)
        assert ga.LAUNCHES == before                     # CPU: no kernel
        assert out.dtype == torch.float32 and out.shape == sim.shape
        np.testing.assert_allclose(out.numpy(), sim, rtol=1e-4, atol=1e-5)

    def test_backward(self, case):
        img, words, cap, wgt, _, (g_img, g_words) = case
        d_img, d_words = ga.gloria_similarity_bwd_reference(
            *_torch(img, words, cap, wgt), *TEMPS)
        assert d_img.shape == img.shape and d_words.shape == words.shape
        _close(d_img, g_img, 2e-3)
        _close(d_words, g_words, 2e-3)

    def test_autograd_function(self, case):
        img, words, cap, wgt, sim, (g_img, g_words) = case
        i, w = (torch.from_numpy(a).requires_grad_() for a in (img, words))
        out = ga.gloria_similarity(i, w, torch.from_numpy(cap), *TEMPS)
        (out * torch.from_numpy(wgt)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), sim, rtol=1e-4,
                                   atol=1e-5)
        _close(i.grad, g_img, 2e-3)
        _close(w.grad, g_words, 2e-3)

    def test_loss_class_pallas_matches_jax(self, case):
        img, words, cap = case[:3]
        b = min(img.shape[0], words.shape[0])
        args = (img[:b], words[:b], cap[:b])
        with pltpu.force_tpu_interpret_mode():
            want = JL.GLORIALocalContrastiveLoss(impl="pallas")(
                *map(jnp.asarray, args))
        got = TL.GLORIALocalContrastiveLoss(impl="pallas")(*_torch(*args))
        np.testing.assert_allclose(
            [got.loss0.item(), got.loss1.item()],
            [float(want.loss0), float(want.loss1)], rtol=1e-4)


class TestFunction:
    def test_frozen_words_skip_d_words(self):
        img, words, cap, wgt = _inputs(3, 3, 32, 4, 4, 9, seed=1)
        grads = []
        for words_grad in (True, False):
            i = torch.from_numpy(img).requires_grad_()
            w = torch.from_numpy(words).requires_grad_(words_grad)
            out = ga.gloria_similarity(i, w, torch.from_numpy(cap), *TEMPS)
            (out * torch.from_numpy(wgt)).sum().backward()
            assert (w.grad is None) == (not words_grad)
            grads.append(i.grad)
        torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)

    def test_bf16_inputs_keep_their_dtype(self):
        img, words, cap, wgt = _inputs(2, 3, 32, 4, 4, 9, seed=2)
        i, w = (torch.from_numpy(a).to(torch.bfloat16) for a in (img, words))
        d_img, d_words = ga.gloria_similarity_backward(
            i, w, torch.from_numpy(cap), torch.from_numpy(wgt), *TEMPS)
        assert d_img.dtype == d_words.dtype == torch.bfloat16
        # the function of bf16 inputs is the function of their f32 values
        want = ga.gloria_similarity_bwd_reference(
            i.float(), w.float(), torch.from_numpy(cap),
            torch.from_numpy(wgt), *TEMPS)
        for a, b in zip((d_img, d_words), want):
            torch.testing.assert_close(a, b.to(torch.bfloat16), rtol=0,
                                       atol=0)

    def test_chunks_do_not_change_the_result(self, monkeypatch):
        img, words, cap, wgt = _inputs(3, 5, 32, 4, 4, 9, seed=3)
        args = _torch(img, words, cap, wgt)
        whole = ga.gloria_similarity_bwd_reference(*args, *TEMPS)
        sim = ga.gloria_similarity_reference(*args[:3], *TEMPS)
        monkeypatch.setattr(ga, "_PLAIN_BYTES", 1)        # one caption a chunk
        torch.testing.assert_close(
            ga.gloria_similarity_reference(*args[:3], *TEMPS), sim)
        # chunks change only the f32 order of d_ctx's sum over captions
        for a, b in zip(ga.gloria_similarity_bwd_reference(*args, *TEMPS),
                        whole):
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-5 * b.abs().max().item())

    def test_local_map_layout_is_read_without_a_copy(self):
        fused = torch.randn(2, 16, 32).to(torch.bfloat16)    # [B, P, E]
        img = fused.permute(0, 2, 1).reshape(2, 32, 4, 4)    # as models/moe.py
        ctx, words_p, caps = ga._kernel_inputs(
            img, torch.randn(3, 32, 9), torch.tensor([3, 9, 5]))
        assert ctx.data_ptr() == fused.data_ptr() and ctx.shape == (2, 16, 32)
        assert words_p.shape == (3, 32, ga.WORD_TILE)
        assert torch.count_nonzero(words_p[..., 9:]) == 0
        assert caps.dtype == torch.int32
        _, words_p, _ = ga._kernel_inputs(img, torch.randn(3, 32, 40),
                                          torch.tensor([3, 40, 5]))
        assert words_p.shape == (3, 32, 2 * ga.WORD_TILE)    # two word tiles
        assert torch.count_nonzero(words_p[..., 40:]) == 0

    @pytest.mark.parametrize("bad", [
        dict(words=(2, 16, 9)),              # D differs
        dict(cap=(3,)),                      # one length per caption
        dict(img_dtype=torch.int32),
        dict(img=(2, 32, 4)),
    ])
    def test_shape_checks_raise(self, bad):
        img = torch.randn(*bad.get("img", (2, 32, 4, 4))).to(
            bad.get("img_dtype", torch.float32))
        words = torch.randn(*bad.get("words", (2, 32, 9)))
        cap = torch.full(bad.get("cap", (2,)), 5, dtype=torch.int32)
        with pytest.raises((ValueError, TypeError)):
            ga.gloria_similarity_forward(img, words, cap,
                                         bad.get("temp1", 4.0))

    def test_scratch_bytes_at_b256(self):
        # captions of 40 words pad to two tiles of 32: bf16(d_wei) and 4
        # per-word vectors per pair, K4b's f32 accumulators (Σ dnum·wei and
        # Σ c2 per caption) and the partial products of its two slices of
        # a chunk's K, and the prologue's passes over 8 images: E
        # [2, M, B_txt·TPAD], Σ_m e of 25 M tiles, 3 sums of 3 D tiles of
        # 256, and wei
        assert ga.K4B_SLICES == 2
        n = 256 * 64
        assert ga.backward_scratch_bytes(256, 256, 3136, 768, 40) == \
            256 * 256 * (768 * 64 * 2 + 4 * 64 * 4) + 256 * 769 * 64 * 4 \
            + 2 * 256 * 768 * 64 * 4 \
            + 8 * (2 * n * 3136 * 2 + 25 * n * 4 + 3 * 3 * n * 4
                   + 256 * 768 * 64 * 4)
        # E takes M rows as they are; M tiles round up to 128, D tiles to 256
        assert ga.backward_scratch_bytes(3, 5, 35, 48, 9) == \
            15 * (48 * 32 * 2 + 4 * 32 * 4) + 5 * 49 * 32 * 4 \
            + 2 * 5 * 48 * 32 * 4 \
            + 3 * (2 * 160 * 35 * 2 + 160 * 4 + 3 * 160 * 4
                   + 5 * 48 * 32 * 4)

    def test_dctx_chunk_at_b256(self):
        # K4a's Z, [images, M, B_txt·2·TPAD] bf16, within 1.7 GB
        per_image = 3136 * 256 * 64 * 2
        assert ga.image_chunk(256, 256, 3136, 25) == (16, 16 * per_image)
        assert ga.image_chunk(3, 5, 35, 40) == (3, 3 * 35 * 5 * 128 * 2)

    @pytest.mark.parametrize("t,tp,images", [(25, 32, 16), (128, 128, 4)])
    def test_image_chunk_and_scratch_at_b256(self, t, tp, images):
        # E (K3, the prologue) and Z (K4a) take M·B_txt·2·TPAD bf16 an image;
        # the chunk holds as many images as fit in 1.7 GB
        per_image = 3136 * 256 * 2 * tp * 2
        assert ga.image_chunk(256, 256, 3136, t) == (images, images * per_image)
        assert images * per_image <= 1.7e9 < (images + 1) * per_image
        n = 256 * tp
        assert ga.backward_scratch_bytes(256, 256, 3136, 768, t) == \
            256 * 256 * (768 * tp * 2 + 4 * tp * 4) + 256 * 769 * tp * 4 \
            + 2 * 256 * 768 * tp * 4 \
            + images * (per_image + 25 * n * 4 + 3 * 3 * n * 4
                        + 256 * 768 * tp * 4)


CARD_80GB = 80 * 10 ** 9


class TestKeptState:
    """The rule by which K3 keeps its f32 state for the backward's prologue,
    and the state's bytes; the kept path against the recompute path, bit
    for bit, is a card test (tests/test_torch_kernels_cuda.py)."""

    @pytest.mark.parametrize("b_img,t,tp", [(256, 25, 32), (128, 25, 32),
                                             (256, 40, 64)])
    def test_kept_bytes(self, b_img, t, tp):
        # f32 wei [B_img, B_txt, D, TPAD], Σ_m e of 25 M tiles of 128 rows
        # and 3 sums of 3 D tiles of 256, over B_txt·TPAD words an image
        n = 256 * tp
        assert ga.kept_bytes(b_img, 256, 3136, 768, t) == \
            b_img * (256 * 768 * tp * 4 + 25 * n * 4 + 3 * 3 * n * 4)
        # E takes M rows as they are; M tiles round up to 128, D tiles to 256
        assert ga.kept_bytes(3, 5, 35, 48, 9) == \
            3 * (5 * 48 * 32 * 4 + 160 * 4 + 3 * 160 * 4)

    def test_kept_bytes_at_b256_flagship(self):
        # 6.44 GB of wei, 0.21 GB of Σ_m e and 0.08 GB of partial sums
        assert ga.kept_bytes(256, 256, 3136, 768, 25) == \
            6_442_450_944 + 209_715_200 + 75_497_472
        assert ga.kept_bytes(128, 256, 3136, 768, 25) * 2 == \
            ga.kept_bytes(256, 256, 3136, 768, 25)

    @pytest.mark.parametrize("b_img,t,keeps", [
        (256, 25, True),      # 6.73 GB of an 80 GB card
        (128, 25, True),      # a rank's block under global negatives
        (256, 128, False),    # wei alone is 25.8 GB: over a quarter
        (128, 128, True),     # 12.9 GB of wei
    ])
    def test_keep_rule_on_an_80gb_card(self, b_img, t, keeps):
        assert ga.keeps_state(b_img, 256, 3136, 768, t, CARD_80GB) is keeps
        assert (4 * ga.kept_bytes(b_img, 256, 3136, 768, t)
                <= CARD_80GB) is keeps
        assert ga.keeps_state(b_img, 256, 3136, 768, t, 0) is False

    def test_the_chunk_scratch_is_the_state_of_a_chunk(self):
        images, shapes = ga._pass_scratch(256, 256, 3136, 768, 25, wei=True)
        assert shapes[1:] == ga._state(images, 256, 3136, 768, 25)
        assert ga._bytes(shapes[1:]) * 256 == \
            ga.kept_bytes(256, 256, 3136, 768, 25) * images

    def test_kept_only_when_a_gradient_will_be_taken(self, monkeypatch):
        img, words, cap, _ = _inputs(3, 3, 32, 4, 4, 9, seed=1)
        cap = torch.from_numpy(cap)
        # off a card nothing is kept
        i = torch.from_numpy(img).requires_grad_()
        assert not ga._keeps(i, torch.from_numpy(words), cap)
        monkeypatch.setattr(ga, "_card_memory", lambda t: CARD_80GB)
        for img_grad, words_grad in ((True, False), (False, True),
                                     (True, True)):
            i = torch.from_numpy(img).requires_grad_(img_grad)
            w = torch.from_numpy(words).requires_grad_(words_grad)
            assert ga._keeps(i, w, cap)
            with torch.no_grad():
                assert not ga._keeps(i, w, cap)
        assert not ga._keeps(torch.from_numpy(img), torch.from_numpy(words),
                             cap)

    def test_function_with_keep_on_the_cpu_keeps_nothing(self, monkeypatch):
        # the CPU path takes the keep decision and runs the plain versions:
        # no state, and the gradient of the recompute path
        img, words, cap, wgt = _inputs(3, 3, 32, 4, 4, 9, seed=1)
        monkeypatch.setattr(ga, "_card_memory", lambda t: CARD_80GB)
        seen = []
        real = ga.gloria_similarity_backward

        def backward(*args, kept=None, **kw):
            seen.append(kept)
            return real(*args, kept=kept, **kw)

        monkeypatch.setattr(ga, "gloria_similarity_backward", backward)
        i = torch.from_numpy(img).requires_grad_()
        out = ga.gloria_similarity(i, torch.from_numpy(words),
                                   torch.from_numpy(cap), *TEMPS)
        (out * torch.from_numpy(wgt)).sum().backward()
        assert len(seen) == 1 and seen[0].tensors is None
        want, _ = ga.gloria_similarity_bwd_reference(
            torch.from_numpy(img), torch.from_numpy(words),
            torch.from_numpy(cap), torch.from_numpy(wgt), *TEMPS,
            need_words=False)
        torch.testing.assert_close(i.grad, want, rtol=0, atol=0)

    def test_counter_names(self):
        from medmoe_torch.utils import trace

        assert (trace.GLORIA_KEPT, trace.GLORIA_RECOMPUTED) == \
            ("gloria.kept", "gloria.recomputed")
        before = trace.counters()
        trace.count(trace.GLORIA_KEPT)
        after = trace.counters()
        assert after["gloria.kept"] == before.get("gloria.kept", 0) + 1
        assert after.get("gloria.recomputed") == \
            before.get("gloria.recomputed")


class TestDispatch:
    def test_auto_takes_the_einsum_path_on_the_cpu(self):
        img, words, cap, _ = _inputs(4, 4, 16, 3, 3, 6, seed=4)
        args = _torch(img, words, cap)
        loss = TL.GLORIALocalContrastiveLoss()
        assert loss.resolve_impl("sum", args[0]) == "xla"
        got = loss(*args)
        want = TL.gloria_local_loss(*args)
        assert got.loss0.item() == want.loss0.item()
        assert got.loss1.item() == want.loss1.item()

    @pytest.mark.parametrize("impl,agg,batch,want", [
        ("auto", "sum", 128, "pallas"),
        ("auto", "sum", 64, "xla"),          # the JAX threshold: above 64
        ("auto", "mean", 128, "xla"),        # the kernels compute agg=sum
        ("pallas", "mean", 4, "pallas"),
        ("xla", "sum", 256, "xla"),
    ])
    def test_resolve_impl_on_cuda_tensors(self, impl, agg, batch, want):
        fake = types.SimpleNamespace(is_cuda=True, shape=(batch, 8, 4, 4))
        assert TL.GLORIALocalContrastiveLoss(impl=impl).resolve_impl(
            agg, fake) == want


def _staged_similarity(img, words, cap, temps, d_tile, m_tile=128):
    """The staging of csrc/gloria_attention.cu in torch ops, f32: per image
    the scores of all captions as one product S [M, B_txt·TPAD] (F1), the
    masked word softmax and e = exp(temp1·a1 - max(temp1, 0)) (0 past T),
    E = [bf16 hi ; bf16 lo] of e in F1's [2, M, B_txt·TPAD] layout, Σ_m e
    over ``m_tile``-row M tiles, each tile's sum taken, then the tiles in
    order; weiᵀ [B_txt·TPAD, D] = E_hiᵀ·ctx + E_loᵀ·ctx times 1/Σ_m e (F2),
    and per ``d_tile``-wide D tile the partial sums of w·wei, wei² and w²;
    then (F3) the D tiles' partials in order, cos and sim."""
    temp1, temp2, temp3 = temps
    bf = torch.bfloat16
    b_img, d, h, w = img.shape
    m = h * w
    ctx = torch.from_numpy(img).reshape(b_img, d, m).to(bf).float()
    b_txt, _, t = words.shape
    tp = ga._tpad(t)
    wt = torch.zeros((b_txt, d, tp))
    wt[..., :t] = torch.from_numpy(words).to(bf).float()     # [B_txt, D, TPAD]
    w_cols = wt.permute(1, 0, 2).reshape(d, b_txt * tp)       # [D, N]
    word = torch.arange(tp) < t
    valid = torch.arange(tp)[None, :] < torch.from_numpy(cap).long()[:, None]
    sims = []
    for b in range(b_img):
        s_b = (ctx[b].T @ w_cols).reshape(m, b_txt, tp)        # F1's product
        masked = torch.where(valid, s_b, ga.NEG_INF)
        a1 = torch.softmax(torch.where(word, masked, -torch.inf), dim=-1)
        e = torch.where(word, torch.exp(temp1 * a1 - max(temp1, 0.0)), 0.0)
        e = e.reshape(m, b_txt * tp)                          # E's rows
        hi = e.to(bf).float()
        lo = (e - hi).to(bf).float()
        tiles = [e[m0:m0 + m_tile].sum(0) for m0 in range(0, m, m_tile)]
        e_sum = torch.zeros(b_txt * tp)
        for part in tiles:
            e_sum = e_sum + part
        rdiv = torch.where(word.repeat(b_txt), 1.0 / e_sum, 0.0)
        wei_t = (hi.T @ ctx[b].T + lo.T @ ctx[b].T) * rdiv[:, None]  # [N, D]
        w_t = w_cols.T                                        # [N, D]
        num = torch.zeros(b_txt * tp)
        wei2 = torch.zeros(b_txt * tp)
        w2 = torch.zeros(b_txt * tp)
        for d0 in range(0, d, d_tile):
            cols = slice(d0, d0 + d_tile)
            num = num + (w_t[:, cols] * wei_t[:, cols]).sum(1)
            wei2 = wei2 + wei_t[:, cols].pow(2).sum(1)
            w2 = w2 + w_t[:, cols].pow(2).sum(1)
        den = torch.clamp(w2.sqrt() * wei2.sqrt(), min=1e-8)
        cos = (num / den).reshape(b_txt, tp)
        row = torch.where(valid & word, torch.exp(temp2 * cos), 0.0)
        sims.append(temp3 * torch.log(row.sum(-1)))
    return torch.stack(sims)


@functools.lru_cache(maxsize=None)
def _staged_case(t):
    """Inputs of the staged test at captions of ``t`` words (M = 132,
    D = 288: two M tiles and a ragged last D tile at either width), and
    the JAX kernel's similarity in interpret mode."""
    img, words, cap, _ = _inputs(3, 5, 288, 12, 11, t, seed=7)
    with pltpu.force_tpu_interpret_mode():
        jax_sim = _sim_forward(jnp.asarray(img), jnp.asarray(words),
                               jnp.asarray(cap), *TEMPS)
    return img, words, cap, np.asarray(jax_sim)


@pytest.mark.parametrize("d_tile", [128, 256])
@pytest.mark.parametrize("t", [9, 32, 40, 128])
def test_staged_form_matches_reference_and_jax(t, d_tile):
    """The kernels' decomposition (bf16 hi + lo of e in E's [M, B_txt·TPAD]
    rows, Σ_m e over 128-row tiles, the partial sums over D tiles of the
    mma.sync design's 128 and the wgmma design's 256) against the plain
    version and the JAX kernel in interpret mode, at M = 132 (two M
    tiles), D = 288 and B_txt = 5: rtol 1e-4, as TestAgainstJax's forward.
    hi + lo carries e to 2^-16 relative, far inside it."""
    img, words, cap, jax_sim = _staged_case(t)
    got = _staged_similarity(img, words, cap, TEMPS, d_tile)
    want = ga.gloria_similarity_reference(*_torch(img, words, cap), *TEMPS)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), jax_sim, rtol=1e-4, atol=1e-5)


def _staged_dwords(img, words, cap, g, temps, chunk, slices=1):
    """The staging of K4b in torch ops, f32 sums of bf16 values: per pair
    the prologue's dnum, c2 and f32 wei and pass 1's bf16(d_scores) (Z's
    second half), as the plain version forms them; then d_words = Σ_b
    dnum·wei (f32 wei, images in order) + Σ over chunks of images, and
    within a chunk over ``slices`` slices of its K, of one product
    ctx_sliceᵀ·bf16(d_scores) [D, B_txt·T], added in order. K is the
    chunk's rows (image, m) in order, in steps of 64 rows; slice s takes
    steps [s·nk/slices, (s+1)·nk/slices) of the chunk's nk, as
    csrc/gloria_attention_bwd.cu cuts it; + (Σ_b c2)·w."""
    temp1, temp2, temp3 = temps
    bf = torch.bfloat16
    b_img, d, h, w = img.shape
    ctx, wt = ga._plain_inputs(*_torch(img, words))          # [B, D, M]
    caps = torch.from_numpy(cap).long()
    cell = ga._plain_chain(ctx, wt, caps, temp1, temp2)
    dcos = torch.from_numpy(g).T[..., None] * (temp2 * temp3) * cell["row"] \
        / cell["rowsum"]
    den, mask = cell["den"], (cell["den_raw"] > 1e-8).float()
    dnum = dcos / den                                         # [B_txt, B, T]
    dden = -dcos * cell["num"] / (den * den) * mask
    c2 = dden * cell["nwei"] / torch.clamp(cell["nw"], min=1e-20)
    d_wei = dnum[:, :, None] * cell["w32"] + (
        dden * cell["nw"] / torch.clamp(cell["nwei"], min=1e-20)
    )[:, :, None] * cell["wei"]
    d_a2 = torch.einsum("bdm,cbdt->cbmt", ctx, d_wei.to(bf).float())
    a1, a2 = cell["a1"], cell["a2"]
    d_a1 = temp1 * a2 * (d_a2 - torch.sum(a2 * d_a2, dim=2, keepdim=True))
    ds = (a1 * (d_a1 - torch.sum(a1 * d_a1, dim=-1, keepdim=True))).to(bf) \
        .float()                                              # [B_txt, B, M, T]
    b_txt, t = wt.shape[0], wt.shape[2]
    acc = torch.zeros((b_txt, d, t))
    c2sum = torch.zeros((b_txt, t))
    for b in range(b_img):                 # the prologue's f32 terms
        acc = acc + dnum[:, b, None, :] * cell["wei"][:, b]
        c2sum = c2sum + c2[:, b]
    for b0 in range(0, b_img, chunk):      # one product a slice of a chunk
        b1 = min(b_img, b0 + chunk)
        a = ctx[b0:b1].permute(1, 0, 2).reshape(d, -1)        # [D, K]
        z = ds[:, b0:b1].permute(1, 2, 0, 3).reshape(a.shape[1], -1)
        nk = -(-a.shape[1] // 64)
        for s in range(slices):
            rows = slice(64 * (s * nk // slices), 64 * ((s + 1) * nk // slices))
            acc = acc + (a[:, rows] @ z[rows]).reshape(d, b_txt, t) \
                .permute(1, 0, 2)
    return acc + c2sum[:, None, :] * wt


@functools.lru_cache(maxsize=None)
def _jax_dwords(shape):
    """The staged d_words test's inputs at ``shape`` and the JAX kernel's
    d_words in interpret mode."""
    img, words, cap, wgt = _inputs(*shape, seed=9)

    def loss(w_):
        return jnp.sum(jnp.asarray(wgt) * gloria_similarity_pallas(
            jnp.asarray(img), w_, jnp.asarray(cap), *TEMPS))

    with pltpu.force_tpu_interpret_mode():
        jax_words = np.asarray(jax.grad(loss)(jnp.asarray(words)))
    return img, words, cap, wgt, jax_words


@pytest.mark.parametrize("shape,chunks,slices", [
    ((3, 5, 32, 12, 11, 9), (1, 2, 3), 1),   # M = 132, B_img != B_txt
    ((4, 4, 64, 6, 6, 40), (1, 3), 1),       # captions of 40 words
    # K4b's slices of a chunk's K: 3 to 7 steps of 64 rows a chunk at M =
    # 132, so slice boundaries fall inside images and inside chunks
    ((3, 5, 32, 12, 11, 9), (1, 2, 3), 2),
    ((4, 4, 64, 6, 6, 40), (1, 3), 3),
], ids=["shape0-chunks0", "shape1-chunks1", "M132-slices2",
        "T40-slices3"])
def test_staged_dwords_matches_reference_and_jax(shape, chunks, slices):
    """K4b's decomposition (the f32 Σ dnum·wei and (Σ c2)·w terms apart
    from one product over Z's bf16(d_scores) a slice of a chunk of images)
    against the plain version, for every chunk size: within 1e-5·max|ref|
    (only the f32 order of the sums over images differs); and against the
    JAX kernel's d_words in interpret mode within 2e-3·max|ref|
    (TestAgainstJax's backward tolerance)."""
    img, words, cap, wgt, jax_words = _jax_dwords(shape)
    _, want = ga.gloria_similarity_bwd_reference(*_torch(img, words, cap, wgt),
                                                 *TEMPS)
    for chunk in chunks:
        got = _staged_dwords(img, words, cap, wgt, TEMPS, chunk, slices)
        _close(got, want, 1e-5)
        _close(got, jax_words, 2e-3)
