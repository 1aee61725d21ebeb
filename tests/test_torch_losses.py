"""The port's losses (medmoe_torch/ops/losses.py, ops/softmax.py) against
medmoe_tpu.ops.losses on the same numpy inputs: values and gradients.

Tolerances: float32 inputs check the algorithm (rtol 1e-4, atol 1e-5 on
values; gradients within 1e-4·max|ref|: only summation order differs).
bfloat16 inputs check the rounding points of the loss dtype (values rtol
1e-3; gradients 2e-2·max|ref|, one bf16 ulp of the inputs being 2^-8).
The bf16-residual softmax backward is exact up to f32 summation order.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medmoe_tpu.ops import losses as JL
from medmoe_tpu.ops import softmax as JS
from medmoe_torch.ops import losses as TL
from medmoe_torch.ops import softmax as TS
from medmoe_torch.ops.gloria_attention import gloria_similarity_reference

torch.set_num_threads(1)

B, D, HW, T = 4, 8, 3, 6


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    img = rng.randn(B, D, HW, HW).astype(np.float32)
    words = rng.randn(B, D, T).astype(np.float32)
    cap = np.array([2, 6, 4, 3], np.int32)
    g_img = rng.randn(B, D).astype(np.float32)
    g_txt = rng.randn(B, D).astype(np.float32)
    return img, words, cap, g_img, g_txt


def _grad_close(got, want, scale):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=scale * max(np.abs(want).max(), 1e-12))


def _jax_local(img, words, cap, dtype, chunk):
    def f(i, w):
        out = JL.gloria_local_loss(i.astype(dtype), w.astype(dtype), cap,
                                   text_chunk=chunk)
        return out.loss0 + out.loss1, (out.loss0, out.loss1)

    (_, (l0, l1)), (gi, gw) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(img), jnp.asarray(words))
    return float(l0), float(l1), gi, gw


def _torch_local(img, words, cap, dtype, chunk):
    i = torch.from_numpy(img).requires_grad_()
    w = torch.from_numpy(words).requires_grad_()
    out = TL.gloria_local_loss(i.to(dtype), w.to(dtype),
                               torch.from_numpy(cap), text_chunk=chunk)
    (out.loss0 + out.loss1).backward()
    return out.loss0.item(), out.loss1.item(), i.grad, w.grad


class TestGloriaLocal:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("chunk", [None, 2])
    def test_value_and_grad(self, inputs, dtype, chunk):
        img, words, cap = inputs[:3]
        j0, j1, jgi, jgw = _jax_local(img, words, cap, jnp.dtype(dtype),
                                      chunk)
        t0, t1, tgi, tgw = _torch_local(img, words, cap, getattr(torch, dtype),
                                        chunk)
        rtol, gtol = (1e-4, 1e-4) if dtype == "float32" else (1e-3, 2e-2)
        np.testing.assert_allclose([t0, t1], [j0, j1], rtol=rtol, atol=1e-5)
        _grad_close(tgi, jgi, gtol)
        _grad_close(tgw, jgw, gtol)

    def test_chunked_equals_unchunked(self, inputs):
        img, words, cap = inputs[:3]
        a = _torch_local(img, words, cap, torch.float32, None)
        b = _torch_local(img, words, cap, torch.float32, 2)
        np.testing.assert_allclose(a[:2], b[:2], rtol=1e-6)
        _grad_close(a[2], b[2], 1e-6)

    def test_att_maps(self, inputs):
        img, words, cap = inputs[:3]
        want = JL.gloria_local_loss(jnp.asarray(img), jnp.asarray(words),
                                    jnp.asarray(cap), return_att_maps=True)
        got = TL.gloria_local_loss(torch.from_numpy(img),
                                   torch.from_numpy(words),
                                   torch.from_numpy(cap), return_att_maps=True)
        assert got.att_maps.shape == (B, T, HW, HW)
        np.testing.assert_allclose(got.att_maps.numpy(),
                                   np.asarray(want.att_maps), rtol=1e-4,
                                   atol=1e-6)

    def test_auto_text_chunk_matches(self):
        for args in [(32, 3136, 25), (256, 3136, 25), (64, 361, 25),
                     (8, 100, 10, 1 << 10)]:
            assert TL.auto_text_chunk(*args) == JL.auto_text_chunk(*args)

    def test_class_paths(self, inputs):
        img, words, cap = inputs[:3]
        args = (torch.from_numpy(img), torch.from_numpy(words),
                torch.from_numpy(cap))
        out = TL.GLORIALocalContrastiveLoss()(*args)
        want = TL.gloria_local_loss(*args)
        assert out.loss0.item() == want.loss0.item()
        # impl="pallas" is the fused similarity (its plain version on the
        # CPU) and its symmetric cross entropy; tests/test_torch_gloria.py
        # holds it against the JAX kernel
        fused = TL.GLORIALocalContrastiveLoss(impl="pallas")(*args)
        sims = gloria_similarity_reference(*args)
        assert fused.loss0.item() == TL._cross_entropy_diag(sims).item()
        assert fused.loss1.item() == TL._cross_entropy_diag(sims.T).item()
        with pytest.raises(ValueError, match="impl"):
            TL.GLORIALocalContrastiveLoss(impl="triton")
        zero = TL.ZEROLocalContrastiveLoss()(*args)
        assert zero.loss0.item() == 0.0 and zero.loss1.item() == 0.0


class TestGlobalAndRouter:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_global_value_and_grad(self, inputs, dtype):
        g_img, g_txt = inputs[3:]
        jdt = jnp.dtype(dtype)
        jv, (jgi, jgt) = jax.value_and_grad(
            lambda a, b: JL.gloria_global_loss(a.astype(jdt), b.astype(jdt)),
            argnums=(0, 1))(jnp.asarray(g_img), jnp.asarray(g_txt))
        a = torch.from_numpy(g_img).requires_grad_()
        b = torch.from_numpy(g_txt).requires_grad_()
        tdt = getattr(torch, dtype)
        tv = TL.gloria_global_loss(a.to(tdt), b.to(tdt))
        tv.backward()
        np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
        _grad_close(a.grad, jgi, 1e-4)
        _grad_close(b.grad, jgt, 1e-4)
        assert TL.ZEROGlobalContrastiveLoss()(a, b).item() == 0.0

    def test_router_ce_and_accuracy(self):
        rng = np.random.RandomState(3)
        logits = rng.randn(8, 6).astype(np.float32)
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        labels = np.array([0, 1, 2, 3, 4, 5, 0, 1], np.int32)
        jv, jg = jax.value_and_grad(JL.router_classification_loss)(
            jnp.asarray(probs), jnp.asarray(labels))
        p = torch.from_numpy(probs).requires_grad_()
        tv = TL.router_classification_loss(p, torch.from_numpy(labels))
        tv.backward()
        np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-6)
        _grad_close(p.grad, jg, 1e-5)
        assert TL.router_accuracy(p.detach(), torch.from_numpy(labels)).item() \
            == pytest.approx(float(JL.router_accuracy(jnp.asarray(probs),
                                                      jnp.asarray(labels))))


class TestSoftmaxBf16Residual:
    @pytest.mark.parametrize("dim", [-1, -2])
    def test_value_and_backward_match_jax(self, dim):
        rng = np.random.RandomState(4)
        x = rng.randn(3, 5, 7).astype(np.float32) * 3
        g = rng.randn(3, 5, 7).astype(np.float32)
        jy, vjp = jax.vjp(functools.partial(JS.softmax_bf16_residual,
                                            axis=dim), jnp.asarray(x))
        (jdx,) = vjp(jnp.asarray(g))
        xt = torch.from_numpy(x).requires_grad_()
        ty = TS.softmax_bf16_residual(xt, dim)
        ty.backward(torch.from_numpy(g))
        np.testing.assert_array_equal(ty.detach().numpy(),
                                      torch.softmax(torch.from_numpy(x),
                                                    dim).numpy())
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx),
                                   rtol=1e-5, atol=1e-6)
        # the residual really is bf16: the exact-f32 vjp differs
        exact = torch.func.vjp(lambda v: torch.softmax(v, dim),
                               torch.from_numpy(x))[1](torch.from_numpy(g))[0]
        assert not torch.equal(exact, xt.grad)
