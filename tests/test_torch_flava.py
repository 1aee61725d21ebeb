"""The port's FLAVA losses (medmoe_torch/ops/flava.py) and BEiT block
masking (medmoe_torch/data/masking.py) against the JAX package's on the
CPU.

Weights: JAX initializes, every leaf is redrawn from a numpy seed
(``logit_scale`` set where a case asks), carried over by
``bridge.from_jax_params`` with the strict check; inputs from numpy seeds.

  * ``_masked_ce`` and every loss — ITM, MLM/MIM masked prediction (rows
    at ``ignore_index``, every row ignored, no labels), the contrastive
    loss, the global contrastive loss with ``logit_scale`` inside and
    beyond its clip to [0, ln 100] — values and gradients (inputs and
    parameters) against ``jax.grad``; the contrastive loss with a mask
    against the reference's cross entropy (JAX's is NaN there);
  * ``FLAVAPretrainingLoss`` with every input and with subsets, and its
    gradients; the MMM weights do nothing, as in JAX;
  * global negatives over two gloo ranks (``axis_name="data"``) against
    JAX's loss on a two-device mesh (``make_mesh(data=2)``);
  * ``ImageMaskingGenerator``: the masks bit-equal to JAX's over seeds and
    grid shapes.

Tolerance: float32, rtol 1e-5 and atol 1e-6 on losses and logits, 1e-5
on gradients (the same sums in another order); the masks exactly.
"""

import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medmoe_tpu.data.masking import ImageMaskingGenerator as JMasking
from medmoe_tpu.ops import flava as jf
from medmoe_torch import bridge
from medmoe_torch.data.masking import ImageMaskingGenerator
from medmoe_torch.ops import flava as tf
from tests.test_torch_lora import flat, redraw

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)
GTOL = dict(rtol=1e-5, atol=1e-5)
D, VOCAB, IMG_VOCAB = 16, 50, 30


def t(x, grad=False):
    out = torch.from_numpy(np.array(x))
    return out.requires_grad_() if grad else out


def params_of(jmodule, *inputs, seed=0, **kw):
    """JAX's init on ``inputs``, every leaf redrawn from ``seed`` but the
    contrastive ``logit_scale``, which keeps its init log(1 / 0.07)."""
    params = jax.device_get(jmodule.init(jax.random.PRNGKey(0), *inputs,
                                         **kw)["params"])
    drawn = redraw(params, seed)
    if "contrastive_loss" in params:
        drawn["contrastive_loss"] = params["contrastive_loss"]
    return drawn


def loaded(tmodule, params):
    bridge.load_jax_params(tmodule, flat(params))
    return tmodule


def grads_of(tmodule):
    return {n: p.grad.numpy() for n, p in tmodule.named_parameters()
            if p.grad is not None}


def jgrads(params, fn):
    g = jax.grad(fn)(params)
    return bridge.from_jax_params(flat(jax.device_get(g)))


def hidden(b, n, seed):
    return np.random.RandomState(seed).randn(b, n, D).astype(np.float32)


def labels(shape, vocab, seed, ignored=0.5):
    rng = np.random.RandomState(seed)
    lab = rng.randint(0, vocab, shape).astype(np.int32)
    lab[rng.rand(*shape) < ignored] = -1
    return lab


@pytest.mark.parametrize("ignored", [0.0, 0.6, 1.0])
def test_masked_ce(ignored):
    logits = np.random.RandomState(1).randn(3, 4, 7).astype(np.float32)
    lab = labels((3, 4), 7, 2, ignored)
    want = jf._masked_ce(jnp.asarray(logits), jnp.asarray(lab))
    got = tf._masked_ce(t(logits), t(lab))
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    if ignored == 1.0:
        assert got.item() == 0.0


class TestITM:
    @pytest.mark.parametrize("with_labels", [True, False])
    def test_against_jax(self, with_labels):
        h = hidden(4, 3, 3)
        lab = np.array([0, 1, -1, 1], np.int32) if with_labels else None
        jm = jf.ITMLoss(D)
        params = params_of(jm, h, lab, seed=4)
        tm = loaded(tf.ITMLoss(D), params)
        ht = t(h, grad=True)
        out = tm(ht, None if lab is None else t(lab))
        want = jm.apply({"params": params}, h, lab)
        np.testing.assert_allclose(out.logits.detach().numpy(), want.logits,
                                   **TOL)
        np.testing.assert_allclose(out.loss.item(), float(want.loss), **TOL)
        if with_labels:
            out.loss.backward()
            want_g = jgrads(params, lambda p: jm.apply({"params": p}, h,
                                                       lab).loss)
            for k, v in grads_of(tm).items():
                np.testing.assert_allclose(v, want_g[k].numpy(), **GTOL,
                                           err_msg=k)


class TestMaskedPrediction:
    @pytest.mark.parametrize("case", ["some", "all_ignored", "none",
                                      "all_ignored_nan"])
    def test_against_jax(self, case):
        h = hidden(2, 5, 5)
        lab = None if case == "none" else labels(
            (2, 5), VOCAB, 6, 1.0 if case.startswith("all") else 0.4)
        nan = case == "all_ignored_nan"
        jm = jf.MaskedPredictionLoss(D, VOCAB, ignore_nan=nan)
        params = params_of(jm, h, lab, seed=7)
        tm = loaded(tf.MaskedPredictionLoss(D, VOCAB, ignore_nan=nan),
                    params)
        ht = t(h, grad=True)
        out = tm(ht, None if lab is None else t(lab))
        want = jm.apply({"params": params}, h, lab)
        np.testing.assert_allclose(out.logits.detach().numpy(), want.logits,
                                   **TOL)
        np.testing.assert_allclose(out.loss.item(), float(want.loss), **TOL)
        out.loss.backward()
        dh = jax.grad(lambda x: jm.apply({"params": params}, x, lab).loss)(
            jnp.asarray(h))
        np.testing.assert_allclose(ht.grad.numpy(), dh, **GTOL)

    def test_head_is_a_tied_bias_decoder(self):
        tm = tf.MaskedPredictionHead(D, VOCAB)
        assert tm.decoder.bias is None and tuple(tm.bias.shape) == (VOCAB,)
        assert tm.layer_norm.eps == 1e-5


class TestContrastive:
    def test_with_temperature(self):
        rng = np.random.RandomState(8)
        a, b = rng.randn(5, D).astype(np.float32), rng.randn(5, D).astype(
            np.float32)
        mask = None
        scale = np.float32(1.3)
        want = jf.contrastive_loss_with_temperature(a, b, scale, mask)
        at, bt, st = t(a, True), t(b, True), t(scale, True)
        got = tf.contrastive_loss_with_temperature(
            at, bt, st, None if mask is None else t(mask))
        for k in ("loss", "loss_a", "loss_b", "logits_a", "logits_b"):
            np.testing.assert_allclose(getattr(got, k).detach().numpy(),
                                       getattr(want, k), **TOL, err_msg=k)
        got.loss.backward()
        da, db, ds = jax.grad(
            lambda x, y, s: jf.contrastive_loss_with_temperature(
                x, y, s, mask).loss, argnums=(0, 1, 2))(a, b, scale)
        np.testing.assert_allclose(at.grad.numpy(), da, **GTOL)
        np.testing.assert_allclose(bt.grad.numpy(), db, **GTOL)
        np.testing.assert_allclose(st.grad.item(), float(ds), **GTOL)

    def test_mask_is_the_reference_cross_entropy(self):
        """Masked pairs take -inf logits. The port picks each row's label
        by a gather, so the loss is the reference's ``CrossEntropyLoss``
        over the unmasked pairs (reference losses.py:574-589); JAX's
        one-hot product multiplies the -inf log-probabilities by 0 and
        returns NaN for any mask that hides a pair (ROADMAP.md Queue 3)."""
        rng = np.random.RandomState(8)
        a, b = rng.randn(5, D).astype(np.float32), rng.randn(5, D).astype(
            np.float32)
        mask = rng.rand(5, 5) > 0.3
        np.fill_diagonal(mask, True)
        scale = np.float32(1.3)
        assert np.isnan(float(jf.contrastive_loss_with_temperature(
            a, b, scale, mask).loss))
        at, bt = t(a, True), t(b, True)
        got = tf.contrastive_loss_with_temperature(at, bt, t(scale), t(mask))
        got.loss.backward()
        ra, rb = t(a, True), t(b, True)
        m, temp = t(mask), math.exp(1.3)
        ce = torch.nn.functional.cross_entropy
        la = (ra @ rb.T) * temp
        lb = (rb @ ra.T) * temp
        inf = torch.tensor(-math.inf)
        labels_ = torch.arange(5)
        want = (ce(torch.where(m, la, inf), labels_)
                + ce(torch.where(m, lb, inf), labels_)) / 2
        want.backward()
        np.testing.assert_allclose(got.loss.item(), want.item(), **TOL)
        np.testing.assert_allclose(at.grad.numpy(), ra.grad.numpy(), **GTOL)
        np.testing.assert_allclose(bt.grad.numpy(), rb.grad.numpy(), **GTOL)

    @pytest.mark.parametrize("logit_scale", [None, 5.0, -0.5])
    def test_global_loss_and_the_clip(self, logit_scale):
        """The learnable scale is clipped to [0, 4.6052] (ln 100): beyond
        it the loss uses the bound and the scale takes no gradient."""
        rng = np.random.RandomState(9)
        img, txt = rng.randn(6, D).astype(np.float32) * 3, rng.randn(
            6, D).astype(np.float32)
        jm = jf.FLAVAGlobalContrastiveLoss()
        params = jax.device_get(jm.init(jax.random.PRNGKey(0), img,
                                        txt)["params"])
        if logit_scale is not None:
            params = {"logit_scale": np.float32(logit_scale)}
        tm = loaded(tf.FLAVAGlobalContrastiveLoss(), params)
        if logit_scale is None:
            assert tm.logit_scale.item() == pytest.approx(math.log(1 / 0.07))
        it, tt_ = t(img, True), t(txt, True)
        out = tm(it, tt_)
        want = jm.apply({"params": params}, img, txt)
        for k in ("loss", "image_loss", "text_loss", "image_logits",
                  "text_logits", "logit_scale", "image_embedding",
                  "text_embedding"):
            np.testing.assert_allclose(getattr(out, k).detach().numpy(),
                                       getattr(want, k), **TOL, err_msg=k)
        bound = {5.0: 4.6052, -0.5: 0.0}.get(logit_scale)
        if bound is not None:
            assert out.logit_scale.item() == pytest.approx(bound)
        out.loss.backward()
        g = jax.grad(lambda p, x, y: jm.apply({"params": p}, x, y).loss,
                     argnums=(0, 1, 2))(params, img, txt)
        np.testing.assert_allclose(tm.logit_scale.grad.item(),
                                   float(g[0]["logit_scale"]), **GTOL)
        if bound is not None:
            assert tm.logit_scale.grad.item() == 0.0
        np.testing.assert_allclose(it.grad.numpy(), g[1], **GTOL)
        np.testing.assert_allclose(tt_.grad.numpy(), g[2], **GTOL)


def _pretraining_inputs(seed=10):
    rng = np.random.RandomState(seed)
    return dict(
        image_sequence=rng.randn(4, D).astype(np.float32),
        text_sequence=rng.randn(4, D).astype(np.float32),
        image_masked_sequence=hidden(4, 6, seed + 1),
        text_masked_sequence=hidden(4, 5, seed + 2),
        multimodal_masked_sequence=hidden(4, 7, seed + 3),
        itm_labels=np.array([1, 0, -1, 1], np.int32),
        mlm_labels=labels((4, 5), VOCAB, seed + 4),
        mim_labels=labels((4, 6), IMG_VOCAB, seed + 5))


class TestPretrainingLoss:
    KW = dict(hidden_size=D, text_vocab_size=VOCAB,
              image_vocab_size=IMG_VOCAB, mlm_weight=0.7, mim_weight=1.3,
              contrastive_loss_weight=0.5, itm_loss_weight=2.0,
              mmm_image_loss_weight=9.0, mmm_text_loss_weight=9.0)

    @pytest.mark.parametrize("inputs", [
        "all", ("text_masked_sequence", "mlm_labels"),
        ("image_sequence", "text_sequence"),
        ("multimodal_masked_sequence", "itm_labels",
         "image_masked_sequence", "mim_labels")])
    def test_against_jax(self, inputs):
        every = _pretraining_inputs()
        jm = jf.FLAVAPretrainingLoss(**self.KW)
        params = params_of(jm, **every, seed=11)
        tm = loaded(tf.FLAVAPretrainingLoss(**self.KW), params)
        given = every if inputs == "all" else {k: every[k] for k in inputs}
        tin = {k: t(v, grad=v.dtype == np.float32) for k, v in given.items()}
        got = tm(**tin)
        want = jm.apply({"params": params}, **given)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].item(), float(want[k]), **TOL,
                                       err_msg=k)
        got["loss"].backward()
        floats = {k: v for k, v in given.items() if v.dtype == np.float32}
        gp, gx = jax.grad(lambda p, x: jm.apply(
            {"params": p}, **x, **{k: v for k, v in given.items()
                                   if k not in x})["loss"],
            argnums=(0, 1))(params, floats)
        want_g = bridge.from_jax_params(flat(jax.device_get(gp)))
        for k, v in grads_of(tm).items():
            np.testing.assert_allclose(v, want_g[k].numpy(), **GTOL,
                                       err_msg=k)
        for k in floats:
            np.testing.assert_allclose(tin[k].grad.numpy(), gx[k], **GTOL,
                                       err_msg=k)

    def test_published_widths(self):
        """FLAVA's defaults: hidden 768, text vocabulary 30522, image
        vocabulary 8192, ignore_index -1 (built on the meta device)."""
        with torch.device("meta"):
            m = tf.FLAVAPretrainingLoss()
        assert m.mlm_loss.cls.decoder.weight.shape == (30522, 768)
        assert m.mim_loss.cls.decoder.weight.shape == (8192, 768)
        assert m.itm_loss.cls.seq_relationship.weight.shape == (2, 768)
        assert m.mlm_loss.ignore_index == -1


def _jax_two_ranks(img, txt):
    """JAX's ``FLAVAGlobalContrastiveLoss(axis_name="data")`` on
    ``make_mesh(data=2)``, each device on its rows: per device, its loss,
    logit rows and the gradients of its own loss to its rows and to
    ``logit_scale`` (the gather's transpose sums the ranks' cotangents, as
    the port's gather's backward does)."""
    from medmoe_tpu.parallel.mesh import make_mesh

    jm = jf.FLAVAGlobalContrastiveLoss(axis_name="data")
    params = jax.device_get(jf.FLAVAGlobalContrastiveLoss().init(
        jax.random.PRNGKey(0), img[:3], txt[:3])["params"])
    mesh = make_mesh(data=2, devices=jax.devices()[:2])
    rows, rep = jax.sharding.PartitionSpec("data"), \
        jax.sharding.PartitionSpec()

    def per_device(p, a, b):
        def loss(p, a, b):
            out = jm.apply({"params": p}, a, b)
            return out.loss, out

        (value, out), (dp, da, db) = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(p, a, b)
        return (value[None], out.image_logits, out.text_logits, da, db,
                dp["logit_scale"][None])

    fn = jax.shard_map(per_device, mesh=mesh, in_specs=(rep, rows, rows),
                       out_specs=(rows,) * 6, check_vma=False)
    outs = fn(params, jnp.asarray(img), jnp.asarray(txt))
    return [np.asarray(o) for o in outs]


def test_global_negatives_over_two_ranks(tmp_path):
    """Two gloo ranks of 3 rows each gather each other's embeddings
    against JAX's loss on a two-device mesh over the same rows: each
    rank's loss, logit rows and gradients to its rows and to
    ``logit_scale``."""
    from tests.test_torch_parallel import Launch, ROOT

    rng = np.random.RandomState(12)
    img, txt = rng.randn(6, D).astype(np.float32), rng.randn(6, D).astype(
        np.float32)
    out = str(tmp_path / "flava")
    spec = dict(task="flava", img=img.tolist(), txt=txt.tolist(),
                init=f"file://{tmp_path / 'store'}", world=2, out=out)
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    Launch([[sys.executable, "-m", "tests.torch_rank_worker", str(path),
             str(r)] for r in range(2)], ROOT).wait()
    ranks = [json.loads(open(f"{out}.{r}.json").read()) for r in range(2)]

    loss, img_logits, txt_logits, d_img, d_txt, d_scale = _jax_two_ranks(
        img, txt)
    for r, res in enumerate(ranks):
        rows = slice(3 * r, 3 * r + 3)
        np.testing.assert_allclose(res["loss"], loss[r], **TOL)
        np.testing.assert_allclose(res["image_logits"], img_logits[rows],
                                   **TOL)
        np.testing.assert_allclose(res["text_logits"], txt_logits[rows],
                                   **TOL)
        np.testing.assert_allclose(res["d_img"], d_img[rows], **GTOL)
        np.testing.assert_allclose(res["d_txt"], d_txt[rows], **GTOL)
        np.testing.assert_allclose(res["d_scale"], d_scale[r], **GTOL)


@pytest.mark.parametrize("args,kw", [
    (((14, 14), 75), {}),
    ((14, 75), {"min_num_patches": 16}),
    (((7, 9), 30), {"max_num_patches": 10, "min_aspect": 0.5}),
    (((10, 16), 60), {"max_aspect": 2.0}),
    (((4, 4), 16), {}),
])
def test_masks_bit_equal(args, kw):
    for seed in (0, 1, 7, 123):
        mine = ImageMaskingGenerator(*args, seed=seed, **kw)
        theirs = JMasking(*args, seed=seed, **kw)
        assert repr(mine) == repr(theirs)
        assert mine.get_shape() == theirs.get_shape()
        for _ in range(4):
            a, b = mine(), theirs()
            assert a.dtype == b.dtype and np.array_equal(a, b)
