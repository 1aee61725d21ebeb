"""Parity of the PyTorch port's modules with their JAX counterparts on the
same weights, carried JAX → ``medmoe_tpu.eval.export._save_weights`` →
``weights.npz`` → ``medmoe_torch.bridge``: layers, Swin, BERT + text
encoder, MoE (router, top-1) and ``MedMoE.encode_image``/``encode_text``
as a whole. The Swin has 4 stages, so the whole-slice test feeds the
expert branch 4 scales (ratios 1/4/16/64 as at 224²).

Tolerances: float32 checks the algorithm (rtol 1e-4, atol 1e-5; only
summation order differs); bfloat16 checks the rounding points, loosely
(rtol 2e-2 and an atol scaled to the output's magnitude, 2e-2·max|ref|:
one bf16 ulp is 2^-8 relative, and a flipped rounding compounds through
the layers of the towers).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medmoe_tpu.config import DotDict as JDotDict
from medmoe_tpu.eval.export import _save_weights
from medmoe_tpu.models import layers as jlayers
from medmoe_tpu.models import moe as jmoe
from medmoe_tpu.models import swin as jswin
from medmoe_tpu.models import text_encoder as jtext
from medmoe_tpu.models.medmoe import MedMoE as JMedMoE
from medmoe_torch import bridge
from medmoe_torch.config import DotDict
from medmoe_torch.models import layers as tlayers
from medmoe_torch.models import moe as tmoe
from medmoe_torch.models import swin as tswin
from medmoe_torch.models import text_encoder as ttext
from medmoe_torch.models.medmoe import MedMoE as TMedMoE

torch.set_num_threads(1)

TIGHT = dict(rtol=1e-4, atol=1e-5)

VISION = dict(model_name="swin", use_moe=True, embed_dim=32, num_experts=3,
              moe_mode="gather", image_size=64, swin_embed_dim=8,
              swin_depths=[2, 1, 1, 1], swin_num_heads=[1, 2, 2, 4],
              swin_window_size=2, drop_path_rate=0.0)
TEXT = dict(last_n_layers=2, aggregate_method="sum", max_length=10,
            embed_dim=32, hidden_size=32, num_layers=3, num_heads=2,
            intermediate_size=64, vocab_size=200)


def assert_close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TIGHT)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-2,
                                   atol=2e-2 * np.abs(want).max())


def carry(jparams, tmp_path, model):
    """JAX params → weights.npz → port model (strict)."""
    path = str(tmp_path / "weights.npz")
    _save_weights(path, jparams)
    return bridge.load_jax_params(model, bridge.load_npz(path)).eval()


def text_inputs(b=4, t=10, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 200, (b, t)).astype(np.int32)
    mask = np.zeros((b, t), np.int32)
    segs = np.full((b, t), -1, np.int32)
    for i in range(b):
        n = 4 + i
        mask[i, :n] = 1
        # a '##'-style merge: tokens 2 and 3 share slot 2
        segs[i, :n] = [0, 1, 2, 2] + list(range(3, n - 1))
    types = np.zeros((b, t), np.int32)
    return ids, mask, types, segs


def torch_long(*arrays):
    return tuple(torch.from_numpy(a).long() for a in arrays)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def medmoe_pair(request, tmp_path_factory):
    dt = request.param
    v, t = dict(VISION, dtype=dt), dict(TEXT, dtype=dt)
    jm = JMedMoE(vision=JDotDict(v), text=JDotDict(t))
    rng = np.random.RandomState(1)
    ids, mask, types, segs = text_inputs()
    batch = {"image": rng.randn(4, 64, 64, 3).astype(np.float32),
             "input_ids": ids, "attention_mask": mask,
             "token_type_ids": types, "segment_ids": segs}
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0),
                               "dropout": jax.random.PRNGKey(0)},
                              batch)["params"]
    tm = carry(params, tmp_path_factory.mktemp(dt),
               TMedMoE(DotDict(v), DotDict(t)))
    return dt, jm, params, tm, batch


class TestMedMoE:
    def test_encode_image(self, medmoe_pair):
        dt, jm, params, tm, batch = medmoe_pair
        os.environ["MEDMOE_EXPERT_IMPL"] = "xla"
        try:
            jg, jl, jr = jax.jit(functools.partial(
                jm.apply, method=lambda m, x: m.encode_image(x)))(
                    {"params": params}, batch["image"])
        finally:
            os.environ.pop("MEDMOE_EXPERT_IMPL", None)
        with torch.no_grad():
            tg, tl, tr = tm.encode_image(torch.from_numpy(batch["image"]))
        assert tuple(tg.shape) == (4, 32) and tuple(tl.shape) == (4, 32, 16, 16)
        assert_close(tg, jg, dt)
        assert_close(tl, jl, dt)
        assert_close(tr, jr, dt)
        # the routed expert agrees wherever the router is not near a tie
        jr = np.asarray(jr, np.float32)
        top2 = np.sort(jr, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-2
        np.testing.assert_array_equal(tr.argmax(-1).numpy()[clear],
                                      jr.argmax(-1)[clear])

    def test_encode_text(self, medmoe_pair):
        dt, jm, params, tm, batch = medmoe_pair
        args = [batch[k] for k in ("input_ids", "attention_mask",
                                   "token_type_ids", "segment_ids")]
        jw, js = jax.jit(functools.partial(
            jm.apply, method=lambda m, *a: m.encode_text(*a)))(
                {"params": params}, *args)
        with torch.no_grad():
            tw, ts = tm.encode_text(*torch_long(*args))
        assert_close(tw.float(), jw, dt)
        assert_close(ts.float(), js, dt)

    def test_forward_returns_all_five(self, medmoe_pair):
        dt, jm, params, tm, batch = medmoe_pair
        os.environ["MEDMOE_EXPERT_IMPL"] = "xla"
        try:
            want = jax.jit(jm.apply)({"params": params}, batch)
        finally:
            os.environ.pop("MEDMOE_EXPERT_IMPL", None)
        tb = {k: torch.from_numpy(v) if k == "image"
              else torch.from_numpy(v).long() for k, v in batch.items()}
        with torch.no_grad():
            got = tm(tb)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            assert_close(g.float(), w, dt)

    def test_uint8_images_normalize_on_device(self, medmoe_pair):
        dt, jm, params, tm, batch = medmoe_pair
        img = np.random.RandomState(7).randint(0, 256, (2, 64, 64, 3),
                                               np.uint8)
        os.environ["MEDMOE_EXPERT_IMPL"] = "xla"
        try:
            jg, _, _ = jax.jit(functools.partial(
                jm.apply, method=lambda m, x: m.encode_image(x)))(
                    {"params": params}, jnp.asarray(img))
        finally:
            os.environ.pop("MEDMOE_EXPERT_IMPL", None)
        with torch.no_grad():
            tg, _, _ = tm.encode_image(torch.from_numpy(img))
        assert_close(tg, jg, dt)

    def test_without_moe(self, tmp_path):
        v = dict(VISION, dtype="float32", use_moe=False)
        t = dict(TEXT, dtype="float32")
        jm = JMedMoE(vision=JDotDict(v), text=JDotDict(t))
        img = np.random.RandomState(8).randn(2, 64, 64, 3).astype(np.float32)
        p = jax.jit(functools.partial(
            jm.init, method=lambda m, x: m.encode_image(x)))(
                jax.random.PRNGKey(3), img)["params"]
        tm = TMedMoE(DotDict(v), DotDict(t))
        sd = bridge.from_jax_params(
            {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(l)
             for kp, l in jax.tree_util.tree_leaves_with_path(p)})
        missing, unexpected = tm.load_state_dict(sd, strict=False)
        assert not unexpected and all(k.startswith("text_encoder")
                                      for k in missing)
        jg, jl, jr = jm.apply({"params": p}, img,
                              method=lambda m, x: m.encode_image(x))
        with torch.no_grad():
            tg, tl, tr = tm.eval().encode_image(torch.from_numpy(img))
        assert jr is None and tr is None
        assert_close(tg, jg, "float32")
        assert_close(tl, jl, "float32")
