"""The port's ResNet tower, the ImageEncoder facade, the ``BACKBONES``
registry and the bridge's strict check for the CNN trees, against the JAX
package on the CPU (weights and inputs as in tests/test_torch_cnn.py):

  * the ResNet tower (resnet_18 with LoRA) at batch 1 from 224²
    (upsampled to 299²), from 320² (downsampled: JAX antialiases) and from
    uint8 pixels, against ``ResNetVisionTower``; the resize alone;
  * the ``BACKBONES`` dims, the facade's dispatch and the unknown-name
    fallback (the strict bridge: tests/test_torch_cnn_bridge.py).

Tolerance: float32, rtol 1e-4 and atol 1e-4 (tests/test_torch_cnn.py);
the uint8 tower atol 3e-4 (1.1e-4 seen: flax's one-pass GroupNorm
variance on the stem's sums of 0..255 pixels). The resize alone 1e-4
(4.9e-5 seen on the antialiased 320² → 299²).
"""

import jax
import numpy as np
import pytest
import torch

from medmoe_tpu.config import DotDict as JDotDict
from medmoe_tpu.models import cnn_backbones as jcb
from medmoe_tpu.models import resnet as jr
from medmoe_tpu.models.vision_encoder import ImageEncoder as JEncoder
from medmoe_torch import bridge
from medmoe_torch.config import DotDict
from medmoe_torch.models import cnn_backbones as tcb
from medmoe_torch.models import resnet as tr
from medmoe_torch.models.vision_encoder import ImageEncoder
from tests.test_torch_cnn import TOL, flat, image, nchw, pair, zeros

torch.set_num_threads(1)


def tower_cfg(**kw):
    return dict(model_name="resnet_18", lora=True, lora_r=4, lora_alpha=8,
                norm="group", **kw)


class TestTower:
    @pytest.mark.parametrize("side,dtype", [(224, np.float32),
                                            (320, np.float32),
                                            (224, np.uint8)])
    def test_resize_then_backbone(self, side, dtype):
        rng = np.random.RandomState(3)
        x = (rng.randint(0, 256, (1, side, side, 3)).astype(dtype)
             if dtype == np.uint8 else rng.randn(1, side, side, 3).astype(
                 dtype))
        jm = jr.ResNetVisionTower(JDotDict(tower_cfg()))
        variables, tm = pair(jm, tr.ResNetVisionTower(DotDict(tower_cfg())),
                             x)
        g, loc, router = jax.jit(jm.apply)(variables, x)
        with torch.no_grad():
            tg, tl, trouter = tm.eval()(torch.from_numpy(x))
        assert router is None and trouter is None
        assert tuple(tl.shape) == (1, 256, 19, 19)
        # uint8 pixels enter unscaled (0..255): flax's GroupNorm takes the
        # variance as E[x²] − E[x]², which loses digits on the stem's large
        # sums (torch's is two-pass): 1.1e-4 seen
        tol = dict(rtol=1e-4, atol=3e-4) if dtype == np.uint8 else TOL
        np.testing.assert_allclose(tg.numpy(), g, **tol)
        np.testing.assert_allclose(tl.numpy(), loc, **tol)

    def test_resize_alone(self):
        """The resize itself: bilinear with half-pixel centres up, the
        antialiased triangle down (without it the 320² case parts by
        ~0.8)."""
        for side in (224, 320):
            x = image(side, b=1, seed=side)
            want = np.asarray(jax.image.resize(x, (1, 299, 299, 3),
                                               "bilinear"))
            got = tr.resize_pixels(torch.from_numpy(x)).permute(0, 2, 3, 1)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                       atol=1e-4)
        x = image(320, b=1)
        plain = torch.nn.functional.interpolate(
            nchw(x), size=(299, 299), mode="bilinear", align_corners=False)
        want = np.asarray(jax.image.resize(x, (1, 299, 299, 3), "bilinear"))
        assert np.abs(plain.permute(0, 2, 3, 1).numpy() - want).max() > 0.1


class TestFacade:
    def test_backbone_dims(self):
        want = {name: build(norm="group")[1:]
                for name, build in jcb.BACKBONES.items() if name != "swin"}
        assert set(tcb.BACKBONES) == set(jcb.BACKBONES)
        with torch.device("meta"):
            for name, (dim, interm) in want.items():
                model, got_dim, got_interm = tcb.BACKBONES[name](norm="group")
                assert (got_dim, got_interm) == (dim, interm), name
                # the module's own global width is the factory's dim
                assert model.feature_dims[0] == dim, name
        assert tcb.BACKBONES["swin"]()[1:] == (768, 768)

    @pytest.mark.parametrize("name,tower", [
        ("resnet_34", "resnet"), ("resnext_100", "resnet"),
        ("densenet_169", "densenet"), ("swin", "swin_moe")])
    def test_dispatch(self, name, tower):
        with torch.device("meta"):
            enc = ImageEncoder(DotDict(dict(model_name=name, norm="group")))
        assert enc.tower_name == tower

    def test_unknown_names(self):
        """JAX's ``.get(name, ResNet50)`` fallback is kept: a name with
        "resnet" in it that no constructor matches builds ResNet-50 in
        both; a name of no family raises in both."""
        cfg = dict(model_name="resnet_999", norm="group", lora=False)
        with torch.device("meta"):
            enc = ImageEncoder(DotDict(cfg))
        assert enc.feature_dims == (2048, 1024)
        shapes = jax.eval_shape(JEncoder(JDotDict(cfg)).init,
                                jax.random.PRNGKey(0), image(64, b=1))
        bridge.from_jax_params(flat(zeros(shapes["params"])), model=enc)
        with pytest.raises(ValueError, match="unknown vision backbone"):
            ImageEncoder(DotDict(dict(model_name="vit")))
        with pytest.raises(ValueError, match="unknown vision backbone"):
            jax.eval_shape(JEncoder(JDotDict(dict(model_name="vit"))).init,
                           jax.random.PRNGKey(0), image(64, b=1))
