"""The port's CNN backbones (medmoe_torch/models/resnet.py, densenet.py,
cnn_backbones.py and the ImageEncoder facade) against the JAX package's on
the CPU.

Weights: JAX's parameter shapes (``jax.eval_shape`` of ``init``), every
leaf drawn from a numpy seed (LoRA factors live, BatchNorm statistics off
their init), carried over by ``bridge.from_jax_params`` with the strict
check; inputs from numpy seeds; JAX's ``apply`` jitted.

  * ResNet-18 and ResNet-50 at 64², LoRA on and off: XLA's "SAME" pads
    (0, 1) and (2, 3) there (the 7×7 stem, the stride-2 3×3s), which a
    symmetric padding gets wrong; ResNeXt-50's grouped conv; DenseNet-121,
    and DenseNet-161 with its gcd(32, C) groups;
  * both norms: 'batch' against flax's ``apply(..., mutable=
    ["batch_stats"])`` in train mode (outputs and the moved statistics) and
    on running statistics in eval; GroupNorm's epsilon (flax 1e-6, torch
    1e-5) on a map of variance ~1e-6, where the two part;
  * the towers, the facade and the strict bridge are in
    tests/test_torch_cnn_tower.py.

Tolerance: float32, rtol 1e-4 and atol 1e-4 on features of magnitude ~1
to 4 (the largest deviation seen is 1.3e-5, ResNet-50's global features:
the same sums in another order through 50 convolutions and norms, and
flax's one-pass variance E[x²] − E[x]² against torch's two-pass). The
GroupNorm epsilon case 1e-4 on outputs of magnitude ~1 from inputs of
scale 1e-3.
"""

import jax
import numpy as np
import pytest
import torch
from flax import linen as fnn

from medmoe_tpu.models import densenet as jd
from medmoe_tpu.models import resnet as jr
from medmoe_torch import bridge
from medmoe_torch.models import densenet as td
from medmoe_torch.models import resnet as tr

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def drawn(shapes, seed):
    """A numpy draw for every leaf of an eval_shape tree: kernels at
    1/sqrt(fan_in), LoRA factors at 0.05, norm scales near 1, variances in
    [0.5, 1.5], the rest at 0.1."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                    ).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        scale = 0.05 if name.startswith("lora_") else 0.1
        return (scale * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def pair(jmodule, tmodule, x, seed=1, **kw):
    """(JAX variables drawn from ``seed``, the port module loaded from them
    — params and batch_stats in one flat mapping)."""
    variables = drawn(jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), x,
                                     **kw), seed)
    merged = flat(variables["params"])
    merged.update(flat(variables.get("batch_stats", {})))
    bridge.load_jax_params(tmodule, merged)
    return variables, tmodule


def zeros(shapes):
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  shapes)


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def image(side, b=2, seed=0):
    return np.random.RandomState(seed).randn(b, side, side, 3).astype(
        np.float32)


CASES = [("resnet_18", 0), ("resnet_18", 4), ("resnet_50", 0),
         ("resnet_50", 4), ("resnext_50", 0), ("densenet_121", 0)]
CTORS = {"resnet_18": (jr.ResNet18, tr.ResNet18),
         "resnet_50": (jr.ResNet50, tr.ResNet50),
         "resnext_50": (jr.ResNeXt50, tr.ResNeXt50),
         "densenet_121": (jd.DenseNet121, td.DenseNet121),
         "densenet_161": (jd.DenseNet161, td.DenseNet161)}


class TestBackbones:
    @pytest.mark.parametrize("name,r", CASES)
    def test_against_jax_at_64(self, name, r):
        jctor, tctor = CTORS[name]
        kw = dict(norm="group")
        if r:
            kw.update(lora_r=r, lora_alpha=16)
        x = image(64)
        variables, tm = pair(jctor(**kw), tctor(**kw), x)
        g, loc = jax.jit(jctor(**kw).apply)(variables, x)
        with torch.no_grad():
            tg, tl = tm.eval()(nchw(x))
        assert tuple(tl.shape) == np.shape(loc)
        assert tm.feature_dims == (g.shape[1], loc.shape[1])
        np.testing.assert_allclose(tg.numpy(), g, **TOL)
        np.testing.assert_allclose(tl.numpy(), loc, **TOL)

    def test_densenet161_gcd_groups(self):
        x = image(32)
        variables, tm = pair(jd.DenseNet161(norm="group"),
                             td.DenseNet161(norm="group"), x)
        g, loc = jax.jit(jd.DenseNet161(norm="group").apply)(variables, x)
        # growth 48: the second layer of block 1 normalizes 144 channels
        assert tm.block1_layer2.norm1.num_groups == 16
        with torch.no_grad():
            tg, tl = tm.eval()(nchw(x))
        assert tuple(tg.shape) == (2, 2208) and tuple(tl.shape[:2]) == (2,
                                                                       2112)
        np.testing.assert_allclose(tg.numpy(), g, **TOL)
        np.testing.assert_allclose(tl.numpy(), loc, **TOL)

    def test_resnext_grouped_kernel_transposes(self):
        """A grouped HWIO kernel [3, 3, 4, 128] lands as OIHW
        [128, 4, 3, 3] under the bridge's conv rule."""
        x = image(32, b=1)
        variables, tm = pair(jr.ResNeXt50(norm="group"),
                             tr.ResNeXt50(norm="group"), x)
        k = variables["params"]["layer1_block0"]["conv2"]["kernel"]
        w = tm.layer1_block0.conv2.weight.detach().numpy()
        assert k.shape == (3, 3, 4, 128) and w.shape == (128, 4, 3, 3)
        np.testing.assert_array_equal(w, k.transpose(3, 2, 0, 1))
        assert tm.layer1_block0.conv2.groups == 32


class TestNorms:
    @pytest.mark.parametrize("train", [True, False])
    def test_batch_norm_against_flax(self, train):
        x = image(64, b=4)
        jm, tm = jr.ResNet18(norm="batch"), tr.ResNet18(norm="batch")
        variables, tm = pair(jm, tm, x)
        if train:
            (g, loc), moved = jax.jit(
                lambda v, x: jm.apply(v, x, deterministic=False,
                                      mutable=["batch_stats"]))(variables, x)
            want_stats = bridge.from_jax_params(flat(moved["batch_stats"]))
        else:
            g, loc = jax.jit(jm.apply)(variables, x)
        tm.train(train)
        with torch.no_grad():
            tg, tl = tm(nchw(x))
        np.testing.assert_allclose(tg.numpy(), g, **TOL)
        np.testing.assert_allclose(tl.numpy(), loc, **TOL)
        stats = {k: v for k, v in tm.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        if train:
            assert set(stats) == set(want_stats)
            for k, v in stats.items():
                np.testing.assert_allclose(v.numpy(), want_stats[k].numpy(),
                                           **TOL, err_msg=k)
        else:
            init = flat(variables["batch_stats"])
            assert all(np.array_equal(v.numpy(), init[
                k.replace(".", "/").replace("running_", "")])
                for k, v in stats.items())

    @pytest.mark.parametrize("channels", [64, 144])
    def test_group_norm_epsilon(self, channels):
        """A map of variance ~1e-6: flax's 1e-6 and torch's default 1e-5
        part by a factor ~1.7 here, so the test holds the epsilon."""
        x = (1e-3 * np.random.RandomState(2).randn(2, 5, 5, channels)
             ).astype(np.float32)
        jm = fnn.GroupNorm(num_groups=int(np.gcd(32, channels)))
        variables, tm = pair(jm, tr.GroupNorm(channels), x)
        want = np.asarray(jm.apply(variables, x)).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(tm(nchw(x)).detach().numpy(), want,
                                   rtol=1e-4, atol=1e-4)
        eps5 = torch.nn.functional.group_norm(
            nchw(x), tm.num_groups, tm.weight, tm.bias, 1e-5)
        assert np.abs(eps5.detach().numpy() - want).max() > 0.1
