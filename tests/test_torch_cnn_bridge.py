"""The bridge's strict check on the CNN trees through classification on
every backbone, against the JAX package's parameter trees on the CPU
(shapes only: ``jax.eval_shape`` of JAX's ``init``; the port's model on
the meta device): ``model=classification`` on every ``BACKBONES`` name but
swin — resnet_18/34/50/101/152, resnext_50/100, densenet_121/161/169 —
with ``lora`` on and off. JAX's ``ClassificationModule`` tree maps onto the
port's under ``bridge.from_jax_params(model=...)`` (flax ``scale`` →
``weight``, HWIO → OIHW, a grouped kernel's [kh, kw, in/groups, out] too,
LoRA factors unchanged), and the head is as wide as the backbone's
features.
"""

import jax
import numpy as np
import pytest
import torch

from medmoe_tpu.config import DotDict as JDotDict
from medmoe_tpu.models import cnn_backbones as jcb
from medmoe_torch import bridge
from medmoe_torch.config import DotDict
from tests.test_torch_cnn import flat, image, zeros

torch.set_num_threads(1)


@pytest.mark.parametrize("lora", [False, True])
@pytest.mark.parametrize("name", [n for n in jcb.BACKBONES if n != "swin"])
def test_bridge_is_strict(name, lora):
    """Every flax parameter maps to a port parameter of the right shape and
    every port parameter is set."""
    from medmoe_tpu.train.classification import ClassificationModule as JCls
    from medmoe_torch.train.classification import ClassificationModule

    cfg = dict(model_name=name, lora=lora, lora_r=4, norm="group")
    batch = {"image": image(32, b=1), "label": np.zeros((1,), np.int32)}
    shapes = jax.eval_shape(
        JCls(num_classes=3, freeze_encoder=False,
             vision=JDotDict(cfg)).init_params, jax.random.PRNGKey(0), batch)
    with torch.device("meta"):
        module = ClassificationModule(num_classes=3, freeze_encoder=False,
                                      vision=DotDict(cfg))
    sd = bridge.from_jax_params(flat(zeros(shapes)), model=module.model)
    assert set(sd) == set(module.model.state_dict())
    # DenseNet carries no LoRA; ResNeXt's grouped 3×3 none either
    n_lora = sum(k.endswith("lora_a") for k in sd)
    assert (n_lora > 0) == (lora and "densenet" not in name)
    assert module.model.head.classifier.in_features == \
        jcb.BACKBONES[name](norm="group")[1]
