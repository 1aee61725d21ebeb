"""The kernels' limits, checked on shapes before anything runs: the
expert branch's (K1 and K2) and the GLoRIA similarity's (K3, K4a, K4b)
``check_kernel_limits``, and the trainer's check of a model before its
first step on a card. Plain Python on shapes and scalars, so it runs here;
tests/test_torch_kernels_cuda.py holds the wrappers to the same limits on
the card."""

import types

import pytest
import torch

from medmoe_torch.config import DotDict
from medmoe_torch.models.medmoe import MedMoE
from medmoe_torch.ops import expert_fusion as ef
from medmoe_torch.ops import gloria_attention as ga
from medmoe_torch.ops import losses as L
from medmoe_torch.train import loop
from medmoe_torch.train.module import MedMoEPretrainingModule

torch.set_num_threads(1)

FLAGSHIP_PYRAMID = (96, 192, 384, 768)


@pytest.mark.parametrize("d,t,temp1", [
    (768, 25, 4.0),          # the flagship local map, captions, temp1
    (768, 128, 80.0),        # every limit at its edge
    (16, 1, -80.0),
    (48, 40, 4.0),           # two word tiles
])
def test_gloria_limits_pass(d, t, temp1):
    ga.check_kernel_limits(d, t, temp1)


@pytest.mark.parametrize("d,t,temp1", [
    (768, 129, 4.0),         # past K4a's 256-wide tile
    (784, 25, 4.0),          # past the accumulators' D
    (40, 25, 4.0),           # D % 16
    (768, 25, 81.0),         # exp(temp1·a1 - max(temp1, 0)) underflows
    (768, 25, -81.0),
])
def test_gloria_limits_raise(d, t, temp1):
    with pytest.raises(ValueError):
        ga.check_kernel_limits(d, t, temp1)


@pytest.mark.parametrize("e,h,d_list", [
    (768, 384, FLAGSHIP_PYRAMID),
    (64, 32, (32, 24)),
    (128, 16, (8,)),
    (96, 48, FLAGSHIP_PYRAMID),           # E % 64 != 0: K2 takes E % 8
    (32, 16, (8, 16)),
    (768, 392, FLAGSHIP_PYRAMID),         # H past 384: no attention tile in
    (1536, 384, FLAGSHIP_PYRAMID),        # shared memory limits H or E
    (32, 8, (8,)),                        # H at its lower edge
    (768, 2048, FLAGSHIP_PYRAMID),        # H at K2's row step's edge
])
def test_expert_limits_pass(e, h, d_list):
    ef.check_kernel_limits(e, h, d_list)


@pytest.mark.parametrize("e,h,d_list", [
    (80, 48, FLAGSHIP_PYRAMID),           # E % 32 (K1's projection pass)
    (48, 16, (8, 16)),
    (768, 2056, FLAGSHIP_PYRAMID),        # H past K2's row step
    (768, 388, FLAGSHIP_PYRAMID),         # H % 8
    (768, 0, FLAGSHIP_PYRAMID),           # no hidden width
    (768, 376, FLAGSHIP_PYRAMID[:3] + (764,)),   # D_s % 8
    (768, 384, (96, 192, 384, 768, 768)),        # five scales
])
def test_expert_limits_raise(e, h, d_list):
    with pytest.raises(ValueError):
        ef.check_kernel_limits(e, h, d_list)


def test_plain_expert_path_takes_what_the_kernels_do_not():
    # E = 96 runs on CPU tensors (the plain version) without a launch; the
    # kernels take it too since K2 takes E % 8 (K1's E % 32 is the limit)
    g = torch.Generator().manual_seed(0)
    xs = (torch.randn(2, 16, 8, generator=g).to(torch.bfloat16),)
    out = ef.expert_fusion_gather(
        xs, (torch.randn(2, 8, 96, generator=g),), (torch.zeros(2, 96),),
        torch.randn(2, 96, 48, generator=g), torch.zeros(2, 48),
        torch.randn(2, 48, 1, generator=g), torch.zeros(2, 1),
        torch.tensor([1, 0], dtype=torch.int32))
    assert out.shape == (2, 16, 96) and torch.isfinite(out).all()


@pytest.mark.parametrize("impl,agg,batch,on_cuda,want", [
    ("auto", "sum", None, True, "pallas"),     # batch unknown: may be fused
    ("auto", "sum", 65, True, "pallas"),
    ("auto", "sum", 64, True, "xla"),
    ("auto", "sum", None, False, "xla"),
    ("xla", "sum", None, True, "xla"),
])
def test_local_loss_impl_for(impl, agg, batch, on_cuda, want):
    assert L.GLORIALocalContrastiveLoss(impl=impl).impl_for(
        agg, batch, on_cuda) == want


def _module(embed_dim=64, max_length=10, dtype="bfloat16", impl="pallas",
            block_size=None):
    vision = DotDict(model_name="swin", use_moe=True, embed_dim=embed_dim,
                     num_experts=2, moe_mode="gather", image_size=32,
                     swin_embed_dim=8, swin_depths=[1, 1], swin_num_heads=[1, 2],
                     swin_window_size=2, drop_path_rate=0.0, dtype=dtype)
    text = DotDict(last_n_layers=2, aggregate_method="sum",
                   max_length=max_length, embed_dim=embed_dim, hidden_size=16,
                   num_layers=2, num_heads=2, intermediate_size=32,
                   vocab_size=64, freeze_bert=True, dtype=dtype)
    loss = DotDict(temp1=4.0, temp2=5.0, temp3=10.0, agg="sum",
                   block_size=block_size)
    module = MedMoEPretrainingModule(model=MedMoE(vision, text), loss=loss)
    module.local_loss = L.GLORIALocalContrastiveLoss(impl=impl)
    return module


@pytest.mark.parametrize("kw,batch,raises", [
    (dict(), 256, False),
    (dict(embed_dim=48), 256, True),                    # bf16 bank, E % 32
    (dict(embed_dim=48, dtype="float32"), 256, False),  # plain expert path
    (dict(max_length=129), 256, True),                  # T past 128
    (dict(max_length=129, impl="auto"), 32, False),     # the einsum path
    (dict(max_length=129, impl="auto"), None, True),
    (dict(max_length=129, impl="auto", block_size=32), 256, False),
    (dict(max_length=129, impl="xla"), 256, False),
])
def test_module_checks_the_kernels_it_would_launch(kw, batch, raises):
    module = _module(**kw)
    if raises:
        with pytest.raises(ValueError):
            module.check_kernel_limits(batch)
    else:
        module.check_kernel_limits(batch)


def test_trainer_checks_before_a_step_on_a_card_only():
    module = _module(max_length=129)
    data = types.SimpleNamespace(batch_size=256)
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError):
        loop.Trainer._check_kernel_limits(on_card, module, data)
    loop.Trainer._check_kernel_limits(
        types.SimpleNamespace(device=torch.device("cpu")), module, data)
