"""The port's CUDA kernels on the card, each against its plain PyTorch
version. Marked ``cuda``: without a card every test skips (a CUDA kernel
has no CPU mode; its plain version's parity with JAX is tested in
tests/test_torch_expert_fusion.py). This file imports neither JAX nor the
JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

Tolerance: rtol 2e-2, atol 2e-3 — both sides round at the same bf16
points; a different f32 summation order can flip one bf16 ulp.
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
