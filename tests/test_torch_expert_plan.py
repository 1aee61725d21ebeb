"""K2's transposed-upsample table and scratch chunks, on the CPU.

``transposed_lerp_plan(p_s, p)`` is the table the CUDA kernel's banded
transposed upsample reads: held here exactly against the JAX package's
dense ``linear_interp_matrix(p_s, p)``, at the pyramid's upsample ratios
and at ragged ones. ``transposed_lerp`` (its plain version) is held
against Gᵀ·x at 1e-6 relative (float32 sums in another order).
``bwd_image_chunk`` and ``fwd_image_chunk`` size the scratch K2 and K1 run
their passes over, within the budget ``images_in_budget`` shares with the
GLoRIA kernels.
"""

import numpy as np
import pytest
import torch

from medmoe_tpu.models.moe import linear_interp_matrix
from medmoe_torch.ops import expert_fusion as ef
from medmoe_torch.ops._scratch import images_in_budget

torch.set_num_threads(1)

FLAGSHIP_P = (3136, 784, 196, 49)

PLANS = [
    (3136, 3136),   # ratio 1: the identity scale
    (1568, 3136),   # ratio 2
    (784, 3136),    # ratio 4
    (392, 3136),    # ratio 8
    (196, 3136),    # ratio 16
    (49, 3136),     # ratio 64
    (25, 200),      # 25 source rows: blocks of 8 rows end ragged
    (7, 21),        # ratio 3: a weight of exactly 0 in every band
    (1, 64),        # one source row takes every destination row
]


def _dense(plan, p):
    start, rows, weights = plan
    mat = np.zeros((len(start) - 1, p), np.float32)
    for i in range(len(start) - 1):
        mat[i, rows[start[i]:start[i + 1]]] = weights[start[i]:start[i + 1]]
    return mat


@pytest.mark.parametrize("p_s,p", PLANS)
def test_plan_is_the_interpolation_matrix_exactly(p_s, p):
    plan = ef.transposed_lerp_plan(p_s, p)
    start, rows, weights = plan
    assert start.dtype == rows.dtype == np.int32 and weights.dtype == np.float32
    assert start[0] == 0 and start[-1] == len(rows) == len(weights)
    np.testing.assert_array_equal(_dense(plan, p), linear_interp_matrix(p_s, p))
    assert np.all(weights != 0)
    r = p // p_s
    for i in range(p_s):
        band = rows[start[i]:start[i + 1]]
        assert np.all(np.diff(band) > 0), f"row {i}: destinations not increasing"
        assert 1 <= len(band) <= 2 * r + 1


@pytest.mark.parametrize("p_s,p", PLANS)
def test_plain_transposed_lerp_matches_gt_x(p_s, p):
    rng = np.random.RandomState(p_s)
    x = rng.randn(2, p, 24).astype(np.float32)
    got = ef.transposed_lerp(ef.transposed_lerp_plan(p_s, p),
                             torch.from_numpy(x)).numpy()
    want = np.einsum("ip,bpe->bie", linear_interp_matrix(p_s, p).astype(np.float64),
                     x.astype(np.float64))
    assert got.shape == (2, p_s, 24)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_plain_transposed_lerp_takes_bf16():
    x = torch.randn(1, 64, 8).to(torch.bfloat16)
    plan = ef.transposed_lerp_plan(16, 64)
    got = ef.transposed_lerp(plan, x)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ef.transposed_lerp(plan, x.float()))


@pytest.mark.parametrize("b,want", [(32, 32), (256, 32), (38, 32), (1, 1)])
def test_image_chunk_flagship(b, want):
    images, nbytes = ef.bwd_image_chunk(b, FLAGSHIP_P, 768, 384)
    assert images == want
    assert nbytes == images * ef.bwd_scratch_bytes(FLAGSHIP_P, 768, 384)
    assert nbytes <= 1.7e9


@pytest.mark.parametrize("b,per_image,want", [
    (256, 52_207_616, 32), (5, 1, 5), (3, 2e9, 1), (256, 1.7e9 / 16, 16)])
def test_images_in_budget(b, per_image, want):
    # the one budget K2 and the GLoRIA kernels size their chunks by
    assert images_in_budget(b, per_image) == want


def test_bwd_parts_flagship():
    # dbp: 25 tiles of 128 rows at the identity scale, 98/25/7 blocks of 8
    # source rows; 2 logit tiles of 192 columns of H = 384; 49 row-step
    # tiles of 64 rows
    assert ef._bwd_parts(FLAGSHIP_P, 384) == [25, 98, 25, 7, 2, 49]
    assert ef._bwd_parts((100, 25), 48) == [1, 4, 0, 0, 1, 2]
    assert ef._bwd_parts((100, 25), 200)[ef.MAX_SCALES] == 2


def test_scratch_bytes_flagship_by_hand():
    # h and bf16(dz_h): 4165 rows; u and bf16(d_u): 3 scales of 3136 rows;
    # a: 4 scales of [3136, 384]; d_att, bf16(att32), 2 logit tiles; 49
    # row-step tiles of dw2/db1; dbp tiles 25 (identity) + 98 + 25 + 7
    p, e, h = 3136, 768, 384
    want = (4165 * e * 4 + 3 * p * e * 4 + 4 * p * h * 2 + 4 * p * 4 * 4
            + 49 * 2 * h * 4 + (25 + 98 + 25 + 7) * e * 4)
    assert ef.bwd_scratch_bytes(FLAGSHIP_P, e, h) == want
    # the f32 d_u the single-pass design held, for comparison
    assert 4 * p * e * 4 == 38_535_168


def test_image_chunk_is_at_least_one_image():
    images, nbytes = ef.bwd_image_chunk(4, (400_000, 200_000), 768, 384)
    assert images == 1
    assert nbytes == ef.bwd_scratch_bytes((400_000, 200_000), 768, 384) > 1.7e9


def test_scratch_of_a_lerped_scale():
    one = ef.bwd_scratch_bytes((64,), 64, 32)
    two = ef.bwd_scratch_bytes((64, 16), 64, 32)
    # the second scale adds its h/dz_h (16 rows), u and bf16(d_u) (64 rows
    # each), a, the row step's logits and its dbp tiles
    assert two - one == (16 * 64 * 4 + 64 * 64 * 4 + 64 * 32 * 2 + 64 * 3 * 4
                         + 2 * 64 * 4)


@pytest.mark.parametrize("b,want", [(32, 32), (256, 87), (88, 87), (1, 1)])
def test_forward_image_chunk_flagship(b, want):
    # K1's chunk: ≈19 MB an image, 87 flagship images in 1.7 GB
    images, nbytes = ef.fwd_image_chunk(b, FLAGSHIP_P, 768, 384)
    assert images == want
    assert nbytes == images * ef.fwd_scratch_bytes(FLAGSHIP_P, 768, 384)
    assert nbytes <= 1.7e9


def test_forward_scratch_by_hand():
    # u of every scale, P rows each (h_0 at the identity scale; the lerped
    # scales' h is never stored), the partial logits of 2 tiles of H = 384
    # for 4 scales; one scale of P rows is its own u; H = 160 is one tile,
    # 200 two
    p, e, h = 3136, 768, 384
    assert ef.fwd_scratch_bytes(FLAGSHIP_P, e, h) == \
        4 * p * e * 2 + 4 * 2 * p * 4 == 19_367_936
    assert ef.fwd_scratch_bytes((64,), 64, 160) == 64 * 64 * 2 + 1 * 64 * 4
    assert ef.fwd_scratch_bytes((64,), 64, 200) == 64 * 64 * 2 + 2 * 64 * 4
    assert ef.fwd_image_chunk(4, (400_000, 200_000), 768, 384)[0] == 1
