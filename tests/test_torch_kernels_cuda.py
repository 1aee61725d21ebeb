"""The port's CUDA kernels on the card, each against its plain PyTorch
version. Marked ``cuda``: without a card every test skips (a CUDA kernel
has no CPU mode; its plain version's parity with JAX is tested in
tests/test_torch_expert_fusion.py). This file imports neither JAX nor the
JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

Tolerances: K1 rtol 2e-2, atol 2e-3 — both sides round at the same bf16
points; a different f32 summation order can flip one bf16 ulp. K2 and
``FusedExpertGather``'s gradients (against autograd through the plain
forward): 5e-2·max|ref| per output, the JAX package's own fused-vs-XLA
gradient bound — a ReLU mask (a > 0, h > 0) whose pre-activation lies
within f32 summation error of zero can differ between two summation
orders, and each such flip moves a whole gradient term. Since such flips
are rare, K2 must also keep all but 1% of each output's elements within
2e-3·max|ref|.

The GLoRIA kernels (K3, K4a, K4b) against their plain versions: K3 within
1e-3·max|ref| (the same bf16 inputs, f32 sums in another order, and the
softmax over regions offset by max(temp1, 0) instead of its maximum); K4a
and K4b every element within 1e-2·max|ref| and at most 1% of the elements
beyond 2e-3·max|ref| — bf16(a2), bf16(d_wei) and bf16(d_scores) feed the
cotangent products, and a value that lands on the other side of a bf16
rounding boundary moves its term by one bf16 step. The prologue's own
outputs (bf16(d_wei) and the per-word vectors) take K4a's tolerance. Worst
measured on the H100 at B=256 flagship and on the odd shapes, with every
product on the wgmma core (K4b's over two slices of a chunk's K) as with
K4b's on mma.sync before it:
K3 2.4e-7·max|ref|; d_img 3.2e-3·max|ref| and d_words 3.6e-3·max|ref|
(its bf16 rounding: 7.8e-3 at max|ref| 2.17), with at most 4.6e-4 of the
elements beyond 2e-3·max|ref|. Expert-branch
widths the kernels do not take (``check_kernel_limits``: E % 32, H % 8,
H <= 2048) raise before K1 launches.

The kernels sum without atomics, so two calls agree bit for bit; K1, K2,
K3, the prologue and K4a run over chunks of images agree bit for bit with
one chunk (a sample's outputs are its own). The prologue from K3's kept
state agrees bit for bit with the prologue that runs F1 and F2 again, and
the GLoRIA digests hold through the autograd Function's kept path. K1's and K2's products run on
the wgmma core as persistent walks over (image, scale, tile): an
out-of-range expert id in the middle of the walk poisons its own sample
and the call returns. Their shared projection's h_s (K2's scratch) and the
u_s K1's projection writes are held against the plain version's at K1's
tolerance, and K1's u against K2's bit for bit (K2 differentiates the
forward K1 took). K4b sums over images chunk by chunk, and within a
chunk over ``K4B_SLICES`` slices of its rows (image, m) in whole steps of
64 rows, each slice's product a partial added in slice order: chunks and
slices reorder that sum, so d_words over other chunk sizes or slice
counts agrees within the tolerance above, not bit for bit.
"""

import hashlib
import subprocess

import numpy as np
import pytest
import torch

from medmoe_torch.ops import expert_fusion as ef
from medmoe_torch.ops import gloria_attention as ga
from medmoe_torch.ops import _scratch
from medmoe_torch.utils import trace

LOOSE = dict(rtol=2e-2, atol=2e-3)
# (nvcc release, card) that the digests were recorded with
DIGESTS_RECORDED_WITH = ("12.9", "NVIDIA H100 80GB HBM3")
# sha256 of K3's and the prologue's bits on the digest tests' two shapes
# (test_gemm_core_a_layout_leaves_gloria_bits), and of K4a's (test_k4a_bits)
K3_PROLOGUE_DIGESTS = (
    "c61a3c00a8e730f4197ad3947f65693808f6fe197f2815c3c7a7725bb4f8191f",
    "d85e86c60398927332cf0a4ed3c82faa87055bd3b6b3e98329e8006df432349a")
K4A_DIGESTS = (
    "42c829d27bda04a63466b13a82cd807e337bbdb0f63483f606c0145447aa9dd5",
    "cfbf8ea0cf26fd0e0ff8f816a37d276b9d81f8c2a217b9ff7bd4df5dbd3ff1ce")
# sha256 of K4b's f32 d_words on the same two shapes (test_k4b_bits)
K4B_DIGESTS = (
    "ec8a7e52d4f01ab02e91885dd0d36b2889eaae67505f653044eb0bd2db05ba87",
    "de3e351c8c52ace1128c764a7d70834be719771ab007a59be51ba26f76cfa2a9")
# sha256 of K1's output and of K2's outputs on the two DIGEST_SHAPES
# (test_k1_bits, test_k2_bits)
K1_DIGESTS = (
    "41fd54eccfa75ae4d8b98bf590a600d370801b58fd0601bf4bf32b9375645c1d",
    "aa0179c417dcedb8987fa1d7700e93e84869b7b9d8aa33e9c23964017e26e390")
K2_DIGESTS = (
    "3a71a88661887424be6554a086b9e1a99a0daea5478ee0237cc5861d21a371de",
    "70e3018a750ed9e256a4af863e853c8a4d78d922e582fb978df3e33ae3709940")


# the digest tests' expert-branch shapes: a small odd one (ragged tiles)
# and a flagship image pair
DIGEST_SHAPES = (
    dict(b=3, p_list=(100, 50, 25), d_list=(24, 136, 16), e=96, h=200, k=2,
         idx=[1, 0, 1]),
    dict(b=2, p_list=(3136, 784, 196, 49), d_list=(96, 192, 384, 768), e=768,
         h=384, k=6, idx=[5, 2]),
)


def _skip_unless_digest_toolchain():
    """Bits depend on the compiler and the card: skip unless they are those
    the digests were recorded with."""
    found = (_nvcc_release(), torch.cuda.get_device_name(0))
    if found != DIGESTS_RECORDED_WITH:
        pytest.skip(f"digests recorded with nvcc and card "
                    f"{DIGESTS_RECORDED_WITH}, found {found}")


def _digest_inputs(dev, case):
    """K1's arguments for digest case ``case``, made with numpy (seed 0) so
    that they are the same on every card and torch build."""
    c = DIGEST_SHAPES[case]
    rng = np.random.RandomState(0)
    e, h, k = c["e"], c["h"], c["k"]

    def t(shape, std=1.0):
        return torch.from_numpy((rng.randn(*shape) * std).astype(np.float32)).to(dev)

    xs = tuple(t((c["b"], p, d)).to(torch.bfloat16)
               for p, d in zip(c["p_list"], c["d_list"]))
    return (xs, tuple(t((k, d, e), d ** -0.5) for d in c["d_list"]),
            tuple(t((k, e), 0.1) for _ in c["d_list"]),
            t((k, e, h), e ** -0.5), t((k, h), 0.1), t((k, h, 1), h ** -0.5),
            t((k, 1), 0.1), torch.tensor(c["idx"], dtype=torch.int32, device=dev))


def _digest_cotangent(dev, case, xs, w1):
    rng = np.random.RandomState(1)
    shape = (xs[0].shape[0], max(x.shape[1] for x in xs), w1.shape[1])
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)


def _nvcc_release() -> str:
    """The "release X.Y" of the nvcc that builds the kernels."""
    from medmoe_torch.ops import _build

    out = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                         text=True, check=True).stdout
    return out.split("release ")[1].split(",")[0]


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, p_list, d_list, e, k, idx, seed=0, h=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    h = h or e // 2

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
        (3, (64, 16, 4, 1), (8, 16, 32, 64), 64, 3, [2, 0, 1]),
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

    @pytest.mark.parametrize("b", [0, 2])
    def test_registered_op_is_the_wrapper(self, dev, b):
        """``medmoe::expert_fusion_gather`` (training, serving and exported
        programs enter K1 through it) launches K1 once (none for an empty
        batch) and gives the wrapper's bits; its fake implementation gives
        the same shape."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        xs, wp, bp, *rest = _inputs(dev, 2, (3136, 784, 196, 49),
                                    (96, 192, 384, 768), 768, 6, [5, 2])
        xs = [x[:b] for x in xs]
        rest[-1] = rest[-1][:b]
        want = ef.expert_fusion_gather(xs, wp, bp, *rest)
        before = ef.LAUNCHES
        got = torch.ops.medmoe.expert_fusion_gather(list(xs), list(wp),
                                                    list(bp), *rest)
        torch.cuda.synchronize()
        assert ef.LAUNCHES == before + (b > 0) and torch.equal(got, want)
        with FakeTensorMode() as mode:
            fake = torch.ops.medmoe.expert_fusion_gather(
                *[[mode.from_tensor(t) for t in ts] for ts in (xs, wp, bp)],
                *[mode.from_tensor(t) for t in rest])
        assert fake.shape == want.shape and fake.dtype == want.dtype
        assert fake.device == want.device

    def test_out_of_range_expert_poisons_only_its_sample(self, dev):
        args = list(_inputs(dev, 2, (64, 16), (8, 16), 64, 3, [1, 3]))
        out = ef.expert_fusion_gather(*args)
        torch.cuda.synchronize()
        assert torch.isnan(out[1]).all() and torch.isfinite(out[0]).all()
        args[7] = args[7][:1]
        args[0] = tuple(x[:1] for x in args[0])
        torch.testing.assert_close(
            out[:1], ef.expert_fusion_gather_reference(*args), **LOOSE)

    def test_empty_batch(self, dev):
        args = list(_inputs(dev, 1, (64, 16), (8, 16), 64, 3, [0]))
        args[0] = tuple(x[:0] for x in args[0])
        args[7] = args[7][:0]
        assert ef.expert_fusion_gather(*args).shape == (0, 64, 64)

    def test_width_k2_cannot_take_raises_before_k1_launches(self, dev):
        # E = 80: neither K1 nor K2 (the limits are joint, E % 32) takes
        # it, so the forward refuses it before it runs
        args = _inputs(dev, 2, (64, 16), (8, 16), 80, 3, [1, 0])
        before = ef.LAUNCHES
        with pytest.raises(ValueError):
            ef.expert_fusion_gather(*args)
        assert ef.LAUNCHES == before

    @pytest.mark.parametrize("e,h", [(64, 2056), (64, 36)])
    def test_hidden_width_the_limits_refuse_raises_before_k1_launches(
            self, dev, e, h):
        # H past K2's row step (2048) or not a multiple of 8
        args = _inputs(dev, 2, (64, 16), (8, 16), e, 3, [1, 0], h=h)
        before = ef.LAUNCHES
        with pytest.raises(ValueError):
            ef.expert_fusion_gather(*args)
        assert ef.LAUNCHES == before

    @pytest.mark.parametrize("h", [8, 160, 392])
    def test_matches_plain_version_odd_hidden(self, dev, h):
        # one ragged 192-wide tile of H (8, 160), three (392: the third
        # ragged)
        args = _inputs(dev, 3, (100, 25), (32, 24), 64, 2, [1, 0, 1], seed=6,
                       h=h)
        out = ef.expert_fusion_gather(*args)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, ef.expert_fusion_gather_reference(*args),
                                   **LOOSE)

    def test_chunks_of_images_match_plain_version(self, dev, monkeypatch):
        # B = 5 over chunks of 2 images (2, 2, 1): the same bits as one
        # chunk, and the plain version across each chunk boundary
        args = _inputs(dev, 5, (64, 16, 4), (8, 16, 32), 64, 3,
                       [2, 0, 1, 1, 0], seed=4)
        whole = ef.expert_fusion_gather(*args)
        per_image = ef.fwd_scratch_bytes((64, 16, 4), 64, 32)
        monkeypatch.setattr(_scratch, "CHUNK_BYTES", 2 * per_image + 1)
        assert ef.fwd_image_chunk(5, (64, 16, 4), 64, 32)[0] == 2
        before = ef.LAUNCHES
        chunked = ef.expert_fusion_gather(*args)
        torch.cuda.synchronize()
        assert ef.LAUNCHES == before + 1
        assert torch.equal(chunked, whole)
        torch.testing.assert_close(chunked,
                                   ef.expert_fusion_gather_reference(*args),
                                   **LOOSE)

    def test_is_the_same_on_every_run(self, dev):
        args = _inputs(dev, 2, (3136, 784, 196, 49), (96, 192, 384, 768), 768,
                       6, [5, 2], seed=5, h=384)
        runs = [ef.expert_fusion_gather(*args) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1])

    def test_undersized_logit_scratch_is_rejected(self, dev, monkeypatch):
        # the C entry holds the partial-logit scratch against its own
        # 192-wide tiles of H: sized for 256-wide tiles (one tile at H =
        # 200, two needed), it raises before any pass runs
        args = _inputs(dev, 2, (64, 16), (8, 16), 64, 3, [1, 0], h=200)
        monkeypatch.setattr(ef, "_LOGIT_TILE", 256)
        before = ef.LAUNCHES
        with pytest.raises(RuntimeError, match="launch failed"):
            ef.expert_fusion_gather(*args)
        assert ef.LAUNCHES == before

    def test_matches_plain_version_partial_wgmma_tiles(self, dev):
        # H = 200 (a 192-wide tile and a ragged one), E = 96 (one and a half
        # 64-deep stages of K), P = 100 with P_s 50/25 (one ragged 128-row
        # tile)
        args = _inputs(dev, 3, (100, 50, 25), (32, 24, 16), 96, 2, [1, 0, 1],
                       seed=9, h=200)
        out = ef.expert_fusion_gather(*args)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, ef.expert_fusion_gather_reference(*args),
                                   **LOOSE)

    def test_out_of_range_expert_mid_walk(self, dev):
        # B = 9 at flagship widths: the bad id (sample 4) sits in the middle
        # of every block's share of the persistent walk; the producer and
        # the consumers skip the same tiles, so the call returns, sample 4
        # is NaN and the others match the plain version
        ids = [5, 0, 3, 1, 6, 2, 4, 0, 5]
        args = list(_inputs(dev, 9, (3136, 784, 196, 49), (96, 192, 384, 768),
                            768, 6, ids, seed=10, h=384))
        out = ef.expert_fusion_gather(*args)
        torch.cuda.synchronize()
        assert torch.isnan(out[4]).all()
        keep = [i for i in range(9) if i != 4]
        assert torch.isfinite(out[keep]).all()
        args[0] = tuple(x[keep] for x in args[0])
        args[7] = args[7][keep]
        torch.testing.assert_close(out[keep],
                                   ef.expert_fusion_gather_reference(*args),
                                   **LOOSE)

    @pytest.mark.parametrize("case", [0, 1])
    def test_k1_bits(self, dev, case):
        """The bits of K1's output on numpy inputs (``_digest_inputs``), as
        the kernel gives them with its logit product on the wgmma core
        (scripts/ab_torch_gloria.py --k1 prints them as "ab K1 bits");
        recorded with ``DIGESTS_RECORDED_WITH``, and anew whenever K1
        changes on purpose."""
        _skip_unless_digest_toolchain()
        args = _digest_inputs(dev, case)
        got = hashlib.sha256(ef.expert_fusion_gather(*args).cpu().numpy()
                             .tobytes())
        assert got.hexdigest() == K1_DIGESTS[case]


def _keep_scratch(monkeypatch):
    """The scratch the K1 and K2 wrappers allocate, kept: {"fwd": (us,
    lpart), "bwd": {name: tensors}} after a call of each."""
    kept = {}
    fwd, bwd = ef._fwd_buffers, ef._bwd_buffers
    monkeypatch.setattr(ef, "_fwd_buffers",
                        lambda *a: kept.setdefault("fwd", fwd(*a)))
    monkeypatch.setattr(ef, "_bwd_buffers",
                        lambda *a: kept.setdefault("bwd", bwd(*a)))
    return kept


def _plain_h_u(xs, wp, bp, idx):
    """The plain version's h_s and u_s, bf16 values as f32."""
    from medmoe_torch.models.moe import interp_patches

    bf, ix = torch.bfloat16, idx.long()
    p = max(x.shape[1] for x in xs)
    hs = [torch.relu(torch.bmm(x.float(), w[ix].to(bf).float())
                     + v[ix].to(bf).float()[:, None, :]).to(bf)
          for x, w, v in zip(xs, wp, bp)]
    return ([h.float() for h in hs],
            [interp_patches(h, p, dim=1).float() for h in hs])


@pytest.mark.cuda
class TestExpertProjection:
    """K1's and K2's shared projection on the wgmma core: K2's h_s of every
    scale and K1's u_s (h_0 at the identity scale), from the scratch the
    wrappers allocate, against the plain version's at K1's tolerance."""

    @pytest.mark.parametrize("b,p_list,d_list,e,idx", [
        # P = 100, P_s 50/25: one ragged row tile each; D 24/32/16 inside
        # one 64-deep stage; E = 64: one ragged 192-wide column tile
        (3, (100, 50, 25), (24, 32, 16), 64, [1, 0, 1]),
        # E = 96; D = 96 ends inside a stage
        (3, (100, 50, 25), (32, 24, 96), 96, [0, 1, 1]),
        # r = 2 with P_s = 128: K1's second row tile owns row 127 alone
        (2, (256, 128), (96, 40), 64, [1, 0]),
        # flagship: D_0 = 96, and the r = 64 scale's one tile writes 3136 u
        # rows a column tile
        (2, (3136, 784, 196, 49), (96, 192, 384, 768), 768, [5, 2]),
    ])
    def test_matches_plain_version(self, dev, monkeypatch, b, p_list, d_list,
                                   e, idx):
        args = _inputs(dev, b, p_list, d_list, e, 2 if e < 768 else 6, idx,
                       seed=21)
        xs, wp, bp, w1, b1, w2, _, ids = args
        kept = _keep_scratch(monkeypatch)
        ef.expert_fusion_gather(*args)
        ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2, ids,
                                    torch.randn((b, p_list[0], e), device=dev))
        torch.cuda.synchronize()
        plain_h, plain_u = _plain_h_u(xs, wp, bp, ids)
        for s in range(len(xs)):
            torch.testing.assert_close(kept["bwd"]["h"][s][:b].float(),
                                       plain_h[s], **LOOSE)
            torch.testing.assert_close(kept["fwd"][0][s][:b].float(),
                                       plain_u[s], **LOOSE)

    def test_out_of_range_expert_mid_walk(self, dev, monkeypatch):
        # B = 9, sample 4's id out of range: both projections skip its
        # tiles on the producer and the consumer side and return; the other
        # samples' h and u match the plain version
        ids = [1, 0, 1, 1, 2, 0, 1, 0, 1]
        args = _inputs(dev, 9, (100, 50, 25), (32, 24, 96), 96, 2, ids,
                       seed=22)
        xs, wp, bp, w1, b1, w2, _, idx = args
        kept = _keep_scratch(monkeypatch)
        out = ef.expert_fusion_gather(*args)
        ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2, idx,
                                    torch.randn((9, 100, 96), device=dev))
        torch.cuda.synchronize()
        assert torch.isnan(out[4]).all()
        keep = [i for i in range(9) if i != 4]
        plain_h, plain_u = _plain_h_u(tuple(x[keep] for x in xs), wp, bp,
                                      idx[keep])
        for s in range(3):
            torch.testing.assert_close(kept["bwd"]["h"][s][keep].float(),
                                       plain_h[s], **LOOSE)
            torch.testing.assert_close(kept["fwd"][0][s][keep].float(),
                                       plain_u[s], **LOOSE)

    @pytest.mark.parametrize("case", [0, 1])
    def test_k1_u_is_k2_u(self, dev, monkeypatch, case):
        """On the digest inputs: the u that K1's projection writes from its
        staged tiles (and h_0 at the identity scale) equals, bit for bit,
        the u that K2's u pass writes from the h_s its projection stores."""
        xs, wp, bp, w1, b1, w2, b2, idx = _digest_inputs(dev, case)
        kept = _keep_scratch(monkeypatch)
        ef.expert_fusion_gather(xs, wp, bp, w1, b1, w2, b2, idx)
        ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2, idx,
                                    _digest_cotangent(dev, case, xs, w1))
        torch.cuda.synchronize()
        b, p = idx.shape[0], max(x.shape[1] for x in xs)
        for s, x in enumerate(xs):
            k2 = kept["bwd"]["h" if x.shape[1] == p else "u"][s]
            assert torch.equal(kept["fwd"][0][s][:b], k2[:b]), f"scale {s}"


def _bwd_close(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        scale = w.abs().max().item()
        torch.testing.assert_close(g, w, rtol=0, atol=5e-2 * scale)
        share = ((g - w).abs() > 2e-3 * scale).float().mean().item()
        assert share <= 0.01, f"output {i}: {share:.2%} beyond 2e-3*max|ref|"


def _bwd_outs(outs):
    d_xs, d_wp, d_bp, d_w1, d_b1, d_w2 = outs
    return list(d_xs) + list(d_wp) + list(d_bp) + [d_w1, d_b1, d_w2]


@pytest.mark.cuda
class TestExpertFusionBackwardKernel:
    @pytest.mark.parametrize("b,p_list,d_list,e,k,idx", [
        (3, (64, 16, 4, 1), (8, 16, 32, 64), 64, 3, [2, 0, 1]),
        (2, (100, 25), (32, 24), 64, 2, [1, 0]),
        (2, (3136, 784, 196, 49), (96, 192, 384, 768), 768, 6, [5, 2]),
    ])
    def test_matches_plain_version(self, dev, b, p_list, d_list, e, k, idx):
        xs, wp, bp, w1, b1, w2, _, ids = _inputs(dev, b, p_list, d_list, e, k,
                                                 idx)
        g = torch.Generator(device=dev).manual_seed(7)
        d_out = torch.randn((b, max(p_list), e), generator=g, device=dev)
        before = ef.BWD_LAUNCHES
        out = ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2, ids, d_out)
        torch.cuda.synchronize()
        assert ef.BWD_LAUNCHES == before + 1
        ref = ef.expert_fusion_gather_bwd_reference(xs, wp, bp, w1, b1, w2,
                                                    ids, d_out)
        got = _bwd_outs(out)
        assert all(torch.isfinite(t).all() for t in got)
        _bwd_close(got, _bwd_outs(ref))

    @pytest.mark.parametrize("b,p_list,d_list,e,h,idx", [
        # P and P_s not multiples of the 128-row tiles or the 8-row bands
        (2, (200, 100, 50, 25), (24, 24, 24, 24), 64, 48, [1, 0]),
        # E % 64 != 0 (the lifted limit), H = 16, one scale
        (3, (100,), (16,), 96, 16, [0, 1, 1]),
        # D_s = 136: two 128-wide d_x and dWp tiles, the second ragged
        (2, (50, 25), (136, 8), 64, 32, [1, 1]),
    ])
    def test_matches_plain_version_odd_tiles(self, dev, b, p_list, d_list, e,
                                             h, idx):
        xs, wp, bp, w1, b1, w2, _, ids = _inputs(dev, b, p_list, d_list, e, 2,
                                                 idx, seed=3, h=h)
        g = torch.Generator(device=dev).manual_seed(8)
        d_out = torch.randn((b, max(p_list), e), generator=g, device=dev)
        out = ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2, ids, d_out)
        torch.cuda.synchronize()
        ref = ef.expert_fusion_gather_bwd_reference(xs, wp, bp, w1, b1, w2,
                                                    ids, d_out)
        got = _bwd_outs(out)
        assert all(torch.isfinite(t).all() for t in got)
        _bwd_close(got, _bwd_outs(ref))

    def test_chunks_of_images_give_the_same_bits(self, dev, monkeypatch):
        # B = 5 over chunks of 2 images (2, 2, 1) against one chunk of 5
        args = _inputs(dev, 5, (64, 16, 4), (8, 16, 32), 64, 3,
                       [2, 0, 1, 1, 0], seed=4)
        xs, wp, bp, w1, b1, w2, _, ids = args
        d_out = torch.randn((5, 64, 64), device=dev)
        whole = _bwd_outs(ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2,
                                                      ids, d_out))
        per_image = ef.bwd_scratch_bytes((64, 16, 4), 64, 32)
        monkeypatch.setattr(_scratch, "CHUNK_BYTES", 2 * per_image + 1)
        assert ef.bwd_image_chunk(5, (64, 16, 4), 64, 32)[0] == 2
        before = ef.BWD_LAUNCHES
        chunked = _bwd_outs(ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1,
                                                        w2, ids, d_out))
        torch.cuda.synchronize()
        assert ef.BWD_LAUNCHES == before + 1
        for a, b in zip(chunked, whole):
            assert torch.equal(a, b)
        ref = ef.expert_fusion_gather_bwd_reference(xs, wp, bp, w1, b1, w2,
                                                    ids, d_out)
        _bwd_close(chunked, _bwd_outs(ref))

    def test_tlerp_and_reduce_over_chunks_of_images(self, dev, monkeypatch):
        # B = 5 over chunks of 2 images (2, 2, 1) at ratios 4, 64 and 512
        # (bands of 8 to 1024 destination rows, several 8-row blocks of
        # source rows at ratio 4): the transposed upsample and the reduce
        # give one chunk's bits, and the plain version's values
        args = _inputs(dev, 5, (512, 128, 8, 1), (24, 24, 24, 16), 64, 3,
                       [2, 0, 1, 1, 0], seed=23, h=48)
        xs, wp, bp, w1, b1, w2, _, ids = args
        d_out = torch.randn((5, 512, 64), device=dev)
        whole = _bwd_outs(ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2,
                                                      ids, d_out))
        p_s = (512, 128, 8, 1)
        per_image = ef.bwd_scratch_bytes(p_s, 64, 48)
        monkeypatch.setattr(_scratch, "CHUNK_BYTES", 2 * per_image + 1)
        assert ef.bwd_image_chunk(5, p_s, 64, 48)[0] == 2
        chunked = _bwd_outs(ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1,
                                                        w2, ids, d_out))
        torch.cuda.synchronize()
        for a, b in zip(chunked, whole):
            assert torch.equal(a, b)
        ref = ef.expert_fusion_gather_bwd_reference(xs, wp, bp, w1, b1, w2,
                                                    ids, d_out)
        _bwd_close(chunked, _bwd_outs(ref))

    def test_is_the_same_on_every_run(self, dev):
        # every sum over P and over tiles in a fixed order, without atomics
        xs, wp, bp, w1, b1, w2, _, ids = _inputs(
            dev, 2, (3136, 784, 196, 49), (96, 192, 384, 768), 768, 6, [5, 2],
            seed=5, h=384)
        d_out = torch.randn((2, 3136, 768), device=dev)
        runs = [_bwd_outs(ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2,
                                                      ids, d_out))
                for _ in range(2)]
        torch.cuda.synchronize()
        for a, b in zip(*runs):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("short", [0, 1, ef.MAX_SCALES,
                                       ef.MAX_SCALES + 1])
    def test_undersized_scratch_is_rejected(self, dev, monkeypatch, short):
        # the C entry holds the wrapper's partial-sum scratch against its
        # own tiles: one count short (dbp of scale 0 or 1, the logit
        # tiles, the row-step tiles) raises before any pass runs
        xs, wp, bp, w1, b1, w2, _, ids = _inputs(dev, 2, (200, 100, 50),
                                                 (24, 24, 24), 64, 2, [1, 0],
                                                 h=48)
        d_out = torch.randn((2, 200, 64), device=dev)
        real = ef._bwd_parts

        def fewer(p_list, h):
            parts = real(p_list, h)
            parts[short] -= 1
            return parts

        monkeypatch.setattr(ef, "_bwd_parts", fewer)
        before = ef.BWD_LAUNCHES
        with pytest.raises(RuntimeError, match="backward launch failed"):
            ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2, ids, d_out)
        assert ef.BWD_LAUNCHES == before

    def test_out_of_range_expert_poisons_only_its_sample(self, dev):
        xs, wp, bp, w1, b1, w2, _, ids = _inputs(dev, 2, (64, 16), (8, 16),
                                                 64, 3, [1, 3])
        d_out = torch.randn((2, 64, 64), device=dev)
        got = _bwd_outs(ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2,
                                                    ids, d_out))
        torch.cuda.synchronize()
        assert all(torch.isnan(t[1]).all() and torch.isfinite(t[0]).all()
                   for t in got)
        ref = _bwd_outs(ef.expert_fusion_gather_bwd_reference(
            tuple(x[:1] for x in xs), wp, bp, w1, b1, w2, ids[:1],
            d_out[:1].contiguous()))
        _bwd_close([t[:1] for t in got], ref)

    def test_empty_batch(self, dev):
        xs, wp, bp, w1, b1, w2, _, ids = _inputs(dev, 1, (64, 16), (8, 16),
                                                 64, 3, [0])
        xs = tuple(x[:0] for x in xs)
        before = ef.BWD_LAUNCHES
        out = ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2, ids[:0],
                                          torch.empty((0, 64, 64), device=dev))
        assert ef.BWD_LAUNCHES == before
        assert [tuple(t.shape) for t in _bwd_outs(out)] == [
            (0, 64, 8), (0, 16, 16), (0, 8, 64), (0, 16, 64), (0, 64),
            (0, 64), (0, 64, 32), (0, 32), (0, 32)]

    def test_fused_function_grads_match_autograd_of_plain(self, dev):
        args = _inputs(dev, 3, (64, 16, 4, 1), (8, 16, 32, 64), 64, 3,
                       [2, 0, 1])
        xs, wp, bp, w1, b1, w2, b2, ids = args
        g = torch.randn((3, 64, 64), device=dev)

        def grads(fn):
            leaves = [t.detach().clone().requires_grad_()
                      for t in (w1, b1, w2, b2, *xs, *wp, *bp)]
            n = len(xs)
            lx, lw, lb = leaves[4:4 + n], leaves[4 + n:4 + 2 * n], leaves[4 + 2 * n:]
            out = fn(lx, lw, lb, *leaves[:4])
            return torch.autograd.grad(out, leaves, g)

        before = (ef.LAUNCHES, ef.BWD_LAUNCHES)
        got = grads(lambda x, w, b, w1_, b1_, w2_, b2_:
                    ef.FusedExpertGather.apply(ids, w1_, b1_, w2_, b2_,
                                               *x, *w, *b))
        assert (ef.LAUNCHES, ef.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
        want = grads(lambda x, w, b, w1_, b1_, w2_, b2_:
                     ef.expert_fusion_gather_reference(x, w, b, w1_, b1_, w2_,
                                                       b2_, ids))
        assert torch.count_nonzero(got[3]) == 0          # attn_b2
        for i, (a, w) in enumerate(zip(got, want)):
            if i == 3:
                continue
            err = (a.float() - w.float()).abs().max() / w.abs().max().clamp(min=1e-6)
            assert err < 5e-2, f"input {i}: rel err {err}"

    def test_matches_plain_version_partial_wgmma_tiles(self, dev):
        # H = 200, E = 96, P = 100 with P_s 50/25: ragged tiles of every
        # product (the logit and d_u products' 192-wide N tiles and 128-row
        # M tiles, dW1's K past P, dWp's and d_x's D_s = 24/136)
        xs, wp, bp, w1, b1, w2, _, ids = _inputs(dev, 3, (100, 50, 25),
                                                 (24, 136, 16), 96, 2,
                                                 [1, 0, 1], seed=9, h=200)
        g = torch.Generator(device=dev).manual_seed(19)
        d_out = torch.randn((3, 100, 96), generator=g, device=dev)
        out = ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2, ids, d_out)
        torch.cuda.synchronize()
        ref = ef.expert_fusion_gather_bwd_reference(xs, wp, bp, w1, b1, w2,
                                                    ids, d_out)
        got = _bwd_outs(out)
        assert all(torch.isfinite(t).all() for t in got)
        _bwd_close(got, _bwd_outs(ref))

    def test_out_of_range_expert_mid_walk(self, dev):
        # B = 9 at flagship widths, sample 4's id out of range: every
        # persistent pass skips its tiles on both sides and returns; its
        # outputs are NaN, the others' match the plain version
        ids = [5, 0, 3, 1, 6, 2, 4, 0, 5]
        xs, wp, bp, w1, b1, w2, _, idx = _inputs(
            dev, 9, (3136, 784, 196, 49), (96, 192, 384, 768), 768, 6, ids,
            seed=10, h=384)
        g = torch.Generator(device=dev).manual_seed(20)
        d_out = torch.randn((9, 3136, 768), generator=g, device=dev)
        got = _bwd_outs(ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2,
                                                    idx, d_out))
        torch.cuda.synchronize()
        keep = [i for i in range(9) if i != 4]
        assert all(torch.isnan(t[4]).all() and torch.isfinite(t[keep]).all()
                   for t in got)
        ref = _bwd_outs(ef.expert_fusion_gather_bwd_reference(
            tuple(x[keep] for x in xs), wp, bp, w1, b1, w2, idx[keep],
            d_out[keep].contiguous()))
        _bwd_close([t[keep] for t in got], ref)

    @pytest.mark.parametrize("case", [0, 1])
    def test_k2_bits(self, dev, case):
        """The bits of K2's outputs on numpy inputs (``_digest_inputs`` and
        a cotangent from the same seed), as the kernel gives them with its
        five products on the wgmma core (scripts/ab_torch_gloria.py --k2
        prints them as "ab K2 bits"); recorded with
        ``DIGESTS_RECORDED_WITH``, and anew whenever K2 changes on
        purpose."""
        _skip_unless_digest_toolchain()
        xs, wp, bp, w1, b1, w2, _, idx = _digest_inputs(dev, case)
        d_out = _digest_cotangent(dev, case, xs, w1)
        got = hashlib.sha256()
        for t in _bwd_outs(ef.expert_fusion_gather_bwd(xs, wp, bp, w1, b1, w2,
                                                       idx, d_out)):
            got.update(t.float().cpu().numpy().tobytes())
        assert got.hexdigest() == K2_DIGESTS[case]


def _gloria_inputs(dev, b_img, b_txt, d, h, w, t, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    img = torch.randn((b_img, d, h, w), generator=g, device=dev)
    words = torch.randn((b_txt, d, t), generator=g, device=dev)
    cap = torch.randint(3, t + 1, (b_txt,), generator=g, device=dev)
    cot = torch.randn((b_img, b_txt), generator=g, device=dev)
    return img.to(torch.bfloat16), words.to(torch.bfloat16), cap, cot


def _gloria_close(got, want, scale=None):
    got, want = got.float(), want.float()
    if scale is None:
        scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-2 * scale)
    share = ((got - want).abs() > 2e-3 * scale).float().mean().item()
    assert share <= 0.01, f"{share:.2%} beyond 2e-3*max|ref|"


def _plain_prologue(img, words, cap, cot, temps):
    """The prologue's outputs in plain PyTorch, step for step
    ``gloria_similarity_bwd_reference`` down to d_wei: (bf16(d_wei)
    [B_img·B_txt, D, TPAD], per-word vectors [B_img·B_txt, 4, TPAD] f32:
    Σ_m e with e = exp(temp1·a1 - max(temp1, 0)), Σ_d bf16(d_wei)·wei, dnum
    and c2), zero past T, pairs image-major as the kernels lay them out."""
    temp1, temp2, temp3 = temps
    ctx, w = ga._plain_inputs(img, words)
    cell = ga._plain_chain(ctx, w, cap.long(), temp1, temp2)   # [B_txt, B_img]
    dcos = cot.float().T[..., None] * (temp2 * temp3) * cell["row"] \
        / cell["rowsum"]
    den = cell["den"]
    dnum = dcos / den
    dden = -dcos * cell["num"] / (den * den) \
        * (cell["den_raw"] > 1e-8).float()
    d_wei = dnum[:, :, None] * cell["w32"] + (
        dden * cell["nw"] / torch.clamp(cell["nwei"], min=1e-20)
    )[:, :, None] * cell["wei"]
    dw_bf = d_wei.to(torch.bfloat16)
    terms = dw_bf.float() * cell["wei"]
    vecs = torch.stack([
        torch.exp(temp1 * cell["a1"] - max(temp1, 0.0)).sum(2),
        terms.sum(2),
        dnum,
        dden * cell["nwei"] / torch.clamp(cell["nw"], min=1e-20)], dim=2)
    b_txt, b_img, d, t = d_wei.shape
    tp = ga._tpad(t)
    dwei = torch.zeros((b_img, b_txt, d, tp), dtype=torch.bfloat16,
                       device=img.device)
    dwei[..., :t] = dw_bf.transpose(0, 1)
    vec = torch.zeros((b_img, b_txt, 4, tp), device=img.device)
    vec[..., :t] = vecs.transpose(0, 1)
    return (dwei.reshape(-1, d, tp), vec.reshape(-1, 4, tp),
            terms.abs().max().item())


def _prologue_close(pairs, plain):
    """The prologue's bf16(d_wei) and its four per-word vectors against the
    plain version, with the backward's tolerance. s = Σ_d bf16(d_wei)·wei
    is a sum that cancels: the cosine does not change with the scale of
    wei, so Σ_d ∂cos/∂wei_d·wei_d = 0, and what is left of s is the bf16
    rounding of d_wei: a value of d_wei on the other side of a rounding
    boundary moves s by 2^-8 of its term. Its tolerance is taken against
    the largest term, max |bf16(d_wei)·wei|, rather than against max|s|."""
    dwei, vecs, s_terms = plain
    _gloria_close(pairs.dwei, dwei)
    for k in range(vecs.shape[1]):
        if k == 1:      # csrc/gloria_common.cuh V_S
            _gloria_close(pairs.vecs[:, k], vecs[:, k], scale=s_terms)
        else:
            _gloria_close(pairs.vecs[:, k], vecs[:, k])


GLORIA_SHAPES = [
    (3, 5, 48, 5, 7, 9),        # B_img != B_txt, odd M, D % 64 != 0, T = 9
    (4, 3, 80, 9, 9, 32),       # one full word tile, M = 81
    (2, 2, 768, 56, 56, 25),    # flagship widths
    (3, 5, 48, 5, 7, 40),       # two word tiles
    (2, 3, 64, 9, 9, 128),      # T at its limit: four word tiles
    (3, 5, 48, 12, 11, 9),      # M = 132: two M tiles, the last ragged;
                                # B_txt·TPAD = 160: a ragged word tile
    (2, 6, 768, 56, 56, 25),    # flagship widths, B_txt = 6: K4a's pass 1
                                # takes 4 captions a tile, the last tile 2
]


# K3 and the prologue where F1's and F2's tiles end: M = 49 (a 7 × 7 map,
# zero_shot_dense's), D = 48 and 80 (not whole 64-deep slices of F1, nor a
# whole 256-wide D tile of F2), T = 96 (F1's 192-wide tile of two
# captions), T = 128 (two captions of 128 a tile)
K3_PROLOGUE_SHAPES = [
    (2, 3, 768, 7, 7, 25),
    (3, 5, 48, 7, 7, 96),
    (3, 4, 80, 7, 7, 96),
    (2, 3, 80, 12, 11, 128),
    (3, 5, 48, 12, 11, 9),
]


@pytest.mark.cuda
class TestGloriaKernels:
    @pytest.mark.parametrize("shape", GLORIA_SHAPES)
    def test_forward_matches_plain_version(self, dev, shape):
        img, words, cap, _ = _gloria_inputs(dev, *shape)
        before = ga.LAUNCHES
        out = ga.gloria_similarity_forward(img, words, cap)
        torch.cuda.synchronize()
        assert ga.LAUNCHES == before + 1
        ref = ga.gloria_similarity_reference(img, words, cap)
        assert torch.isfinite(out).all() and out.shape == ref.shape
        torch.testing.assert_close(out, ref, rtol=0,
                                   atol=1e-3 * ref.abs().max().item())

    @pytest.mark.parametrize("shape", GLORIA_SHAPES)
    def test_backward_matches_plain_version(self, dev, shape):
        img, words, cap, cot = _gloria_inputs(dev, *shape, seed=1)
        before = (ga.DCTX_LAUNCHES, ga.DWORDS_LAUNCHES)
        d_img, d_words = ga.gloria_similarity_backward(img, words, cap, cot)
        torch.cuda.synchronize()
        assert (ga.DCTX_LAUNCHES, ga.DWORDS_LAUNCHES) == (before[0] + 1,
                                                          before[1] + 1)
        ref_img, ref_words = ga.gloria_similarity_bwd_reference(
            img, words, cap, cot)
        assert d_img.shape == img.shape and d_words.shape == words.shape
        assert d_img.dtype == d_words.dtype == torch.bfloat16
        for a, b in ((d_img, ref_img), (d_words, ref_words)):
            assert torch.isfinite(a).all()
            _gloria_close(a, b)

    @pytest.mark.parametrize("bad", [
        dict(t=129), dict(d=40), dict(d=784), dict(temp1=81.0)])
    def test_wrapper_raises_on_what_the_kernels_do_not_take(self, dev, bad):
        img, words, cap, cot = _gloria_inputs(dev, 2, 2, bad.get("d", 32), 4,
                                              4, bad.get("t", 9))
        temp1 = bad.get("temp1", 4.0)
        with pytest.raises(ValueError):
            ga.gloria_similarity_forward(img, words, cap, temp1)
        with pytest.raises(ValueError):
            ga.gloria_similarity_backward(img, words, cap, cot, temp1)

    @pytest.mark.parametrize("shape", [
        (2, 2, 768, 56, 56, 25),    # flagship widths
        (3, 5, 48, 5, 7, 40),       # two word tiles
        (2, 3, 64, 9, 9, 128),      # T at its limit
        (3, 5, 48, 12, 11, 9),      # M = 132, ragged captions, B_img != B_txt
    ])
    def test_dwords_alone_matches_plain_version(self, dev, shape):
        # K4b without K4a's second pass (the words' cotangent only)
        img, words, cap, cot = _gloria_inputs(dev, *shape, seed=6)
        before = (ga.DCTX_LAUNCHES, ga.DWORDS_LAUNCHES)
        d_img, d_words = ga.gloria_similarity_backward(img, words, cap, cot,
                                                       need_img=False)
        torch.cuda.synchronize()
        assert d_img is None
        assert (ga.DCTX_LAUNCHES, ga.DWORDS_LAUNCHES) == (before[0],
                                                          before[1] + 1)
        _, ref = ga.gloria_similarity_bwd_reference(img, words, cap, cot,
                                                    need_img=False)
        assert torch.isfinite(d_words).all()
        _gloria_close(d_words, ref)

    def test_dwords_is_the_same_on_every_run(self, dev):
        # K4b sums over images in chunk order, without atomics
        img, words, cap, cot = _gloria_inputs(dev, 3, 5, 48, 12, 11, 40, seed=7)
        runs = [ga.gloria_similarity_backward(img, words, cap, cot)[1]
                for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1])

    @pytest.mark.parametrize("images", [1, 2])
    def test_dwords_over_chunks_of_images(self, dev, monkeypatch, images):
        # five images over chunks of 1 or 2: the sum over images reordered,
        # so within the tolerance of the whole-batch run, not bit for bit
        img, words, cap, cot = _gloria_inputs(dev, 5, 3, 48, 12, 11, 40,
                                              seed=8)
        whole = ga.gloria_similarity_backward(img, words, cap, cot)
        per_image = ga.image_chunk(5, 3, 132, 40)[1] // 5
        monkeypatch.setattr(_scratch, "CHUNK_BYTES", images * per_image + 1)
        assert ga.image_chunk(5, 3, 132, 40)[0] == images
        chunked = ga.gloria_similarity_backward(img, words, cap, cot)
        torch.cuda.synchronize()
        ref = ga.gloria_similarity_bwd_reference(img, words, cap, cot)
        for a, w, r in zip(chunked, whole, ref):
            _gloria_close(a, w)
            _gloria_close(a, r)

    @pytest.mark.parametrize("shape,slices", [
        ((3, 5, 48, 12, 11, 9), 2),     # M = 132: 7 steps of 64 rows, the
                                        # slice boundary inside an image;
                                        # B_txt = 5: a ragged word tile
        ((3, 5, 48, 12, 11, 9), 8),     # more slices than steps: one empty
        ((2, 3, 64, 9, 9, 40), 3),      # TPAD 64
        ((3, 3, 80, 7, 7, 96), 2),      # TPAD 96: tiles across captions;
                                        # D = 80: a ragged D tile
        ((2, 3, 64, 9, 9, 128), 2),     # TPAD 128
        ((2, 6, 768, 56, 56, 25), 3),   # flagship widths, B_txt = 6
    ])
    def test_dwords_k_slices_match_plain_version(self, dev, monkeypatch,
                                                 shape, slices):
        # K4b's product over slices of a chunk's K, summed in order
        img, words, cap, cot = _gloria_inputs(dev, *shape, seed=12)
        monkeypatch.setattr(ga, "K4B_SLICES", slices)
        before = ga.DWORDS_LAUNCHES
        _, d_words = ga.gloria_similarity_backward(img, words, cap, cot,
                                                   need_img=False)
        torch.cuda.synchronize()
        assert ga.DWORDS_LAUNCHES == before + 1
        _, ref = ga.gloria_similarity_bwd_reference(img, words, cap, cot,
                                                    need_img=False)
        assert torch.isfinite(d_words).all()
        _gloria_close(d_words, ref)

    @pytest.mark.parametrize("images", [1, 2])
    def test_dctx_over_chunks_of_images(self, dev, monkeypatch, images):
        # five images over chunks of 1 or 2: an image's d_ctx comes from its
        # own Z and its own tiles, so the same bits as the whole-batch run
        img, words, cap, cot = _gloria_inputs(dev, 5, 3, 48, 12, 11, 40,
                                              seed=9)
        whole = ga.gloria_similarity_backward(img, words, cap, cot,
                                              need_words=False)[0]
        per_image = ga.image_chunk(5, 3, 132, 40)[1] // 5
        monkeypatch.setattr(_scratch, "CHUNK_BYTES", images * per_image + 1)
        assert ga.image_chunk(5, 3, 132, 40)[0] == images
        before = ga.DCTX_LAUNCHES
        chunked = ga.gloria_similarity_backward(img, words, cap, cot,
                                                need_words=False)[0]
        torch.cuda.synchronize()
        assert ga.DCTX_LAUNCHES == before + 1
        assert torch.equal(chunked, whole)
        ref, _ = ga.gloria_similarity_bwd_reference(img, words, cap, cot,
                                                    need_words=False)
        _gloria_close(chunked, ref)

    def test_dctx_is_the_same_on_every_run(self, dev):
        # K4a sums over captions in a fixed order, without atomics
        img, words, cap, cot = _gloria_inputs(dev, 3, 5, 48, 5, 7, 40, seed=3)
        runs = [ga.gloria_similarity_backward(img, words, cap, cot,
                                              need_words=False)[0]
                for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1])

    def test_forward_is_the_same_on_every_run(self, dev):
        # K3 sums over M, D and words in a fixed order, without atomics
        img, words, cap, _ = _gloria_inputs(dev, 3, 5, 48, 12, 11, 40, seed=4)
        runs = [ga.gloria_similarity_forward(img, words, cap) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1])

    @pytest.mark.parametrize("shape", K3_PROLOGUE_SHAPES)
    def test_k3_and_prologue_match_plain_versions(self, dev, shape):
        # sim, and the prologue's bf16(d_wei) and per-word vectors, on the
        # shapes that F1's and F2's tiles meet at their edges
        img, words, cap, cot = _gloria_inputs(dev, *shape, seed=10)
        temps = (4.0, 5.0, 10.0)
        before = (ga.LAUNCHES, ga.PROLOGUE_LAUNCHES)
        sim = ga.gloria_similarity_forward(img, words, cap, *temps)
        pairs = ga.pair_cotangents(img, words, cap, cot, *temps)
        torch.cuda.synchronize()
        assert (ga.LAUNCHES, ga.PROLOGUE_LAUNCHES) == (before[0] + 1,
                                                       before[1] + 1)
        ref = ga.gloria_similarity_reference(img, words, cap, *temps)
        assert torch.isfinite(sim).all()
        torch.testing.assert_close(sim, ref, rtol=0,
                                   atol=1e-3 * ref.abs().max().item())
        _prologue_close(pairs, _plain_prologue(img, words, cap, cot, temps))

    @pytest.mark.parametrize("images", [1, 2])
    def test_k3_and_prologue_over_chunks_of_images(self, dev, monkeypatch,
                                                   images):
        # five images over chunks of 1 or 2: an image's sim, d_wei and
        # per-word vectors come from its own E and its own tiles, so the
        # same bits as the whole-batch run
        img, words, cap, cot = _gloria_inputs(dev, 5, 3, 48, 12, 11, 40,
                                              seed=11)
        temps = (4.0, 5.0, 10.0)
        sim = ga.gloria_similarity_forward(img, words, cap, *temps)
        pairs = ga.pair_cotangents(img, words, cap, cot, *temps)
        per_image = ga.image_chunk(5, 3, 132, 40)[1] // 5
        monkeypatch.setattr(_scratch, "CHUNK_BYTES", images * per_image + 1)
        assert ga.image_chunk(5, 3, 132, 40)[0] == images
        sim_c = ga.gloria_similarity_forward(img, words, cap, *temps)
        pairs_c = ga.pair_cotangents(img, words, cap, cot, *temps)
        torch.cuda.synchronize()
        assert torch.equal(sim_c, sim)
        assert torch.equal(pairs_c.dwei, pairs.dwei)
        assert torch.equal(pairs_c.vecs, pairs.vecs)
        ref = ga.gloria_similarity_reference(img, words, cap, *temps)
        torch.testing.assert_close(sim_c, ref, rtol=0,
                                   atol=1e-3 * ref.abs().max().item())
        _prologue_close(pairs_c, _plain_prologue(img, words, cap, cot, temps))

    def test_prologue_is_the_same_on_every_run(self, dev):
        # the prologue's bf16(d_wei) and per-word vectors, bit for bit
        img, words, cap, cot = _gloria_inputs(dev, 3, 5, 48, 12, 11, 40, seed=5)
        runs = [ga.pair_cotangents(img, words, cap, cot, 4.0, 5.0, 10.0)
                for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0].dwei, runs[1].dwei)
        assert torch.equal(runs[0].vecs, runs[1].vecs)

    @staticmethod
    def _digest_inputs(dev, shape):
        """The digest tests' (img, words, cap, cot), made with numpy."""
        _skip_unless_digest_toolchain()
        b_img, b_txt, d, h, w, t = shape
        rng = np.random.RandomState(0)
        img = torch.from_numpy(rng.randn(b_img, d, h, w).astype(np.float32))
        words = torch.from_numpy(rng.randn(b_txt, d, t).astype(np.float32))
        cap = torch.from_numpy(rng.randint(3, t + 1, b_txt).astype(np.int32))
        cot = torch.from_numpy(rng.randn(b_img, b_txt).astype(np.float32))
        img, words = (x.to(torch.bfloat16).to(dev) for x in (img, words))
        return img, words, cap.to(dev), cot.to(dev)

    def _digest_run(self, dev, shape, need_words=False):
        """K3, the prologue and K4a (and K4b with ``need_words``) on numpy
        inputs: (sim, pairs, d_ctx, d_words or None)."""
        img, words, cap, cot = self._digest_inputs(dev, shape)
        temps = (4.0, 5.0, 10.0)
        sim = ga.gloria_similarity_forward(img, words, cap, *temps)
        pairs = ga.pair_cotangents(img, words, cap, cot, *temps, need_words)
        dctx, dwords = ga.cotangents_of(pairs, True, need_words)
        return sim, pairs, dctx, dwords

    def _function_digest_run(self, dev, monkeypatch, shape, need_words):
        """The same through the autograd Function, whose K3 keeps its state
        (the digest shapes' state is far under a quarter of the card): the
        prologue's scratch and K4a's and K4b's f32 outputs as the backward
        made them."""
        img, words, cap, cot = self._digest_inputs(dev, shape)
        seen = {}
        for name, key in (("pair_cotangents", "pairs"),
                          ("cotangents_of", "out")):
            def record(*a, _fn=getattr(ga, name), _key=key, **k):
                seen[_key] = _fn(*a, **k)
                return seen[_key]

            monkeypatch.setattr(ga, name, record)
        kept = trace.counters().get(trace.GLORIA_KEPT, 0)
        i = img.clone().requires_grad_()
        w = words.clone().requires_grad_(need_words)
        sim = ga.gloria_similarity(i, w, cap, 4.0, 5.0, 10.0)
        (sim * cot).sum().backward()
        torch.cuda.synchronize()
        assert trace.counters()[trace.GLORIA_KEPT] == kept + 1
        return (sim.detach(), seen["pairs"]) + tuple(seen["out"])

    @pytest.mark.parametrize("shape,digest", [
        ((3, 5, 48, 12, 11, 40), K3_PROLOGUE_DIGESTS[0]),
        ((2, 3, 768, 56, 56, 25), K3_PROLOGUE_DIGESTS[1]),
    ])
    def test_gemm_core_a_layout_leaves_gloria_bits(self, dev, shape, digest):
        """The bits of K3 and the prologue (sim, bf16(d_wei), the per-word
        vectors) on numpy inputs, as the kernels give them with F1 and F2
        on the wgmma core of csrc/wgmma_core.cuh (scripts/ab_torch_gloria.py
        prints the digest as "ab digest K3 + prologue"); a change to another
        kernel (K4a, K4b, the expert branch) leaves them alone. Bits depend
        on the compiler and the card, so the digests hold only for the
        toolkit and card they were recorded with (``DIGESTS_RECORDED_WITH``)
        and the test skips on any other; record them anew whenever K3 or
        the prologue change on purpose."""
        sim, pairs, _, _ = self._digest_run(dev, shape)
        got = hashlib.sha256()
        for out in (sim, pairs.dwei, pairs.vecs):
            got.update(out.float().cpu().numpy().tobytes())
        assert got.hexdigest() == digest

    @pytest.mark.parametrize("shape,digest", [
        ((3, 5, 48, 12, 11, 40), K4A_DIGESTS[0]),
        ((2, 3, 768, 56, 56, 25), K4A_DIGESTS[1]),
    ])
    def test_k4a_bits(self, dev, shape, digest):
        """The bits of K4a's d_ctx on the same inputs, as the wgmma K4a
        gives them from the prologue's bf16(d_wei) and per-word vectors
        (scripts/ab_torch_gloria.py prints them as "ab K4a bits");
        recorded with ``DIGESTS_RECORDED_WITH``, and anew whenever K4a or
        the prologue change on purpose."""
        _, _, dctx, _ = self._digest_run(dev, shape)
        got = hashlib.sha256(dctx.float().cpu().numpy().tobytes())
        assert got.hexdigest() == digest

    @pytest.mark.parametrize("shape,digest", [
        ((3, 5, 48, 12, 11, 40), K4B_DIGESTS[0]),
        ((2, 3, 768, 56, 56, 25), K4B_DIGESTS[1]),
    ])
    def test_k4b_bits(self, dev, shape, digest):
        """The bits of K4b's f32 d_words on the same inputs, as the wgmma
        K4b gives them (its product over ``K4B_SLICES`` slices of a chunk's
        K, summed in order, with the prologue's f32 terms); the second
        shape's chunk has 98 steps of 64 rows, cut at step 49
        (scripts/ab_torch_gloria.py prints them as "ab K4b bits");
        recorded with ``DIGESTS_RECORDED_WITH``, and anew whenever K4b or
        the prologue change on purpose."""
        _, _, _, dwords = self._digest_run(dev, shape, need_words=True)
        got = hashlib.sha256(dwords.float().cpu().numpy().tobytes())
        assert got.hexdigest() == digest

    @pytest.mark.parametrize("case", [0, 1])
    def test_kept_path_keeps_the_k3_prologue_and_k4a_digests(
            self, dev, monkeypatch, case):
        """The bits of K3, the prologue and K4a, reached through the
        autograd Function with K3's state kept: the digests of the recompute
        path (``test_gemm_core_a_layout_leaves_gloria_bits``,
        ``test_k4a_bits``)."""
        shape = ((3, 5, 48, 12, 11, 40), (2, 3, 768, 56, 56, 25))[case]
        sim, pairs, dctx, _ = self._function_digest_run(dev, monkeypatch,
                                                        shape, False)
        got = hashlib.sha256()
        for out in (sim, pairs.dwei, pairs.vecs):
            got.update(out.float().cpu().numpy().tobytes())
        assert got.hexdigest() == K3_PROLOGUE_DIGESTS[case]
        got = hashlib.sha256(dctx.float().cpu().numpy().tobytes())
        assert got.hexdigest() == K4A_DIGESTS[case]

    @pytest.mark.parametrize("case", [0, 1])
    def test_kept_path_keeps_the_k4b_digests(self, dev, monkeypatch, case):
        """K4b's f32 d_words through the autograd Function with K3's state
        kept (the prologue's f32 terms from the kept wei): the digests of
        ``test_k4b_bits``."""
        shape = ((3, 5, 48, 12, 11, 40), (2, 3, 768, 56, 56, 25))[case]
        _, _, _, dwords = self._function_digest_run(dev, monkeypatch, shape,
                                                    True)
        got = hashlib.sha256(dwords.float().cpu().numpy().tobytes())
        assert got.hexdigest() == K4B_DIGESTS[case]

    @staticmethod
    def _kept_and_recomputed(img, words, cap, cot, need_words):
        """K3 with its state kept and the prologue from it, then K3 without
        and the prologue recomputing, on the same inputs: (sim with the
        store, sim without, kept pairs, recomputed pairs)."""
        temps = (4.0, 5.0, 10.0)
        counts = trace.counters()
        state = ga.KeptState()
        sim_kept = ga.gloria_similarity_forward(img, words, cap, *temps,
                                                kept=state)
        assert [x.shape for x in state.tensors] == [
            s for s, _ in ga._state(img.shape[0], words.shape[0],
                                    img.shape[2] * img.shape[3],
                                    img.shape[1], words.shape[2])]
        kept = ga.pair_cotangents(img, words, cap, cot, *temps, need_words,
                                  kept=state)
        assert state.tensors is None          # freed once queued
        sim = ga.gloria_similarity_forward(img, words, cap, *temps)
        recomputed = ga.pair_cotangents(img, words, cap, cot, *temps,
                                        need_words)
        torch.cuda.synchronize()
        after = trace.counters()
        for name in (trace.GLORIA_KEPT, trace.GLORIA_RECOMPUTED):
            assert after[name] == counts.get(name, 0) + 1
        return sim_kept, sim, kept, recomputed

    @staticmethod
    def _assert_same_pairs(a, b, need_words):
        assert torch.equal(a.dwei, b.dwei)
        assert torch.equal(a.vecs, b.vecs)
        if need_words:
            assert torch.equal(a.wsum, b.wsum)
            assert torch.equal(a.c2sum, b.c2sum)

    @pytest.mark.parametrize("need_words", [False, True])
    @pytest.mark.parametrize("shape", K3_PROLOGUE_SHAPES)
    def test_kept_state_gives_the_recomputed_bits(self, dev, shape,
                                                  need_words):
        # the prologue from K3's kept state against the prologue running
        # F1 and F2 again: bf16(d_wei), the per-word vectors and K4b's f32
        # terms bit for bit; K3's sim the same with wei stored or not
        img, words, cap, cot = _gloria_inputs(dev, *shape, seed=13)
        sim_kept, sim, kept, rec = self._kept_and_recomputed(
            img, words, cap, cot, need_words)
        assert torch.equal(sim_kept, sim)
        self._assert_same_pairs(kept, rec, need_words)

    @pytest.mark.parametrize("images", [1, 2])
    def test_kept_state_over_chunks_of_images(self, dev, monkeypatch,
                                              images):
        # five images over chunks of 1 or 2: K3 writes each image's state
        # at its place in the whole batch, and the prologue reads it in one
        # pass; the bits of the recompute path, and of the whole-batch run
        img, words, cap, cot = _gloria_inputs(dev, 5, 3, 48, 12, 11, 40,
                                              seed=14)
        _, whole_sim, _, whole = self._kept_and_recomputed(
            img, words, cap, cot, True)
        per_image = ga.image_chunk(5, 3, 132, 40)[1] // 5
        monkeypatch.setattr(_scratch, "CHUNK_BYTES", images * per_image + 1)
        assert ga.image_chunk(5, 3, 132, 40)[0] == images
        sim_kept, sim, kept, rec = self._kept_and_recomputed(
            img, words, cap, cot, True)
        for s in (sim_kept, sim):
            assert torch.equal(s, whole_sim)
        self._assert_same_pairs(kept, rec, True)
        self._assert_same_pairs(kept, whole, True)

    @pytest.mark.parametrize("words_grad", [False, True])
    def test_function_recomputes_over_the_rule_with_the_same_bits(
            self, dev, monkeypatch, words_grad):
        # a card too small for the state: the Function keeps nothing, its
        # prologue runs F1 and F2 again, and the gradients are the bits of
        # the kept path
        img, words, cap, cot = _gloria_inputs(dev, 3, 5, 48, 12, 11, 40,
                                              seed=15)
        grads = {}
        for total in (None, ga.kept_bytes(3, 5, 132, 48, 40) * 4 - 1):
            if total is not None:
                monkeypatch.setattr(ga, "_card_memory", lambda t: total)
            counts = trace.counters()
            i = img.clone().requires_grad_()
            w = words.clone().requires_grad_(words_grad)
            out = ga.gloria_similarity(i, w, cap)
            (out * cot).sum().backward()
            torch.cuda.synchronize()
            name = trace.GLORIA_KEPT if total is None \
                else trace.GLORIA_RECOMPUTED
            assert trace.counters()[name] == counts.get(name, 0) + 1
            grads[total is None] = (out.detach(), i.grad, w.grad)
        assert (grads[True][2] is None) == (not words_grad)
        for a, b in zip(grads[True], grads[False]):
            if a is None:
                assert b is None
            else:
                assert torch.equal(a, b)

    def test_prologue_refuses_a_state_of_other_inputs(self, dev):
        img, words, cap, cot = _gloria_inputs(dev, 3, 5, 48, 12, 11, 40,
                                              seed=17)
        state = ga.KeptState()
        ga.gloria_similarity_forward(img[:2], words, cap, kept=state)
        with pytest.raises(ValueError):
            ga.pair_cotangents(img, words, cap, cot, 4.0, 5.0, 10.0,
                               kept=state)

    def test_no_state_without_a_gradient(self, dev):
        img, words, cap, _ = _gloria_inputs(dev, 3, 5, 48, 12, 11, 40,
                                            seed=16)
        i = img.clone().requires_grad_()
        assert ga._keeps(i, words, cap)
        with torch.no_grad():
            assert not ga._keeps(i, words, cap)
        assert not ga._keeps(img, words, cap)

    def test_wrapper_raises_on_mixed_devices_and_dtypes(self, dev):
        img, words, cap, _ = _gloria_inputs(dev, 2, 2, 32, 4, 4, 9)
        with pytest.raises(ValueError):
            ga.gloria_similarity_forward(img, words.cpu(), cap)
        with pytest.raises(TypeError):
            ga.gloria_similarity_forward(img, words, cap.float())

    @pytest.mark.parametrize("words_grad", [False, True])
    def test_function_counts_its_launches(self, dev, words_grad):
        img, words, cap, cot = _gloria_inputs(dev, 3, 3, 32, 4, 4, 9, seed=2)
        i = img.clone().requires_grad_()
        w = words.clone().requires_grad_(words_grad)
        counts = ("LAUNCHES", "PROLOGUE_LAUNCHES", "DCTX_LAUNCHES",
                  "DWORDS_LAUNCHES")
        before = [getattr(ga, c) for c in counts]
        out = ga.gloria_similarity(i, w, cap)
        (out * cot).sum().backward()
        torch.cuda.synchronize()
        assert [getattr(ga, c) for c in counts] == [
            before[0] + 1, before[1] + 1, before[2] + 1,
            before[3] + int(words_grad)]
        assert (w.grad is not None) == words_grad
        ref_img, _ = ga.gloria_similarity_bwd_reference(img, words, cap, cot)
        _gloria_close(i.grad, ref_img)
