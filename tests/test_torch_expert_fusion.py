"""K1, the fused expert branch, in the PyTorch port: the wrapper's plain
version (what it runs for CPU tensors) against both JAX arms — the XLA
gather path of ``ExpertBank.apply_gathered`` and the Pallas kernel in
interpret mode — on a 4-scale pyramid with the flagship's 4×/16×/64×
upsample ratios, plus the wrapper's input contract.

Tolerances: float32 checks the algorithm, so it is tight (rtol 1e-4,
atol 1e-5: only the f32 summation order differs). bfloat16 checks the
rounding points with the JAX package's own fused-vs-XLA tolerance
(tests/test_pallas_expert.py, rtol 2e-2, atol 2e-3): both sides round at
the same points, and a different summation order can flip one bf16 ulp.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from medmoe_tpu.models import moe as jmoe
from medmoe_tpu.ops.pallas import expert_fusion as jef
from medmoe_torch.models import moe as tmoe
from medmoe_torch.ops import expert_fusion as ef

torch.set_num_threads(1)

P_LIST = (64, 16, 4, 1)            # ratios 1, 4, 16, 64 like 3136/784/196/49
D_LIST = (8, 16, 32, 64)
E, K, B = 32, 3, 6
TIGHT = dict(rtol=1e-4, atol=1e-5)
LOOSE = dict(rtol=2e-2, atol=2e-3)


def _jax_bank(dtype):
    cfg = jmoe.MoEConfig(num_experts=K, hidden_dims=D_LIST, output_dim=E,
                         router_input_dim=64, router_hidden_dim=8,
                         dtype=dtype)
    return jmoe.ExpertBank(cfg)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    pyramid = [rng.randn(B, p, d).astype(np.float32)
               for p, d in zip(P_LIST, D_LIST)]
    idx = np.array([0, 1, 2, 2, 1, 0], np.int32)       # every expert used
    params = jax.jit(functools.partial(
        _jax_bank(jnp.float32).init, method=jmoe.ExpertBank.apply_gathered))(
            jax.random.PRNGKey(0), [jnp.asarray(x) for x in pyramid],
            jnp.asarray(idx))["params"]
    # nonzero biases so every bias path is exercised
    params = {k: (np.asarray(v) + 0.1 * rng.randn(*v.shape).astype(np.float32)
                  if "_b" in k else np.asarray(v)) for k, v in params.items()}
    return pyramid, idx, params


def _jax_run(pyramid, idx, params, dtype, impl):
    bank = _jax_bank(dtype)
    os.environ["MEDMOE_EXPERT_IMPL"] = impl
    try:
        args = ({"params": params}, [jnp.asarray(x) for x in pyramid],
                jnp.asarray(idx))
        if impl == "pallas":
            with pltpu.force_tpu_interpret_mode():
                out = bank.apply(*args, method=jmoe.ExpertBank.apply_gathered)
        else:
            out = bank.apply(*args, method=jmoe.ExpertBank.apply_gathered)
    finally:
        os.environ.pop("MEDMOE_EXPERT_IMPL", None)
    return np.asarray(out, np.float32)


def _torch_args(pyramid, idx, params, dtype):
    t = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    xs = tuple(torch.from_numpy(x).to(dtype) for x in pyramid)
    n = len(pyramid)
    return (xs, tuple(t[f"proj_w{s}"] for s in range(n)),
            tuple(t[f"proj_b{s}"] for s in range(n)), t["attn_w1"],
            t["attn_b1"], t["attn_w2"], t["attn_b2"],
            torch.from_numpy(idx))


class TestPlainVersionAgainstJax:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_xla_gather(self, data, dtype):
        pyramid, idx, params = data
        jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
        want = _jax_run(pyramid, idx, params, jdt, "xla")
        args = _torch_args(pyramid, idx, params, tdt)
        got = ef.expert_fusion_gather_reference(*args, dtype=tdt).numpy()
        assert got.shape == (B, P_LIST[0], E)
        np.testing.assert_allclose(got, want,
                                   **(TIGHT if dtype == "float32" else LOOSE))

    def test_wrapper_matches_pallas_interpret_bf16(self, data):
        """The wrapper on CPU tensors (its plain version) against the TPU
        kernel itself, run in interpret mode as the JAX package's own
        tests run it."""
        pyramid, idx, params = data
        want = _jax_run(pyramid, idx, params, jnp.bfloat16, "pallas")
        got = ef.expert_fusion_gather(
            *_torch_args(pyramid, idx, params, torch.bfloat16)).numpy()
        np.testing.assert_allclose(got, want, **LOOSE)

    def test_pallas_arm_float32_takes_plain_path(self, data):
        """In float32 the JAX gate sends even MEDMOE_EXPERT_IMPL=pallas to
        XLA, and the port's gate sends the bank to its plain version: the
        two agree tightly."""
        pyramid, idx, params = data
        assert not ef.use_fused_expert(P_LIST, P_LIST[0], torch.float32)
        want = _jax_run(pyramid, idx, params, jnp.float32, "pallas")
        cfg = tmoe.MoEConfig(num_experts=K, hidden_dims=D_LIST, output_dim=E,
                             router_input_dim=64, router_hidden_dim=8,
                             dtype=torch.float32)
        bank = tmoe.ExpertBank(cfg)
        bank.load_state_dict({k: torch.from_numpy(np.array(v))
                              for k, v in params.items()})
        with torch.no_grad():
            got = bank.apply_gathered(
                [torch.from_numpy(x) for x in pyramid],
                torch.from_numpy(idx)).numpy()
        np.testing.assert_allclose(got, want, **TIGHT)

    def test_bank_bf16_goes_through_wrapper(self, data):
        pyramid, idx, params = data
        cfg = tmoe.MoEConfig(num_experts=K, hidden_dims=D_LIST, output_dim=E,
                             router_input_dim=64, router_hidden_dim=8)
        bank = tmoe.ExpertBank(cfg)
        bank.load_state_dict({k: torch.from_numpy(np.array(v))
                              for k, v in params.items()})
        calls = []
        real = ef.expert_fusion_gather
        ef.expert_fusion_gather = lambda *a: calls.append(a) or real(*a)
        try:
            with torch.no_grad():
                got = bank.apply_gathered(
                    [torch.from_numpy(x) for x in pyramid],
                    torch.from_numpy(idx)).numpy()
        finally:
            ef.expert_fusion_gather = real
        assert len(calls) == 1
        want = _jax_run(pyramid, idx, params, jnp.bfloat16, "xla")
        np.testing.assert_allclose(got, want, **LOOSE)

    def test_cpu_run_counts_no_launch(self, data):
        pyramid, idx, params = data
        before = ef.LAUNCHES
        ef.expert_fusion_gather(*_torch_args(pyramid, idx, params,
                                             torch.bfloat16))
        assert ef.LAUNCHES == before


class TestInterpolation:
    @pytest.mark.parametrize("src,dst", [(49, 3136), (196, 3136), (784, 3136),
                                         (4, 64), (5, 15), (6, 10)])
    def test_matches_torch_interpolate(self, src, dst):
        x = torch.from_numpy(np.random.RandomState(src).randn(2, src, 3)
                             .astype(np.float32))
        got = tmoe.interp_patches(x, dst, dim=1)
        want = F.interpolate(x.permute(0, 2, 1), size=dst, mode="linear",
                             align_corners=False).permute(0, 2, 1)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("src,dst", [(16, 64), (1, 64), (5, 15)])
    def test_matches_jax_interp_patches_bf16(self, src, dst):
        x = np.random.RandomState(dst).randn(2, src, 4).astype(np.float32)
        want = np.asarray(jmoe.interp_patches(
            jnp.asarray(x, jnp.bfloat16), dst, axis=1), np.float32)
        got = tmoe.interp_patches(torch.from_numpy(x).to(torch.bfloat16), dst,
                                  dim=1).float().numpy()
        np.testing.assert_array_equal(got, want)

    def test_interp_matrix_matches_jax(self):
        np.testing.assert_array_equal(tmoe.linear_interp_matrix(196, 3136),
                                      jmoe.linear_interp_matrix(196, 3136))

    def test_gate_matches_jax(self):
        for p_list in ([64, 16, 4, 1], [64, 24], [3136, 784, 196, 49]):
            assert ef.expert_fusion_supported(p_list, max(p_list)) == \
                jef.expert_fusion_supported(p_list, max(p_list))


def _good_args():
    rng = np.random.RandomState(1)
    pyramid = [rng.randn(2, p, d).astype(np.float32)
               for p, d in zip(P_LIST, D_LIST)]
    idx = np.array([0, 2], np.int32)
    params = {}
    for s, d in enumerate(D_LIST):
        params[f"proj_w{s}"] = rng.randn(K, d, E).astype(np.float32)
        params[f"proj_b{s}"] = rng.randn(K, E).astype(np.float32)
    params.update(attn_w1=rng.randn(K, E, E // 2).astype(np.float32),
                  attn_b1=rng.randn(K, E // 2).astype(np.float32),
                  attn_w2=rng.randn(K, E // 2, 1).astype(np.float32),
                  attn_b2=rng.randn(K, 1).astype(np.float32))
    return list(_torch_args(pyramid, idx, params, torch.bfloat16))


def _pyramid_f32(a):
    a[0] = tuple(x.float() for x in a[0])


def _ratio_5(a):
    a[0] = (a[0][0][:, :60], a[0][1][:, :16])
    a[1], a[2] = a[1][:2], a[2][:2]


def _bad_expert_id(a):
    a[7] = torch.tensor([0, K], dtype=torch.int32)


def _hidden_too_wide(a):
    k, e, _ = a[3].shape
    a[3] = torch.zeros(k, e, 2056)
    a[4] = torch.zeros(k, 2056)
    a[5] = torch.zeros(k, 2056, 1)


def _non_contiguous(a):
    a[3] = a[3].transpose(1, 2).contiguous().transpose(1, 2)


def _params_bf16(a):
    a[3] = a[3].to(torch.bfloat16)


def _five_scales(a):
    a[0] = a[0] + a[0][-1:]
    a[1] = a[1] + a[1][-1:]
    a[2] = a[2] + a[2][-1:]


class TestWrapperContract:
    def test_good_args_run(self):
        out = ef.expert_fusion_gather(*_good_args())
        assert out.shape == (2, P_LIST[0], E) and out.dtype == torch.float32

    @pytest.mark.parametrize("breaker,exc", [
        (_pyramid_f32, TypeError), (_ratio_5, ValueError),
        (_bad_expert_id, IndexError), (_hidden_too_wide, ValueError),
        (_non_contiguous, ValueError), (_params_bf16, TypeError),
        (_five_scales, ValueError)])
    def test_raises_on_what_the_kernel_does_not_take(self, breaker, exc):
        a = _good_args()
        breaker(a)
        with pytest.raises(exc):
            ef.expert_fusion_gather(*a)

    def test_forward_scratch_fits_flagship(self):
        # u_s of every scale (h_0 at the identity scale) and 4 × 2
        # partial-logit tiles an image; a serving wave of 32 is one chunk,
        # B=256 three
        assert ef.fwd_scratch_bytes((3136, 784, 196, 49), 768, 384) == \
            4 * 3136 * 768 * 2 + 4 * 2 * 3136 * 4
        assert ef.fwd_image_chunk(32, (3136, 784, 196, 49), 768, 384)[0] == 32
        assert ef.fwd_image_chunk(256, (3136, 784, 196, 49), 768, 384)[0] == 87


def _lerp_rows(p, p_s, p_max):
    """Source rows and weight of u row p, as ``lerp_rows`` in
    csrc/expert_fusion_passes.cuh computes them (the phase form; offsets in
    double, the weight in f32)."""
    r = p_max // p_s
    q, ph = divmod(p, r)
    off = (ph + 0.5) / r - 0.5
    c = np.floor(off)
    w = np.float32(off - c)
    if c < 0:
        return max(q - 1, 0), q, w
    return q, min(q + 1, p_s - 1), w


def _tiled_u(h, p_max):
    """u_s = bf16(lerp(h_s)) as K1's projection writes it from its staged
    tiles (``ef.proj_row_tiles`` with the halo): each tile holds its 128 h
    rows — rows past P_s are NaN here, so a u row that read one would show
    it — and writes the u rows of the h rows it owns from its own rows,
    x0·(1 − w) + x1·w in f32 with a rounding after each operation. Each u
    row must be written exactly once."""
    bf = torch.bfloat16
    b, p_s, e = h.shape
    r = p_max // p_s
    u = torch.full((b, p_max, e), float("nan"))
    written = np.zeros(p_max, np.int64)
    for m0, lo, hi in ef.proj_row_tiles(p_s, True):
        tile = torch.full((b, 128, e), float("nan"))
        n = min(128, p_s - m0)
        tile[:, :n] = h[:, m0:m0 + n].float()
        for p in range(lo * r, hi * r):
            i0, i1, w = _lerp_rows(p, p_s, p_max)
            assert 0 <= i0 - m0 < 128 and 0 <= i1 - m0 < 128
            wt = torch.tensor(w)
            x0, x1 = tile[:, i0 - m0], tile[:, i1 - m0]
            u[:, p] = (x0 * (1 - wt) + x1 * wt).to(bf)
            written[p] += 1
    assert (written == 1).all()
    return u


def _staged_forward(xs, wp, bp, w1, b1, w2, idx, tile=192):
    """The staging of csrc/expert_fusion.cu's passes in torch ops, f32 sums
    of bf16 values: h_s as the plain version rounds it; u_s from h_s in
    the projection's row tiles (``_tiled_u``; the identity scale's u is
    h_0); per scale the attention MLP's 192-wide tiles of H, each tile's
    partial logit of a row summed as the wgmma epilogue sums it: lane q of
    the row's quad holds columns 8j + 2q + e of the tile and adds
    bf16(relu(·))·w2 over them in order (j, then e), one fused multiply-add
    each (an f64 product and sum rounded to f32), then the quad's four
    lanes in order; the tiles summed in order; att = bf16(softmax over
    scales); out = Σ_s att_s·u_s in scale order. attn_b2 cancels in the
    softmax and is left out, as the kernel leaves it out."""
    bf = torch.bfloat16
    ix = idx.long()
    p_max = max(x.shape[1] for x in xs)

    def sel(param):
        return param[ix].to(bf).float()

    w1s, b1s, w2s = sel(w1), sel(b1), sel(w2)[..., 0]
    h_dim = w1s.shape[2]
    us, logits = [], []
    for s, x in enumerate(xs):
        h = torch.relu(torch.bmm(x.to(bf).float(), sel(wp[s]))
                       + sel(bp[s])[:, None, :]).to(bf)
        u = h.float() if x.shape[1] == p_max else _tiled_u(h, p_max)
        logit = torch.zeros(u.shape[:2])
        for n0 in range(0, h_dim, tile):
            n1 = min(n0 + tile, h_dim)
            a = torch.relu(torch.bmm(u, w1s[:, :, n0:n1])
                           + b1s[:, None, n0:n1]).to(bf).double()
            terms = torch.zeros(u.shape[:2] + (tile,), dtype=torch.float64)
            wts = torch.zeros(u.shape[:1] + (1, tile), dtype=torch.float64)
            terms[..., :n1 - n0] = a
            wts[..., :n1 - n0] = w2s[:, None, n0:n1].double()
            # [.., j, q, e] → lane q's columns in order (j, e)
            terms = terms.reshape(*terms.shape[:2], tile // 8, 4, 2) \
                .permute(0, 1, 3, 2, 4).reshape(*terms.shape[:2], 4, -1)
            wts = wts.reshape(wts.shape[0], 1, tile // 8, 4, 2) \
                .permute(0, 1, 3, 2, 4).reshape(wts.shape[0], 1, 4, -1)
            lanes = torch.zeros(u.shape[:2] + (4,), dtype=torch.float32)
            for c in range(terms.shape[-1]):
                lanes = (lanes.double() + terms[..., c] * wts[..., c]).float()
            part = lanes[..., 0]
            for q in range(1, 4):
                part = part + lanes[..., q]
            logit = logit + part
        us.append(u)
        logits.append(logit)
    att = torch.softmax(torch.stack(logits, -1), dim=-1).to(bf).float()
    out = us[0] * att[..., 0:1]
    for s in range(1, len(us)):
        out = out + us[s] * att[..., s:s + 1]
    return out


def _staged_case(p_list, d_list, e, h, idx, seed):
    """The staged forward against the plain version and the JAX
    ``_fwd_kernel`` in interpret mode on seeded inputs, at LOOSE."""
    rng = np.random.RandomState(seed)
    pyramid = [rng.randn(len(idx), p, d).astype(np.float32)
               for p, d in zip(p_list, d_list)]
    idx = np.array(idx, np.int32)
    params = {}
    for s, d in enumerate(d_list):
        params[f"proj_w{s}"] = (rng.randn(K, d, e) / np.sqrt(d)).astype(np.float32)
        params[f"proj_b{s}"] = (0.1 * rng.randn(K, e)).astype(np.float32)
    params.update(
        attn_w1=(rng.randn(K, e, h) / np.sqrt(e)).astype(np.float32),
        attn_b1=(0.1 * rng.randn(K, h)).astype(np.float32),
        attn_w2=(rng.randn(K, h, 1) / np.sqrt(h)).astype(np.float32),
        attn_b2=(0.1 * rng.randn(K, 1)).astype(np.float32))
    xs, wp, bp, w1, b1, w2, b2, tidx = _torch_args(pyramid, idx, params,
                                                   torch.bfloat16)
    got = _staged_forward(xs, wp, bp, w1, b1, w2, tidx)
    assert torch.isfinite(got).all()
    want = ef.expert_fusion_gather_reference(xs, wp, bp, w1, b1, w2, b2, tidx)
    torch.testing.assert_close(got, want, **LOOSE)
    jxs, n = [jnp.asarray(x, jnp.bfloat16) for x in pyramid], len(p_list)
    with pltpu.force_tpu_interpret_mode():
        jout = jef._fwd_pallas(
            jxs, [jnp.asarray(params[f"proj_w{s}"]) for s in range(n)],
            [jnp.asarray(params[f"proj_b{s}"]) for s in range(n)],
            jnp.asarray(params["attn_w1"]), jnp.asarray(params["attn_b1"]),
            jnp.asarray(params["attn_w2"]), jnp.asarray(idx),
            jef._interp_mats(list(p_list), p_list[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(jout, np.float32),
                               **LOOSE)


@pytest.mark.parametrize("h", [16, 160, 384, 200])
def test_staged_forward_matches_plain_version_and_jax(h):
    """The kernel's decomposition of the forward (u from the projection's
    row tiles, partial logits over 192-wide tiles of H, summed in tile
    order, then the combine) against the plain version and the JAX
    ``_fwd_kernel`` in interpret mode, at H = 16 and 160 (one ragged tile),
    384 (two) and 200 (two, the second ragged), in bf16 at the JAX
    package's fused-vs-XLA tolerance (LOOSE)."""
    _staged_case(P_LIST, D_LIST, 64, h, [0, 1, 2, 2, 1, 0], seed=h)


@pytest.mark.parametrize("p_list,d_list", [
    # r = 2, P_s = 128: 2 tiles, the second owns row 127 alone
    ((256, 128), (96, 32)),
    # r = 64, 2 tiles; D = 96 ends inside a 64-deep stage
    ((8384, 131), (24, 96)),
    # r = 2, 4, 50; P_s = 200: 2 tiles
    ((400, 200, 100, 8), (96, 40, 24, 16)),
])
def test_staged_forward_tile_edges_match_plain_version_and_jax(p_list, d_list):
    """The staged forward where the projection's row tiles end between h
    rows (P_s not a multiple of the 126-row stride), at ratios 2 to 64,
    against the plain version and the JAX kernel in interpret mode (LOOSE,
    as above)."""
    _staged_case(p_list, d_list, 32, 16, [2, 0], seed=sum(p_list))


@pytest.mark.parametrize("p_s,p", [(1, 64), (2, 128), (49, 3136), (126, 252),
                                   (127, 254), (128, 256), (131, 8384),
                                   (196, 3136), (253, 506), (784, 3136),
                                   (3136, 3136)])
def test_owning_tiles_cover_every_u_row_once(p_s, p):
    """K1's projection tiles (``proj_row_tiles``): with the halo (P_s < P)
    each tile holds 128 h rows from m0, owns [lo, hi), and every h row is
    owned once, so every u row p, written by the owner of p // r, is
    written once; the two source rows of each such u row lie in the
    owner's 128 rows. Without the halo the 128-row tiles own their rows,
    each once."""
    r = p // p_s
    halo = p_s != p
    tiles = ef.proj_row_tiles(p_s, halo)
    owned = np.zeros(p_s, np.int64)
    u_rows = np.zeros(p, np.int64)
    for m0, lo, hi in tiles:
        assert 0 <= m0 <= lo < hi <= min(m0 + 128, p_s)
        owned[lo:hi] += 1
        u_rows[lo * r:hi * r] += 1
        if halo:
            for q in (lo, hi - 1):
                for u in range(q * r, q * r + r):
                    i0, i1, _ = _lerp_rows(u, p_s, p)
                    assert m0 <= i0 <= i1 < m0 + 128
    assert (owned == 1).all() and (u_rows == 1).all()
    if halo:
        assert len(tiles) == max(1, -(-(p_s - 1) // 126))
