"""Soft-label and hard-negative pretraining of the port against the JAX
package on the same numpy inputs and the same weights.

  * the losses: ``soft_xent``, ``soft_xent_penalty``,
    ``hard_negative_loss`` (nmax 1 and 2), ``SoftGLORIAGlobalContrastiveLoss``
    and ``SoftGLORIALocalContrastiveLoss`` by its einsum path and by
    ``impl="pallas"`` (the kernels' plain versions on the CPU): values and
    input gradients, on scores whose partition is not degenerate;
  * the tool BERT's targets (``soft_targets``) in train mode with dropout
    on, against JAX's ``_soft_targets``; the snapshot fixed across an
    optimizer step that moved the live BERT;
  * one process: 2 steps of gloria256's losses (soft global + soft local,
    BERT training), one case with ``HardNegativeContrastiveLoss`` as the
    global loss, and one of pretraining_medmoe_ddp's shape (block = micro-
    batch, accumulation 2, BERT frozen), against JAX's ``build_train_step``
    with ``capture_tool_params``;
  * the refusals (tests/test_torch_soft_ranks.py holds the data- and
    expert-parallel ranks and the resume).

The weights are the port's seeded init carried into JAX's tree, so that
both packages' tool BERT is the seed's (the port's snapshot is taken from
its own init, also on a resume). The thresholds sit between the batches'
tool scores, well away from each (a random BERT's CLS rows are nearly
collinear: the shipped 0.98/0.97 would mark every pair positive and the
soft loss would be exactly 0).

Tolerances are tests/test_torch_losses.py's for the losses (float32 values
rtol 1e-4, atol 1e-5, gradients 1e-4·max|ref|; bfloat16 values rtol 1e-3,
gradients 2e-2·max|ref|) and tests/test_torch_train.py's for training
(float32 metrics rtol 1e-5; parameters within 1e-2 of their own update).
``impl="pallas"`` rounds its inputs to bf16 and its backward rounds d_wei,
a2 and d_scores to bf16 before each cotangent product (as the JAX kernel
does): it is held on bf16 inputs against JAX's soft local on the same
values, its values at the float32 rtol and its gradients at the bf16 one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medmoe_tpu.config import DotDict as JDotDict
from medmoe_tpu.ops import losses as JL
from medmoe_tpu.train.module import MedMoEPretrainingModule as JModule
from medmoe_tpu.train.optim import adam as jadam
from medmoe_tpu.train.state import TrainState as JState
from medmoe_tpu.train.step import build_train_step as jax_train_step
from medmoe_torch import bridge
from medmoe_torch.cli.train import train
from medmoe_torch.config import DotDict, compose
from medmoe_torch.models.layers import set_generator
from medmoe_torch.models.medmoe import MedMoE
from medmoe_torch.ops import losses as TL
from medmoe_torch.train.module import MedMoEPretrainingModule
from medmoe_torch.train.optim import adam
from medmoe_torch.train.state import TrainState
from medmoe_torch.train.step import build_train_step
from tests.test_torch_ep import BASE as EP_BASE
from tests.test_torch_parallel import METRICS, _assert_params
from tests.test_torch_train import TEXT, VISION, _micro

torch.set_num_threads(1)

LR = 1e-3
# Adam eps 1e-6, as tests/test_torch_ep.py takes it: at eps 1e-8 elements
# whose clipped gradient is ~1e-9 let rounding decide their update, and the
# second step's grad_norm parts from JAX's by 1.1e-5 relative
EPS = 1e-6

# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------

B, D, HW, T = 6, 8, 3, 6
THR = (0.7, 0.4)


def _partition_scores():
    """A symmetric [B, B] score matrix (unit diagonal) whose partition at
    THR has an anchor with >= 2 positives and >= 1 negative, pairs in
    neither set, and one anchor with no negative at all."""
    rng = np.random.RandomState(5)
    s = rng.uniform(0.0, 1.0, (B, B))
    s = (s + s.T) / 2
    s[B - 1, :] = s[:, B - 1] = rng.uniform(0.45, 0.95, B)
    np.fill_diagonal(s, 1.0)
    return s.astype(np.float32)


def assert_partition(scores, thr):
    pos, neg = scores > thr[0], scores <= thr[1]
    assert np.any((pos.sum(1) >= 2) & (neg.sum(1) >= 1))
    assert np.any(~pos & ~neg)
    assert np.any(neg.sum(1) == 0)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    img = rng.randn(B, D, HW, HW).astype(np.float32)
    words = rng.randn(B, D, T).astype(np.float32)
    cap = np.array([2, 6, 4, 3, 5, 1], np.int32)
    g_img = rng.randn(B, D).astype(np.float32)
    g_txt = rng.randn(B, D).astype(np.float32)
    scores = _partition_scores()
    assert_partition(scores, THR)
    return img, words, cap, g_img, g_txt, scores


def _grad_close(got, want, scale):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=scale * max(np.abs(want).max(), 1e-12))


def _tols(dtype):
    return (1e-4, 1e-4) if dtype == "float32" else (1e-3, 2e-2)


def _compare(jfn, tfn, arrays, dtype, tols=None):
    """jfn/tfn(*arrays cast to dtype) -> scalar; values and the gradients
    of every array, at the tolerances of ``dtype`` (or ``tols``)."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jv, jg = jax.value_and_grad(
        lambda *a: jfn(*[x.astype(jdt) for x in a]),
        argnums=tuple(range(len(arrays))))(*map(jnp.asarray, arrays))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    tv = tfn(*[x.to(tdt) for x in leaves])
    tv.backward()
    rtol, gtol = tols or _tols(dtype)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=rtol, atol=1e-5)
    assert float(jv) != 0.0
    for t, j in zip(leaves, jg):
        _grad_close(t.grad, j, gtol)
    return float(jv)


DTYPES = ["float32", "bfloat16"]


class TestSoftXent:
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_soft_xent(self, dtype):
        rng = np.random.RandomState(1)
        target = rng.dirichlet(np.ones(5), 4).astype(np.float32)
        logits = rng.randn(4, 5).astype(np.float32) * 3
        _compare(lambda x: JL.soft_xent(jnp.asarray(target), x),
                 lambda x: TL.soft_xent(torch.from_numpy(target), x),
                 [logits], dtype)

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_soft_xent_penalty(self, dtype):
        rng = np.random.RandomState(2)
        target = rng.dirichlet(np.ones(5), 4).astype(np.float32)
        penalty = rng.uniform(0.5, 2.0, (4, 5)).astype(np.float32)
        logits = rng.randn(4, 5).astype(np.float32) * 3
        _compare(lambda x: JL.soft_xent_penalty(jnp.asarray(target), x,
                                                jnp.asarray(penalty)),
                 lambda x: TL.soft_xent_penalty(torch.from_numpy(target), x,
                                                torch.from_numpy(penalty)),
                 [logits], dtype)


class TestHardNegative:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("nmax", [1, 2])
    def test_value_and_grad(self, inputs, dtype, nmax):
        g_img, g_txt = inputs[3:5]
        _compare(lambda a, b: JL.hard_negative_loss(a, b, nmax, 0.2),
                 lambda a, b: TL.hard_negative_loss(a, b, nmax, 0.2),
                 [g_img, g_txt], dtype)
        loss = TL.HardNegativeContrastiveLoss(nmax=nmax, margin=0.3)
        # a float32 image code and a bf16 caption code, as the towers hand
        # them: the product in the promoted dtype, as jnp's
        _compare(lambda a, b: JL.hard_negative_loss(
                     a, b.astype(jnp.bfloat16), nmax, 0.2),
                 lambda a, b: TL.hard_negative_loss(a, b.bfloat16(), nmax,
                                                    0.2),
                 [g_img, g_txt], "float32", tols=_tols("bfloat16"))
        a, b = torch.from_numpy(g_img), torch.from_numpy(g_txt)
        assert loss(a, b).item() == TL.hard_negative_loss(a, b, nmax,
                                                          0.3).item()


class TestSoftGlobal:
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_value_and_grad(self, inputs, dtype):
        g_img, g_txt, scores = inputs[3:]
        js, ts = jnp.asarray(scores), torch.from_numpy(scores)
        _compare(lambda a, b: JL.SoftGLORIAGlobalContrastiveLoss()(
                     a, b, 10.0, scores=js, thresholds=THR),
                 lambda a, b: TL.SoftGLORIAGlobalContrastiveLoss()(
                     a, b, 10.0, scores=ts, thresholds=THR),
                 [g_img, g_txt], dtype)

    def test_without_scores_raises(self, inputs):
        a, b = map(torch.from_numpy, inputs[3:5])
        with pytest.raises(ValueError, match="soft_label"):
            TL.SoftGLORIAGlobalContrastiveLoss()(a, b)


def _jax_soft_local(scores):
    def f(i, w, cap):
        out = JL.SoftGLORIALocalContrastiveLoss()(
            i, w, cap, 4.0, 5.0, 10.0, scores=jnp.asarray(scores),
            thresholds=THR)
        return out.loss0 + out.loss1
    return f


def _torch_soft_local(scores, impl):
    def f(i, w, cap):
        out = TL.SoftGLORIALocalContrastiveLoss(impl=impl)(
            i, w, cap, 4.0, 5.0, 10.0, agg="mean",
            scores=torch.from_numpy(scores), thresholds=THR)
        return out.loss0 + out.loss1
    return f


class TestSoftLocal:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("chunk", [None, 2])
    def test_einsum_path(self, inputs, dtype, chunk):
        """``agg="mean"`` is ignored: the soft local always sums, as JAX's
        does."""
        img, words, cap, _, _, scores = inputs
        jf, tf = _jax_soft_local(scores), _torch_soft_local(scores, "xla")
        loss = TL.SoftGLORIALocalContrastiveLoss(text_chunk=chunk)
        tf_chunk = lambda i, w, c: sum(loss(  # noqa: E731
            i, w, c, agg="mean", scores=torch.from_numpy(scores),
            thresholds=THR)[:2])
        for fn in (tf, tf_chunk):
            _compare(lambda i, w: jf(i, w, jnp.asarray(cap)),
                     lambda i, w: fn(i, w, torch.from_numpy(cap)),
                     [img, words], dtype)

    def test_fused_path(self, inputs):
        """impl="pallas": the kernels' plain versions, on bf16 values."""
        img, words, cap, _, _, scores = inputs
        img = torch.from_numpy(img).bfloat16().float().numpy()
        words = torch.from_numpy(words).bfloat16().float().numpy()
        jf, tf = _jax_soft_local(scores), _torch_soft_local(scores, "pallas")
        _compare(lambda i, w: jf(i, w, jnp.asarray(cap)),
                 lambda i, w: tf(i.bfloat16(), w.bfloat16(),
                                 torch.from_numpy(cap)),
                 [img, words], "float32", tols=(1e-4, 2e-2))

    def test_fused_path_is_the_kernels_similarity(self, inputs):
        from medmoe_torch.ops.gloria_attention import gloria_similarity

        img, words, cap, _, _, scores = map(torch.from_numpy, inputs)
        loss = TL.SoftGLORIALocalContrastiveLoss(impl="pallas")
        out = loss(img, words, cap, agg="mean", scores=scores,
                   thresholds=THR)
        sim = gloria_similarity(img, words, cap, 4.0, 5.0, 10.0)
        assert out.loss0.item() == TL.soft_partition_xent(
            sim, scores, THR).item()
        assert out.loss1.item() == TL.soft_partition_xent(
            sim.T, scores, THR).item()
        # the dispatch: the fused path for CUDA tensors above 64 whatever
        # agg says, the einsum path otherwise
        auto = TL.SoftGLORIALocalContrastiveLoss()
        assert auto.impl_for("mean", 65, True) == "pallas"
        assert auto.impl_for("mean", 64, True) == "xla"
        assert auto.impl_for("sum", 256, False) == "xla"
        assert isinstance(auto, TL.GLORIALocalContrastiveLoss)

    def test_without_scores_raises(self, inputs):
        img, words, cap = map(torch.from_numpy, inputs[:3])
        with pytest.raises(ValueError, match="soft_label"):
            TL.SoftGLORIALocalContrastiveLoss()(img, words, cap)

    def test_hard_local_is_unchanged(self, inputs):
        """The hard local loss through ``pair_losses`` is the einsum
        path's diagonal cross entropy, bit for bit."""
        img, words, cap = map(torch.from_numpy, inputs[:3])
        out = TL.GLORIALocalContrastiveLoss()(img, words, cap)
        want = TL.gloria_local_loss(img, words, cap)
        assert (out.loss0.item(), out.loss1.item()) == \
            (want.loss0.item(), want.loss1.item())


# ---------------------------------------------------------------------------
# the tool BERT's targets and one process
# ---------------------------------------------------------------------------

def _key(kp) -> str:
    return "/".join(str(getattr(k, "key", k)) for k in kp)


def jax_params_from(model, template):
    """The port model's parameters in the JAX package's tree (``template``,
    e.g. ``jax.eval_shape`` of ``init_params``): bridge.py's rules read
    backwards."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}

    def leaf(kp, x):
        key = _key(kp)
        a = sd[bridge.torch_key(key, len(x.shape))]
        if key.endswith("kernel"):
            a = a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0)
        return jnp.asarray(a, x.dtype)

    params = jax.tree_util.tree_map_with_path(leaf, template)
    back = bridge.from_jax_params(
        {_key(kp): np.asarray(v)
         for kp, v in jax.tree_util.tree_leaves_with_path(params)}, model)
    assert all(torch.equal(back[k], model.state_dict()[k].float())
               for k in back)
    return params


def pick_thresholds(score_mats, margin=1e-4):
    """(threshold0, threshold1) between the off-diagonal tool scores of
    every batch, at least ``margin`` from each: positives the top quarter
    of the pairs, negatives the lower ~40%, the rest in neither set."""
    vals = np.unique(np.concatenate(
        [np.asarray(s)[np.triu_indices(len(s), 1)] for s in score_mats]))
    gaps = [(vals[i] + vals[i + 1]) / 2 for i in range(len(vals) - 1)
            if vals[i + 1] - vals[i] > 2 * margin]
    gaps = np.asarray(gaps)

    def near(q):
        return float(gaps[np.argmin(np.abs(gaps - np.quantile(vals, q)))])

    thr0, thr1 = near(0.75), near(0.4)
    assert thr0 > thr1, (thr0, thr1)
    return thr0, thr1


def _torch_batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


ONE_LOSS = dict(global_loss_weight=0.5, local_loss_weight=0.5,
                classifier_loss_weight=2.0, temp1=4.0, temp2=5.0, temp3=10.0,
                agg="sum", global_negatives=True)


def _targets(pkg, glob, local):
    loss = {}
    if glob:
        loss["global_loss"] = {"_target_": f"{pkg}.ops.losses.{glob}"}
    if local:
        loss["local_loss"] = {"_target_": f"{pkg}.ops.losses.{local}"}
    return loss


SOFT_G, SOFT_L = "SoftGLORIAGlobalContrastiveLoss", \
    "SoftGLORIALocalContrastiveLoss"
# name → (global loss, local loss, loss extras, freeze_bert, accum)
CASES = {
    "soft": (SOFT_G, SOFT_L, {}, False, 1),
    "hard_negative": ("HardNegativeContrastiveLoss", SOFT_L, {}, False, 1),
    # pretraining_medmoe_ddp's shape: per-micro losses, the block being
    # the micro-batch, accumulation, BERT frozen
    "blocks": (SOFT_G, SOFT_L, dict(global_negatives=False, block_size=4),
               True, 2),
}
STEPS = 2


@pytest.fixture(scope="module")
def base():
    """The port's seeded init at tiny float32 widths, its weights in JAX's
    tree, the batches, and thresholds between their tool scores."""
    vision, text = dict(VISION, dtype="float32"), \
        dict(TEXT, dtype="float32", freeze_bert=False)
    rng = np.random.RandomState(0)
    micros = [_micro(rng) for _ in range(STEPS * 2)]
    model = MedMoE(DotDict(vision), DotDict(text))
    module = MedMoEPretrainingModule(model=model, loss=DotDict(ONE_LOSS))
    module.init_params(0)
    jm = JModule(model=JDotDict(vision=JDotDict(vision), text=JDotDict(text)),
                 loss=JDotDict(ONE_LOSS))
    template = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0),
                              micros[0])
    params = jax_params_from(model, template)
    with torch.no_grad():
        mats = [module.soft_targets(_torch_batch(m))[0] for m in micros]
    thr = pick_thresholds(mats)
    return dict(vision=vision, text=text, micros=micros, params=params,
                init={k: v.detach().clone()
                      for k, v in model.state_dict().items()},
                thr=thr, mats=mats)


def _modules(base, glob, local, extra, freeze, soft=True):
    text = dict(base["text"], freeze_bert=freeze)
    thr0, thr1 = base["thr"]
    loss = dict(ONE_LOSS, soft_label=soft, threshold0=thr0,
                threshold1=thr1, **extra)
    jm = JModule(model=JDotDict(vision=JDotDict(base["vision"]),
                                text=JDotDict(text)),
                 loss=JDotDict(loss, **{k: JDotDict(v) for k, v in _targets(
                     "medmoe_tpu", glob, local).items()}),
                 optimizer=functools.partial(jadam, lr=LR, eps=EPS))
    model = MedMoE(DotDict(base["vision"]), DotDict(text))
    model.load_state_dict(base["init"])
    module = MedMoEPretrainingModule(
        model=model, loss=DotDict(loss, **_targets("medmoe_torch", glob,
                                                   local)),
        optimizer=functools.partial(adam, lr=LR, eps=EPS))
    return jm, module


@pytest.fixture(scope="module", params=list(CASES))
def one_process(request, base):
    glob, local, extra, freeze, accum = CASES[request.param]
    jm, module = _modules(base, glob, local, extra, freeze)
    params = base["params"]
    jm.capture_tool_params(params)
    assert (jm.tool_bert_params is None) == freeze
    state = JState.create(params, jm.make_optimizer(gradient_clip_val=0.25))
    step = jax_train_step(jm, accum_steps=accum, donate=False)
    windows = [base["micros"][i * accum:(i + 1) * accum]
               for i in range(STEPS)]
    jax_metrics = []
    for w in windows:
        batch = w[0] if accum == 1 else \
            {k: np.stack([m[k] for m in w]) for k in w[0]}
        state, m = step(state, batch, jax.random.PRNGKey(1))
        jax_metrics.append({k: float(v) for k, v in m.items()})
    jax_final = bridge.from_jax_params(
        {_key(kp): np.asarray(v)
         for kp, v in jax.tree_util.tree_leaves_with_path(state.params)})

    module.capture_tool_params()
    assert (module.tool_bert is None) == freeze
    ts = TrainState.create(module.model, module.make_optimizer(0.25))
    tstep = build_train_step(module, accum)
    torch_metrics = []
    for w in windows:
        ts, m = tstep(ts, [_torch_batch(mb) for mb in w])
        torch_metrics.append({k: float(v) for k, v in m.items()})
    model = module.model
    trainable = {n: p.requires_grad for n, p in model.named_parameters()}
    final = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return request.param, jax_metrics, torch_metrics, jax_final, final, \
        trainable


class TestOneProcess:
    @pytest.mark.parametrize("name", METRICS)
    def test_per_step_metrics(self, one_process, name):
        case, jm, tm = one_process[:3]
        got, want = [m[name] for m in tm], [m[name] for m in jm]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        if name in ("l_loss", "g_loss"):
            assert all(v != 0.0 for v in want), (case, name, want)

    def test_final_parameters(self, one_process, base):
        jax_final, final, trainable = one_process[3:]
        _assert_params(final, jax_final, base["init"], STEPS, trainable)


class TestTargets:
    @pytest.mark.parametrize("freeze", [False, True])
    def test_dropout_off_in_a_training_step(self, base, freeze):
        """Train mode with dropout 0.3: the scores equal JAX's
        deterministic ``_soft_targets`` (the snapshot's with BERT
        training, the live BERT's when it is frozen), and the live BERT
        stays in train mode."""
        text = dict(base["text"], hidden_dropout_prob=0.3,
                    attention_probs_dropout_prob=0.3)
        jm, module = _modules(dict(base, text=text), SOFT_G, SOFT_L, {},
                              freeze)
        params = base["params"]
        jm.capture_tool_params(params)
        module.capture_tool_params()
        module.model.train()
        set_generator(module.model, torch.Generator().manual_seed(3))
        jtargets = jax.jit(lambda p, b, t: jm._soft_targets(p, b, t)[0])
        for micro in base["micros"][:2]:
            want = jtargets(params, micro, jm.tool_bert_params)
            got, thr = module.soft_targets(_torch_batch(micro))
            assert got.dtype == torch.float32 and not got.requires_grad
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)
            assert thr == tuple(base["thr"])
        assert module.model.text_encoder.bert.training

    def test_snapshot_fixed_after_a_step(self, base):
        jm, module = _modules(base, SOFT_G, SOFT_L, {}, False)
        module.capture_tool_params()
        tool = module.tool_bert
        assert not tool.training
        assert not any(p.requires_grad for p in tool.parameters())
        before = {k: v.clone() for k, v in tool.state_dict().items()}
        batch = _torch_batch(base["micros"][0])
        scores0 = module.soft_targets(batch)[0]
        ts = TrainState.create(module.model, module.make_optimizer(0.25))
        build_train_step(module, 1)(ts, [batch])
        live = module.model.text_encoder.bert.state_dict()
        assert any(not torch.equal(live[k], v) for k, v in before.items())
        assert all(torch.equal(tool.state_dict()[k], v)
                   for k, v in before.items())
        assert torch.equal(module.soft_targets(batch)[0], scores0)
        # outside every state: the model, its optimizer
        assert not set(map(id, tool.parameters())) & set(map(id, ts.params))
        ptrs = {v.data_ptr() for v in module.model.state_dict().values()}
        assert not ptrs & {v.data_ptr() for v in tool.state_dict().values()}
        # captured once: a second call keeps the first snapshot
        module.capture_tool_params()
        assert module.tool_bert is tool

    def test_scores_only_when_a_loss_reads_them(self, base, monkeypatch):
        _, module = _modules(base, None, None, {}, False)
        assert module.soft_label and not module.reads_scores
        assert module.uses_tool_bert
        monkeypatch.setattr(module, "soft_targets", None)
        module.loss_fn(_torch_batch(base["micros"][0]))
        _, soft = _modules(base, SOFT_G, None, {}, True)
        assert soft.reads_scores and not soft.uses_tool_bert


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def soft_overrides(pkg, thr):
    """The soft-label CLI overrides (BERT training), for package ``pkg``."""
    return ["model.loss.soft_label=true",
            f"model.loss.global_loss._target_={pkg}.ops.losses.{SOFT_G}",
            f"model.loss.local_loss._target_={pkg}.ops.losses.{SOFT_L}",
            "model.model.text.freeze_bert=false",
            f"model.loss.threshold0={thr[0]!r}",
            f"model.loss.threshold1={thr[1]!r}"]


# gloria256 at tiny widths in one process, 1 step an epoch (a node batch
# of 8)
RESUME = ["experiment=gloria256", "data.batch_size=8", "data.num_samples=8",
          "callbacks=default", "trainer.limit_val_batches=1"] \
    + [o for o in EP_BASE if o.startswith(("model.model", "model.optimizer",
                                        "trainer.accelerator", "extras",
                                        "trainer.num_sanity", "trainer.log",
                                        "logger", "data.image_size",
                                        "data.num_classes", "data=synth"))]


class TestRefusals:
    def test_blocks_smaller_than_the_batch_raise(self, base, tmp_path,
                                                 monkeypatch):
        """A soft loss on per-micro blocks smaller than the batch the loss
        sees raises before the first step, naming block_size; JAX fails
        there too (a shape error); a block as large as the batch runs."""
        from medmoe_torch.train import loop

        built = []
        monkeypatch.setattr(loop, "build_train_step",
                            lambda *a, **k: built.append(a))
        cfg = compose("train", RESUME + soft_overrides(
            "medmoe_torch", (0.9, 0.5)) + [
            "model.loss.global_negatives=false", "model.loss.block_size=4",
            f"paths.root_dir={tmp_path}", "trainer.max_epochs=1"])
        with pytest.raises(ValueError, match="block_size=4"):
            train(cfg)
        assert not built
        jm, module = _modules(base, SOFT_G, SOFT_L, dict(
            global_negatives=False, block_size=2), False)
        with pytest.raises(ValueError, match="block_size=2"):
            module.check_blocks(4)
        module.check_blocks(2)
        with pytest.raises(Exception):
            jax.jit(jm.loss_fn)(base["params"], base["micros"][0])
        for bs in (4, 8):
            module.block_size = bs
            module.check_blocks(4)
            assert np.isfinite(module.loss_fn(
                _torch_batch(base["micros"][0]))[0].item())

    def test_soft_label_without_a_soft_loss_reads_nothing(self, base):
        _, module = _modules(base, "HardNegativeContrastiveLoss", None,
                             dict(global_negatives=False, block_size=2),
                             False)
        assert not module.reads_scores
        module.check_blocks(4)
