"""The eval surfaces of the port against the JAX package's, on the CPU, on
the same weights (JAX init → ``_save_weights`` → weights.npz → the port's
``ckpt_path``) and the same inputs, drawn from numpy seeds:

  * ``_average_ranks`` and ``binary_auroc``: exact, on ties and on a
    missing class (NaN);
  * ``zero_shot_classification``: the similarities at f32 within 1e-5 and
    equal metrics, for single-label data and for CheXpert-style
    multilabel data read from a CheXpert tree on disk;
  * ``image_text_retrieval``: equal R@K and median ranks;
  * the linear probe: the head's weights after 50 full-batch Adam steps
    within 1e-5 (CE and BCE), equal accuracies at 1/10/100 %;
  * ``run_eval_zs``: an unknown protocol raises in both packages;
  * both ``cli.eval_zs`` mains on the same weights print the same metrics
    JSON (the JAX main converts a MedCLIP checkpoint; the port's reads the
    npz of the JAX weights that result).

Towers run in float32, so the comparisons check the algorithm.
"""

import csv
import importlib
import json
import os

import jax
import numpy as np
import pytest
import torch

from medmoe_tpu.config import compose as jcompose
from medmoe_tpu.eval import zero_shot as jzs
from medmoe_tpu.eval.export import _save_weights
from medmoe_torch.config import compose as tcompose
from medmoe_torch.data.datamodules import CheXpertDataModule
from medmoe_torch.eval import linear_probe as tlp
from medmoe_torch.eval import zero_shot as tzs

# the JAX package's eval/__init__.py re-exports the function under the
# module's name
jlp = importlib.import_module("medmoe_tpu.eval.linear_probe")
torch.set_num_threads(1)

VOCAB = 28996
TINY = [
    "model.model.vision.image_size=64",
    "model.model.vision.swin_embed_dim=8",
    "model.model.vision.swin_depths=[1,1,1,1]",
    "model.model.vision.swin_num_heads=[1,2,2,4]",
    "model.model.vision.swin_window_size=2",
    "model.model.vision.num_experts=3",
    "model.model.vision.embed_dim=32",
    "model.model.vision.dtype=float32",
    "model.model.vision.drop_path_rate=0.0",
    "model.model.text.hidden_size=32",
    "model.model.text.num_layers=2",
    "model.model.text.num_heads=2",
    "model.model.text.intermediate_size=64",
    f"model.model.text.vocab_size={VOCAB}",
    "model.model.text.max_length=10",
    "model.model.text.dtype=float32",
    "data.image_size=64", "data.batch_size=4", "data.num_workers=0",
]
KEYS = ("input_ids", "attention_mask", "token_type_ids", "segment_ids",
        "cap_lens")
SIM_ATOL = 1e-5
HEAD_ATOL = 1e-5


def chexpert_tree(root: str, n: int = 12) -> str:
    """A CheXpert tree: valid.csv + frontal JPEGs + 5-task labels, both
    classes in every task (the pattern of tests/test_zero_shot_gate.py)."""
    from PIL import Image

    rng = np.random.RandomState(0)
    rows = []
    os.makedirs(os.path.join(root, "valid"), exist_ok=True)
    for i in range(n):
        rel = f"valid/img{i:03d}.jpg"
        Image.fromarray((rng.rand(40, 32, 3) * 255).astype(np.uint8)).save(
            os.path.join(root, rel))
        row = {"Path": f"CheXpert-v1.0/{rel}", "Frontal/Lateral": "Frontal"}
        for t, task in enumerate(CheXpertDataModule.COMPETITION_TASKS):
            row[task] = float((i // (t + 1) + t) % 2)
        rows.append(row)
    with open(os.path.join(root, "valid.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    return root


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX weights of the tiny model → npz; (JAX module, params, the port
    model loaded from the npz, tokenizer)."""
    root = tmp_path_factory.mktemp("weights")
    cfg = jcompose("eval_zs", TINY + ["data=unimed",
                                      f"paths.root_dir={root}"])
    module, _, tok, params = jzs.load_for_eval(cfg, synthetic_init=True)
    npz = str(root / "weights.npz")
    _save_weights(npz, params)
    tcfg = tcompose("eval_zs", TINY + ["data=unimed", "device=cpu",
                                       f"ckpt_path={npz}",
                                       f"paths.root_dir={root}"])
    model, _, _ = tzs.load_for_eval(tcfg)
    return module, params, model, tok, npz


def _images(n, seed, size=64):
    rng = np.random.RandomState(seed)
    return rng.randn(n, size, size, 3).astype(np.float32)


class TestAuroc:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_ranks_and_auroc_with_ties(self, seed):
        rng = np.random.RandomState(seed)
        scores = rng.randint(0, 5, 40).astype(np.float64)     # many ties
        labels = rng.randint(0, 2, 40)
        assert np.array_equal(tzs._average_ranks(scores),
                              jzs._average_ranks(scores))
        assert tzs.binary_auroc(scores, labels) == \
            jzs.binary_auroc(scores, labels)

    def test_known_values_and_missing_class(self):
        labels = np.array([0, 0, 1, 1])
        assert tzs.binary_auroc(np.array([.1, .2, .8, .9]), labels) == 1.0
        assert tzs.binary_auroc(np.ones(10), np.arange(10) % 2) == 0.5
        for lab in (np.ones(3), np.zeros(3)):
            assert np.isnan(tzs.binary_auroc(np.arange(3.0), lab))
            assert np.isnan(jzs.binary_auroc(np.arange(3.0), lab))


class TestZeroShot:
    def test_similarities(self, weights):
        module, params, model, tok, _ = weights
        names = ["X-ray", "CT scan", "MRI scan"]
        images = _images(5, 3)
        jc = np.asarray(jzs.encode_class_prompts(module, params, tok, names,
                                                 max_length=10))
        ji = np.asarray(jzs.make_image_embedder(module)(params, images))
        tc = tzs.encode_class_prompts(model, tok, names, max_length=10)
        ti = tzs.make_image_embedder(model)(images)
        np.testing.assert_allclose((ti @ tc.T).numpy(), ji @ jc.T,
                                   atol=SIM_ATOL, rtol=0)

    def test_single_label(self, weights):
        module, params, model, tok, _ = weights
        names = ["X-ray", "CT scan", "MRI scan", "Ultrasound"]
        rng = np.random.RandomState(4)
        batches = [{"image": _images(4, 10 + i),
                    "label": rng.randint(0, 4, 4).astype(np.int32)}
                   for i in range(3)]
        want = jzs.zero_shot_classification(module, params, tok, batches,
                                            names, max_length=10)
        got = tzs.zero_shot_classification(model, tok, batches, names,
                                           max_length=10)
        assert got == want and set(got) == {"zero_shot/n",
                                            "zero_shot/accuracy"}

    def test_chexpert_multilabel(self, weights, tmp_path):
        module, params, model, tok, _ = weights
        root = chexpert_tree(str(tmp_path / "chexpert"))
        batches = list(CheXpertDataModule(data_dir=root, batch_size=5,
                                          image_size=64).test_dataloader())
        assert batches[0]["label"].shape == (5, 5)
        names = CheXpertDataModule.COMPETITION_TASKS
        want = jzs.zero_shot_classification(module, params, tok, batches,
                                            names, max_length=10)
        got = tzs.zero_shot_classification(model, tok, batches, names,
                                           max_length=10)
        assert got.keys() == want.keys() and len(got) == 8
        for k, v in want.items():
            assert got[k] == v, k
            if "auroc" in k:
                assert 0.0 <= got[k] <= 1.0


class TestRetrieval:
    def test_metrics_equal(self, weights):
        module, params, model, tok, _ = weights
        captions = [f"chest film number {i} with finding {i % 4}"
                    for i in range(12)]
        batches = []
        for i in range(3):
            enc = tok.encode_batch(captions[4 * i:4 * i + 4], max_length=10)
            batches.append({"image": _images(4, 20 + i),
                            **{k: enc[k] for k in KEYS}})
        want = jzs.image_text_retrieval(module, params, batches, (1, 5, 10))
        got = tzs.image_text_retrieval(model, batches, (1, 5, 10))
        assert got == want and len(got) == 8


class _Batches:
    """A datamodule over fixed batches (the probe's two splits)."""

    def __init__(self, train, test):
        self.train, self.test = train, test

    def train_dataloader(self, epoch=0):
        return iter(self.train)

    def test_dataloader(self):
        return iter(self.test)


class TestLinearProbe:
    @pytest.mark.parametrize("multilabel", [False, True])
    def test_head_after_50_steps(self, multilabel):
        rng = np.random.RandomState(5)
        x = rng.randn(24, 16).astype(np.float32)
        y = (rng.rand(24, 3) > 0.5).astype(np.float32) if multilabel \
            else rng.randint(0, 3, 24).astype(np.int32)
        jw, jb = jlp._train_head(x, y, 3, 1e-3, 50, 0, multilabel)
        tw, tb = tlp._train_head(x, y, 3, 1e-3, 50, multilabel)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw),
                                   atol=HEAD_ATOL, rtol=0)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb),
                                   atol=HEAD_ATOL, rtol=0)

    def test_accuracies_equal(self, weights):
        module, params, model, _, _ = weights
        rng = np.random.RandomState(6)

        def batches(n, seed):
            return [{"image": _images(4, seed + i),
                     "label": rng.randint(0, 3, 4).astype(np.int32)}
                    for i in range(n)]

        dm = _Batches(batches(5, 30), batches(2, 40))
        want = jlp.linear_probe(module, params, dm, (0.01, 0.1, 1.0),
                                lr=1e-3, epochs=50)
        got = tlp.linear_probe(model, dm, (0.01, 0.1, 1.0), lr=1e-3,
                               epochs=50)
        assert got == want and len(got) == 3


class TestRunEvalZs:
    def test_unknown_protocol_raises(self, tmp_path):
        over = TINY + ["data=synthetic", "eval.protocol=bogus",
                       f"paths.root_dir={tmp_path}"]
        with pytest.raises(ValueError, match="unknown eval protocol"):
            jzs.run_eval_zs(jcompose("eval_zs", over))
        with pytest.raises(ValueError, match="unknown eval protocol"):
            tzs.run_eval_zs(tcompose("eval_zs", over + ["device=cpu"]))

    def test_cuda_default_raises_without_a_card(self, tmp_path, monkeypatch):
        from medmoe_torch.cli import eval_zs

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device=cpu"):
            eval_zs.main(TINY + ["data=synthetic", "extras.print_config=false",
                                 f"paths.root_dir={tmp_path}"])


def _medclip_checkpoint(path: str) -> None:
    """A MedCLIP-shaped pytorch_model.bin at the tiny widths: HF Swin + HF
    BERT state dicts under vision_model./text_model."""
    from transformers import BertConfig, BertModel, SwinConfig, SwinModel

    torch.manual_seed(0)
    swin = SwinModel(SwinConfig(
        image_size=64, patch_size=4, num_channels=3, embed_dim=8,
        depths=[1, 1, 1, 1], num_heads=[1, 2, 2, 4], window_size=2,
        drop_path_rate=0.0))
    bert = BertModel(BertConfig(
        vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=512))
    sd = {f"vision_model.{k}": v for k, v in swin.state_dict().items()}
    sd.update({f"text_model.{k}": v for k, v in bert.state_dict().items()})
    torch.save(sd, path)


class TestCliAgainstJax:
    def test_same_metrics_json(self, tmp_path, capsys):
        from medmoe_tpu.cli import eval_zs as jcli
        from medmoe_torch.cli import eval_zs as tcli

        ckpt = str(tmp_path / "pytorch_model.bin")
        _medclip_checkpoint(ckpt)
        root = chexpert_tree(str(tmp_path / "chexpert"))
        over = TINY + ["data=chexpert", f"data.data_dir={root}",
                       "extras.print_config=false",
                       f"paths.root_dir={tmp_path}"]
        jcli.main(over + [f"medclip_ckpt={ckpt}"])
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        # the weights the JAX main evaluated: its seeded init, then the
        # converted MedCLIP towers
        _, _, _, params = jzs.load_for_eval(jcompose(
            "eval_zs", over + [f"medclip_ckpt={ckpt}"]))
        npz = str(tmp_path / "weights.npz")
        _save_weights(npz, jax.device_get(params))
        tcli.main(over + ["device=cpu", f"ckpt_path={npz}"])
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert got == want and "zero_shot/auroc" in got
