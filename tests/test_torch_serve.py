"""The serving slice end to end: ``python -m medmoe_torch.cli.serve`` with
``device=cpu`` on PNGs, held against numpy computations over the JAX
package's ``make_image_embedder`` and ``encode_class_prompts`` on the same
weights (JAX init → ``_save_weights`` → weights.npz → ``ckpt_path``).

Tolerances: float32 checks the algorithm (embeddings and scores to
rtol 1e-4 / atol 1e-5, identical labels); the bfloat16 run checks the
rounding points (atol 2e-2 on unit-norm embeddings, ≈ five bf16 ulps of
their largest entries).
"""

import json

import jax
import numpy as np
import pytest
import torch

from medmoe_tpu.config import compose as jcompose
from medmoe_tpu.data.transforms import ImageTransform, decode_image
from medmoe_tpu.eval import zero_shot as jzs
from medmoe_tpu.eval.export import _save_weights
from medmoe_torch.cli import serve as tserve
from medmoe_torch.eval import zero_shot as tzs

torch.set_num_threads(1)

# UniMed's class names tokenize through the packaged 28,996-row vocab into
# distinct prompts (the synthetic data's bare indices would tie)
TINY = [
    "data=unimed",
    "model.model.vision.image_size=64",
    "model.model.vision.swin_embed_dim=8",
    "model.model.vision.swin_depths=[1,1,1,1]",
    "model.model.vision.swin_num_heads=[1,2,2,4]",
    "model.model.vision.swin_window_size=2",
    "model.model.vision.num_experts=3",
    "model.model.vision.embed_dim=32",
    "model.model.text.hidden_size=32",
    "model.model.text.num_layers=2",
    "model.model.text.num_heads=2",
    "model.model.text.intermediate_size=64",
    "model.model.text.vocab_size=64",
    "model.model.text.max_length=10",
    "serve.batch_size=4",
]


def _write_images(tmp_path, n=6):
    from PIL import Image

    rng = np.random.RandomState(0)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i in range(n):
        arr = (rng.rand(48 + 8 * i, 64, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(img_dir / f"scan_{i}.png")
    (img_dir / "notes.txt").write_text("not an image")
    return img_dir


def _jax_reference(tmp_path, dtype, img_dir):
    """JAX weights → npz, plus the JAX package's serving math on them."""
    cfg = jcompose("eval_zs", TINY + [f"model.model.vision.dtype={dtype}",
                                      f"model.model.text.dtype={dtype}",
                                      f"paths.root_dir={tmp_path}"])
    module, dm, tok, params = jzs.load_for_eval(cfg, synthetic_init=True)
    npz = str(tmp_path / f"weights_{dtype}.npz")
    _save_weights(npz, params)
    names = jzs.default_class_names(cfg, dm)
    class_emb = np.asarray(jzs.encode_class_prompts(
        module, params, tok, names, "this is a photo of {}", 10))
    transform = ImageTransform(64, train=False)
    paths = sorted(str(p) for p in img_dir.glob("*.png"))
    batch = np.stack([transform(decode_image(open(p, "rb").read()))
                      for p in paths])
    emb = np.asarray(jzs.make_image_embedder(module)(params, batch))
    sims = emb @ class_emb.T
    z = sims * 10.0
    probs = np.exp(z - z.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    return npz, names, paths, emb, sims, probs


def _serve(capsys, tmp_path, npz, dtype, *extra):
    rc = tserve.main(TINY + [f"model.model.vision.dtype={dtype}",
                             f"model.model.text.dtype={dtype}",
                             "device=cpu", f"ckpt_path={npz}",
                             f"paths.root_dir={tmp_path}", *extra])
    assert rc == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


class TestServeAgainstJax:
    def test_classify_float32(self, tmp_path, capsys):
        img_dir = _write_images(tmp_path)
        npz, names, paths, _, sims, probs = _jax_reference(
            tmp_path, "float32", img_dir)
        recs = _serve(capsys, tmp_path, npz, "float32",
                      f"serve.input={img_dir}")
        assert [r["path"] for r in recs] == paths     # 6 images, 2 waves
        assert len(set(np.argmax(sims, -1))) > 1      # not one label for all
        for r, s, pr in zip(recs, sims, probs):
            top2 = np.sort(s)[-2:]
            if top2[1] - top2[0] > 1e-4:                # no near-tie
                assert r["label"] == names[int(np.argmax(s))]
            np.testing.assert_allclose(r["score"], s.max(), rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose([r["probs"][c] for c in names], pr,
                                       rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                            ("bfloat16", 2e-2)])
    def test_embed_list_file(self, tmp_path, capsys, dtype, atol):
        img_dir = _write_images(tmp_path, n=3)
        npz, _, paths, emb, _, _ = _jax_reference(tmp_path, dtype, img_dir)
        listfile = tmp_path / "list.txt"
        listfile.write_text("\n".join([paths[0], str(tmp_path / "missing.png"),
                                       paths[1], paths[2]]))
        recs = _serve(capsys, tmp_path, npz, dtype, f"serve.input={listfile}",
                      "serve.mode=embed")
        errs = [r for r in recs if "error" in r]
        assert len(errs) == 1 and errs[0]["path"].endswith("missing.png")
        got = np.array([r["embedding"] for r in recs if "embedding" in r])
        assert got.shape == (3, 32)
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   atol=1e-5)
        np.testing.assert_allclose(got, emb, rtol=1e-4, atol=atol)


class TestServeSurface:
    def test_invalid_mode_fails_fast(self, tmp_path):
        with pytest.raises(SystemExit, match="serve.mode"):
            tserve.main(TINY + ["device=cpu", "serve.mode=classifiy",
                                f"paths.root_dir={tmp_path}"])

    def test_cuda_default_raises_without_a_card(self, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device=cpu"):
            tserve.main(TINY + [f"paths.root_dir={tmp_path}"])

    def test_help(self, capsys):
        assert tserve.main(["--help"]) == 0
        assert "serve.input" in capsys.readouterr().out

    def test_serve_waves_on_decoded_arrays(self):
        """The wave loop that chip_smoke.py drives without an image
        decoder: errors are reported, labels come from the class list."""
        import io

        emb = np.eye(3, dtype=np.float32)
        waves = [(["a", "b"], np.zeros((2, 4, 4, 3), np.uint8), [("x", "bad")]),
                 ([], np.zeros((0, 4, 4, 3), np.uint8), [])]
        out = io.StringIO()
        n_ok, n_err = tserve.serve_waves(
            lambda imgs: torch.from_numpy(emb[:len(imgs)]), waves, "classify",
            ["p", "q", "r"], emb, 10.0, out)
        recs = [json.loads(line) for line in out.getvalue().splitlines()]
        assert (n_ok, n_err) == (2, 1)
        assert recs[0] == {"path": "x", "error": "bad"}
        assert [r["label"] for r in recs[1:]] == ["p", "q"]


class TestDeviceRule:
    def test_resolve_device(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tzs.resolve_device()
        with pytest.raises(RuntimeError):
            tzs.resolve_device("cuda:0")
        assert tzs.resolve_device("cpu") == torch.device("cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert tzs.resolve_device().type == "cuda"

    def test_jax_side_is_on_cpu(self):
        assert jax.devices()[0].platform == "cpu"
