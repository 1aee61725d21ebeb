"""The port's export (medmoe_torch/eval/export.py, cli/export.py) on the
CPU, at tiny widths:

  * the round trip: each program, loaded back, against the live module
    (max abs ≤ 2e-3, the JAX exporter's bound; here it is 0), and the
    float32 programs against the JAX package's ``make_image_embedder`` and
    ``encode_text`` on the same weights (atol 1e-5);
  * the symbolic batch takes b = 1, 2 and 5 (unit norm; different inputs
    give different outputs); a pinned batch takes only its own;
  * ``bake_weights=false``: programs of (weights, inputs) that hold no
    weights, with ``weights.npz`` beside them, giving the baked outputs;
  * the manifest's fields;
  * the bfloat16 image program holds the registered op
    ``medmoe::expert_fusion_gather`` (the one entry to kernel K1), whose
    fake implementation gives [B, P, E] float32, B = 0 included;
  * ``tpu`` and an absent ``cuda`` raise; the CLI exports with
    ``device=cpu`` and raises without a card when no device is given.
"""

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
from medmoe_torch.eval import export as tex
from medmoe_torch.eval import zero_shot as tzs
from medmoe_torch.ops import expert_fusion as ef

torch.set_num_threads(1)

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
    "extras.print_config=false",
]
F32 = ["model.model.vision.dtype=float32", "model.model.text.dtype=float32"]
JAX_ATOL = 1e-5


def _model(tmp, *extra):
    cfg = tcompose("eval_zs", TINY + ["device=cpu", f"paths.root_dir={tmp}",
                                      *extra])
    return tzs.load_for_eval(cfg)[0]


@pytest.fixture(scope="module")
def f32(tmp_path_factory):
    """JAX float32 weights → npz → the port's model; (JAX module, params,
    port model, baked export dir)."""
    root = tmp_path_factory.mktemp("f32")
    cfg = jcompose("eval_zs", TINY + F32 + [f"paths.root_dir={root}"])
    module, _, _, params = jzs.load_for_eval(cfg, synthetic_init=True)
    npz = str(root / "weights.npz")
    _save_weights(npz, params)
    model = _model(root, *F32, f"ckpt_path={npz}")
    out = str(root / "export")
    tex.export_encoders(model, out, platforms=["cpu"])
    return module, params, model, out


@pytest.fixture(scope="module")
def bf16(tmp_path_factory):
    root = tmp_path_factory.mktemp("bf16")
    model = _model(root)
    out = str(root / "export")
    tex.export_encoders(model, out)
    return model, out


def _tokens(b, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 64, (b, 10)).astype(np.int32)
    mask = np.ones((b, 10), np.int32)
    mask[:, 7:] = rng.randint(0, 2, (b, 3))
    return (ids, mask, np.zeros((b, 10), np.int32),
            np.tile(np.arange(10, dtype=np.int32), (b, 1)))


def _images(b, seed):
    return np.random.RandomState(seed).rand(b, 64, 64, 3).astype(np.float32)


class TestRoundTrip:
    def test_against_jax(self, f32):
        module, params, _, out = f32
        images, tokens = _images(3, 0), _tokens(3, 1)
        got_i = tex.call_exported(out, "image")(torch.from_numpy(images))
        got_t = tex.call_exported(out, "text")(
            *(torch.from_numpy(a) for a in tokens))
        want_i = np.asarray(jzs.make_image_embedder(module)(params, images))
        _, sent = module.model.apply(
            {"params": params}, *tokens,
            method=lambda m, *a: m.encode_text(*a, deterministic=True))
        sent = np.asarray(sent, np.float32)
        want_t = sent / np.linalg.norm(sent, axis=-1, keepdims=True)
        np.testing.assert_allclose(got_i.numpy(), want_i, atol=JAX_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(got_t.numpy(), want_t, atol=JAX_ATOL,
                                   rtol=0)

    def test_against_the_live_module(self, bf16):
        model, out = bf16
        images = torch.from_numpy(_images(4, 2))
        tokens = [torch.from_numpy(a) for a in _tokens(4, 3)]
        with torch.no_grad():
            want_i = tex.ImageProgram(model)(images)
            want_t = tex.TextProgram(model)(*tokens)
        assert torch.equal(tex.call_exported(out, "image")(images), want_i)
        assert torch.equal(tex.call_exported(out, "text")(*tokens), want_t)

    def test_symbolic_batch(self, bf16):
        _, out = bf16
        image, text = (tex.call_exported(out, w) for w in ("image", "text"))
        for b in (1, 2, 5):
            emb = image(torch.from_numpy(_images(b, 10 + b)))
            sent = text(*(torch.from_numpy(a) for a in _tokens(b, 20 + b)))
            for e in (emb, sent):
                assert e.shape == (b, 32) and e.dtype == torch.float32
                np.testing.assert_allclose(e.norm(dim=-1).numpy(), 1.0,
                                           atol=1e-5)
            if b > 1:
                assert (emb[0] - emb[1]).abs().max() > 1e-3
                assert (sent[0] - sent[1]).abs().max() > 1e-3

    def test_pinned_batch(self, tmp_path):
        model = _model(tmp_path)
        manifest = tex.export_encoders(model, str(tmp_path / "x"), batch=3)
        assert manifest["image"]["input"] == "float32[3,64,64,3]"
        assert manifest["text"]["input_shape"] == "int32[3,10]"
        image = tex.call_exported(str(tmp_path / "x"), "image")
        assert image(torch.from_numpy(_images(3, 0))).shape == (3, 32)
        with pytest.raises(Exception):
            image(torch.from_numpy(_images(2, 0)))


class TestUnbaked:
    def test_weights_beside_the_program(self, tmp_path, bf16):
        model, baked = bf16
        out = str(tmp_path / "unbaked")
        manifest = tex.export_encoders(model, out, bake_weights=False)
        assert manifest["weights"] == "weights.npz"
        weights = tex.load_weights(out)
        assert list(weights) == list(model.state_dict())
        for which, tower in (("image", "image_encoder."),
                             ("text", "text_encoder.")):
            name = tex.program_file(which, "cpu")
            # the unbaked program holds no weights; the baked one all of
            # its own tower's, and none of the other tower's
            held = torch.export.load(os.path.join(out, name)).state_dict
            assert not held
            held = torch.export.load(os.path.join(baked, name)).state_dict
            assert sorted(held) == sorted(
                f"model.{k}" for k, v in model.named_parameters()
                if k.startswith(tower))
        images = torch.from_numpy(_images(2, 5))
        tokens = [torch.from_numpy(a) for a in _tokens(2, 6)]
        assert torch.equal(tex.call_exported(out, "image")(images),
                           tex.call_exported(baked, "image")(images))
        assert torch.equal(tex.call_exported(out, "text")(*tokens),
                           tex.call_exported(baked, "text")(*tokens))
        # a baked re-export into the same dir removes the stale weights
        tex.export_encoders(model, out)
        assert not os.path.exists(os.path.join(out, "weights.npz"))


class TestManifestAndGraph:
    def test_manifest(self, bf16):
        _, out = bf16
        with open(os.path.join(out, "manifest.json")) as f:
            m = json.load(f)
        assert m["platforms"] == ["cpu"] and m["embed_dim"] == 32
        assert m["image"]["file"] == {"cpu": "encode_image.cpu.pt2"}
        assert m["text"]["file"] == {"cpu": "encode_text.cpu.pt2"}
        assert m["image"]["input"] == "float32[b,64,64,3]"
        assert m["text"]["input_shape"] == "int32[b,10]"
        assert m["text"]["max_length"] == 10
        assert m["weights"] == "baked"
        assert m["roundtrip_max_abs_err"] == {"cpu": {"image": 0.0,
                                                      "text": 0.0}}
        assert m["torch_version"] == torch.__version__
        assert {"format", "prompt_template"} <= set(m)
        assert "jax_version" not in m

    def test_graph_holds_the_expert_op(self, bf16):
        _, out = bf16
        ep = torch.export.load(os.path.join(out, "encode_image.cpu.pt2"))
        targets = [n.target for n in ep.graph.nodes]
        assert targets.count(torch.ops.medmoe.expert_fusion_gather.default) \
            == 1
        assert ef.expert_fusion_gather_op._qualname == \
            "medmoe::expert_fusion_gather"

    @pytest.mark.parametrize("b", [0, 3])
    def test_fake_shapes(self, b):
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            xs = [torch.empty(b, p, d, dtype=torch.bfloat16)
                  for p, d in ((16, 8), (4, 16))]
            wp = [torch.empty(3, d, 32) for d in (8, 16)]
            bp = [torch.empty(3, 32) for _ in range(2)]
            out = torch.ops.medmoe.expert_fusion_gather(
                xs, wp, bp, torch.empty(3, 32, 16), torch.empty(3, 16),
                torch.empty(3, 16, 1), torch.empty(3, 1),
                torch.empty(b, dtype=torch.int32))
        assert tuple(out.shape) == (b, 16, 32) and out.dtype == torch.float32

    def test_op_on_cpu_is_the_plain_version(self):
        rng = np.random.RandomState(0)
        xs = [torch.from_numpy(rng.randn(2, p, d).astype(np.float32)).to(
            torch.bfloat16) for p, d in ((16, 8), (4, 16))]
        wp = [torch.from_numpy(rng.randn(3, d, 32).astype(np.float32))
              for d in (8, 16)]
        bp = [torch.zeros(3, 32), torch.zeros(3, 32)]
        rest = [torch.from_numpy(rng.randn(*s).astype(np.float32))
                for s in ((3, 32, 16), (3, 16), (3, 16, 1), (3, 1))]
        idx = torch.tensor([2, 0], dtype=torch.int32)
        got = torch.ops.medmoe.expert_fusion_gather(xs, wp, bp, *rest, idx)
        want = ef.expert_fusion_gather_reference(xs, wp, bp, *rest, idx)
        assert torch.equal(got, want)


class TestPlatforms:
    def test_tpu_raises(self, bf16, tmp_path):
        model, _ = bf16
        with pytest.raises(ValueError, match="tpu"):
            tex.export_encoders(model, str(tmp_path), platforms=["cpu", "tpu"])

    def test_absent_cuda_raises(self, bf16, tmp_path, monkeypatch):
        model, _ = bf16
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tex.export_encoders(model, str(tmp_path), platforms=["cuda"])


class TestCli:
    def test_export_on_the_cpu(self, tmp_path, capsys):
        from medmoe_torch.cli import export

        out = str(tmp_path / "art")
        export.main(TINY + ["device=cpu", f"export.dir={out}",
                            f"paths.root_dir={tmp_path}"])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["platforms"] == ["cpu"] and line["embed_dim"] == 32
        assert set(line["bytes"]) == {"encode_image.cpu.pt2",
                                      "encode_text.cpu.pt2", "manifest.json"}

    def test_cuda_default_raises_without_a_card(self, tmp_path, monkeypatch):
        from medmoe_torch.cli import export

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device=cpu"):
            export.main(TINY + [f"paths.root_dir={tmp_path}"])


def test_jax_side_is_on_cpu():
    assert jax.devices()[0].platform == "cpu"
