"""The port's weight converters (medmoe_torch/models/convert.py) on the CPU:

  * HF ``SwinModel`` / ``BertModel``, built from config objects with
    random weights (no network), loaded into the port's towers through
    ``convert_hf_swin`` / ``convert_hf_bert``: the towers' forwards match
    the HF forwards at float32 (rtol 1e-4, atol 1e-4);
  * the port converters' output equals the JAX ``convert_hf_*`` followed
    by ``bridge.from_jax_params``, bit for bit, and so does a whole
    MedCLIP checkpoint loaded into a MedMoE by both packages;
  * ``load_medclip_checkpoint(strict=True)`` consumes every key, and
    raises on an unconsumed one; a missing file is a no-op with a warning;
  * ``python -m medmoe_torch.cli.serve medclip_ckpt=...`` serves the
    converted towers, not the seeded ones;
  * a full-size case (swin-tiny, BERT-base, strict), marked slow.
"""

import json
import logging

import jax
import numpy as np
import pytest
import torch

from medmoe_tpu.models import convert as jconvert
from medmoe_torch import bridge
from medmoe_torch.config import DotDict
from medmoe_torch.models import convert as tconvert
from medmoe_torch.models.bert import BertConfig, BertModel
from medmoe_torch.models.medmoe import MedMoE, init_weights
from medmoe_torch.models.swin import SwinBackbone, SwinConfig

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _hf_swin(**kw):
    from transformers import SwinConfig as HFSwinConfig, SwinModel

    torch.manual_seed(0)
    cfg = dict(image_size=56, patch_size=4, num_channels=3, embed_dim=8,
               depths=[1, 1], num_heads=[1, 2], window_size=7,
               hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               drop_path_rate=0.0)
    cfg.update(kw)
    return SwinModel(HFSwinConfig(**cfg)).eval()


def _hf_bert(**kw):
    from transformers import BertConfig as HFBertConfig
    from transformers import BertModel as HFBertModel

    torch.manual_seed(1)
    cfg = dict(vocab_size=120, hidden_size=16, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=32,
               max_position_embeddings=64, type_vocab_size=2,
               hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    cfg.update(kw)
    return HFBertModel(HFBertConfig(**cfg)).eval()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _numpy_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k].float(), want[k].float()), k


def _bert_inputs(vocab, t=10):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, vocab, size=(2, t)).astype(np.int64)
    mask = np.ones((2, t), np.int64)
    mask[1, 7:] = 0
    return ids, mask, np.zeros((2, t), np.int64)


class TestSwin:
    def test_outputs_match_hf(self):
        hf = _hf_swin()
        x = np.random.RandomState(0).randn(2, 3, 56, 56).astype(np.float32)
        with torch.no_grad():
            out = hf(torch.from_numpy(x), output_hidden_states=True)
        ours = SwinBackbone(SwinConfig(image_size=56, embed_dim=8,
                                       depths=(1, 1), num_heads=(1, 2),
                                       window_size=7, drop_path_rate=0.0,
                                       dtype=torch.float32)).eval()
        n = tconvert._merge_into(ours, tconvert.convert_hf_swin(
            hf.state_dict(), depths=(1, 1)))
        assert n == len(ours.state_dict())           # every tensor lands
        with torch.no_grad():
            pyramid, final = ours(torch.from_numpy(x.transpose(0, 2, 3, 1)))
        for got, want in ((pyramid[0], out.hidden_states[0]),
                          (pyramid[1], out.hidden_states[1]),
                          (final, out.last_hidden_state)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)

    def test_equals_jax_convert_then_bridge(self):
        sd = _numpy_sd(_hf_swin(depths=[2, 2], num_heads=[1, 2]))
        want = bridge.from_jax_params(_flat(jconvert.convert_hf_swin(
            sd, depths=(2, 2))))
        _assert_same(tconvert.convert_hf_swin(sd, depths=(2, 2)), want)


class TestBert:
    def test_outputs_match_hf(self):
        hf = _hf_bert()
        ids, mask, types = _bert_inputs(120)
        with torch.no_grad():
            out = hf(torch.from_numpy(ids), torch.from_numpy(mask),
                     torch.from_numpy(types), output_hidden_states=True)
        ours = BertModel(BertConfig(vocab_size=120, hidden_size=16,
                                    num_layers=2, num_heads=2,
                                    intermediate_size=32,
                                    max_position_embeddings=64,
                                    dtype=torch.float32)).eval()
        n = tconvert._merge_into(ours, tconvert.convert_hf_bert(
            hf.state_dict(), num_layers=2))
        assert n == len(ours.state_dict())
        with torch.no_grad():
            last, pooled, hidden = ours(*(torch.from_numpy(a)
                                          for a in (ids, mask, types)))
        np.testing.assert_allclose(last.numpy(),
                                   out.last_hidden_state.numpy(), **TOL)
        np.testing.assert_allclose(pooled.numpy(),
                                   out.pooler_output.numpy(), **TOL)
        for i in (0, 1, 2):
            np.testing.assert_allclose(hidden[i].numpy(),
                                       out.hidden_states[i].numpy(), **TOL)

    def test_equals_jax_convert_then_bridge(self):
        sd = _numpy_sd(_hf_bert())
        want = bridge.from_jax_params(_flat(jconvert.convert_hf_bert(
            sd, num_layers=2)))
        _assert_same(tconvert.convert_hf_bert(sd, num_layers=2), want)


# --- a MedCLIP checkpoint into a whole MedMoE ------------------------------

VISION = dict(model_name="swin", embed_dim=16, use_moe=True, image_size=56,
              num_experts=3, moe_mode="gather", router_top_k=1,
              dtype="float32", swin_embed_dim=8, swin_depths=[1, 1],
              swin_num_heads=[1, 2], swin_window_size=7, drop_path_rate=0.0)
TEXT = dict(last_n_layers=2, aggregate_method="sum", norm=False,
            agg_tokens=True, max_length=10, embed_dim=16, projection=False,
            dtype="float32", vocab_size=120, hidden_size=16, num_layers=2,
            num_heads=2, intermediate_size=32, max_position_embeddings=64)


def _medclip(path, swin=None, bert=None, extra=()):
    sd = {f"vision_model.{k}": v
          for k, v in (swin or _hf_swin()).state_dict().items()}
    sd.update({f"text_model.{k}": v
               for k, v in (bert or _hf_bert()).state_dict().items()})
    sd.update({k: torch.zeros(2) for k in extra})
    torch.save(sd, str(path))
    return str(path)


def _medmoe(seed=0):
    return init_weights(MedMoE(DotDict(VISION), DotDict(TEXT)), seed)


class TestMedclip:
    def test_strict_load_equals_jax(self, tmp_path):
        from medmoe_tpu.models.medmoe import MedMoE as JMedMoE

        path = _medclip(tmp_path / "pytorch_model.bin")
        model = tconvert.load_medclip_checkpoint(
            _medmoe(), path, depths=(1, 1), num_layers=2, strict=True)
        jmodel = JMedMoE(vision=VISION, text=TEXT)
        ids, mask, types = (a.astype(np.int32) for a in _bert_inputs(120))
        batch = {"image": np.zeros((1, 56, 56, 3), np.float32),
                 "input_ids": ids[:1], "attention_mask": mask[:1],
                 "token_type_ids": types[:1], "segment_ids": ids[:1] * 0}
        params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch)["params"]
        loaded = jconvert.load_medclip_checkpoint(
            params, path, depths=(1, 1), num_layers=2, strict=True)
        want = bridge.from_jax_params(_flat(loaded), model)
        got = model.state_dict()
        towers = [k for k in want if k.startswith(
            ("image_encoder.swin_moe.swin.", "text_encoder.bert."))]
        assert len(towers) > 40
        for k in towers:
            assert torch.equal(got[k], want[k]), k

    @pytest.mark.parametrize("extra", ["vision_model.extra.weight",
                                       "text_model.pooler.extra",
                                       "logit_scale"])
    def test_strict_raises_on_an_unconsumed_key(self, tmp_path, extra):
        path = _medclip(tmp_path / "pytorch_model.bin", extra=[extra])
        with pytest.raises(ValueError, match="NOT consumed"):
            tconvert.load_medclip_checkpoint(_medmoe(), path, depths=(1, 1),
                                             num_layers=2, strict=True)
        # without strict the same file loads, with a warning
        tconvert.load_medclip_checkpoint(_medmoe(), path, depths=(1, 1),
                                         num_layers=2)

    def test_missing_file_is_a_noop(self, caplog):
        model = _medmoe()
        before = {k: v.clone() for k, v in model.state_dict().items()}
        with caplog.at_level(logging.WARNING):
            out = tconvert.load_medclip_checkpoint(model, "/nonexistent.bin")
        assert out is model
        assert "file missing" in caplog.text
        _assert_same(model.state_dict(), before)

    def test_shape_mismatch_is_skipped(self, tmp_path, caplog):
        path = _medclip(tmp_path / "pytorch_model.bin",
                        bert=_hf_bert(intermediate_size=48))
        model = _medmoe()
        before = model.text_encoder.bert.layer_0.intermediate.weight.clone()
        with caplog.at_level(logging.WARNING):
            tconvert.load_medclip_checkpoint(model, path, depths=(1, 1),
                                             num_layers=2)
        assert "shape mismatch" in caplog.text
        assert torch.equal(model.text_encoder.bert.layer_0.intermediate.weight,
                           before)

    def test_hf_pretrained_files(self, tmp_path):
        swin, bert = _hf_swin(), _hf_bert()
        torch.save(swin.state_dict(), str(tmp_path / "swin.bin"))
        torch.save(bert.state_dict(), str(tmp_path / "bert.bin"))
        model = tconvert.load_hf_pretrained(
            _medmoe(), str(tmp_path / "swin.bin"), str(tmp_path / "bert.bin"),
            depths=(1, 1), num_layers=2, strict=True)
        ref = tconvert.load_medclip_checkpoint(
            _medmoe(), _medclip(tmp_path / "m.bin", swin, bert),
            depths=(1, 1), num_layers=2, strict=True)
        _assert_same(model.state_dict(), ref.state_dict())


class TestServeMedclip:
    def test_served_embeddings_are_the_converted_towers(self, tmp_path,
                                                        capsys):
        """R2: the serve CLI's ``load_for_eval`` applies ``medclip_ckpt``
        (it used to be read by nobody)."""
        from PIL import Image

        from medmoe_torch.cli import serve
        from medmoe_torch.data.transforms import ImageTransform, decode_image
        from medmoe_torch.eval.zero_shot import make_image_embedder

        img_dir = tmp_path / "imgs"
        img_dir.mkdir()
        rng = np.random.RandomState(0)
        for i in range(3):
            Image.fromarray((rng.rand(60, 56, 3) * 255).astype(np.uint8)).save(
                img_dir / f"scan_{i}.png")
        ckpt = _medclip(tmp_path / "pytorch_model.bin")
        over = [f"model.model.vision.{k}={json.dumps(v).replace(' ', '')}"
                for k, v in VISION.items()] + [
            f"model.model.text.{k}={v}" for k, v in TEXT.items()] + [
            "data=unimed", "device=cpu", "serve.mode=embed",
            f"serve.input={img_dir}", f"paths.root_dir={tmp_path}"]

        def served(*extra):
            assert serve.main(over + list(extra)) == 0
            return np.asarray([json.loads(line)["embedding"] for line in
                               capsys.readouterr().out.splitlines()
                               if line.startswith("{")], np.float32)

        seeded = served()
        converted = served(f"medclip_ckpt={ckpt}")
        model = tconvert.load_medclip_checkpoint(
            init_weights(MedMoE(DotDict(VISION), DotDict(
                TEXT, vocab_size=28996)), 12345), ckpt, depths=(1, 1),
            num_layers=2).eval()
        transform = ImageTransform(56, train=False)
        images = np.stack([transform(decode_image(p.read_bytes()))
                           for p in sorted(img_dir.glob("*.png"))])
        want = make_image_embedder(model)(images).numpy()
        assert seeded.shape == converted.shape == (3, 16)
        assert np.abs(seeded - converted).max() > 0.1
        np.testing.assert_array_equal(converted, want)


@pytest.mark.slow
class TestFullSize:
    def test_strict_medclip_and_towers_match_hf(self, tmp_path):
        """swin-tiny (depths 2,2,6,2, 224 px) and BERT-base, strict."""
        hf_swin = _hf_swin(image_size=224, embed_dim=96, depths=[2, 2, 6, 2],
                           num_heads=[3, 6, 12, 24])
        hf_bert = _hf_bert(vocab_size=28996, hidden_size=768,
                           num_hidden_layers=12, num_attention_heads=12,
                           intermediate_size=3072,
                           max_position_embeddings=512)
        vision = dict(VISION, image_size=224, swin_embed_dim=96,
                      swin_depths=[2, 2, 6, 2], swin_num_heads=[3, 6, 12, 24],
                      embed_dim=768)
        text = dict(TEXT, vocab_size=28996, hidden_size=768, num_layers=12,
                    num_heads=12, intermediate_size=3072,
                    max_position_embeddings=512, last_n_layers=4)
        model = tconvert.load_medclip_checkpoint(
            init_weights(MedMoE(DotDict(vision), DotDict(text))),
            _medclip(tmp_path / "m.bin", hf_swin, hf_bert), strict=True)
        model.eval()
        x = np.random.RandomState(0).randn(2, 224, 224, 3).astype(np.float32)
        ids, mask, types = _bert_inputs(28996, t=25)
        with torch.no_grad():
            out = hf_swin(torch.from_numpy(x.transpose(0, 3, 1, 2)),
                          output_hidden_states=True)
            _, final = model.image_encoder.swin_moe.swin(torch.from_numpy(x))
            hf_out = hf_bert(*(torch.from_numpy(a) for a in (ids, mask,
                                                             types)))
            last, _, _ = model.text_encoder.bert(
                *(torch.from_numpy(a) for a in (ids, mask, types)))
        np.testing.assert_allclose(final.numpy(),
                                   out.last_hidden_state.numpy(), **TOL)
        np.testing.assert_allclose(last.numpy(),
                                   hf_out.last_hidden_state.numpy(), **TOL)
