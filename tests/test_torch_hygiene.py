"""Rules the PyTorch port keeps: it imports nothing of JAX or of the JAX
package (checked with ``ast`` — this image imports jax at interpreter
start, so ``sys.modules`` cannot tell), its copied pure-Python modules
(config, tokenizer, transforms, prefetch, data label spaces) behave like
the originals, and the kernel build fails loudly without a compiler."""

import ast
import importlib
import os

import numpy as np
import pytest

import medmoe_torch
from medmoe_torch.config import compose
from medmoe_torch.data import datamodules as tdm
from medmoe_torch.data import tokenizer as ttok
from medmoe_torch.data import transforms as ttr
from medmoe_torch.data.prefetch import prefetch
from medmoe_torch.ops import _build
from medmoe_torch.utils.logging import _process_index

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "medmoe_tpu"}


def _port_files():
    pkg = os.path.dirname(medmoe_torch.__file__)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for root, _, names in os.walk(pkg):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


class TestImportHygiene:
    def test_scan_covers_the_port(self):
        files = _port_files()
        assert len(files) > 20
        assert any(f.endswith("chip_smoke.py") for f in files)

    def test_no_jax_or_jax_package_imports(self):
        bad = [(os.path.relpath(f, ROOT), line, mod)
               for f in _port_files()
               for mod, line in _imported_roots(f) if mod in FORBIDDEN]
        assert not bad, f"forbidden imports in the port: {bad}"

    def test_scanner_catches_a_forbidden_import(self, tmp_path):
        p = tmp_path / "m.py"
        p.write_text("def f():\n    from medmoe_tpu.models import moe\n"
                     "    import jax.numpy as jnp\n")
        assert {m for m, _ in _imported_roots(str(p))} == {"medmoe_tpu", "jax"}

    def test_every_port_module_imports(self):
        pkg = os.path.dirname(medmoe_torch.__file__)
        for f in _port_files():
            if f.startswith(pkg):
                rel = os.path.relpath(f, os.path.dirname(pkg))[:-3]
                importlib.import_module(rel.replace(os.sep, ".")
                                        .removesuffix(".__init__"))


class TestConfig:
    def test_eval_zs_composes_with_port_targets(self):
        cfg = compose("eval_zs")
        assert cfg.device == "cuda" and cfg.serve.batch_size == 32
        assert cfg.model.model._target_ == "medmoe_torch.models.medmoe.MedMoE"
        assert cfg.model.loss.temp3 == 10.0
        targets = []

        def walk(node):
            if isinstance(node, dict):
                for k, v in node.items():
                    if k == "_target_":
                        targets.append(v)
                    walk(v)

        walk(cfg)
        assert targets and all(t.startswith("medmoe_torch.") for t in targets)
        for t in targets:
            mod, _, attr = t.rpartition(".")
            assert hasattr(importlib.import_module(mod), attr), t

    @pytest.mark.parametrize("data", ["chexpert", "unimed", "synthetic"])
    def test_data_groups_instantiate(self, data):
        from medmoe_torch.utils.instantiate import instantiate

        dm = instantiate(compose("eval_zs", [f"data={data}"]).data)
        assert dm.tokenizer.vocab_size > 0 and dm.num_classes > 0

    def test_yaml_floats_and_interpolation(self):
        cfg = compose("eval_zs", ["+x=5e-5", "paths.root_dir=/r"])
        assert cfg.x == 5e-5
        assert cfg.paths.data_dir == "/r/data"


class TestCopiedModules:
    def test_label_spaces_match_jax_package(self):
        from medmoe_tpu.data import datamodules as jdm

        assert tdm.UnimedDataModule.CLASS_NAMES == \
            jdm.UnimedDataModule.CLASS_NAMES
        assert tdm.CheXpertDataModule.COMPETITION_TASKS == \
            jdm.CheXpertDataModule.COMPETITION_TASKS
        assert tdm.SyntheticDataModule.CAPTIONS == \
            jdm.SyntheticDataModule.CAPTIONS

    def test_vocab_fixture_is_a_copy(self):
        from medmoe_tpu.data import tokenizer as jtok

        with open(ttok.fixture_vocab_path(), "rb") as a, \
                open(jtok.fixture_vocab_path(), "rb") as b:
            assert a.read() == b.read()

    def test_tokenizer_matches(self):
        from medmoe_tpu.data import tokenizer as jtok

        texts = ["this is a photo of Pleural Effusion",
                 "Cardiomegaly with unbelievably enlarged silhouette"]
        a = ttok.load_or_build_tokenizer("fixture:bio_clinical_bert") \
            .encode_batch(texts, 25)
        b = jtok.load_or_build_tokenizer("fixture:bio_clinical_bert") \
            .encode_batch(texts, 25)
        for k in ("input_ids", "attention_mask", "segment_ids", "cap_lens"):
            np.testing.assert_array_equal(a[k], b[k])
        assert a["sents"] == b["sents"]

    def test_transform_matches(self):
        from medmoe_tpu.data import transforms as jtr

        img = np.random.RandomState(0).randint(0, 256, (40, 50, 3), np.uint8)
        for kw in ({}, {"pad_to_square": True}):
            np.testing.assert_array_equal(
                ttr.ImageTransform(32, **kw)(img),
                jtr.ImageTransform(32, **kw)(img))

    def test_prefetch_order_and_errors(self):
        assert list(prefetch(range(10), depth=2, transform=lambda x: x * 2)) \
            == [2 * i for i in range(10)]

        def boom():
            yield 1
            raise ValueError("source failed")

        with pytest.raises(ValueError, match="source failed"):
            list(prefetch(boom(), depth=1))

    def test_rank_without_process_group(self):
        assert _process_index() == 0


class TestKernelBuild:
    def test_missing_nvcc_raises(self, monkeypatch):
        monkeypatch.setenv("CUDA_HOME", "/nonexistent")
        monkeypatch.setenv("PATH", "/nonexistent")
        monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.nvcc()

    def test_library_path_tracks_source_and_flags(self, monkeypatch):
        a = _build.library_path("expert_fusion")
        assert a.startswith(_build.BUILD_DIR) and a.endswith(".so")
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
        assert _build.library_path("expert_fusion") != a

    def test_every_kernel_source_exists(self):
        for name in _build.KERNELS:
            assert os.path.isfile(os.path.join(_build.CSRC, f"{name}.cu"))
