"""The port's disk-backed data against the JAX package's, on the same files.

  * the shard engine (brace expansion, multi-source weights, the tar
    round trip through the port's ``ShardWriter``, a corrupt shard
    skipped, the epoch-seeded shard order and shuffle buffer, the process
    split) against ``medmoe_tpu.data.shards``;
  * ``sample_caption`` against JAX's over the same rng;
  * every loader's batches (Unimed with 0 and 2 decode workers, f32 and
    uint8; CheXpert, Csv, Pmcoa, Slake) bit-equal — ``np.array_equal`` and
    the same dtype on every key — to the JAX datamodule's on the same tmp
    files, written as ``tests/test_data.py`` writes them;
  * the decode-failure rule (drop in one process, a zero image with
    several) and ``use_native`` refused.

No tolerance anywhere: both sides run the same PIL calls on the host.
"""

import csv
import io
import json
import os
import random

import numpy as np
import pytest
import torch

from medmoe_tpu.data import datamodules as jdm
from medmoe_tpu.data import shards as jsh
from medmoe_tpu.data import templates as jtpl
from medmoe_torch.data import datamodules as tdm
from medmoe_torch.data import shards as tsh
from medmoe_torch.data import templates as ttpl
from medmoe_torch.data.shard_writer import ShardWriter

torch.set_num_threads(1)

CAPTIONS = [
    "ct of the chest_radimagenet_axial ct slice_radimagenet_a ct scan",
    "frontal chest film_chexpert_no finding_chexpert_normal heart size",
    "retina fundus_all_retina_merged_fundus photograph of the eye",
    "mri brain_dr_diabetic retinopathy grade two_dr_fundus image",
    "histology slide stained",
    "report one_mimiccxr_report two_mimiccxr_noreportpresent",
]


def _jpeg(arr, quality=90):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _image(rng, h=None, w=None):
    h = h or int(rng.randint(20, 48))
    w = w or int(rng.randint(20, 48))
    return (rng.rand(h, w, 3) * 255).astype(np.uint8)


def _assert_batches_equal(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def unimed_dir(tmp_path_factory):
    """Three sources of shards (2, 1 and 1 shards of 6 non-square JPEGs),
    one corrupt member and one bare sample without a caption, and a val
    shard; sizes.json written by the port's ShardWriter."""
    root = tmp_path_factory.mktemp("unimed")
    rng = np.random.RandomState(0)
    n = 0
    for src, shards in (("a", 2), ("b", 1), ("c", 1)):
        for s in range(shards):
            with ShardWriter(str(root / f"{src}-{s + 1:06d}.tar")) as w:
                for i in range(6):
                    w.write({"__key__": f"{src}{s}_{i:04d}",
                             "jpg": _jpeg(_image(rng)),
                             "txt": CAPTIONS[n % len(CAPTIONS)],
                             "cls": n % 6})
                    n += 1
                if src == "a" and s == 0:
                    w.write({"__key__": "broken", "jpg": b"not a jpeg",
                             "txt": "broken image", "cls": 1})
                    w.write({"__key__": "nocaption",
                             "jpg": _jpeg(_image(rng))})
    with ShardWriter(str(root / "val-000001.tar")) as w:
        for i in range(7):
            w.write({"__key__": f"v{i:04d}", "jpg": _jpeg(_image(rng)),
                     "txt": CAPTIONS[i % len(CAPTIONS)], "cls": i % 6})
    return root


def _unimed_kw(root, **kw):
    base = dict(
        train_data_paths=(f"{root}/a-{{000001..000002}}.tar::"
                          f"{root}/b-000001.tar::{root}/c-000001.tar"),
        val_data_paths=f"{root}/val-000001.tar",
        weights="2.0::1.0::0.5", batch_size=4, image_size=32,
        max_length=12, shuffle_buffer=5, seed=3)
    base.update(kw)
    return base


class TestShards:
    def test_braceexpand_and_weights(self):
        for spec in ("d-{001..003}.tar", "plain.tar", "x{1..2}-{08..10}.tar"):
            assert tsh.braceexpand(spec) == jsh.braceexpand(spec)
        for urls, weights in (("a-{01..02}.tar::b.tar", "2.0::1.0"),
                              ("a-{01..02}.tar::b.tar", None),
                              (["x.tar", "y.tar"], [1.0, 3.0])):
            assert tsh.expand_urls(urls, weights) == \
                jsh.expand_urls(urls, weights)

    def test_weight_mismatch_raises(self):
        for mod in (tsh, jsh):
            with pytest.raises(ValueError, match="2 url groups but 1"):
                mod.expand_urls("a.tar::b.tar", "1.0")

    def test_write_read_and_sizes(self, tmp_path):
        rng = np.random.RandomState(1)
        with ShardWriter(str(tmp_path / "s-%06d.tar"), maxcount=4) as w:
            for i in range(10):
                w.write({"__key__": f"{i:04d}", "jpg": _jpeg(_image(rng)),
                         "txt": f"caption {i}", "cls": i % 3})
        with open(tmp_path / "sizes.json") as f:
            assert json.load(f) == {"s-000000.tar": 4, "s-000001.tar": 4,
                                    "s-000002.tar": 2}
        urls = str(tmp_path / "s-{000000..000002}.tar")
        assert tsh.discover_num_samples(urls) == \
            jsh.discover_num_samples(urls) == 10
        ours = list(tsh.WebDatasetReader(urls).samples())
        theirs = list(jsh.WebDatasetReader(urls).samples())
        assert ours == theirs and len(ours) == 10
        assert ours[3]["txt"] == b"caption 3" and ours[3]["cls"] == b"0"

    def test_corrupt_shard_is_skipped(self, tmp_path):
        rng = np.random.RandomState(2)
        with ShardWriter(str(tmp_path / "ok-%06d.tar"), maxcount=3) as w:
            for i in range(3):
                w.write({"__key__": f"{i:04d}", "jpg": _jpeg(_image(rng)),
                         "txt": f"c {i}"})
        (tmp_path / "bad.tar").write_bytes(b"\x00garbage" * 100)
        good = open(tmp_path / "ok-000000.tar", "rb").read()
        (tmp_path / "cut.tar").write_bytes(good[:len(good) // 2])
        urls = [str(tmp_path / n) for n in ("bad.tar", "ok-000000.tar",
                                            "cut.tar", "missing.tar")]
        ours = list(tsh.WebDatasetReader(urls).samples())
        assert ours == list(jsh.WebDatasetReader(urls).samples())
        assert [s["__key__"] for s in ours[:3]] == [b"0000", b"0001",
                                                    b"0002"]

    @pytest.mark.parametrize("resampled", [False, True])
    def test_epoch_order_and_split(self, resampled):
        urls = "s-{000000..000009}.tar"
        for procs, workers in ((1, 1), (2, 1), (3, 2)):
            for p in range(procs):
                for wk in range(workers):
                    kw = dict(resampled=resampled, seed=7,
                              num_processes=procs, process_index=p,
                              num_workers=workers, worker_index=wk)
                    ours = tsh.ShardList(urls, "1.0" if resampled else None,
                                         **kw)
                    theirs = jsh.ShardList(urls, "1.0" if resampled
                                           else None, **kw)
                    for epoch in range(3):
                        assert ours.for_epoch(epoch) == \
                            theirs.for_epoch(epoch)
        one = tsh.ShardList(urls, seed=7)
        assert one.for_epoch(0) != one.for_epoch(1)
        assert sorted(one.for_epoch(0)) == sorted(one.for_epoch(1))

    def test_shuffle_buffer(self):
        for seed in (0, 5):
            items = list(range(40))
            assert list(tsh.shuffled(iter(items), 8, seed)) == \
                list(jsh.shuffled(iter(items), 8, seed))
        # the reader's buffer seed: hash of an int tuple, independent of
        # PYTHONHASHSEED
        assert hash((3, 1)) & 0x7FFFFFFF == hash((3, 1)) & 0x7FFFFFFF


class TestCaptions:
    def test_sample_caption_matches_jax(self):
        texts = CAPTIONS + [
            "one_openi_two_openi_three",
            "a_medicat_nothingpresent", "a_medicat_b_medicat_c",
            "x_mimiccxr_y_mimiccxr_final report"]
        ours_rng, jax_rng = random.Random(11), random.Random(11)
        for _ in range(5):
            for t in texts:
                assert ttpl.sample_caption(t, ours_rng) == \
                    jtpl.sample_caption(t, jax_rng)
        assert ttpl.SEPARATORS == jtpl.SEPARATORS


class TestUnimed:
    @pytest.mark.parametrize("num_workers,emit_uint8", [
        (0, False), (2, False), (2, True)])
    def test_batches_equal_jax(self, unimed_dir, num_workers, emit_uint8):
        kw = _unimed_kw(unimed_dir, num_workers=num_workers,
                        emit_uint8=emit_uint8)
        ours, theirs = tdm.UnimedDataModule(**kw), \
            jdm.UnimedDataModule(**kw)
        assert ours.steps_per_epoch == theirs.steps_per_epoch == 6
        assert ours.val_steps_per_epoch == theirs.val_steps_per_epoch == 1
        for epoch in (0, 1):
            batches = list(ours.train_dataloader(epoch))
            _assert_batches_equal(batches, theirs.train_dataloader(epoch))
            want = np.uint8 if emit_uint8 else np.float32
            assert batches[0]["image"].dtype == want
            assert batches[0]["image"].shape == (4, 32, 32, 3)
        _assert_batches_equal(ours.val_dataloader(),
                              theirs.val_dataloader())

    def test_workers_do_not_change_the_batches(self, unimed_dir):
        serial = tdm.UnimedDataModule(**_unimed_kw(unimed_dir, num_workers=0))
        pooled = tdm.UnimedDataModule(**_unimed_kw(unimed_dir, num_workers=3))
        _assert_batches_equal(serial.train_dataloader(2),
                              pooled.train_dataloader(2))

    def test_unresampled_shuffle(self, unimed_dir):
        kw = _unimed_kw(unimed_dir, resampled=False, weights=None,
                        shuffle_buffer=3)
        ours = list(tdm.UnimedDataModule(**kw).train_dataloader(1))
        _assert_batches_equal(ours, jdm.UnimedDataModule(**kw)
                              .train_dataloader(1))
        # 24 decodable captioned pairs (the broken and the bare one drop)
        assert len(ours) == 6

    def test_use_native_raises(self, unimed_dir, tmp_path, monkeypatch):
        """A decode helper that does not build raises with the compiler's
        message (JAX falls back to PIL there); with uint8 images the
        helper is not used, so nothing is built."""
        from medmoe_torch.data import native

        src = tmp_path / "medmoe_native.cpp"
        src.write_text("#include <no_such_header_medmoe.h>\n")
        monkeypatch.setattr(native, "SOURCE", str(src))
        monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
        monkeypatch.setattr(native, "_lib", None)
        with pytest.raises(RuntimeError, match=r"g\+\+") as err:
            tdm.UnimedDataModule(**_unimed_kw(unimed_dir), use_native=True)
        if "not found" not in str(err.value):
            assert "no_such_header_medmoe.h" in str(err.value)
        dm = tdm.UnimedDataModule(**_unimed_kw(unimed_dir, emit_uint8=True),
                                  use_native=True)
        assert not dm.use_native
        assert not [n for n in os.listdir(tmp_path / "build")
                    if n.endswith(".so")]


def _write_chexpert(root, rng):
    tasks = jdm.CheXpertDataModule.TASKS
    fields = ["Path", "Sex", "Frontal/Lateral"] + tasks
    for split, n in (("train", 9), ("valid", 5)):
        rows = []
        for i in range(n):
            rel = f"{split}/p{i}/view1.jpg"
            os.makedirs(root / os.path.dirname(rel), exist_ok=True)
            if i == 3:
                (root / rel).write_bytes(b"corrupt")      # dropped
            else:
                (root / rel).write_bytes(_jpeg(_image(rng)))
            row = {"Path": f"CheXpert-v1.0-small/{rel}", "Sex": "F",
                   "Frontal/Lateral": "Lateral" if i == 5 else "Frontal"}
            for t in tasks:
                row[t] = ["1.0", "0.0", "-1.0", ""][(i + len(t)) % 4]
            rows.append(row)
        with open(root / f"{split}.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields)
            w.writeheader()
            w.writerows(rows)


class TestFileLoaders:
    def test_chexpert(self, tmp_path):
        _write_chexpert(tmp_path, np.random.RandomState(3))
        kw = dict(data_dir=str(tmp_path), batch_size=2, image_size=24,
                  fraction=0.9, seed=4)
        ours, theirs = tdm.CheXpertDataModule(**kw), \
            jdm.CheXpertDataModule(**kw)
        for epoch in (0, 1):
            _assert_batches_equal(ours.train_dataloader(epoch),
                                  theirs.train_dataloader(epoch))
            assert ours.steps_per_epoch == theirs.steps_per_epoch
        _assert_batches_equal(ours.val_dataloader(), theirs.val_dataloader())
        _assert_batches_equal(ours.test_dataloader(),
                              theirs.test_dataloader())
        assert ours.val_steps_per_epoch == theirs.val_steps_per_epoch

    @pytest.mark.parametrize("emit_uint8", [False, True])
    def test_csv(self, tmp_path, emit_uint8):
        from PIL import Image

        rng = np.random.RandomState(4)
        rows = []
        for i in range(7):
            rel = f"im{i}.jpg"
            Image.fromarray(_image(rng)).save(str(tmp_path / rel))
            rows.append({"filepath": rel, "title": f"caption {i}",
                         "cls": f"{i % 3}.0"})
        rows.append({"filepath": "missing.jpg", "title": "gone", "cls": 1})
        with open(tmp_path / "data.tsv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["filepath", "title", "cls"],
                               delimiter="\t")
            w.writeheader()
            w.writerows(rows)
        kw = dict(data_dir=str(tmp_path), csv_path=str(tmp_path / "data.tsv"),
                  sep="\t", batch_size=3, image_size=16, max_length=8,
                  emit_uint8=emit_uint8)
        ours, theirs = tdm.CsvDataModule(**kw), jdm.CsvDataModule(**kw)
        for epoch in (0, 3):
            _assert_batches_equal(ours.train_dataloader(epoch),
                                  theirs.train_dataloader(epoch))
        _assert_batches_equal(ours.val_dataloader(), theirs.val_dataloader())
        assert ours.val_steps_per_epoch == theirs.val_steps_per_epoch == 3

    def test_pmcoa(self, tmp_path):
        from PIL import Image

        rng = np.random.RandomState(5)
        os.makedirs(tmp_path / "images")
        with open(tmp_path / "ann.jsonl", "w") as f:
            for i in range(40):
                name = f"images/{i}.png"
                Image.fromarray(_image(rng)).save(str(tmp_path / name))
                key = "image" if i % 2 else "image_path"
                f.write(json.dumps({key: name, "caption": f"figure {i}",
                                    "label": f"{i % 5}.0"}) + "\n")
                if i == 7:
                    f.write("\n")
        kw = dict(data_dir=str(tmp_path), ann_path=str(tmp_path / "ann.jsonl"),
                  batch_size=4, image_size=16, max_length=8, seed=2)
        ours, theirs = tdm.PmcoaDataModule(**kw), jdm.PmcoaDataModule(**kw)
        _assert_batches_equal(ours.train_dataloader(1),
                              theirs.train_dataloader(1))
        _assert_batches_equal(ours.val_dataloader(), theirs.val_dataloader())

    @pytest.mark.parametrize("label_type", ["modality", "abnormal"])
    def test_slake(self, tmp_path, label_type):
        from PIL import Image

        rng = np.random.RandomState(6)
        os.makedirs(tmp_path / "imgs")
        mods = ["MRI", "CT", "X-Ray", "US"]
        for split, n in (("train", 10), ("validate", 5), ("test", 3)):
            recs = []
            for i in range(n):
                name = f"{split}_{i}.jpg"
                Image.fromarray(_image(rng)).save(str(tmp_path / "imgs" /
                                                      name))
                recs.append({"img_name": name, "q_lang": "zh" if i == 2
                             else "en", "modality": mods[i % 4],
                             "content_type": "Organ",
                             "question": "is there a tumor?" if i % 3
                             else "which organ?", "answer": "yes"})
            with open(tmp_path / f"{split}.json", "w") as f:
                json.dump(recs, f)
        kw = dict(data_dir=str(tmp_path), label_type=label_type,
                  batch_size=3, image_size=16, max_length=8)
        ours, theirs = tdm.SlakeDataModule(**kw), jdm.SlakeDataModule(**kw)
        _assert_batches_equal(ours.train_dataloader(0),
                              theirs.train_dataloader(0))
        _assert_batches_equal(ours.val_dataloader(), theirs.val_dataloader())
        assert ours.num_classes == theirs.num_classes


class TestProcessSplit:
    def test_rows_split_by_rank(self, monkeypatch):
        dm = tdm.CsvDataModule()
        rows = list(range(11))
        assert dm._process_split(rows) == rows
        monkeypatch.setattr(tdm, "_rank_and_world", lambda: (1, 3))
        assert dm._process_split(rows) == rows[1:9:3]

    def test_unimed_reader_takes_the_rank(self, unimed_dir, monkeypatch):
        monkeypatch.setattr(tdm, "_rank_and_world", lambda: (1, 2))
        dm = tdm.UnimedDataModule(**_unimed_kw(unimed_dir))
        shards = dm._reader(dm.train_data_paths, train=True).shards
        assert (shards.num_processes, shards.process_index) == (2, 1)
        # 26 samples by sizes.json (the broken and bare ones count): 13 a rank
        assert dm.steps_per_epoch == 26 // 2 // 4

    @pytest.mark.parametrize("emit_uint8", [False, True])
    def test_decode_failure(self, monkeypatch, emit_uint8):
        dm = tdm.CsvDataModule(image_size=8, emit_uint8=emit_uint8)

        def bad():
            raise OSError("truncated")

        assert dm._decode(bad) is None             # one process: dropped
        monkeypatch.setattr(tdm, "_rank_and_world", lambda: (0, 2))
        img = dm._decode(bad)                      # several: a zero image
        assert img.shape == (8, 8, 3) and not img.any()
        assert img.dtype == (np.uint8 if emit_uint8 else np.float32)
