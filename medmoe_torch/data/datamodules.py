"""Data modules: named datasets with train/val/test iterators (counterpart
of medmoe_tpu/data/datamodules.py).

Every training module yields host batches of numpy arrays:
    image          [B, S, S, 3] float32 (NHWC, normalized) or uint8
    input_ids / attention_mask / token_type_ids / segment_ids  [B, T] int32
    cap_lens       [B] int32
    label          [B] int32 (modality class — router supervision)
and exposes ``steps_per_epoch`` when known. Every loader is the JAX
package's, step for step: the same shard order, shuffle buffer, caption
draws, row shuffles and PIL transforms give bit-equal batches on the same
files. The process split comes from the rank's data coordinate in the
data × expert grid (``parallel/mesh.py``; the ``torch.distributed`` rank
and world size when e = 1): data rank r of d takes rows r, r + d,
r + 2d, ... of the globally ordered list, trimmed so that every rank gets
the same count and so the same number of steps an epoch. The e ranks of
an expert group read the same rows.

``data.batch_size`` is the batch of one node, as in the JAX package, where
one process drives a host's chips: each of a node's ``ranks_per_node``
data ranks (``trainer.devices`` over the expert axis, which the train CLI
passes) loads ``batch_size // ranks_per_node`` rows — the reference's
global batch // world size. A node batch that does not divide over its
data ranks raises. The constructors
take the same config fields as
``medmoe_tpu``'s modules, so the copied ``configs/data/*.yaml``
instantiate unchanged. ``use_native`` (Unimed, f32 images) decodes
through the C++ helper (``data/native.py``), built at first use; a build
that fails raises.
"""

from __future__ import annotations

import csv
import json
import os
import random
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from medmoe_torch.data import native
from medmoe_torch.data.prefetch import prefetch
from medmoe_torch.data.shards import WebDatasetReader, discover_num_samples
from medmoe_torch.data.templates import sample_caption
from medmoe_torch.data.tokenizer import (WordPieceTokenizer,
                                         load_or_build_tokenizer)
from medmoe_torch.data.transforms import ImageTransform, decode_image


def _rank_and_world():
    """(data coordinate, data size) of this rank in the grid
    (``parallel.mesh.data_coords``), (0, 1) without a process group."""
    from medmoe_torch.parallel.mesh import data_coords

    return data_coords()


def _ceil_div(n: int, d: int) -> int:
    return max(1, -(-n // d))


class BaseDataModule:
    """Tokenizer resolution and batching shared by every dataset."""

    def __init__(self, batch_size: int = 32, num_workers: int = 0,
                 image_size: int = 224, max_length: int = 25,
                 vocab_path: Optional[str] = None, seed: int = 0,
                 emit_uint8: bool = False, ranks_per_node: int = 1,
                 **_ignored):
        ranks_per_node = int(ranks_per_node)
        if ranks_per_node < 1 or batch_size % ranks_per_node:
            raise ValueError(
                f"data.batch_size={batch_size} is the batch of one node and "
                f"must divide evenly over its {ranks_per_node} data ranks "
                f"(trainer.devices)")
        #: the node's batch; ``batch_size`` is this rank's share of it
        self.node_batch_size = batch_size
        self.batch_size = batch_size // ranks_per_node
        self.num_workers = num_workers
        self.image_size = image_size
        self.max_length = max_length
        self.vocab_path = vocab_path
        self.seed = seed
        self.emit_uint8 = emit_uint8
        self._tokenizer: Optional[WordPieceTokenizer] = None
        # per-split batch counts (fractional limit_*_batches); None =
        # unknown length
        self.steps_per_epoch: Optional[int] = None
        self.val_steps_per_epoch: Optional[int] = None
        self.test_steps_per_epoch: Optional[int] = None

    @property
    def tokenizer(self) -> WordPieceTokenizer:
        if self._tokenizer is None:
            self._tokenizer = load_or_build_tokenizer(
                vocab_path=self.vocab_path, corpus=self._corpus_fallback())
        return self._tokenizer

    def _corpus_fallback(self) -> Optional[Sequence[str]]:
        return None

    def _process_split(self, rows: List) -> List:
        """This process's stride slice of a globally ordered row list,
        trimmed so every process gets the same count."""
        rank, world = _rank_and_world()
        if world <= 1:
            return rows
        usable = len(rows) - (len(rows) % world)
        return rows[rank:usable:world]

    def _decode(self, load) -> Optional[np.ndarray]:
        """Decode one image. In a single process a failed decode drops the
        sample (webdataset nothrow). With several processes a drop would
        leave this rank a batch short and the others waiting in a
        collective, so the sample becomes a zero image of the configured
        dtype and every rank keeps the count ``_process_split`` gave it."""
        try:
            return load()
        except Exception as exc:
            if _rank_and_world()[1] <= 1:
                return None
            self._decode_failures = getattr(self, "_decode_failures", 0) + 1
            if self._decode_failures <= 3:
                from medmoe_torch.utils.logging import get_logger

                get_logger(__name__).warning(
                    f"decode failed with several processes ({exc}); "
                    f"substituting a zero image to keep per-rank batch "
                    f"counts equal")
            dtype = np.uint8 if self.emit_uint8 else np.float32
            return np.zeros((self.image_size, self.image_size, 3), dtype)

    def _collate(self, images: List[np.ndarray], captions: List[str],
                 labels: List[int]) -> Dict[str, np.ndarray]:
        enc = self.tokenizer.encode_batch(captions, max_length=self.max_length)
        stacked = np.stack(images)
        return {
            "image": stacked if stacked.dtype == np.uint8
            else stacked.astype(np.float32),
            "input_ids": enc["input_ids"],
            "attention_mask": enc["attention_mask"],
            "token_type_ids": enc["token_type_ids"],
            "segment_ids": enc["segment_ids"],
            "cap_lens": enc["cap_lens"],
            "label": np.asarray(labels, dtype=np.int32),
        }

    def _batched(self, samples: Iterator, drop_last: bool = True
                 ) -> Iterator[Dict[str, np.ndarray]]:
        images, captions, labels = [], [], []
        for img, cap, lab in samples:
            images.append(img)
            captions.append(cap)
            labels.append(lab)
            if len(images) == self.batch_size:
                yield self._collate(images, captions, labels)
                images, captions, labels = [], [], []
        if images and not drop_last:
            yield self._collate(images, captions, labels)

    def train_dataloader(self, epoch: int = 0) -> Iterator:
        raise NotImplementedError

    def val_dataloader(self) -> Iterator:
        raise NotImplementedError

    def test_dataloader(self) -> Iterator:
        return self.val_dataloader()

    @property
    def num_classes(self) -> int:
        return 6


class SyntheticDataModule(BaseDataModule):
    """In-memory random pairs — hermetic smoke/bench data (no disk). Sample
    i draws from ``RandomState((seed·100003 + i) mod 2³²)``, so it is
    bit-equal to the JAX package's sample i, whatever the process split.
    With ``emit_uint8`` the image is uint8 0..255 from the same seed (the
    JAX package's module ignores the option and yields floats)."""

    CAPTIONS = [
        "chest xray shows bilateral infiltrates",
        "mri of the brain with contrast enhancement",
        "ct scan of the abdomen appears normal",
        "ultrasound of the thyroid gland with nodule",
        "histopathology slide of stained tissue",
        "fundus photograph of the retina",
    ]

    def __init__(self, num_samples: int = 256, num_classes: int = 6, **kw):
        super().__init__(**kw)
        self.num_samples = num_samples
        self._num_classes = num_classes
        per_process = num_samples // _rank_and_world()[1]
        self.steps_per_epoch = per_process // self.batch_size
        self.val_steps_per_epoch = self.steps_per_epoch
        self.test_steps_per_epoch = self.steps_per_epoch

    def _corpus_fallback(self):
        return self.CAPTIONS

    def _iter(self, seed: int) -> Iterator:
        for i in self._process_split(list(range(self.num_samples))):
            rng = np.random.RandomState((seed * 100_003 + i) % 2**32)
            shape = (self.image_size, self.image_size, 3)
            img = rng.randint(0, 256, shape, dtype=np.uint8) \
                if self.emit_uint8 else rng.randn(*shape).astype(np.float32)
            cls = i % self._num_classes
            yield img, self.CAPTIONS[cls % len(self.CAPTIONS)], cls

    def train_dataloader(self, epoch: int = 0) -> Iterator:
        return self._batched(self._iter(self.seed + epoch))

    def val_dataloader(self) -> Iterator:
        return self._batched(self._iter(self.seed + 10_000))

    @property
    def num_classes(self) -> int:
        return self._num_classes


class UnimedDataModule(BaseDataModule):
    """UniMed webdataset mix (reference src/data/unimed_datamodule.py):
    tar shards with {jpg|png, txt, cls}, resampled shard sampling, caption
    template sampling, modality label for router supervision."""

    # the cls label space, as defined by the auto-labeler scripts (reference
    # scripts/label_roco.py:18-25) — the zero-shot eval's default prompt
    # classes for this data
    CLASS_NAMES = ["X-ray", "CT scan", "MRI scan", "Ultrasound",
                   "Histopathology", "Fundus photograph"]

    def __init__(self, train_data_paths: str = "", val_data_paths: str = "",
                 test_data_paths: str = "", data_dir: str = "",
                 resampled: bool = True, shuffle_buffer: int = 5000,
                 weights: Optional[str] = None, pin_memory: bool = False,
                 use_native: bool = False,
                 train_num_samples: Optional[int] = None,
                 val_num_samples: Optional[int] = None, **kw):
        super().__init__(**kw)
        self.train_data_paths = train_data_paths
        self.val_data_paths = val_data_paths
        self.test_data_paths = test_data_paths or val_data_paths
        self.resampled = resampled
        self.shuffle_buffer = shuffle_buffer
        self.weights = weights
        # epoch length of the (possibly resampled, so endless) shard
        # stream: explicit *_num_samples config wins, else sizes.json
        self.steps_per_epoch = self._steps_for(train_data_paths,
                                               train_num_samples)
        self.val_steps_per_epoch = self._steps_for(val_data_paths,
                                                   val_num_samples)
        self.test_steps_per_epoch = self._steps_for(self.test_data_paths,
                                                    val_num_samples)
        # the C++ fused decode → resize → normalize (csrc/medmoe_native.cpp,
        # data/native.py): a throughput option for f32 images. PIL stays
        # the default (its downscale antialiases; the helper's bilinear
        # does not). uint8 images take the PIL resize and the on-device
        # normalize. The library builds here, and a failed build raises.
        self.use_native = bool(use_native) and not self.emit_uint8
        if self.use_native:
            native.load_library()

    def _corpus_fallback(self):
        return SyntheticDataModule.CAPTIONS

    def _steps_for(self, urls: str, num_samples: Optional[int]
                   ) -> Optional[int]:
        if not urls:
            return None
        if num_samples is None:
            num_samples = discover_num_samples(urls)
        if not num_samples:
            return None
        per_process = num_samples // _rank_and_world()[1]
        return max(1, per_process // self.batch_size)

    def _reader(self, urls: str, train: bool) -> WebDatasetReader:
        rank, world = _rank_and_world()
        return WebDatasetReader(
            urls, weights=self.weights if train else None,
            resampled=self.resampled and train,
            seed=self.seed,
            shuffle_buffer=self.shuffle_buffer if train else 0,
            num_processes=world, process_index=rank)

    def _raw_stream(self, reader: WebDatasetReader, epoch: int) -> Iterator:
        """(img_bytes, caption, label) triples in stream order. Captions
        are drawn here, before any parallel decode, so ``num_workers``
        does not change them."""
        rng = random.Random(self.seed * 1_000_003 + epoch)
        for sample in reader.samples(epoch):
            img_bytes = sample.get("jpg") or sample.get("png") \
                or sample.get("jpeg")
            txt = sample.get("txt")
            if img_bytes is None or txt is None:
                continue
            caption = sample_caption(txt.decode("utf-8", "replace"), rng)
            label = int(sample.get("cls", b"0").decode() or 0)
            yield bytes(img_bytes), caption, label

    def _decode_stream(self, reader: WebDatasetReader, epoch: int,
                       train: bool) -> Iterator:
        """Decode: serial when num_workers=0, otherwise chunked parallel
        decode — the C++ helper's thread pool (``mn_decode_batch``) with
        ``use_native``, else a thread pool of ``num_workers`` around the
        PIL transform (the reference's analogue is the 5-worker torch
        DataLoader, configs/data/unimed.yaml)."""
        transform = ImageTransform(self.image_size, train=train,
                                   seed=self.seed + epoch,
                                   normalize_output=not self.emit_uint8)
        raw = self._raw_stream(reader, epoch)
        if self.num_workers and self.num_workers > 0:
            yield from self._parallel_decode(raw, transform)
            return
        for img_bytes, caption, label in raw:
            try:
                if self.use_native:
                    img = native.decode_resize_normalize(img_bytes,
                                                         self.image_size)
                else:
                    img = transform(decode_image(img_bytes))
            except Exception:
                continue          # nothrow (reference log_and_continue)
            yield img, caption, label

    def _parallel_decode(self, raw: Iterator,
                         transform: ImageTransform) -> Iterator:
        """Decode ``num_workers``-wide over batch-sized chunks, in stream
        order. Failed decodes are dropped (nothrow); downstream _batched
        re-packs to exact batch_size."""
        from concurrent.futures import ThreadPoolExecutor

        chunk_size = max(self.batch_size, self.num_workers)

        def decode(item):
            try:
                return transform(decode_image(item[0]))
            except Exception:
                return None

        def decoded(chunk):
            if self.use_native:
                imgs, ok = native.decode_batch(
                    [c[0] for c in chunk], self.image_size,
                    num_threads=self.num_workers)
                for i, (_, caption, label) in enumerate(chunk):
                    if ok[i]:
                        yield imgs[i], caption, label
                return
            for img, (_, caption, label) in zip(pool.map(decode, chunk),
                                                chunk):
                if img is not None:
                    yield img, caption, label

        pool = None if self.use_native \
            else ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            chunk: List = []
            for item in raw:
                chunk.append(item)
                if len(chunk) >= chunk_size:
                    yield from decoded(chunk)
                    chunk = []
            if chunk:
                yield from decoded(chunk)
        finally:
            if pool is not None:
                pool.shutdown(wait=False)

    def train_dataloader(self, epoch: int = 0) -> Iterator:
        reader = self._reader(self.train_data_paths, train=True)
        return prefetch(
            self._batched(self._decode_stream(reader, epoch, train=True)),
            depth=4)

    def val_dataloader(self) -> Iterator:
        reader = self._reader(self.val_data_paths, train=False)
        return prefetch(
            self._batched(self._decode_stream(reader, 0, train=False)),
            depth=2)


class CheXpertDataModule(BaseDataModule):
    """CheXpert CSV dataset (reference src/data/components/chexpert.py):
    frontal images, 5 competition tasks, uncertain-label mapping per the
    CheXpert paper, aspect-preserving resize + zero-pad."""

    TASKS = ["No Finding", "Enlarged Cardiomediastinum", "Cardiomegaly",
             "Lung Lesion", "Lung Opacity", "Edema", "Consolidation",
             "Pneumonia", "Atelectasis", "Pneumothorax", "Pleural Effusion",
             "Pleural Other", "Fracture", "Support Devices"]
    COMPETITION_TASKS = ["Atelectasis", "Cardiomegaly", "Consolidation",
                         "Edema", "Pleural Effusion"]
    UNCERTAIN_MAPPINGS = {"Atelectasis": 1, "Cardiomegaly": 0,
                          "Consolidation": 0, "Edema": 1,
                          "Pleural Effusion": 1}

    def __init__(self, data_dir: str = "", fraction: float = 1.0,
                 sample_n: Optional[int] = None, img_type: str = "Frontal",
                 pin_memory: bool = False, **kw):
        super().__init__(**kw)
        self.data_dir = data_dir
        self.fraction = fraction
        self.sample_n = sample_n
        self.img_type = img_type

    def _corpus_fallback(self):
        # zero-shot prompts over the task names (scripts/label protocol)
        return [f"this is a photo of {t}" for t in self.TASKS]

    def _read_csv(self, name: str) -> List[Dict[str, str]]:
        path = os.path.join(self.data_dir, name)
        with open(path, newline="") as f:
            return list(csv.DictReader(f))

    def _rows(self, split: str) -> List[Dict[str, Any]]:
        fname = {"train": "train_split.csv", "valid": "valid_split.csv",
                 "test": "valid.csv"}[split]
        if not os.path.exists(os.path.join(self.data_dir, fname)):
            fname = "train.csv" if split == "train" else "valid.csv"
        rows = self._read_csv(fname)
        if self.img_type != "All":
            rows = [r for r in rows
                    if r.get("Frontal/Lateral", "Frontal") == self.img_type]
        if split == "train" and self.fraction < 1.0:
            rng = random.Random(self.seed)
            rows = rng.sample(rows, max(1, int(len(rows) * self.fraction)))
        out = []
        for r in rows:
            label = []
            for task in self.COMPETITION_TASKS:
                v = float(r.get(task) or 0.0)
                if v == -1.0:
                    v = float(self.UNCERTAIN_MAPPINGS[task])
                label.append(v)
            rel = "/".join(r["Path"].split("/")[1:])
            out.append({"path": os.path.join(self.data_dir, rel),
                        "label": np.asarray(label, np.float32),
                        "report": r.get("Report Impression", "")})
        return out

    def _iter(self, rows: List[Dict[str, Any]], train: bool) -> Iterator:
        transform = ImageTransform(self.image_size, pad_to_square=True,
                                   train=train, seed=self.seed)
        for row in rows:
            img = self._decode(lambda: transform(
                decode_image(open(row["path"], "rb").read())))
            if img is None:
                continue
            yield img, row["label"]

    def _label_batched(self, samples: Iterator) -> Iterator:
        images, labels = [], []
        for img, lab in samples:
            images.append(img)
            labels.append(lab)
            if len(images) == self.batch_size:
                yield {"image": np.stack(images),
                       "label": np.stack(labels)}
                images, labels = [], []
        if images:
            yield {"image": np.stack(images), "label": np.stack(labels)}

    def train_dataloader(self, epoch: int = 0) -> Iterator:
        rows = self._rows("train")
        # fresh in-batch negatives every epoch (reference DataLoader
        # shuffle=True); deterministic in (seed, epoch) — identical on every
        # process, so the stride split below is globally disjoint
        random.Random(self.seed * 1_000_003 + epoch).shuffle(rows)
        rows = self._process_split(rows)
        self.steps_per_epoch = max(1, len(rows) // self.batch_size)
        return prefetch(self._label_batched(self._iter(rows, True)))

    def val_dataloader(self) -> Iterator:
        rows = self._process_split(self._rows("valid"))
        self.val_steps_per_epoch = _ceil_div(len(rows), self.batch_size)
        return prefetch(self._label_batched(self._iter(rows, False)))

    def test_dataloader(self) -> Iterator:
        rows = self._process_split(self._rows("test"))
        self.test_steps_per_epoch = _ceil_div(len(rows), self.batch_size)
        return prefetch(self._label_batched(self._iter(rows, False)))

    @property
    def num_classes(self) -> int:
        return len(self.COMPETITION_TASKS)


class CsvDataModule(BaseDataModule):
    """Generic CSV image-caption dataset (reference CsvDataset /
    get_csv_dataset, src/data/data_utils.py:46-62, 493-518): columns for
    image path, caption, and optional class label, custom separator."""

    def __init__(self, data_dir: str = "", csv_path: str = "", sep: str = ",",
                 img_key: str = "filepath", caption_key: str = "title",
                 label_key: str = "cls", pin_memory: bool = False, **kw):
        super().__init__(**kw)
        self.data_dir = data_dir
        self.csv_path = csv_path
        self.sep = sep
        self.img_key = img_key
        self.caption_key = caption_key
        self.label_key = label_key

    def _corpus_fallback(self):
        return SyntheticDataModule.CAPTIONS

    def _rows(self) -> List[Dict[str, str]]:
        with open(self.csv_path, newline="") as f:
            return list(csv.DictReader(f, delimiter=self.sep))

    def _iter(self, rows: List[Dict[str, str]], train: bool) -> Iterator:
        transform = ImageTransform(self.image_size, train=train,
                                   seed=self.seed,
                                   normalize_output=not self.emit_uint8)
        for row in rows:
            path = row.get(self.img_key, "")
            if self.data_dir and not os.path.isabs(path):
                path = os.path.join(self.data_dir, path)
            img = self._decode(lambda path=path: transform(
                decode_image(open(path, "rb").read())))
            if img is None:
                continue
            label = int(float(row.get(self.label_key, 0) or 0))
            yield img, row.get(self.caption_key, ""), label

    def train_dataloader(self, epoch: int = 0) -> Iterator:
        rows = self._rows()
        random.Random(self.seed * 1_000_003 + epoch).shuffle(rows)
        rows = self._process_split(rows)
        self.steps_per_epoch = max(1, len(rows) // self.batch_size)
        return prefetch(self._batched(self._iter(rows, True)))

    def val_dataloader(self) -> Iterator:
        rows = self._process_split(self._rows())
        self.val_steps_per_epoch = _ceil_div(len(rows), self.batch_size)
        return prefetch(self._batched(self._iter(rows, False),
                                        drop_last=False))


class PmcoaDataModule(BaseDataModule):
    """PMC-OA jsonl image-caption pairs with modality labels (reference
    src/data/components/pmcoa.py:100-145)."""

    def __init__(self, data_dir: str = "", ann_path: str = "",
                 pin_memory: bool = False, **kw):
        super().__init__(**kw)
        self.data_dir = data_dir
        self.ann_path = ann_path

    def _corpus_fallback(self):
        return SyntheticDataModule.CAPTIONS

    def _records(self, split: str) -> List[Dict[str, Any]]:
        records = []
        with open(self.ann_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    records.append(json.loads(line))
        n = len(records)
        # deterministic 90/5/5 split
        rng = random.Random(self.seed)
        idx = list(range(n))
        rng.shuffle(idx)
        bounds = {"train": idx[: int(0.9 * n)],
                  "valid": idx[int(0.9 * n): int(0.95 * n)],
                  "test": idx[int(0.95 * n):]}
        return [records[i] for i in bounds[split]]

    def _iter(self, records: List[Dict[str, Any]], train: bool) -> Iterator:
        transform = ImageTransform(self.image_size, norm="pmcoa",
                                   train=train, seed=self.seed)
        for rec in records:
            path = rec.get("image") or rec.get("image_path") or ""
            if not os.path.isabs(path):
                path = os.path.join(self.data_dir, path)
            img = self._decode(lambda path=path: transform(
                decode_image(open(path, "rb").read())))
            if img is None:
                continue
            caption = rec.get("caption") or rec.get("text") or ""
            # float-tolerant like CsvDataModule: a '4.0' annotation label
            # must not kill the epoch mid-stream
            label = int(float(rec.get("label", rec.get("cls", 0)) or 0))
            yield img, caption, label

    def train_dataloader(self, epoch: int = 0) -> Iterator:
        records = self._records("train")
        random.Random(self.seed * 1_000_003 + epoch).shuffle(records)
        records = self._process_split(records)
        self.steps_per_epoch = max(1, len(records) // self.batch_size)
        return prefetch(self._batched(self._iter(records, True)))

    def val_dataloader(self) -> Iterator:
        records = self._process_split(self._records("valid"))
        self.val_steps_per_epoch = _ceil_div(len(records), self.batch_size)
        return prefetch(self._batched(self._iter(records, False),
                                        drop_last=False))


class SlakeDataModule(BaseDataModule):
    """SLAKE VQA json (reference src/data/components/slake.py): filters by
    content_type/language, derives modality + abnormality labels."""

    MODALITIES = {"MRI": 0, "CT": 1, "X-Ray": 2}

    def __init__(self, data_dir: str = "", label_type: str = "modality",
                 content_type: Optional[str] = None, language: str = "en",
                 pin_memory: bool = False, **kw):
        super().__init__(**kw)
        self.data_dir = data_dir
        self.label_type = label_type
        self.content_type = content_type
        self.language = language

    def _corpus_fallback(self):
        return SyntheticDataModule.CAPTIONS

    def _records(self, split: str) -> List[Dict[str, Any]]:
        fname = {"train": "train.json", "valid": "validate.json",
                 "test": "test.json"}[split]
        with open(os.path.join(self.data_dir, fname)) as f:
            records = json.load(f)
        out = []
        for r in records:
            if self.language and r.get("q_lang", "en") != self.language:
                continue
            if self.content_type and r.get("content_type") != self.content_type:
                continue
            out.append(r)
        return out

    def _label(self, rec: Dict[str, Any]) -> int:
        if self.label_type == "modality":
            return self.MODALITIES.get(rec.get("modality", ""), 0)
        if self.label_type == "abnormal":
            qa = (rec.get("question", "") + " " + rec.get("answer", "")).lower()
            return int("abnormal" in qa or "tumor" in qa or "lesion" in qa)
        return int(rec.get("content_type_id", 0))

    def _iter(self, records: List[Dict[str, Any]], train: bool) -> Iterator:
        transform = ImageTransform(self.image_size, norm="slake",
                                   train=train, seed=self.seed)
        for rec in records:
            path = os.path.join(self.data_dir, "imgs",
                                rec.get("img_name", ""))
            img = self._decode(lambda path=path: transform(
                decode_image(open(path, "rb").read())))
            if img is None:
                continue
            caption = (rec.get("question", "") + " "
                       + rec.get("answer", "")).strip()
            yield img, caption, self._label(rec)

    def train_dataloader(self, epoch: int = 0) -> Iterator:
        records = self._records("train")
        random.Random(self.seed * 1_000_003 + epoch).shuffle(records)
        records = self._process_split(records)
        self.steps_per_epoch = max(1, len(records) // self.batch_size)
        return prefetch(self._batched(self._iter(records, True)))

    def val_dataloader(self) -> Iterator:
        records = self._process_split(self._records("valid"))
        self.val_steps_per_epoch = _ceil_div(len(records), self.batch_size)
        return prefetch(self._batched(self._iter(records, False),
                                        drop_last=False))

    @property
    def num_classes(self) -> int:
        return {"modality": 3, "abnormal": 2}.get(self.label_type, 104)
