"""Data modules: named datasets with train/val/test iterators (counterpart
of medmoe_tpu/data/datamodules.py).

Every training module yields host batches of numpy arrays:
    image          [B, S, S, 3] float32 (NHWC, normalized) or uint8
    input_ids / attention_mask / token_type_ids / segment_ids  [B, T] int32
    cap_lens       [B] int32
    label          [B] int32 (modality class — router supervision)
and exposes ``steps_per_epoch`` when known. ``SyntheticDataModule`` is
ported whole; the disk-backed datasets keep only what serving reads (their
tokenizer and label space) until their loaders are ported. The process
split comes from ``torch.distributed``'s rank and world size. The
constructors take the same config fields as ``medmoe_tpu``'s modules, so
the copied ``configs/data/*.yaml`` instantiate unchanged.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from medmoe_torch.data.tokenizer import (WordPieceTokenizer,
                                         load_or_build_tokenizer)


def _rank_and_world():
    """(rank, world size) of the torch.distributed group, (0, 1) without
    one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class BaseDataModule:
    """Tokenizer resolution and batching shared by every dataset."""

    def __init__(self, batch_size: int = 32, num_workers: int = 0,
                 image_size: int = 224, max_length: int = 25,
                 vocab_path: Optional[str] = None, seed: int = 0,
                 emit_uint8: bool = False, **_ignored):
        self.batch_size = batch_size
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
        raise NotImplementedError(
            f"{type(self).__name__}'s image loading is not ported yet; "
            f"use data=synthetic")

    def val_dataloader(self) -> Iterator:
        raise NotImplementedError(
            f"{type(self).__name__}'s image loading is not ported yet; "
            f"use data=synthetic")

    def test_dataloader(self) -> Iterator:
        return self.val_dataloader()

    @property
    def num_classes(self) -> int:
        return 6


class SyntheticDataModule(BaseDataModule):
    """In-memory random pairs — hermetic smoke/bench data (no disk). Sample
    i draws from ``RandomState((seed·100003 + i) mod 2³²)``, so it is
    bit-equal to the JAX package's sample i, whatever the process split."""

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
            img = rng.randn(self.image_size, self.image_size, 3).astype(
                np.float32)
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
    """UniMed webdataset mix (reference src/data/unimed_datamodule.py)."""

    # the cls label space, as defined by the auto-labeler scripts (reference
    # scripts/label_roco.py:18-25) — the zero-shot eval's default prompt
    # classes for this data
    CLASS_NAMES = ["X-ray", "CT scan", "MRI scan", "Ultrasound",
                   "Histopathology", "Fundus photograph"]

    def _corpus_fallback(self):
        return SyntheticDataModule.CAPTIONS

    @property
    def num_classes(self) -> int:
        return len(self.CLASS_NAMES)


class CheXpertDataModule(BaseDataModule):
    """CheXpert CSV dataset (reference src/data/components/chexpert.py)."""

    TASKS = ["No Finding", "Enlarged Cardiomediastinum", "Cardiomegaly",
             "Lung Lesion", "Lung Opacity", "Edema", "Consolidation",
             "Pneumonia", "Atelectasis", "Pneumothorax", "Pleural Effusion",
             "Pleural Other", "Fracture", "Support Devices"]
    COMPETITION_TASKS = ["Atelectasis", "Cardiomegaly", "Consolidation",
                         "Edema", "Pleural Effusion"]

    def _corpus_fallback(self):
        # zero-shot prompts over the task names (scripts/label protocol)
        return [f"this is a photo of {t}" for t in self.TASKS]

    @property
    def num_classes(self) -> int:
        return len(self.COMPETITION_TASKS)
