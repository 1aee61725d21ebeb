"""Data modules: the part of each dataset that serving reads.

Serving needs a dataset's tokenizer and its label space, never its
images: ``eval/zero_shot.default_class_names`` reads ``COMPETITION_TASKS``
(CheXpert), ``CLASS_NAMES`` (UniMed) or ``num_classes``, and the class
prompts go through ``tokenizer``. Image loading (webdataset shards, the
CheXpert CSV, synthetic pairs) arrives with the training port. The
constructors take the same config fields as ``medmoe_tpu``'s modules, so
the copied ``configs/data/*.yaml`` instantiate unchanged.
"""

from __future__ import annotations

from typing import Optional, Sequence

from medmoe_torch.data.tokenizer import (WordPieceTokenizer,
                                         load_or_build_tokenizer)


class BaseDataModule:
    """Tokenizer resolution shared by every dataset."""

    def __init__(self, vocab_path: Optional[str] = None, **_loading):
        self.vocab_path = vocab_path
        self._tokenizer: Optional[WordPieceTokenizer] = None

    @property
    def tokenizer(self) -> WordPieceTokenizer:
        if self._tokenizer is None:
            self._tokenizer = load_or_build_tokenizer(
                vocab_path=self.vocab_path, corpus=self._corpus_fallback())
        return self._tokenizer

    def _corpus_fallback(self) -> Optional[Sequence[str]]:
        return None


class SyntheticDataModule(BaseDataModule):
    """In-memory random pairs (hermetic smoke data): its captions are the
    toy tokenizer's corpus when no vocab file is configured."""

    CAPTIONS = [
        "chest xray shows bilateral infiltrates",
        "mri of the brain with contrast enhancement",
        "ct scan of the abdomen appears normal",
        "ultrasound of the thyroid gland with nodule",
        "histopathology slide of stained tissue",
        "fundus photograph of the retina",
    ]

    def __init__(self, num_classes: int = 6, **kw):
        super().__init__(**kw)
        self._num_classes = num_classes

    def _corpus_fallback(self):
        return self.CAPTIONS

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
