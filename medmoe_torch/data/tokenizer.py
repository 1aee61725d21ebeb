"""Self-contained WordPiece tokenizer with wordpiece-merge segment ids.

Replaces the reference's HF ``AutoTokenizer`` + per-token python merge loop
(reference med_moe.py:73-79, text_encoder.py:32-90). Two deliberate changes
for TPU:

  1. **Static shapes**: always pads to ``max_length`` (the reference pads
     'longest', which changes the traced shape batch-to-batch and would force
     XLA recompiles). Truncation semantics match HF: [CLS] + max-2 pieces +
     [SEP].
  2. **Merge structure precomputed**: ``segment_ids[b, t]`` is the merged-word
     slot of token ``t``, reproducing the reference's bank-flush algorithm
     (text_encoder.py:48-77) exactly:
       * [CLS] occupies slot 0;
       * a token NOT starting with '##' opens a new slot;
       * '##' continuations join the current slot (summed on device);
       * [SEP] closes the last word and then takes its own slot;
       * padding after [SEP] gets slot -1 (dropped on device).
     ``cap_lens[b]`` = (#merged words not starting with '[') + 1 — the exact
     quantity the local loss consumes (reference medmoe_module.py:221-223).

The tokenizer is vocab-file driven (standard BERT vocab.txt). Without a
vocab file (no network egress in tests), ``build_vocab`` derives a WordPiece
vocab from a corpus so the full pipeline runs hermetically.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def basic_tokenize(text: str, lowercase: bool = False) -> List[str]:
    """BERT BasicTokenizer: clean, whitespace-split, isolate punctuation."""
    out: List[str] = []
    if lowercase:
        text = text.lower()
        text = unicodedata.normalize("NFD", text)
        text = "".join(c for c in text if unicodedata.category(c) != "Mn")
    current = []
    for ch in text:
        if ch.isspace():
            if current:
                out.append("".join(current))
                current = []
        elif _is_punctuation(ch):
            if current:
                out.append("".join(current))
                current = []
            out.append(ch)
        elif unicodedata.category(ch) in ("Cc", "Cf") or ord(ch) in (0, 0xFFFD):
            continue
        else:
            current.append(ch)
    if current:
        out.append("".join(current))
    return out


class WordPieceTokenizer:
    def __init__(self, vocab: Dict[str, int], lowercase: bool = False,
                 max_chars_per_word: int = 100):
        self.vocab = dict(vocab)
        self.ids_to_tokens = {v: k for k, v in self.vocab.items()}
        self.lowercase = lowercase
        self.max_chars_per_word = max_chars_per_word
        for tok in ("[PAD]", "[UNK]", "[CLS]", "[SEP]"):
            if tok not in self.vocab:
                raise ValueError(f"vocab is missing required token {tok}")
        self.pad_id = self.vocab["[PAD]"]
        self.unk_id = self.vocab["[UNK]"]
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]

    @classmethod
    def from_vocab_file(cls, path: str, lowercase: bool = False
                        ) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, lowercase=lowercase)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def wordpiece(self, word: str) -> List[str]:
        """Greedy longest-match-first subword split."""
        if len(word) > self.max_chars_per_word:
            return ["[UNK]"]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return ["[UNK]"]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        pieces: List[str] = []
        for word in basic_tokenize(text, self.lowercase):
            pieces.extend(self.wordpiece(word))
        return pieces

    def encode_batch(self, texts: Sequence[str], max_length: int = 25
                     ) -> Dict[str, object]:
        """Tokenize + pad to static max_length + compute merge structure.

        Returns numpy arrays:
          input_ids / attention_mask / token_type_ids / segment_ids  [B, T]
          cap_lens [B] int32
        and ``sents``: list of merged-word string lists (reference `sents`).
        """
        b = len(texts)
        t = max_length
        input_ids = np.full((b, t), self.pad_id, dtype=np.int32)
        attention_mask = np.zeros((b, t), dtype=np.int32)
        token_type_ids = np.zeros((b, t), dtype=np.int32)
        segment_ids = np.full((b, t), -1, dtype=np.int32)
        cap_lens = np.zeros((b,), dtype=np.int32)
        sents: List[List[str]] = []

        for i, text in enumerate(texts):
            pieces = self.tokenize(text)[: t - 2]
            tokens = ["[CLS]"] + pieces + ["[SEP]"]
            n = len(tokens)
            input_ids[i, :n] = [self.vocab.get(tok, self.unk_id) for tok in tokens]
            attention_mask[i, :n] = 1

            # bank-flush merge (reference text_encoder.py:48-77)
            words: List[str] = []
            slot = -1
            bank_word = ""
            for pos, tok in enumerate(tokens):
                if tok == "[SEP]":
                    if bank_word:
                        words.append(bank_word)
                    slot = len(words)
                    words.append(tok)
                    segment_ids[i, pos] = slot
                    break
                if not tok.startswith("##"):
                    if bank_word:
                        words.append(bank_word)
                    bank_word = tok
                    slot = len(words)
                else:
                    bank_word += tok[2:]
                segment_ids[i, pos] = slot
            padded_words = words + ["[PAD]"] * (t - len(words))
            sents.append(padded_words)
            cap_lens[i] = sum(
                1 for w in padded_words if not w.startswith("[")) + 1

        return {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "token_type_ids": token_type_ids,
            "segment_ids": segment_ids,
            "cap_lens": cap_lens,
            "sents": sents,
        }


def build_vocab(corpus: Iterable[str], max_size: int = 8000,
                lowercase: bool = False) -> Dict[str, int]:
    """Derive a WordPiece-style vocab from a corpus (hermetic test path).

    Whole words get vocab entries; their prefixes/suffix pieces are added so
    that unseen inflections still split instead of hitting [UNK].
    """
    from collections import Counter

    counts: Counter = Counter()
    for text in corpus:
        for word in basic_tokenize(text, lowercase):
            counts[word] += 1

    vocab: Dict[str, int] = {tok: i for i, tok in enumerate(SPECIAL_TOKENS)}

    def add(tok: str) -> None:
        if tok not in vocab and len(vocab) < max_size:
            vocab[tok] = len(vocab)

    # single characters first (guarantee non-[UNK] splits)
    chars = sorted({c for w in counts for c in w})
    for c in chars:
        add(c)
        add("##" + c)
    for word, _ in counts.most_common():
        add(word)
    return vocab


def fixture_vocab_path(name: str = "bio_clinical_bert") -> str:
    """Path of a vocab fixture shipped with the package (offline stand-in
    for the Bio_ClinicalBERT vocab; see scripts/make_vocab_fixture.py)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", f"{name}_vocab.txt")


def load_or_build_tokenizer(vocab_path: Optional[str] = None,
                            corpus: Optional[Iterable[str]] = None,
                            lowercase: bool = False) -> WordPieceTokenizer:
    """Resolution order: explicit vocab file > packaged fixture
    ('fixture:<name>' paths) > corpus-derived toy vocab."""
    if vocab_path and vocab_path.startswith("fixture:"):
        vocab_path = fixture_vocab_path(vocab_path.split(":", 1)[1])
    if vocab_path and os.path.exists(vocab_path):
        return WordPieceTokenizer.from_vocab_file(vocab_path, lowercase)
    if corpus is not None:
        return WordPieceTokenizer(build_vocab(corpus, lowercase=lowercase),
                                  lowercase=lowercase)
    raise FileNotFoundError(
        f"no vocab file at {vocab_path!r} and no corpus to build one from")
