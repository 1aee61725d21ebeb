"""Webdataset-style tar shard engine, dependency-free (a copy of
medmoe_tpu/data/shards.py: the same seeds, so the same shard order and
shuffle buffer as the JAX package's loaders).

Re-implements the subset of the webdataset pipeline the reference uses
(reference src/data/data_utils.py: expand_urls :145-164, detshuffle2
:302-335, ResampledShards2 :338-384, tarfile_to_samples_nothrow /
group_by_keys_nothrow :254-289, split_by_node/split_by_worker :421-422,
sample shuffle buffer :427-434) without the webdataset package:

  * ``expand_urls`` — ``::``-separated multi-source strings with brace
    ranges ``{000001..001047}`` and optional per-source weights;
  * ``iterate_tar`` — fault-tolerant tar streaming: corrupt members /
    truncated archives are skipped, never raised (the reference's
    log_and_continue / nothrow semantics, data_utils.py:248-289);
  * ``group_by_keys`` — members sharing a basename-before-first-dot key
    become one sample dict {ext: bytes};
  * deterministic epoch-seeded shard shuffling and weighted resampling;
  * shard splitting by (process, worker), the caller passing the
    ``torch.distributed`` rank and world size — the analogue of
    wds.split_by_node/split_by_worker.
"""

from __future__ import annotations

import io
import logging
import os
import random
import re
import tarfile
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

log = logging.getLogger(__name__)

_BRACE_RE = re.compile(r"\{(\d+)\.\.(\d+)\}")


def braceexpand(url: str) -> List[str]:
    """Expand one ``{000001..000104}``-style numeric range (recursively)."""
    m = _BRACE_RE.search(url)
    if not m:
        return [url]
    lo, hi = m.group(1), m.group(2)
    width = len(lo)
    out = []
    for i in range(int(lo), int(hi) + 1):
        expanded = url[: m.start()] + str(i).zfill(width) + url[m.end():]
        out.extend(braceexpand(expanded))
    return out


def expand_urls(urls: str | Sequence[str],
                weights: Optional[str | Sequence[float]] = None
                ) -> Tuple[List[str], Optional[List[float]]]:
    """``a-{01..03}.tar::b-{01..02}.tar`` (+ optional ``1.0::2.0`` weights)."""
    if not isinstance(urls, str):
        return list(urls), list(weights) if weights is not None else None
    url_groups = urls.split("::")
    if weights is None:
        all_urls: List[str] = []
        for g in url_groups:
            all_urls.extend(braceexpand(g))
        return all_urls, None
    weight_list = (weights.split("::") if isinstance(weights, str)
                   else list(weights))
    if len(weight_list) != len(url_groups):
        raise ValueError(
            f"got {len(url_groups)} url groups but {len(weight_list)} weights")
    all_urls, all_weights = [], []
    for g, w in zip(url_groups, weight_list):
        expanded = braceexpand(g)
        all_urls.extend(expanded)
        all_weights.extend([float(w)] * len(expanded))
    return all_urls, all_weights


def discover_num_samples(urls: str | Sequence[str]) -> Optional[int]:
    """Total sample count across shards via ``sizes.json`` sidecars.

    The reference discovers shard sizes from a ``sizes.json`` file in each
    shard directory mapping shard basename → sample count (reference
    data_utils.py:166-185 get_dataset_size). Returns None when any shard's
    directory lacks a sizes entry — callers then fall back to configured
    ``num_samples`` or unknown-length semantics.
    """
    expanded, _ = expand_urls(urls)
    sizes_cache: Dict[str, Optional[Dict[str, int]]] = {}
    total = 0
    for url in expanded:
        d = os.path.dirname(url)
        if d not in sizes_cache:
            path = os.path.join(d, "sizes.json")
            try:
                import json

                with open(path) as f:
                    sizes_cache[d] = {k: int(v) for k, v in json.load(f).items()}
            except (OSError, ValueError):
                sizes_cache[d] = None
        sizes = sizes_cache[d]
        if sizes is None or os.path.basename(url) not in sizes:
            return None
        total += sizes[os.path.basename(url)]
    return total


def iterate_tar(path: str) -> Iterator[Tuple[str, bytes]]:
    """Yield (member_name, bytes); skip anything unreadable."""
    try:
        with tarfile.open(path, mode="r|*") as tf:
            for member in tf:
                if not member.isfile():
                    continue
                try:
                    f = tf.extractfile(member)
                    if f is None:
                        continue
                    yield member.name, f.read()
                except (tarfile.TarError, OSError, EOFError) as e:
                    log.warning("skipping corrupt member %s in %s: %r",
                                member.name, path, e)
    except (tarfile.TarError, OSError, EOFError) as e:
        log.warning("skipping unreadable shard %s: %r", path, e)


def group_by_keys(members: Iterable[Tuple[str, bytes]]
                  ) -> Iterator[Dict[str, bytes]]:
    """Group tar members into samples by basename-before-first-dot.

    Tolerates duplicate keys by emitting the current sample and starting a
    fresh one (nothrow semantics, reference data_utils.py:254-281).
    """
    current: Dict[str, bytes] = {}
    current_key: Optional[str] = None
    for name, data in members:
        base = os.path.basename(name)
        key, _, ext = base.partition(".")
        prefix_key = os.path.join(os.path.dirname(name), key)
        if current_key is None:
            current_key = prefix_key
        if prefix_key != current_key or ext in current:
            if current:
                current["__key__"] = current_key.encode()
                yield current
            current = {}
            current_key = prefix_key
        current[ext] = data
    if current:
        current["__key__"] = (current_key or "").encode()
        yield current


class ShardList:
    """Deterministic shard scheduling: epoch-seeded shuffle or weighted
    resampling, split across (process, worker)."""

    def __init__(self, urls: str | Sequence[str],
                 weights: Optional[str | Sequence[float]] = None,
                 resampled: bool = False, seed: int = 0,
                 num_processes: int = 1, process_index: int = 0,
                 num_workers: int = 1, worker_index: int = 0):
        self.urls, self.weights = expand_urls(urls, weights)
        if not self.urls:
            raise ValueError("empty shard list")
        self.resampled = resampled
        self.seed = seed
        self.num_processes = max(num_processes, 1)
        self.process_index = process_index
        self.num_workers = max(num_workers, 1)
        self.worker_index = worker_index

    def for_epoch(self, epoch: int, n: Optional[int] = None) -> List[str]:
        rng = random.Random(self.seed * 1_000_003 + epoch)
        if self.resampled:
            # sample-with-replacement (reference ResampledShards2)
            count = n or len(self.urls)
            picks = rng.choices(self.urls, weights=self.weights, k=count)
        else:
            picks = list(self.urls)
            rng.shuffle(picks)          # detshuffle2: same order every rank
        stride = self.num_processes * self.num_workers
        offset = self.process_index * self.num_workers + self.worker_index
        return picks[offset::stride]


def shuffled(samples: Iterator, buffer_size: int, seed: int) -> Iterator:
    """Streaming shuffle buffer (reference wds.shuffle(bufsize=5000))."""
    rng = random.Random(seed)
    buf: List = []
    for s in samples:
        if len(buf) < buffer_size:
            buf.append(s)
            continue
        idx = rng.randrange(len(buf))
        yield buf[idx]
        buf[idx] = s
    rng.shuffle(buf)
    yield from buf


class WebDatasetReader:
    """tar shards → decoded sample dicts, fault tolerant + deterministic."""

    def __init__(self, urls, weights=None, resampled=False, seed=0,
                 shuffle_buffer=0, num_processes=1, process_index=0,
                 num_workers=1, worker_index=0):
        self.shards = ShardList(urls, weights, resampled, seed,
                                num_processes, process_index,
                                num_workers, worker_index)
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed

    def samples(self, epoch: int = 0) -> Iterator[Dict[str, bytes]]:
        def raw():
            for shard in self.shards.for_epoch(epoch):
                yield from group_by_keys(iterate_tar(shard))

        if self.shuffle_buffer > 1:
            yield from shuffled(raw(), self.shuffle_buffer,
                                seed=hash((self.seed, epoch)) & 0x7FFFFFFF)
        else:
            yield from raw()
