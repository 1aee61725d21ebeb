"""Tar shard writer (a copy of medmoe_tpu/data/shard_writer.py; reference
scripts/*_webdataset.py wds.ShardWriter analogue): streams {__key__, jpg,
txt, cls} samples into numbered tar shards.
"""

from __future__ import annotations

import io
import os
import tarfile
import time
from typing import Dict, Optional, Union

Scalar = Union[bytes, str, int, float]


class ShardWriter:
    """Writes samples to ``pattern % shard_index`` tars, rolling over every
    ``maxcount`` samples (reference uses 10k samples/shard,
    scripts/roco_webdataset.py)."""

    def __init__(self, pattern: str, maxcount: int = 10_000):
        self.pattern = pattern
        self.maxcount = maxcount
        self.shard_index = 0
        self.count = 0
        self.total = 0
        self._tar: Optional[tarfile.TarFile] = None
        self._path: Optional[str] = None

    def _open_next(self) -> None:
        self.close()
        path = self.pattern % self.shard_index \
            if "%" in self.pattern else self.pattern
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._tar = tarfile.open(path, "w")
        self._path = path
        self.shard_index += 1
        self.count = 0

    def _record_size(self) -> None:
        """Merge this shard's sample count into the directory's sizes.json
        (the sidecar discover_num_samples / the reference's
        get_dataset_size read for epoch-length accounting)."""
        import json

        sizes_path = os.path.join(os.path.dirname(self._path) or ".",
                                  "sizes.json")
        sizes = {}
        if os.path.exists(sizes_path):
            try:
                with open(sizes_path) as f:
                    sizes = json.load(f)
            except (OSError, ValueError):
                sizes = {}
        sizes[os.path.basename(self._path)] = self.count
        with open(sizes_path, "w") as f:
            json.dump(sizes, f)

    def write(self, sample: Dict[str, Scalar]) -> None:
        if self._tar is None or self.count >= self.maxcount:
            self._open_next()
        key = sample.get("__key__", f"{self.total:09d}")
        if isinstance(key, bytes):
            key = key.decode()
        for ext, value in sample.items():
            if ext == "__key__":
                continue
            if isinstance(value, (int, float)):
                value = str(value)
            if isinstance(value, str):
                value = value.encode("utf-8")
            info = tarfile.TarInfo(name=f"{key}.{ext}")
            info.size = len(value)
            info.mtime = int(time.time())
            self._tar.addfile(info, io.BytesIO(value))
        self.count += 1
        self.total += 1

    def close(self) -> None:
        if self._tar is not None:
            self._tar.close()
            self._tar = None
            self._record_size()

    def __enter__(self) -> "ShardWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
