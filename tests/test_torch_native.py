"""The port's C++ decode helper (medmoe_torch/data/native.py over
csrc/medmoe_native.cpp) against the JAX package's (medmoe_tpu/data/
native.py over native/medmoe_native.cpp), each package with its own
library built by g++: tar indexing, single and batched decode → resize →
normalize, bit for bit, and a UnimedDataModule epoch with use_native
bit-equal to JAX's. Skips where g++ or libjpeg's headers are absent."""

import io
import os
import shutil
import subprocess

import numpy as np
import pytest

from medmoe_torch.data import datamodules as tdm
from medmoe_torch.data import native as tnative
from medmoe_torch.data.shard_writer import ShardWriter
from medmoe_tpu.data import datamodules as jdm
from medmoe_tpu.data import native as jnative
from tests.test_torch_data import (_assert_batches_equal, _unimed_kw,
                                   unimed_dir)  # noqa: F401 — a fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Both libraries: the port's built by its own ``build`` (csrc/build),
    JAX's compiled from native/medmoe_native.cpp with its ``build``'s
    command into a temporary directory (nothing is written to native/)
    and loaded in place of any other."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    probe = subprocess.run([gxx, "-E", "-x", "c++", "-"],
                           input="#include <jpeglib.h>\n",
                           capture_output=True, text=True)
    if probe.returncode != 0:
        pytest.skip("jpeglib.h not found")
    tnative.load_library()
    out = str(tmp_path_factory.mktemp("jax_native") / "libmedmoe_native.so")
    subprocess.run([gxx, "-O3", "-shared", "-fPIC", "-std=c++17", "-o", out,
                    os.path.join(ROOT, "native", "medmoe_native.cpp"),
                    "-ljpeg", "-pthread"], check=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB_CANDIDATES", (out,))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_lib_checked", False)
        assert jnative.available()
        yield


def _jpeg(seed, shape, quality=90):
    from PIL import Image

    rng = np.random.RandomState(seed)
    buf = io.BytesIO()
    Image.fromarray((rng.rand(*shape) * 255).astype(np.uint8)).save(
        buf, format="JPEG", quality=quality)
    return buf.getvalue()


# downscale, upscale, square, odd sizes
SHAPES = [(120, 90, 3), (20, 33, 3), (64, 64, 3), (47, 101, 3)]


@pytest.mark.parametrize("norm", ["imagenet", "half", "slake"])
@pytest.mark.parametrize("size", [32, 57])
def test_decode_resize_normalize_bit_equal(libs, size, norm):
    for seed, shape in enumerate(SHAPES):
        jpeg = _jpeg(seed, shape)
        got = tnative.decode_resize_normalize(jpeg, size, norm)
        want = jnative.decode_resize_normalize(jpeg, size, norm)
        assert got.dtype == np.float32 and got.shape == (size, size, 3)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("threads", [0, 1, 3])
def test_decode_batch_bit_equal(libs, threads):
    jpegs = [_jpeg(s, SHAPES[s % 4]) for s in range(7)]
    jpegs[4] = b"not a jpeg"
    got, ok = tnative.decode_batch(jpegs, 40, num_threads=threads)
    want, jok = jnative.decode_batch(jpegs, 40, num_threads=threads)
    assert ok.tolist() == jok.tolist() == [True] * 4 + [False] + [True] * 2
    assert np.array_equal(got[ok], want[jok])
    for i in (0, 6):
        assert np.array_equal(got[i],
                              tnative.decode_resize_normalize(jpegs[i], 40))


def test_corrupt_input_raises_like_jax(libs):
    for mod in (tnative, jnative):
        with pytest.raises(ValueError, match="JPEG decode failed"):
            mod.decode_resize_normalize(b"garbage bytes", 32)


def test_tar_index_equal(libs, tmp_path):
    path = str(tmp_path / "s-000000.tar")
    with ShardWriter(path) as w:
        for i in range(3):
            w.write({"__key__": f"k{i}", "jpg": _jpeg(i, SHAPES[i]),
                     "txt": f"caption {i}", "cls": i})
    index = tnative.tar_index(path)
    assert index == jnative.tar_index(path)
    assert [n for n, _, _ in index] == [f"k{i}.{e}" for i in range(3)
                                        for e in ("jpg", "txt", "cls")]
    name, offset, size = index[1]
    with open(path, "rb") as f:
        f.seek(offset)
        assert f.read(size) == b"caption 0"
    with pytest.raises(OSError):
        tnative.tar_index(str(tmp_path / "missing.tar"))


@pytest.mark.parametrize("num_workers,emit_uint8", [(0, False), (2, False),
                                                    (2, True)])
def test_unimed_epoch_equals_jax(libs, unimed_dir, num_workers,  # noqa: F811
                                 emit_uint8):
    """use_native decodes f32 images through the helper, serially or on its
    thread pool, bit-equal to JAX's loader; uint8 images keep the PIL
    resize in both packages."""
    kw = _unimed_kw(unimed_dir, num_workers=num_workers,
                    emit_uint8=emit_uint8, use_native=True)
    ours, theirs = tdm.UnimedDataModule(**kw), jdm.UnimedDataModule(**kw)
    assert ours.use_native == (not emit_uint8)
    for epoch in (0, 1):
        _assert_batches_equal(ours.train_dataloader(epoch),
                              theirs.train_dataloader(epoch))
    _assert_batches_equal(ours.val_dataloader(), theirs.val_dataloader())
    if not emit_uint8:
        # the helper's bilinear, not PIL's antialiased resize
        pil = tdm.UnimedDataModule(**dict(kw, use_native=False))
        a = next(iter(ours.val_dataloader()))["image"]
        b = next(iter(pil.val_dataloader()))["image"]
        assert a.shape == b.shape and not np.array_equal(a, b)


def test_library_is_keyed_by_source_and_flags(monkeypatch, tmp_path):
    a = tnative.library_path()
    assert a.startswith(tnative.BUILD_DIR) and a.endswith(".so")
    monkeypatch.setattr(tnative, "GXX_FLAGS", tnative.GXX_FLAGS + ("-g",))
    assert tnative.library_path() != a
    src = tmp_path / "medmoe_native.cpp"
    src.write_bytes(open(tnative.SOURCE, "rb").read() + b"\n// edited\n")
    monkeypatch.setattr(tnative, "SOURCE", str(src))
    monkeypatch.setattr(tnative, "GXX_FLAGS", tnative.GXX_FLAGS[:-1])
    assert tnative.library_path() not in (a, None)
