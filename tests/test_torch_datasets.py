"""The training image pipeline against the JAX package's: Pillow's BOX and
BICUBIC resizes reproduced in numpy (``utils/resample.py``, held to Pillow
itself), and ``load_data``'s batches bit-equal to JAX's on a folder of PNGs
written by ``utils/png.py`` (halving, bicubic scaling, random crop and flip,
class labels, shards), and on a folder of JPEGs, GIFs and PNGs written by
Pillow; a file that cannot be decoded raises, naming its format."""

import os

import numpy as np
import pytest
from PIL import Image

from diffpir_tpu.train import datasets as jdata
from diffpir_tpu_torch.train import datasets as tdata
from diffpir_tpu_torch.utils import resample
from diffpir_tpu_torch.utils.png import write_png


def _image(rng, h, w, c=3, smooth=False):
    if smooth:
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([np.sin(yy / (3.0 + k) + k) * np.cos(xx / (5.0 - k))
                        for k in range(c)], -1) * 120 + 128
        return np.clip(img, 0, 255).astype(np.uint8)
    return rng.integers(0, 256, (h, w, c), dtype=np.uint8)


SIZES = [((37, 53), (18, 26)), ((64, 64), (32, 32)), ((50, 31), (77, 47)),
         ((9, 200), (3, 67)), ((129, 96), (96, 129)), ((40, 40), (40, 13)),
         ((16, 16), (16, 16)), ((301, 7), (150, 3))]


@pytest.mark.parametrize("filt", [resample.BOX, resample.BICUBIC])
@pytest.mark.parametrize("smooth", [False, True], ids=["noise", "smooth"])
def test_resize_equals_pillow(filt, smooth):
    """Every pixel equal to Pillow's (its 8-bit, 22-bit fixed-point
    separable resampler), up- and downscaling, one axis or both, RGB and
    gray."""
    rng = np.random.default_rng(0)
    pil_filter = Image.BOX if filt == resample.BOX else Image.BICUBIC
    for (h, w), (oh, ow) in SIZES:
        for c in (3, 1):
            img = _image(rng, h, w, c, smooth)
            src = img if c == 3 else img[:, :, 0]
            ref = np.asarray(Image.fromarray(src).resize((ow, oh), pil_filter))
            got = resample.resize(src, (ow, oh), filt)
            assert got.shape == ref.shape and got.dtype == np.uint8
            np.testing.assert_array_equal(got, ref, err_msg=f"{(h, w)}->{(oh, ow)} c{c}")


def test_resize_refuses_other_input():
    with pytest.raises(TypeError, match="uint8"):
        resample.resize(np.zeros((4, 4, 3), np.float32), (2, 2), resample.BOX)
    with pytest.raises(ValueError, match="resample"):
        resample.resize(np.zeros((4, 4, 3), np.uint8), (2, 2), "hamming")


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """PNGs of several sizes (some halved before the bicubic step at 16 px),
    RGB and gray, in two classes and a subfolder."""
    root = tmp_path_factory.mktemp("images")
    os.makedirs(root / "sub")
    rng = np.random.default_rng(1)
    shapes = [(70, 50), (40, 33), (16, 24), (130, 65), (33, 33), (48, 100), (21, 17),
              (64, 32), (90, 90)]
    for i, (h, w) in enumerate(shapes):
        img = _image(rng, h, w, 1 if i % 4 == 2 else 3, smooth=i % 2 == 0)
        folder = root / "sub" if i % 3 == 0 else root
        write_png(img if img.shape[2] == 3 else img[:, :, 0],
                  str(folder / f"{'cat' if i % 2 else 'dog'}_{i}.png"))
    return str(root)


@pytest.mark.parametrize("opts", [
    dict(),
    dict(class_cond=True, random_crop=True, seed=3),
    dict(random_flip=False, deterministic=True, shard=1, num_shards=2),
    dict(class_cond=True, random_crop=True, shard=0, num_shards=2, seed=5),
], ids=["default", "classes_crop", "shard1_fixed", "shard0_classes_crop"])
def test_load_data_equals_jax(image_dir, opts):
    kw = dict(data_dir=image_dir, batch_size=2, image_size=16, **opts)
    kw.setdefault("shard", 0)
    kw.setdefault("num_shards", 1)
    ref, got = jdata.load_data(**kw), tdata.load_data(**kw)
    for _ in range(6):   # past the first epoch of every shard
        (ri, rl), (gi, gl) = next(ref), next(got)
        assert gi.dtype == np.float32 and gi.shape == (2, 16, 16, 3)
        np.testing.assert_array_equal(gi, ri)
        if rl is None:
            assert gl is None
        else:
            np.testing.assert_array_equal(gl, rl)
    assert tdata.list_image_files_recursively(image_dir) == \
        jdata.list_image_files_recursively(image_dir)


@pytest.mark.parametrize("opts", [dict(), dict(class_cond=True, random_crop=True, seed=2)],
                         ids=["default", "classes_crop"])
def test_load_data_reads_jpeg_and_gif_as_jax(tmp_path, opts):
    """A training folder of JPEGs (baseline and progressive, 4:2:0 and
    4:4:4, gray), GIFs and a PNG, which the JAX loader reads through
    Pillow: the same batches."""
    rng = np.random.default_rng(4)
    writers = [("jpg", dict(quality=85)), ("jpeg", dict(quality=70, progressive=True)),
               ("gif", {}), ("jpg", dict(quality=95, subsampling=0)), ("png", {}),
               ("jpg", dict(quality=90, gray=True))]
    for i, (ext, kw) in enumerate(writers):
        img = Image.fromarray(_image(rng, 20 + 7 * i, 41 - 3 * i, smooth=i % 2 == 1))
        if kw.pop("gray", False):
            img = img.convert("L")
        img = img.quantize(64) if ext == "gif" else img
        img.save(tmp_path / f"{'cat' if i % 2 else 'dog'}_{i}.{ext}", **kw)
    kw = dict(data_dir=str(tmp_path), batch_size=2, image_size=16, shard=0, num_shards=1,
              **opts)
    ref, got = jdata.load_data(**kw), tdata.load_data(**kw)
    for _ in range(4):
        (ri, rl), (gi, gl) = next(ref), next(got)
        np.testing.assert_array_equal(gi, ri)
        if rl is None:
            assert gl is None
        else:
            np.testing.assert_array_equal(gl, rl)


def test_load_data_refuses_what_it_cannot_read(tmp_path):
    write_png(np.zeros((20, 20, 3), np.uint8), str(tmp_path / "a.png"))
    with open(tmp_path / "b.jpg", "wb") as f:
        f.write(b"\xff\xd8\xff\xe0 not decoded here")
    with pytest.raises(ValueError, match="corrupt JPEG"):
        next(tdata.load_data(data_dir=str(tmp_path), batch_size=2, image_size=8,
                             deterministic=True, random_flip=False))
    with pytest.raises(ValueError, match="batch_size"):
        next(tdata.load_data(data_dir=str(tmp_path), batch_size=3, image_size=8))
