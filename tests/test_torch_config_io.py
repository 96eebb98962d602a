"""The port's host path against the JAX package: YAML reader and TaskConfig,
the stdlib PNG codec against Pillow, metrics, masks and inpaint inputs."""

import dataclasses
import glob
import io
import os
import struct
import zlib

import numpy as np
import pytest
import yaml
from PIL import Image

from diffpir_tpu import config as jconfig
from diffpir_tpu import data as jdata
from diffpir_tpu.utils import image as jim
from diffpir_tpu_torch import config as tconfig
from diffpir_tpu_torch import data as tdata
from diffpir_tpu_torch.utils import image as tim
from diffpir_tpu_torch.utils import imageio, png
from tests.conftest import REFERENCE_ROOT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = (sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
           + sorted(glob.glob(os.path.join(REFERENCE_ROOT, "configs", "*.yaml"))))
TEST_PNGS = sorted(p for d in ("demo32", "demo64", "demo256")
                   for p in glob.glob(os.path.join(ROOT, "testsets", d, "*.png")))


# ---------------------------------------------------------------------------
# YAML and TaskConfig
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_reader_equals_safe_load(path):
    with open(path) as f:
        text = f.read()
    assert tconfig.read_flat_yaml(text) == yaml.safe_load(text)


def test_yaml_reader_scalar_resolution_equals_safe_load():
    text = "\n".join([
        "a: 1e-5", "b: 1.0e-5", "c: .5", "d: +3", "e: -0.25", "f: yes",
        "g: Off", "h: ~", "i:", "j: 'it''s'", 'k: "x y"', "l: [1, a, 2.5, true]",
        "m: []", "n: x#y  # comment", "o: 1_000", "p: .inf", "q: -.inf",
        "r: some text", "s: 'a # b'", "# full-line comment", "", "t: NULL",
    ])
    assert tconfig.read_flat_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("bad", [
    "a:\n  b: 1", "- 1", "a: {b: 1}", "a: &x 1", "a: *x", "a: |", "a: 0x10",
    "a: 012", "a: 1:30", "a: 2001-12-14", "---", 'a: "x\\ny"', "a: [1, 2",
    "a 1", "a: 1\na: 2",
])
def test_yaml_reader_rejects_what_it_does_not_parse(bad):
    with pytest.raises(ValueError):
        tconfig.read_flat_yaml(bad)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_task_config_equals_jax(path):
    assert _fields(tconfig.load_config(path)) == _fields(jconfig.load_config(path))
    over = dict(iter_num=7, noise_level_img=12.75, noise_level_model=5,
                mask_prob_range=[0.3, 0.6], zeta=0.3)
    assert (_fields(tconfig.load_config(path, over))
            == _fields(jconfig.load_config(path, over)))


def test_unknown_keys_and_sentinel_as_jax(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("task: inpaint\nnoise_level_model: noise_level_img\nnoise_level_img: 10\n")
    assert _fields(tconfig.load_config(str(p))) == _fields(jconfig.load_config(str(p)))
    with pytest.raises(ValueError, match="unknown config keys"):
        tconfig.load_config(str(p), {"not_a_key": 1})


# ---------------------------------------------------------------------------
# PNG codec
# ---------------------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode_with_filters(img: np.ndarray, colour: int) -> bytes:
    """Test-side PNG encoder that cycles the five row filters."""
    h = img.shape[0]
    rows = img.reshape(h, -1).astype(np.int64)
    bpp = img.shape[2] if img.ndim == 3 else 1
    raw = bytearray()
    prior = np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        ftype = y % 5
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if ftype == 0:
            filt = cur
        elif ftype == 1:
            filt = cur - left
        elif ftype == 2:
            filt = cur - prior
        elif ftype == 3:
            filt = cur - (left + prior) // 2
        else:
            filt = cur - np.array([_paeth(a, b, c) for a, b, c in
                                   zip(left, prior, upleft)])
        raw.append(ftype)
        raw.extend((filt % 256).astype(np.uint8).tobytes())
        prior = cur
    return _png(img.shape[1], h, 8, colour, 0, bytes(raw))


@pytest.mark.parametrize("path", TEST_PNGS, ids=lambda p: os.path.relpath(p, ROOT))
def test_png_decodes_testsets_as_pillow(path):
    ours = png.read_png(path)
    with Image.open(path) as im:
        ref = np.asarray(im.convert("RGB"))
        gray = np.asarray(im.convert("L"))
    np.testing.assert_array_equal(ours, ref)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(imageio.decode_image(f.read(), "L"), gray)
    mode, back, _ = png.decode_png(png.encode_png(ours))
    assert mode == "RGB"
    np.testing.assert_array_equal(back, ours)
    with Image.open(io.BytesIO(png.encode_png(ours))) as im:
        np.testing.assert_array_equal(np.asarray(im), ref)


@pytest.mark.parametrize("colour,channels,mode", [
    (0, 1, "L"), (2, 3, "RGB"), (4, 2, "LA"), (6, 4, "RGBA")])
def test_png_all_filters_and_colour_types(colour, channels, mode):
    rng = np.random.default_rng(colour)
    img = rng.integers(0, 256, (23, 17, channels), dtype=np.uint8)
    img[5:12] = img[5:6]  # runs of equal rows and pixels exercise Up/Paeth ties
    data = _encode_with_filters(img if channels > 1 else img[:, :, 0], colour)
    got_mode, pixels, _ = png.decode_png(data)   # as Pillow opens it, alpha dropped
    assert got_mode == ("L" if channels <= 2 else "RGB")
    np.testing.assert_array_equal(pixels, img[:, :, 0] if channels <= 2 else img[:, :, :3])
    with Image.open(io.BytesIO(data)) as im:
        assert im.mode == mode
        np.testing.assert_array_equal(np.asarray(im).reshape(img.shape), img)
        for target in ("RGB", "L"):
            np.testing.assert_array_equal(imageio.decode_image(data, target),
                                          np.asarray(im.convert(target)))


@pytest.mark.parametrize("mode,n_channels", [
    ("RGB", 1), ("RGB", 3), ("RGBA", 1), ("RGBA", 3), ("L", 1), ("L", 3),
    ("LA", 3)])
def test_imread_uint_converts_as_jax(tmp_path, mode, n_channels):
    rng = np.random.default_rng(7)
    shape = {"L": (19, 21), "LA": (19, 21, 2), "RGB": (19, 21, 3),
             "RGBA": (19, 21, 4)}[mode]
    path = str(tmp_path / "x.png")
    Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode).save(path)
    np.testing.assert_array_equal(tim.imread_uint(path, n_channels),
                                  jim.imread_uint(path, n_channels))


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _png(width, height, depth, colour, interlace, raw, extra=b""):
    ihdr = struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + extra
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def test_png_rejects_what_it_does_not_decode(tmp_path):
    raw = bytes(2 * (1 + 2 * 3))
    assert png.decode_png(_png(2, 2, 8, 2, 0, raw))[1].shape == (2, 2, 3)
    with pytest.raises(ValueError, match="bit depth 16, colour type 3"):
        png.decode_png(_png(2, 2, 16, 3, 0, bytes(2 * 5), _chunk(b"PLTE", bytes(3))))
    with pytest.raises(ValueError, match="palette PNG without a PLTE"):
        png.decode_png(_png(2, 2, 8, 3, 0, bytes(2 * 3)))
    with pytest.raises(ValueError, match="interlace method"):
        png.decode_png(_png(2, 2, 8, 2, 2, raw))
    with pytest.raises(ValueError, match="filter type 7"):
        png.decode_png(_png(2, 2, 8, 2, 0, b"\x07" + raw[1:]))
    with pytest.raises(ValueError, match="wrong length"):
        png.decode_png(_png(2, 2, 8, 2, 0, raw[:-1]))
    good = png.encode_png(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(good[:20] + bytes([good[20] ^ 1]) + good[21:])
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a" + good[6:])
    path = str(tmp_path / "p.gif")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).convert("P").save(path)
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(path)


@pytest.mark.parametrize("case", ["interlaced", "16bit", "palette", "pillow_palette"])
def test_png_decodes_what_it_once_refused_as_pillow(tmp_path, case):
    """Adam7 interlacing, 16-bit samples and palettes, which the port's PNG
    reader once refused: now as Pillow reads them."""
    rng = np.random.default_rng(len(case))
    if case == "interlaced":
        rows = rng.integers(0, 256, (5, 7 * 3), dtype=np.uint8)
        # Adam7 of a 5x7 RGB image: each pass's pixels, filter 0 on every row
        img = rows.reshape(5, 7, 3)
        raw = b""
        for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
                               (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)):
            sub = img[y0::dy, x0::dx]
            if sub.size:
                raw += b"".join(b"\x00" + r.tobytes() for r in sub.reshape(sub.shape[0], -1))
        data = _png(7, 5, 8, 2, 1, raw)
    elif case == "16bit":
        v = rng.integers(0, 65536, (3, 4 * 3)).astype(">u2")
        data = _png(4, 3, 16, 2, 0, b"".join(b"\x00" + r.tobytes() for r in v))
    elif case == "palette":
        idx = rng.integers(0, 3, (2, 2), dtype=np.uint8)
        data = _png(2, 2, 8, 3, 0, b"".join(b"\x00" + r.tobytes() for r in idx),
                    _chunk(b"PLTE", rng.integers(0, 256, 9, dtype=np.uint8).tobytes()))
    else:
        path = str(tmp_path / "p.png")
        Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).convert("P").save(path)
        with open(path, "rb") as f:
            data = f.read()
    for target in ("RGB", "L"):
        with Image.open(io.BytesIO(data)) as im:
            np.testing.assert_array_equal(imageio.decode_image(data, target),
                                          np.asarray(im.convert(target)))


# ---------------------------------------------------------------------------
# Metrics, masks and inpaint inputs
# ---------------------------------------------------------------------------

def test_metrics_equal_jax():
    rng = np.random.default_rng(11)
    a = rng.integers(0, 256, (2, 40, 36, 3), dtype=np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-9, 10, a.shape), 0, 255).astype(np.uint8)
    assert tim.psnr(a[0], b[0]) == jim.psnr(a[0], b[0])
    assert tim.psnr(a[0], b[0], border=4) == jim.psnr(a[0], b[0], border=4)
    fa, fb = a / 127.5 - 1, b / 127.5 - 1
    assert tim.psnr_batch(fa, fb) == jim.psnr_batch(fa, fb)
    assert tim.ssim(a[0], b[0]) == jim.ssim(a[0], b[0])
    assert tim.ssim(a[1, :, :, :1], b[1, :, :, :1]) == jim.ssim(a[1, :, :, :1], b[1, :, :, :1])
    np.testing.assert_array_equal(tim.rgb_to_y(a[0]), jim.rgb_to_y(a[0]))
    np.testing.assert_array_equal(tim.rgb_to_y_batch(fa), jim.rgb_to_y_batch(fa))


@pytest.mark.parametrize("overrides", [
    dict(),
    dict(noise_level_img=12.75, seed=3),
    dict(mask_type="box", mask_len_range=[16, 30]),
    dict(mask_type="both", mask_prob_range=[0.2, 0.8]),
    dict(mask_type="extreme", mask_len_range=[20, 21], n_channels=1),
])
def test_prepare_images_bit_for_bit(overrides):
    path = os.path.join(ROOT, "configs", "demo64_inpaint.yaml")
    over = dict(overrides, cwd=ROOT)
    jcfg = jconfig.load_config(path, over)
    tcfg = tconfig.load_config(path, over)
    np.random.seed(jcfg.seed)
    ref = jdata.prepare_images(jcfg)
    np.random.seed(tcfg.seed)
    got = tdata.prepare_images(tcfg)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g["name"] == r["name"]
        for key in ("img_H", "img_L", "mask"):
            assert g[key].dtype == r[key].dtype, key
            np.testing.assert_array_equal(g[key], r[key], err_msg=key)
    tb = tdata.make_batches(got, 3)
    jb = jdata.make_batches(ref, 3)
    assert [b.names for b in tb] == [b.names for b in jb]
    for t, j in zip(tb, jb):
        np.testing.assert_array_equal(t.img_L, j.img_L)
        np.testing.assert_array_equal(t.mask, j.mask)


def test_prepare_images_refuses_unported_tasks():
    """Nothing the port refuses for deblurring any more: DPS_y0 under a
    model axis builds (its gradient runs through the sharded UNet's
    collectives).  DIY motion PSFs (Pillow-rasterised in the JAX package,
    numpy here) go through the data path and the Runner, as do the
    first-order prox of sub_1_analytic=false (guidance), save_LEH and a
    mesh_shape (none in one process, as JAX on one device)."""
    path = os.path.join(ROOT, "configs", "demo64_deblur.yaml")
    cfg = tconfig.load_config(path, dict(use_DIY_kernel=True, blur_mode="motion",
                                         cwd=ROOT))
    np.random.seed(cfg.seed)
    items = tdata.prepare_images(cfg)
    for item in items:
        k = item["kernel"]
        assert k.shape == (cfg.kernel_size, cfg.kernel_size)
        assert abs(float(k.sum()) - 1.0) < 1e-5 and (k >= 0).all()
    from diffpir_tpu_torch.runner import Runner

    dps = Runner(tconfig.load_config(path, dict(mesh_shape=[1, 2], generate_mode="DPS_y0",
                                                cwd=ROOT)), abstract_params=True)
    assert dps.mesh.shape == {"data": 1, "model": 2}
    assert Runner(tconfig.load_config(path, dict(mesh_shape=[1], cwd=ROOT)),
                  device="cpu").mesh is None
    for over in (dict(sub_1_analytic=False), dict(save_LEH=True),
                 dict(use_DIY_kernel=True, blur_mode="motion")):
        Runner(tconfig.load_config(path, dict(over, cwd=ROOT)), device="cpu")