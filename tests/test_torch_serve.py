"""The port's serving layer (``serve.py``): the cases of ``tests/test_serve.py``
on the port, the batches the service hands to ``restore_batch`` against the
JAX package's for the same requests, and the service against its own
runner."""

import os
import threading

import numpy as np
import pytest
import torch

from diffpir_tpu import config as jconfig
from diffpir_tpu import serve as jserve
from diffpir_tpu_torch import config as tconfig
from diffpir_tpu_torch.ops.fft_prox import psf_to_otf
from diffpir_tpu_torch.serve import RequestError, RestorationService, serve_folder
from diffpir_tpu_torch.utils import image as im

IMG = 64


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def tiny_env(tmp_path):
    rng = np.random.default_rng(0)
    tdir = tmp_path / "testsets" / "tiny"
    tdir.mkdir(parents=True)
    for i in range(3):
        x = np.zeros((IMG, IMG, 3), np.float32)
        x[:, :] = rng.random(3)
        x[20:44, 20:44] = rng.random(3)
        im.imsave(im.single2uint(x), str(tdir / f"img{i}.png"))
    return tmp_path


def _over(tmp_path, **over):
    o = dict(task="inpaint", model_name="tiny_test", testset_name="tiny",
             cwd=str(tmp_path), iter_num=3, batch_size=2, seed=0,
             save_E=False, save_L=False, dtype="float32", noise_level_img=0,
             mask_prob_range=[0.3, 0.3], recover_known=True)
    o.update(over)
    return o


def _cfg(tmp_path, **over):
    return tconfig.load_config(None, _over(tmp_path, **over))


def _service(tmp_path, cfg_over=None, **kw):
    kw = dict(dict(device="cpu", allow_random_weights=True, service_batch=2), **kw)
    return RestorationService(_cfg(tmp_path, **(cfg_over or {})), **kw)


def _masked(rng, shapes):
    masks = [(rng.random(s) > 0.3).astype(np.float32) for s in shapes]
    imgs = [rng.random(s + (3,)).astype(np.float32) * m[:, :, None]
            for s, m in zip(shapes, masks)]
    return imgs, masks


def test_service_handles_arbitrary_request_sizes(tiny_env):
    svc = _service(tiny_env)
    imgs, masks = _masked(np.random.default_rng(1), [(IMG, IMG)] * 3)
    outs = svc.restore(imgs, masks=masks)  # 3 requests through batches of 2
    assert len(outs) == 3
    for o, img, m in zip(outs, imgs, masks):
        assert o.shape == (IMG, IMG, 3) and np.isfinite(o).all()
        # known pixels recovered (recover_known=True)
        np.testing.assert_allclose(o[m > 0], img[m > 0], atol=1e-5)


def test_serve_folder(tiny_env, tmp_path):
    out_dir = str(tmp_path / "served")
    stats = serve_folder(_cfg(tiny_env), str(tiny_env / "testsets" / "tiny"), out_dir,
                         device="cpu", allow_random_weights=True)
    assert stats["n_images"] == 3
    assert sum(f.startswith("restored_") for f in os.listdir(out_dir)) == 3


def test_request_validation(tiny_env):
    svc = _service(tiny_env)
    rng = np.random.default_rng(2)
    good = rng.random((IMG, IMG, 3)).astype(np.float32)
    good_mask = (rng.random((IMG, IMG)) > 0.5).astype(np.float32)

    with pytest.raises(RequestError, match="expected"):
        svc.restore([good[..., :1]])                       # wrong channels
    bad = good.copy()
    bad[0, 0, 0] = np.nan
    with pytest.raises(RequestError, match="non-finite"):
        svc.restore([bad])
    with pytest.raises(RequestError, match="binary"):
        svc.restore([good], masks=[good_mask * 0.5])
    with pytest.raises(RequestError, match="shape"):
        svc.restore([good], masks=[good_mask[:32]])
    with pytest.raises(RequestError, match="normalized"):
        svc.restore([good], kernels=[np.ones((5, 5), np.float32)])
    with pytest.raises(RequestError, match="larger than image"):
        svc.restore([good], kernels=[np.full((IMG + 5, 5), 0.0, np.float32)
                                     + 1.0 / ((IMG + 5) * 5)])
    with pytest.raises(RequestError, match="1:1"):
        svc.restore([good, good], masks=[good_mask])


def test_mixed_shape_requests_grouped(tiny_env):
    """Requests of different sizes are served per shape; outputs come back in
    request order."""
    svc = _service(tiny_env)
    imgs, masks = _masked(np.random.default_rng(3), [(IMG, IMG), (IMG * 2, IMG), (IMG, IMG)])
    outs = svc.restore(imgs, masks=masks)
    assert [o.shape for o in outs] == [i.shape for i in imgs]
    assert all(np.isfinite(o).all() for o in outs)


def test_non_modulo_sizes_pad_and_crop(tiny_env):
    """H and W not divisible by the UNet's deepest downsample factor are
    padded to it before the card sees them and cropped back."""
    svc = _service(tiny_env)
    assert svc._pad_mod == 8  # tiny config: 4 levels
    imgs, masks = _masked(np.random.default_rng(5), [(50, 52), (61, 45)])
    outs = svc.restore(imgs, masks=masks)
    assert [o.shape for o in outs] == [i.shape for i in imgs]
    for o, img, m in zip(outs, imgs, masks):
        assert np.isfinite(o).all()
        np.testing.assert_allclose(o[m > 0], img[m > 0], atol=1e-5)


def test_sr_non_modulo_pad_and_crop(tiny_env):
    """sf > 1: a padded (h, w) observation is restored at sf times the
    padded size and cropped back to exactly (h*sf, w*sf)."""
    svc = _service(tiny_env, dict(task="sr", sf=2, sr_mode="blur", mask_prob_range=None))
    rng = np.random.default_rng(7)
    imgs = [rng.random(s + (3,)).astype(np.float32) for s in [(30, 26), (32, 32)]]
    outs = svc.restore(imgs)
    assert [o.shape for o in outs] == [(60, 52, 3), (64, 64, 3)]
    assert all(np.isfinite(o).all() for o in outs)


def test_kernel_padding_preserves_otf(tiny_env):
    """_pad_kernel keeps the PSF's centre at size//2, so its OTF (the FFT
    prox's) is bit-identical, the odd size differences included."""
    svc = _service(tiny_env, dict(task="deblur"))
    rng = np.random.default_rng(6)
    for size in (5, 7, 8, 11, 19):
        k = rng.random((size, size)).astype(np.float32)
        k /= k.sum()
        kp = svc._pad_kernel(k, (IMG, IMG))
        assert kp.shape[0] % 8 == 0 and kp.shape[0] >= size
        assert torch.equal(psf_to_otf(torch.from_numpy(kp)[None], (IMG, IMG)),
                           psf_to_otf(torch.from_numpy(k)[None], (IMG, IMG)))
    # a fixed service-wide kernel size
    svc2 = _service(tiny_env, dict(task="deblur"), kernel_size=16)
    shapes = {svc2._pad_kernel(rng.random((s, s)).astype(np.float32), (IMG, IMG)).shape
              for s in (5, 7, 11, 13)}
    assert shapes == {(16, 16)}


def test_close_fails_queued_futures_and_restarts(tiny_env):
    """close() resolves (never strands) queued futures; a later submit starts
    a new worker."""
    svc = _service(tiny_env, max_wait_ms=1.0)
    (img,), (m,) = _masked(np.random.default_rng(7), [(IMG, IMG)])
    release = threading.Event()
    orig = svc.runner.restore_batch

    def slow(batch, *a, **kw):
        release.wait(timeout=60)
        return orig(batch, *a, **kw)

    svc.runner.restore_batch = slow
    futs = [svc.submit(img, mask=m) for _ in range(6)]
    release.set()
    svc.close()
    svc.runner.restore_batch = orig
    resolved = 0
    for f in futs:
        try:
            assert np.isfinite(f.result(timeout=120)).all()
            resolved += 1
        except RequestError as e:
            assert "closed" in str(e)
    assert resolved >= 1  # the group in flight completes; none hangs
    fut = svc.submit(img, mask=m)  # a new worker after close
    assert np.isfinite(fut.result(timeout=300)).all()
    svc.close()


def test_drain_launches_use_distinct_seeds(tiny_env):
    """Coalesced launches never share one noise stream."""
    svc = _service(tiny_env, max_wait_ms=1.0)
    seeds = []
    orig = svc.runner.restore_batch

    def recording(batch, *a, seed=0, **kw):
        seeds.append(seed)
        return orig(batch, *a, seed=seed, **kw)

    svc.runner.restore_batch = recording
    (img,), (m,) = _masked(np.random.default_rng(8), [(IMG, IMG)])
    for _ in range(3):
        svc.submit(img, mask=m).result(timeout=300)
    svc.close()
    assert len(seeds) == len(set(seeds)) == 3, seeds


def test_submit_coalesces_concurrent_requests(tiny_env):
    """Concurrent submits share launches: four requests, batches of two."""
    svc = _service(tiny_env, max_wait_ms=300.0)
    imgs, masks = _masked(np.random.default_rng(4), [(IMG, IMG)] * 4)
    svc.warmup((IMG, IMG))
    calls = []
    orig = svc.runner.restore_batch

    def counting(batch, *a, **kw):
        calls.append(len(batch.names))
        return orig(batch, *a, **kw)

    svc.runner.restore_batch = counting
    futs = [svc.submit(i, mask=m) for i, m in zip(imgs, masks)]
    outs = [f.result(timeout=300) for f in futs]
    svc.close()
    assert all(o.shape == (IMG, IMG, 3) and np.isfinite(o).all() for o in outs)
    # at most 3 launches for 4 requests: one carried 2 coalesced requests
    assert len(calls) <= 3


def test_service_refuses_random_weights(tiny_env, monkeypatch):
    with pytest.raises(RuntimeError, match="random"):
        RestorationService(_cfg(tiny_env), device="cpu", service_batch=2)
    with pytest.raises(RuntimeError, match="random"):
        serve_folder(_cfg(tiny_env), str(tiny_env / "testsets" / "tiny"),
                     str(tiny_env / "out"), device="cpu")
    # a bundle's weights were vetted at export, which refuses random ones
    # unless asked; the service boots from one without building a runner
    from diffpir_tpu_torch import serve as serve_mod
    from diffpir_tpu_torch.export import save_bundle
    from diffpir_tpu_torch.runner import Runner

    runner = Runner(_cfg(tiny_env, iter_num=2), device="cpu")
    with pytest.raises(RuntimeError, match="random"):
        save_bundle(runner, str(tiny_env / "bundle"), batch=2, height=IMG, width=IMG,
                    platforms=("cpu",))
    path = save_bundle(runner, str(tiny_env / "bundle"), batch=2, height=IMG, width=IMG,
                       platforms=("cpu",), allow_random_weights=True)

    def no_runner(*a, **k):
        raise AssertionError("a Runner was built in bundle mode")

    monkeypatch.setattr(serve_mod, "Runner", no_runner)
    svc = RestorationService(bundle_path=path, device="cpu")
    assert svc.runner is None and svc.loaded is not None
    assert svc.batch == 2 and svc.cfg.task == "inpaint" and svc.cfg.iter_num == 2


def test_per_request_operating_point(tiny_env):
    """(lambda, zeta) per request: distinct points give distinct outputs and
    share one launch, whose rows equal the points run alone."""
    svc = _service(tiny_env, dict(task="deblur"), max_wait_ms=200.0)
    rng = np.random.default_rng(7)
    img = rng.random((IMG, IMG, 3)).astype(np.float32)
    k = np.full((5, 5), 1.0 / 25.0, np.float32)
    launches = []
    orig = svc.runner.restore_batch

    def counting(batch, lam=None, zeta=None, **kw):
        launches.append(np.ndim(lam))
        return orig(batch, lam, zeta, **kw)

    svc.runner.restore_batch = counting
    futs = [svc.submit(img, kernel=k, lambda_=lam) for lam in (0.01, 400.0)]
    o_lo, o_hi = (f.result(timeout=600) for f in futs)
    svc.close()
    svc.runner.restore_batch = orig
    assert np.abs(o_lo - o_hi).max() > 1e-3
    assert launches == [1], launches  # one launch with per-sample lambda
    v = svc.restore([img, img], kernels=[k, k], lambda_=[0.01, 400.0], seed=9)
    a = svc.restore([img, img], kernels=[k, k], lambda_=0.01, seed=9)
    b = svc.restore([img, img], kernels=[k, k], lambda_=400.0, seed=9)
    np.testing.assert_allclose(v[0], a[0], atol=1e-5)
    np.testing.assert_allclose(v[1], b[1], atol=1e-5)
    r1 = svc.restore([img], kernels=[k], zeta=0.0)[0]
    r2 = svc.restore([img], kernels=[k], zeta=1.0)[0]
    assert np.abs(r1 - r2).max() > 1e-3
    for bad in (dict(lambda_=-1.0), dict(lambda_=float("nan")),
                dict(zeta=1.5), dict(zeta=-0.1)):
        with pytest.raises(RequestError):
            svc.submit(img, kernel=k, **bad)
    with pytest.raises(RequestError):
        svc.restore([img], kernels=[k], lambda_=[1.0, 2.0])  # 2 lambdas, 1 image


def _record_both(tmp_path, monkeypatch, cfg_over, svc_kw):
    """A JAX service and a port service on the same config, each with its
    runner's restore_batch replaced by a recorder that returns the
    observation repeated sf times (nearest), plus its row number."""
    over = _over(tmp_path, **cfg_over)
    jsvc = jserve.RestorationService(jconfig.load_config(None, over), use_mesh=False,
                                     allow_random_weights=True, **svc_kw)
    tsvc = RestorationService(tconfig.load_config(None, over), device="cpu",
                              allow_random_weights=True, **svc_kw)
    sf = over.get("sf", 1) if over["task"] == "sr" else 1
    records = {"jax": [], "torch": []}

    def recorder(side):
        def restore_batch(batch, lambda_=None, zeta=None, seed=0, fetch=True):
            records[side].append((batch, lambda_, zeta, seed))
            out = np.repeat(np.repeat(batch.img_L, sf, axis=1), sf, axis=2)
            out = out + np.arange(len(out), dtype=np.float32)[:, None, None, None]
            return out if side == "jax" else torch.from_numpy(out)
        return restore_batch

    monkeypatch.setattr(jsvc.runner, "restore_batch", recorder("jax"))
    monkeypatch.setattr(tsvc.runner, "restore_batch", recorder("torch"))
    return jsvc, tsvc, records


def _assert_same_launches(records):
    assert len(records["jax"]) == len(records["torch"]) > 0
    for (jb, jl, jz, js), (tb, tl, tz, ts) in zip(records["jax"], records["torch"]):
        for field in ("img_H", "img_L", "kernel", "mask"):
            a, b = getattr(jb, field), getattr(tb, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(b, a, err_msg=field)
        assert tb.names == jb.names and tb.init is None and jb.init is None
        for a, b in ((jl, tl), (jz, tz)):
            assert (a is None) == (b is None)
            if a is not None:
                assert np.ndim(a) == np.ndim(b)
                np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        assert ts == js


@pytest.mark.parametrize("case", ["inpaint", "deblur", "sr"])
def test_batches_handed_to_restore_batch_match_jax(tiny_env, monkeypatch, case):
    """For the same requests the two services hand restore_batch bit-equal
    batches (pads, padded PSFs and masks), per-chunk (lambda, zeta) and
    seeds, and crop the same outputs back."""
    rng = np.random.default_rng(10)
    shapes = [(50, 52), (64, 64), (50, 52), (61, 45), (3, 6), (50, 52)]
    imgs = [rng.random(s + (3,)).astype(np.float32) for s in shapes]
    kw = {}
    if case == "inpaint":
        cfg_over, svc_kw = {}, dict(service_batch=2)
        kw["masks"] = [(rng.random(s) > 0.4).astype(np.float32) if i % 2 else
                       (rng.random(s + (3,)) > 0.4).astype(np.float32)
                       for i, s in enumerate(shapes)]
        kw["lambda_"] = [0.5, 1.0, 2.0, 4.0, 8.0, 16.0]
    elif case == "deblur":
        cfg_over, svc_kw = dict(task="deblur"), dict(service_batch=2)
        kernels = []
        for s, ks in zip(shapes, (5, 19, 7, 11, 3, 8)):
            k = rng.random((ks, ks)).astype(np.float32)
            kernels.append(k / k.sum())
        kw["kernels"] = kernels
        kw["zeta"] = 0.3
    else:
        cfg_over, svc_kw = dict(task="sr", sf=2, sr_mode="blur",
                                mask_prob_range=None), dict(service_batch=4)
    jsvc, tsvc, records = _record_both(tiny_env, monkeypatch, cfg_over, svc_kw)
    jout = jsvc.restore(imgs, seed=5, **kw)
    tout = tsvc.restore(imgs, seed=5, **kw)
    _assert_same_launches(records)
    assert len(tout) == len(jout) == len(imgs)
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(b, a)
    if case == "deblur":  # the padded PSFs are multiples of 8
        assert {r[0].kernel.shape[1] % 8 for r in records["torch"]} == {0}


def test_coalesced_submits_hand_the_same_batches_as_jax(tiny_env, monkeypatch):
    """Queued requests at mixed operating points drain into the same
    launches, seed blocks included."""
    jsvc, tsvc, records = _record_both(tiny_env, monkeypatch, {},
                                       dict(service_batch=2, max_wait_ms=500.0))
    imgs, masks = _masked(np.random.default_rng(11), [(IMG, IMG)] * 3)
    lams = [None, 3.0, None]
    for svc in (jsvc, tsvc):
        futs = [svc.submit(i, mask=m, lambda_=lam) for i, m, lam in zip(imgs, masks, lams)]
        [f.result(timeout=60) for f in futs]
        svc.close()
    _assert_same_launches(records)


def test_service_restore_equals_its_runners_restore_batch(tiny_env):
    """service.restore on a chunk equals runner.restore_batch on the padded
    batch the service built, at the same seed (equality expected; bound
    1e-6)."""
    svc = _service(tiny_env)
    imgs, masks = _masked(np.random.default_rng(12), [(50, 52), (50, 52)])
    handed = []
    orig = svc.runner.restore_batch

    def recording(batch, *a, seed=0, **kw):
        handed.append((batch, seed))
        return orig(batch, *a, seed=seed, **kw)

    svc.runner.restore_batch = recording
    outs = svc.restore(imgs, masks=masks, seed=17)
    svc.runner.restore_batch = orig
    (batch, seed), = handed
    assert seed == 17 and batch.img_L.shape == (2, 56, 56, 3)
    direct = svc.runner.restore_batch(batch, seed=17)
    for j, o in enumerate(outs):
        assert np.abs(o - direct[j, :50, :52]).max() <= 1e-6
