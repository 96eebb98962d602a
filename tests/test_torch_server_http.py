"""The port's HTTP front end (``server_http.py``): the cases of
``tests/test_server_http.py`` on the port, and its PNG path against the JAX
package's Pillow path."""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from diffpir_tpu import server_http as jserver_http
from diffpir_tpu_torch import server_http as tserver_http
from diffpir_tpu_torch.config import load_config
from diffpir_tpu_torch.serve import RestorationService
from diffpir_tpu_torch.server_http import start_server


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _service(task="inpaint", **kw):
    cfg = load_config(None, overrides=dict(
        task=task, model_name="tiny_test", iter_num=2, iter_num_U=1,
        batch_size=2, noise_level_img=0.0, seed=0, dtype="float32",
        save_E=False, save_L=False))
    return RestorationService(cfg, device="cpu", allow_random_weights=True,
                              service_batch=2, **kw)


@pytest.fixture(scope="module")
def server():
    service = _service(max_wait_ms=40.0)
    httpd = start_server(service, port=0)
    host, port = httpd.server_address
    yield f"http://{host}:{port}", service
    httpd.shutdown()
    service.close()


def _post(url, body, ctype, query=""):
    req = urllib.request.Request(url + "/restore" + query, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.headers.get("Content-Type"), r.read()


def _npz_body(**arrs):
    buf = io.BytesIO()
    np.savez(buf, **arrs)
    return buf.getvalue()


def _png(u8, mode=None):
    buf = io.BytesIO()
    Image.fromarray(u8, mode).save(buf, format="PNG")
    return buf.getvalue()


def test_healthz_and_stats(server):
    url, service = server
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        info = json.loads(r.read())
    assert info == dict(status="ok", task="inpaint", model="tiny_test", iter_num=2,
                        batch=2, n_channels=3, sf=1)
    with urllib.request.urlopen(url + "/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert {"requests", "images", "errors", "avg_latency_s"} <= set(stats)


def test_concurrent_npz_requests_coalesce(server):
    url, service = server
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(size=(16, 16, 3)).astype(np.float32) for _ in range(4)]
    masks = [(rng.uniform(size=(16, 16, 3)) > 0.3).astype(np.float32) for _ in range(4)]
    results, errs = [None] * 4, []

    def call(i):
        try:
            ctype, body = _post(url, _npz_body(image=imgs[i] * masks[i], mask=masks[i]),
                                "application/x-npz")
            assert ctype == "application/x-npz"
            with np.load(io.BytesIO(body)) as z:
                results[i] = z["restored"]
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    for r in results:
        assert r is not None and r.shape == (16, 16, 3) and np.isfinite(r).all()


def test_png_roundtrip(server):
    url, _ = server
    u8 = np.random.default_rng(1).integers(0, 256, (16, 16, 3)).astype(np.uint8)
    ctype, body = _post(url, _png(u8), "image/png")
    assert ctype == "image/png"
    assert np.asarray(Image.open(io.BytesIO(body))).shape == (16, 16, 3)


def test_bad_requests_return_400(server):
    url, _ = server
    codes = []
    for body, ctype, route in (
            (b"junk", "text/plain", ""),                                  # content type
            (_npz_body(foo=np.zeros((4, 4, 3), np.float32)), "application/x-npz", ""),
            (_npz_body(image=np.zeros((4, 4), np.float32)), "application/x-npz", ""),
            (b"junk", "application/x-npz", ""),                           # not an npz
            (b"junk", "image/png", ""),                                   # not a PNG
            (b"", "application/x-npz", "/nope")):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + route, body, ctype)
        codes.append(ei.value.code)
    assert codes == [400, 400, 400, 400, 400, 404]


def test_deblur_kernel_request():
    """A deblur service takes a PSF per request over HTTP."""
    service = _service("deblur", max_wait_ms=5.0)
    httpd = start_server(service, port=0)
    try:
        host, port = httpd.server_address
        url = f"http://{host}:{port}"
        img = np.random.default_rng(2).uniform(size=(16, 16, 3)).astype(np.float32)
        k = np.zeros((5, 5), np.float32)
        k[1:4, 1:4] = 1.0 / 9.0
        _, body = _post(url, _npz_body(image=img, kernel=k), "application/x-npz")
        with np.load(io.BytesIO(body)) as z:
            out = z["restored"]
        assert out.shape == (16, 16, 3) and np.isfinite(out).all()
        with pytest.raises(urllib.error.HTTPError) as ei:  # not normalised
            _post(url, _npz_body(image=img, kernel=k * 3.0), "application/x-npz")
        assert ei.value.code == 400
    finally:
        httpd.shutdown()
        service.close()


def test_stats_progress(server):
    url, _ = server
    with urllib.request.urlopen(url + "/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["requests"] >= 5
    assert stats["errors"] >= 5
    assert {"p50_latency_s", "p95_latency_s", "p99_latency_s",
            "latency_window"} <= set(stats)
    assert 0.0 < stats["p50_latency_s"] <= stats["p95_latency_s"] <= stats["p99_latency_s"]
    assert stats["latency_window"] <= stats["requests"]


def test_stats_percentiles_unit():
    st = tserver_http._Stats(window=4)
    assert "p50_latency_s" not in st.snapshot()
    for v in (0.1, 0.2, 0.3, 0.4):
        st.record(1, v)
    s = st.snapshot()
    assert s["p50_latency_s"] == pytest.approx(0.25)
    assert s["p99_latency_s"] == pytest.approx(0.397)
    assert s["avg_latency_s"] == pytest.approx(0.25)
    st.record(1, 0.5)  # the window drops the oldest; the mean keeps it
    s = st.snapshot()
    assert s["latency_window"] == 4
    assert s["p50_latency_s"] == pytest.approx(0.35)
    assert s["avg_latency_s"] == pytest.approx(0.3)


def test_oversized_body_rejected_with_413():
    service = _service()
    httpd = start_server(service, port=0, max_body_bytes=64)
    host, port = httpd.server_address
    try:
        body = _npz_body(image=np.zeros((8, 8, 3), np.float32))
        assert len(body) > 64
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"http://{host}:{port}", body, "application/x-npz")
        assert err.value.code == 413
    finally:
        httpd.shutdown()
        service.close()


def test_query_param_operating_point(server):
    """?lambda=&zeta= set the request's operating point; a bad value is 400."""
    url, _ = server
    rng = np.random.default_rng(5)
    img = rng.random((32, 32, 3)).astype(np.float32)
    mask = (rng.random((32, 32, 3)) > 0.5).astype(np.float32)
    body = _npz_body(image=img * mask, mask=mask)
    outs = []
    for q in ("?lambda=7.0&zeta=0.0", "?lambda=7.0&zeta=1.0"):
        _, raw = _post(url, body, "application/x-npz", q)
        with np.load(io.BytesIO(raw)) as z:
            outs.append(np.asarray(z["restored"]))
    assert np.abs(outs[0] - outs[1]).max() > 1e-3
    for q in ("?lambda=bogus", "?zeta=2"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, body, "application/x-npz", q)
        assert ei.value.code == 400


@pytest.mark.parametrize("mode,channels", [("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)])
def test_parse_png_matches_the_pillow_path(mode, channels):
    """Gray, gray+alpha, RGB and RGBA bodies (encoded by Pillow) become the
    same RGB floats as the JAX package's ``Image.convert("RGB")``."""
    rng = np.random.default_rng(channels)
    u8 = rng.integers(0, 256, (9, 13, channels)).astype(np.uint8)
    body = _png(u8[:, :, 0] if channels == 1 else u8, mode)
    ref = jserver_http._parse_png(body)
    got = tserver_http._parse_png(body)
    assert got.shape == ref.shape == (9, 13, 3) and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    # and the answer's encoder gives what Pillow's does
    img = rng.random((9, 13, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(tserver_http._png_bytes(img)))),
        np.asarray(Image.open(io.BytesIO(jserver_http._png_bytes(img)))))
