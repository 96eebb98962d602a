"""Serving from a port bundle: the cases of ``tests/test_serve_bundle.py`` on
the port.  ``RestorationService(bundle_path=...)`` boots from the exported
programs with no Runner (the tests make building one fail), pads requests to
the manifest's size, takes per-request operating points from a
dynamic-point bundle and refuses them on a fixed one; the AOT sidecar
round-trips; and ``python -m diffpir_tpu_torch.server_http --bundle``
answers a request.  Two bundles are exported, once each."""

import io
import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

import diffpir_tpu_torch.serve as serve_mod
from diffpir_tpu_torch.config import load_config
from diffpir_tpu_torch.export import LoadedRestore, save_bundle
from diffpir_tpu_torch.parallel.multihost import free_port
from diffpir_tpu_torch.runner import Runner
from diffpir_tpu_torch.serve import RequestError, RestorationService
from diffpir_tpu_torch.server_http import start_server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 32
B = 2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cfg(**over):
    o = dict(task="inpaint", model_name="tiny_test", iter_num=2, iter_num_U=1,
             batch_size=B, seed=0, save_E=False, save_L=False, dtype="float32",
             noise_level_img=0, recover_known=True)
    o.update(over)
    return load_config(None, o)


@pytest.fixture(scope="module")
def bundle_env(tmp_path_factory):
    """A dynamic-point and a fixed-point bundle of the tiny inpaint restore,
    the config, and requests."""
    td = tmp_path_factory.mktemp("bundle")
    cfg = _cfg()
    runner = Runner(cfg, device="cpu")
    kw = dict(batch=B, height=IMG, width=IMG, platforms=("cpu",), allow_random_weights=True)
    path = save_bundle(runner, str(td / "art"), dynamic_point=True, **kw)
    fixed = save_bundle(runner, str(td / "fixed"), **kw)
    rng = np.random.default_rng(0)
    imgs = rng.random((B, IMG, IMG, 3)).astype(np.float32)
    masks = (rng.random((B, IMG, IMG, 3)) > 0.5).astype(np.float32)
    return cfg, path, fixed, imgs, masks


@pytest.fixture()
def no_runner(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a Runner was built in bundle mode")

    monkeypatch.setattr(serve_mod, "Runner", boom)
    return monkeypatch


def test_bundle_service_boots_without_runner_and_matches_live(bundle_env, no_runner):
    cfg, path, _, imgs, masks = bundle_env
    svc = RestorationService(bundle_path=path, device="cpu")
    assert svc.runner is None and svc.batch == B
    # the manifest's config drives the HTTP manifest fields
    assert svc.cfg.task == "inpaint" and svc.cfg.iter_num == 2
    outs = svc.restore(list(imgs), masks=list(masks), seed=0)
    assert len(outs) == B and outs[0].shape == (IMG, IMG, 3)
    no_runner.undo()
    live = RestorationService(cfg, device="cpu", service_batch=B, allow_random_weights=True)
    want = live.restore(list(imgs), masks=list(masks), seed=0)
    np.testing.assert_allclose(np.stack(outs), np.stack(want), atol=2e-5)


def test_bundle_service_pads_small_requests(bundle_env, no_runner):
    _, path, _, imgs, masks = bundle_env
    svc = RestorationService(bundle_path=path, device="cpu")
    small = imgs[0][: IMG - 5, : IMG - 3]
    out = svc.restore([small], masks=[masks[0][: IMG - 5, : IMG - 3]])
    assert out[0].shape == (IMG - 5, IMG - 3, 3) and np.isfinite(out[0]).all()
    with pytest.raises(RequestError, match="exceeds the bundle"):
        svc.restore([np.zeros((IMG + 1, IMG, 3), np.float32)])
    # a PSF larger than the program's kernel_hw (1 x 1 here)
    with pytest.raises(RequestError, match="exceeds the bundle's compiled PSF"):
        svc.restore([imgs[0]], kernels=[np.full((3, 3), 1.0 / 9.0, np.float32)])


def test_bundle_service_per_request_operating_point(bundle_env, no_runner):
    _, path, _, imgs, masks = bundle_env
    svc = RestorationService(bundle_path=path, device="cpu", max_wait_ms=200.0)
    try:
        futs = [svc.submit(imgs[i], mask=masks[i], lambda_=5.0 + i) for i in range(B)]
        outs = [f.result(timeout=300) for f in futs]
    finally:
        svc.close()
    assert all(np.isfinite(o).all() and o.shape == (IMG, IMG, 3) for o in outs)
    # the rows of one launch, each at its own point, equal the points alone
    alone = [svc.restore([imgs[i]], masks=[masks[i]], seed=4096, lambda_=5.0 + i)[0]
             for i in range(B)]
    both = svc.restore(list(imgs), masks=list(masks), seed=4096, lambda_=[5.0, 6.0])
    assert not np.array_equal(both[0], both[1])
    np.testing.assert_allclose(both[0], alone[0], atol=1e-6)


def test_fixed_point_bundle_rejects_operating_point_override(bundle_env, no_runner):
    _, _, fixed, imgs, _ = bundle_env
    svc = RestorationService(bundle_path=fixed, device="cpu")
    img = np.zeros((IMG, IMG, 3), np.float32)
    with pytest.raises(RequestError, match="bakes its operating point"):
        svc.restore([img] * B, lambda_=2.0)
    with pytest.raises(RequestError, match="bakes its operating point"):
        svc.submit(img, zeta=0.5)


def test_aot_sidecar_roundtrip(bundle_env, no_runner):
    """save_aot writes the programs on this host's device; a fresh load
    boots from them (the portable archive is never read) and matches."""
    _, path, _, imgs, masks = bundle_env
    base = LoadedRestore(path, use_aot=False, device="cpu")
    assert "aot_load_s" not in base.boot_timings
    sidecar = base.save_aot()
    assert sidecar.endswith("aot.cpu.pt2")
    fresh = LoadedRestore(path, device="cpu")
    assert {"manifest_s", "params_load_s", "aot_load_s"} <= set(fresh.boot_timings)
    got = fresh(imgs, mask=masks, seed=0)
    want = base(imgs, mask=masks, seed=0)
    assert "program_load_s" in base.boot_timings
    assert "program_load_s" not in fresh.boot_timings
    np.testing.assert_allclose(got, want, atol=0)
    svc = RestorationService(bundle_path=path, device="cpu")
    assert "aot_load_s" in svc.loaded.boot_timings   # serving boots on the sidecar too
    # a stale sidecar is ignored with a warning, and the archive serves
    with open(sidecar, "wb") as f:
        f.write(b"not an archive")
    with pytest.warns(UserWarning, match="ignoring AOT sidecar"):
        stale = LoadedRestore(path, device="cpu")
    np.testing.assert_allclose(stale(imgs, mask=masks, seed=0), want, atol=0)
    os.remove(sidecar)
    with pytest.raises(ValueError, match="mesh"):
        stale.manifest["mesh"] = {"shape": [2]}
        stale.save_aot()


def test_server_http_serves_a_bundle(bundle_env, no_runner):
    """``python -m diffpir_tpu_torch.server_http --bundle DIR --cpu``: the
    health manifest and one npz restore, equal to the bundle service's
    restore of the same request; ``--bundle`` with ``--opt`` is refused."""
    from diffpir_tpu_torch import server_http

    _, path, _, imgs, masks = bundle_env
    with pytest.raises(SystemExit, match="self-describing"):
        server_http.main(["--bundle", path, "--opt", "x.yaml", "--cpu"])
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.Popen([sys.executable, "-m", "diffpir_tpu_torch.server_http",
                             "--bundle", path, "--cpu", "--port", str(port)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        url = f"http://127.0.0.1:{port}"
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
                    man = json.loads(r.read())
                break
            except OSError:
                if proc.poll() is not None or time.time() > deadline:
                    raise AssertionError(proc.stdout.read() if proc.poll() is not None
                                         else "the server did not come up")
                time.sleep(0.3)
        assert man["task"] == "inpaint" and man["batch"] == B
        body = io.BytesIO()
        np.savez(body, image=imgs[0], mask=masks[0])
        req = urllib.request.Request(url + "/restore", data=body.getvalue(),
                                     headers={"Content-Type": "application/x-npz"})
        with urllib.request.urlopen(req, timeout=300) as r:
            with np.load(io.BytesIO(r.read())) as z:
                restored = z["restored"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    svc = RestorationService(bundle_path=path, device="cpu")
    # the server's worker draws its first launch from seed block 1 << 12
    want = svc.restore([imgs[0]], masks=[masks[0]], seed=1 << 12)[0]
    assert restored.shape == (IMG, IMG, 3)
    np.testing.assert_allclose(restored, want, atol=0)
    # embedded: start_server over a bundle service in this process
    httpd = start_server(svc, port=0)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{httpd.server_address[1]}/healthz", timeout=30) as r:
            assert json.loads(r.read())["model"] == "tiny_test"
    finally:
        httpd.shutdown()
        svc.close()
