"""HTTP front end of ``serve.RestorationService``, on the standard library.

Port of ``diffpir_tpu/server_http.py``.  A ``ThreadingHTTPServer`` whose
handler threads only parse, validate and queue: each request goes to
``RestorationService.submit``, whose worker thread coalesces concurrent
requests into batch launches, so no handler thread reaches the card.

Endpoints
---------
* ``GET /healthz``: liveness and the bound task and model (JSON).
* ``GET /stats``: request, image and error counters, latency mean and
  p50/p95/p99 over the last 4096 requests (JSON).
* ``POST /restore``: one restoration request.
    - ``Content-Type: application/x-npz``: an ``np.savez`` archive with
      ``image`` ((h, w, C) float [0, 1] degraded observation) and optional
      ``kernel`` ((kh, kw) PSF) and ``mask`` ((h, w[, C]) in {0, 1}); the
      answer is an npz archive with ``restored``.
    - ``Content-Type: image/png``: the degraded image, in any format
      ``utils/imageio.py`` reads (as the JAX server hands the body to
      Pillow), made RGB as Pillow's ``convert("RGB")`` does; the answer is
      the restored PNG.
    - optional ``?lambda=<float>&zeta=<float>``: this request's operating
      point.

A malformed request gets 400 with the ``serve.RequestError`` message, an
unknown route 404, a body over ``max_body_bytes`` 413 before it is read.

    python -m diffpir_tpu_torch.server_http --opt configs/<task>.yaml \
        [--port 8000] [--host 127.0.0.1] [--warmup H W] [--set key=value ...] \
        [--cpu] [--allow-random-weights]
    python -m diffpir_tpu_torch.server_http --bundle DIR [--port ...] [--cpu]

runs on the CUDA card unless ``--cpu`` is given; ``--bundle`` serves an
exported bundle (``export.save_bundle``) instead of building a Runner.  ``start_server(service,
port)`` embeds it and returns the live server (``.shutdown()`` stops it).
Images are decoded by ``utils/imageio.py`` and encoded by ``utils/png.py``.
"""

from __future__ import annotations

import io
import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from diffpir_tpu_torch.serve import RequestError, RestorationService
from diffpir_tpu_torch.utils.imageio import decode_image
from diffpir_tpu_torch.utils.png import encode_png

__all__ = ["start_server", "make_handler", "main"]


class _Stats:
    """Request counters and latency aggregates.  Percentiles are over the
    last ``window`` latencies (a ring buffer); the mean is over all."""

    def __init__(self, window: int = 4096) -> None:
        self.lock = threading.Lock()
        self.requests = 0
        self.images = 0
        self.errors = 0
        self.latency_sum = 0.0
        self._window = deque(maxlen=window)

    def record(self, n_images: int, seconds: float) -> None:
        with self.lock:
            self.requests += 1
            self.images += n_images
            self.latency_sum += seconds
            self._window.append(seconds)

    def error(self) -> None:
        with self.lock:
            self.errors += 1

    def snapshot(self) -> dict:
        with self.lock:
            out = dict(requests=self.requests, images=self.images, errors=self.errors,
                       avg_latency_s=(self.latency_sum / self.requests
                                      if self.requests else 0.0))
            if self._window:
                lat = np.sort(np.asarray(self._window, np.float64))
                for name, q in (("p50", 50.0), ("p95", 95.0), ("p99", 99.0)):
                    out[f"{name}_latency_s"] = float(np.percentile(lat, q))
                out["latency_window"] = int(lat.size)
            return out


def _parse_npz(body: bytes):
    try:
        z = np.load(io.BytesIO(body), allow_pickle=False)
    except (ValueError, OSError) as e:
        raise RequestError(f"body is not an npz archive: {e}") from e
    with z:
        if "image" not in z:
            raise RequestError("npz body must contain an 'image' array")
        image = np.asarray(z["image"], np.float32)
        kernel = np.asarray(z["kernel"], np.float32) if "kernel" in z else None
        mask = np.asarray(z["mask"], np.float32) if "mask" in z else None
    return image, kernel, mask


def _parse_png(body: bytes) -> np.ndarray:
    """An ``image/png`` body -> (h, w, 3) float in [0, 1].  As the JAX
    handler hands the bytes to Pillow, any format that ``utils/imageio.py``
    reads is decoded (by its first bytes), made RGB as Pillow's
    ``convert("RGB")`` does."""
    try:
        u8 = decode_image(body, "RGB")
    except ValueError as e:
        raise RequestError(f"cannot decode the image body: {e}") from e
    return u8.astype(np.float32) / 255.0


def _png_bytes(img01: np.ndarray) -> bytes:
    return encode_png(np.clip(np.rint(img01 * 255.0), 0, 255).astype(np.uint8))


def make_handler(service: RestorationService, stats: _Stats,
                 timeout_s: float = 600.0,
                 max_body_bytes: int = 256 * 1024 * 1024):
    """The request-handler class bound to one service.  ``max_body_bytes``
    refuses larger bodies with 413 before reading them: the length is the
    client's to choose and every connection has its own thread."""
    manifest = dict(
        status="ok", task=service.cfg.task, model=service.cfg.model_name,
        iter_num=service.cfg.iter_num, batch=service.batch,
        n_channels=service.cfg.n_channels,
        sf=service.cfg.sf if service.cfg.task == "sr" else 1)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj: dict) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(200, manifest)
            elif self.path == "/stats":
                self._send_json(200, stats.snapshot())
            else:
                self._send_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/restore":
                self._send_json(404, {"error": f"no route {self.path}"})
                return
            t0 = time.perf_counter()
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > max_body_bytes:
                    stats.error()
                    self._send_json(413, {"error": f"request body {length} bytes "
                                                   f"exceeds cap {max_body_bytes}"})
                    return
                body = self.rfile.read(length)
                ctype = (self.headers.get("Content-Type") or "").split(";")[0]
                as_png = ctype == "image/png"
                if as_png:
                    image, kernel, mask = _parse_png(body), None, None
                elif ctype == "application/x-npz":
                    image, kernel, mask = _parse_npz(body)
                else:
                    raise RequestError(f"unsupported Content-Type {ctype!r} (use "
                                       "application/x-npz or image/png)")
                q = parse_qs(url.query)

                def qfloat(name):
                    if name not in q:
                        return None
                    try:
                        return float(q[name][0])
                    except ValueError:
                        raise RequestError(
                            f"query param {name}={q[name][0]!r} is not a float") from None

                fut = service.submit(image, kernel=kernel, mask=mask,
                                     lambda_=qfloat("lambda"), zeta=qfloat("zeta"))
                restored = fut.result(timeout=timeout_s)
                stats.record(1, time.perf_counter() - t0)
                if as_png:
                    self._send(200, _png_bytes(restored), "image/png")
                else:
                    out = io.BytesIO()
                    np.savez(out, restored=restored)
                    self._send(200, out.getvalue(), "application/x-npz")
            except RequestError as e:
                stats.error()
                self._send_json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — answer 500, keep serving
                stats.error()
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def start_server(service: RestorationService, port: int = 8000,
                 host: str = "127.0.0.1",
                 warmup_hw: Optional[tuple[int, int]] = None,
                 block: bool = False,
                 max_body_bytes: int = 256 * 1024 * 1024) -> ThreadingHTTPServer:
    """Serve ``service`` over HTTP.  ``block=False`` runs the accept loop in
    a daemon thread and returns the server (its ``.server_address`` has the
    port bound for ``port=0``); ``warmup_hw`` runs one batch at that input
    size first."""
    stats = _Stats()
    httpd = ThreadingHTTPServer(
        (host, port), make_handler(service, stats, max_body_bytes=max_body_bytes))
    httpd.daemon_threads = True
    if warmup_hw is not None:
        service.warmup(warmup_hw)
    if block:
        try:
            httpd.serve_forever()
        finally:
            service.close()
        return httpd
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def main(argv: Optional[list[str]] = None) -> None:
    import argparse

    from diffpir_tpu_torch import resolve_device
    from diffpir_tpu_torch.config import load_config, parse_overrides

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--opt", default=None, help="task YAML config")
    ap.add_argument("--bundle", default=None, metavar="DIR",
                    help="serve an exported bundle (diffpir_tpu_torch.export) instead of "
                         "building a Runner; with its sidecar the boot runs no nvcc")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--warmup", type=int, nargs=2, metavar=("H", "W"), default=None,
                    help="run one batch at this input size before serving")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override (repeatable)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--allow-random-weights", action="store_true",
                    help="serve without trained weights (test fixtures only)")
    args = ap.parse_args(argv)
    device = resolve_device(args.cpu)
    if args.bundle is not None:
        if args.opt is not None or args.set:
            raise SystemExit("--bundle is self-describing; drop --opt/--set")
        service = RestorationService(bundle_path=args.bundle, device=device)
    else:
        if args.opt is None:
            raise SystemExit("pass --opt <config.yaml> or --bundle <dir>")
        cfg = load_config(args.opt, parse_overrides(args.set))
        service = RestorationService(cfg, device=device,
                                     allow_random_weights=args.allow_random_weights)
    cfg = service.cfg
    print(f"serving {cfg.task}/{cfg.model_name} on {args.host}:{args.port} ({device})"
          + (f" from bundle {args.bundle}" if args.bundle else ""), flush=True)
    start_server(service, args.port, host=args.host,
                 warmup_hw=tuple(args.warmup) if args.warmup else None, block=True)


if __name__ == "__main__":
    main()
