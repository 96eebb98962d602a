"""Restoration as a long-lived service: ``RestorationService`` and ``serve_folder``.

Port of ``diffpir_tpu/serve.py``.  ``RestorationService`` binds one task
config and its model once and serves requests of any size:

  * validation on the caller's thread (channel count, finite values,
    normalised PSF no larger than the image, binary mask, operating point),
    so a malformed request raises ``RequestError`` before it reaches the card;
  * requests grouped by shape, chunked into the service batch (a short chunk
    padded by repeating its first image), each padded to the UNet's deepest
    downsample factor (reflect, or edge where the pad is not smaller than the
    image) and cropped back, at ``sf`` times the size for super-resolution;
  * PSFs zero-padded to a multiple of 8 (or ``kernel_size``) about their
    ``size//2`` centre, which leaves the OTF of ``ops/fft_prox.py`` unchanged;
  * per-image (lambda, zeta);
  * one device section at a time (``self._lock``): every launch of the
    kernels goes through it, whatever thread calls;
  * ``submit``, which returns a ``Future``: a worker thread coalesces queued
    requests into batches (waiting at most ``max_wait_ms``), each launch with
    its own seed block, and ``close`` fails what is still queued;
  * refusal of random weights unless asked for;
  * under a device mesh (``use_mesh``, a process group of several ranks),
    every rank runs the same service and submits the same requests: each
    chunk is padded to the service batch as always, and rank 0 decides how
    many queued requests a coalescing round takes and tells the others
    (``mesh.host_group``), so every rank launches the same batches.

The runner's ``restore_batch(..., fetch=False)`` returns the card's tensors
without waiting, so a chunk's fetch overlaps the next chunk's trajectory.
``serve_folder`` restores a directory of images the same way.

``RestorationService(bundle_path=...)`` boots from an exported bundle
(``export.save_bundle``; ``diffpir_tpu/serve.py:63-102``) instead of a
Runner: the config comes from the manifest, no model is built, and with the
bundle's sidecar (``LoadedRestore.save_aot``) the boot runs no ``nvcc``.
The program's shapes are fixed: each request is padded to the manifest's
H x W and cropped back, a PSF larger than its ``kernel_hw`` is a request
error, ``service_batch`` is ignored, and a fixed-point bundle refuses
call-time (lambda, zeta).  Weight provenance was checked at export.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from diffpir_tpu_torch.config import TaskConfig, load_config
from diffpir_tpu_torch.data import Batch, make_batches, prepare_images
from diffpir_tpu_torch.runner import Runner, overlap_dispatch
from diffpir_tpu_torch.utils import image as im

__all__ = ["RestorationService", "serve_folder", "RequestError"]


class RequestError(ValueError):
    """A malformed restoration request (caught before the card sees it)."""


def _random_weights_error(cfg: TaskConfig) -> RuntimeError:
    return RuntimeError(
        f"no trained weights found for model {cfg.model_name!r} (zoo: "
        f"{cfg.model_zoo!r}) — refusing to serve random-weight restorations. "
        "Pass allow_random_weights=True for test fixtures.")


class RestorationService:
    """Long-lived restoration endpoint over a fixed task configuration, or
    over an exported bundle (``bundle_path``; ``cfg`` then defaults to the
    manifest's and no Runner is built).

    ``device`` defaults to the card (raising when there is none);
    ``device="cpu"`` runs on the CPU."""

    def __init__(self, cfg: Optional[TaskConfig] = None, *,
                 bundle_path: Optional[str] = None,
                 device: Optional[torch.device | str] = None,
                 use_mesh: bool = True,
                 service_batch: Optional[int] = None,
                 max_wait_ms: float = 20.0,
                 kernel_size: Optional[int] = None,
                 allow_random_weights: bool = False):
        self.loaded = None
        self._bundle_hw = None
        if bundle_path is not None:
            from diffpir_tpu_torch.export import load_bundle

            self.loaded = load_bundle(bundle_path, device=device)
            m = self.loaded.manifest
            if cfg is None:
                cfg = load_config(None, overrides=dict(
                    task=m["task"], n_channels=m["n_channels"], model_name=m["model_name"],
                    iter_num=m["iter_num"], batch_size=m["batch"], lambda_=m["lambda_"],
                    zeta=m["zeta"], **(dict(sf=m["sf"]) if m["task"] == "sr" else {})))
            self.cfg = cfg
            self.runner = None
            self.device = self.loaded.device
            self.batch = m["batch"]
            self._bundle_hw = (m["height"], m["width"])
            self._pad_mod = 1  # requests are padded to the manifest's size instead
            if kernel_size is None:
                kernel_size = tuple(m["kernel_hw"])
            mesh = self.loaded.mesh
        else:
            if cfg is None:
                raise ValueError("pass a TaskConfig or bundle_path")
            self.cfg = cfg
            self.runner = Runner(cfg, device=device, use_mesh=use_mesh)
            if self.runner.weights_provenance == "random" and not allow_random_weights:
                raise _random_weights_error(cfg)
            self.device = self.runner.device
            self.batch = service_batch or cfg.batch_size
            mesh = self.runner.mesh
            # deepest downsample factor of the bound model's topology
            self._pad_mod = 2 ** (len(self.runner.model.cfg.channel_mult) - 1)
        # the group over which rank 0 announces each coalescing round
        self._rounds = None if mesh is None else mesh.host_group
        self._leader = not dist.is_initialized() or dist.get_rank() == 0
        # None: round each PSF up to a multiple of 8; an int or a pair: that size
        self._kernel_size = kernel_size
        self._lock = threading.Lock()        # the device section
        self._max_wait = max_wait_ms / 1000.0
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._wlock = threading.Lock()       # worker lifecycle and seed ticks
        self._seed_tick = 0                  # a seed block per drained launch
        self._shutdown = False

    # ------------------------------------------------------------------
    # validation
    # ------------------------------------------------------------------
    def _validate(self, images, kernels, masks) -> None:
        C = self.cfg.n_channels
        for i, img in enumerate(images):
            a = np.asarray(img)
            if a.ndim != 3 or a.shape[-1] != C:
                raise RequestError(f"image[{i}]: expected (h, w, {C}), got {a.shape}")
            if not np.isfinite(a).all():
                raise RequestError(f"image[{i}]: non-finite values")
        if kernels is not None:
            if len(kernels) != len(images):
                raise RequestError("kernels must match images 1:1")
            for i, k in enumerate(kernels):
                ka = np.asarray(k)
                if ka.ndim != 2:
                    raise RequestError(f"kernel[{i}]: expected 2-D PSF, got "
                                       f"shape {ka.shape}")
                if not np.isfinite(ka).all():
                    raise RequestError(f"kernel[{i}]: non-finite values")
                s = float(ka.sum())
                if not 0.99 <= s <= 1.01:
                    raise RequestError(f"kernel[{i}]: PSF must be normalized (sum={s:.4f})")
                h, w = np.asarray(images[i]).shape[:2]
                if ka.shape[0] > h or ka.shape[1] > w:
                    raise RequestError(
                        f"kernel[{i}]: {ka.shape} larger than image ({h},{w})")
        if masks is not None:
            if len(masks) != len(images):
                raise RequestError("masks must match images 1:1")
            for i, m in enumerate(masks):
                ma = np.asarray(m)
                hw = np.asarray(images[i]).shape[:2]
                if ma.shape[:2] != hw:
                    raise RequestError(f"mask[{i}]: shape {ma.shape[:2]} != image {hw}")
                vals = np.unique(ma)
                if not np.isin(vals, (0.0, 1.0)).all():
                    raise RequestError(f"mask[{i}]: must be binary 0/1 (found {vals[:5]})")

    def _validate_point(self, lambda_, zeta) -> None:
        """lambda_/zeta: None, a scalar, or a per-image sequence."""
        m = None if self.loaded is None else self.loaded.manifest
        if m is not None and not m.get("dynamic_point") and (lambda_ is not None
                                                              or zeta is not None):
            raise RequestError(
                f"this bundle bakes its operating point (lambda={m.get('lambda_')}, "
                f"zeta={m.get('zeta')}); re-export with dynamic_point=True to choose "
                "(lambda, zeta) per request")
        if lambda_ is not None:
            lam = np.atleast_1d(np.asarray(lambda_, np.float64))
            if not (np.isfinite(lam).all() and (lam > 0).all()):
                raise RequestError(f"lambda_ must be finite and > 0, got {lambda_}")
        if zeta is not None:
            z = np.atleast_1d(np.asarray(zeta, np.float64))
            if not (np.isfinite(z).all() and ((z >= 0) & (z <= 1)).all()):
                raise RequestError(f"zeta must be in [0, 1], got {zeta}")

    # ------------------------------------------------------------------
    def restore(self, images: Sequence[np.ndarray],
                kernels: Optional[Sequence[np.ndarray]] = None,
                masks: Optional[Sequence[np.ndarray]] = None,
                seed: int = 0, lambda_=None, zeta=None) -> list[np.ndarray]:
        """Restore degraded images, each (h, w, C) float in [0, 1].

        ``kernels``: per-image PSFs (deblur, sr); ``masks``: per-image {0,1}
        masks (inpaint).  ``lambda_``/``zeta`` override the config's
        operating point, as a scalar for the call or a per-image sequence.
        Chunk ``c`` of the call draws its noise from seed ``seed + c``.
        Thread-safe.
        """
        self._validate(images, kernels, masks)
        self._validate_point(lambda_, zeta)
        for name, v in (("lambda_", lambda_), ("zeta", zeta)):
            if v is not None and np.ndim(v) == 1 and len(v) != len(images):
                raise RequestError(f"per-image {name} must match images 1:1 "
                                   f"(got {len(v)} for {len(images)} images)")
        outs: list[Optional[np.ndarray]] = [None] * len(images)
        by_shape: dict[tuple, list[int]] = {}
        for j in range(len(images)):
            by_shape.setdefault(np.asarray(images[j]).shape, []).append(j)

        chunks = []
        for shape, idx_group in by_shape.items():
            h, w = shape[:2]
            if self._bundle_hw is not None:
                # a bundle's program takes exactly the manifest's size
                H, W = self._bundle_hw
                if h > H or w > W:
                    raise RequestError(f"image ({h},{w}) exceeds the bundle's compiled "
                                       f"input size ({H},{W})")
                ph, pw = H - h, W - w
            else:
                # the UNet's skip concatenations need H and W divisible by its
                # deepest downsample factor; outputs are cropped back
                ph, pw = (-h) % self._pad_mod, (-w) % self._pad_mod
            # reflect keeps the content's statistics; it needs pad < size
            pad_mode = "reflect" if (ph < h and pw < w) else "edge"
            for i in range(0, len(idx_group), self.batch):
                chunks.append((idx_group[i:i + self.batch], (h, w), ph, pw, pad_mode))

        def padded(chunk):
            return chunk + [chunk[0]] * (self.batch - len(chunk))

        def prep(chunk, ph, pw, pad_mode):
            idxs = padded(chunk)
            imgs = np.stack([np.asarray(images[j], np.float32) for j in idxs])
            if ph or pw:
                imgs = np.pad(imgs, ((0, 0), (0, ph), (0, pw), (0, 0)), mode=pad_mode)
            if kernels is not None:
                kern = np.stack([self._pad_kernel(kernels[j], imgs.shape[1:3])
                                 for j in idxs])
            else:
                kern = np.ones((self.batch, 1, 1), np.float32)
            if masks is not None:
                mk = np.stack([np.asarray(masks[j], np.float32) for j in idxs])
                if mk.ndim == 3:
                    mk = mk[..., None]
                if ph or pw:
                    # padded as y is, so (y, mask) agree in the margin
                    mk = np.pad(mk, ((0, 0), (0, ph), (0, pw), (0, 0)), mode=pad_mode)
                if mk.shape[-1] == 1:
                    mk = np.repeat(mk, imgs.shape[-1], axis=-1)
            else:
                mk = np.ones_like(imgs)
            return Batch(img_H=np.zeros_like(imgs, dtype=np.uint8), img_L=imgs,
                         kernel=kern, mask=mk, names=[str(j) for j in idxs])

        def per_chunk(v, chunk):
            # a per-image vector sliced to the chunk, padded as prep pads
            if v is None or np.ndim(v) != 1:
                return v
            return np.asarray([v[j] for j in padded(chunk)], np.float32)

        def consume(chunk, hw, was_padded, padded_h, restored):
            if isinstance(restored, tuple):
                restored = restored[0]
            out = restored.cpu().numpy()[:len(chunk)]  # waits for the card
            if was_padded:
                s = out.shape[1] // padded_h  # sf for sr, else 1
                out = out[:, :hw[0] * s, :hw[1] * s]
            for j, o in zip(chunk, out):
                outs[j] = o

        dev = self.device
        on_card = (torch.cuda.device(dev) if dev.type == "cuda"
                   else contextlib.nullcontext())
        pending = None
        for chunk_no, (chunk, hw, ph, pw, pad_mode) in enumerate(chunks):
            batch = prep(chunk, ph, pw, pad_mode)
            with self._lock, on_card:
                if self.loaded is not None:
                    try:
                        restored = self.loaded(
                            batch.img_L, kernel=batch.kernel if kernels is not None else None,
                            mask=batch.mask if masks is not None else None,
                            seed=seed + chunk_no, lambda_=per_chunk(lambda_, chunk),
                            zeta=per_chunk(zeta, chunk), fetch=False)
                    except ValueError as e:
                        # a request the program cannot take, not a server fault
                        raise RequestError(str(e)) from e
                else:
                    restored = self.runner.restore_batch(
                        batch, per_chunk(lambda_, chunk), per_chunk(zeta, chunk),
                        seed=seed + chunk_no, fetch=False)
            if pending is not None:
                consume(*pending)
            pending = (chunk, hw, bool(ph or pw), batch.img_L.shape[1], restored)
        if pending is not None:
            consume(*pending)
        return outs  # type: ignore[return-value]

    def _pad_kernel(self, k, hw: tuple[int, int]) -> np.ndarray:
        """Zero-pad a PSF to the service's kernel size, centre kept at size//2.

        ``ops/fft_prox.psf_to_otf`` rolls by -(size//2), so the PSF's centre
        must land exactly there: floor-centred padding would shift the OTF by
        one pixel whenever the size difference is odd.  With the centre kept,
        the padded PSF has the same OTF."""
        k = np.asarray(k, np.float32)
        tgt = self._kernel_size
        if tgt is not None and np.ndim(tgt) == 0:
            tgt = (int(tgt), int(tgt))
        pads = []
        for ax in range(2):
            size = k.shape[ax]
            t = tgt[ax] if tgt is not None else -(-size // 8) * 8  # multiple of 8
            if self._bundle_hw is not None and size > t:
                raise RequestError(f"kernel dim {size} exceeds the bundle's compiled PSF "
                                   f"size {tuple(tgt)}")
            t = min(max(t, size), hw[ax])  # never larger than the image
            p0 = t // 2 - size // 2
            pads.append((p0, t - size - p0))
        return np.pad(k, tuple(pads))

    # ------------------------------------------------------------------
    # asynchronous coalescing front end
    # ------------------------------------------------------------------
    def submit(self, image: np.ndarray, kernel: Optional[np.ndarray] = None,
               mask: Optional[np.ndarray] = None, lambda_: Optional[float] = None,
               zeta: Optional[float] = None) -> "Future[np.ndarray]":
        """Queue one request; returns a Future of the restored image.

        A worker thread coalesces queued requests into service batches,
        waiting at most ``max_wait_ms`` to fill one; requests at different
        (lambda, zeta) share a batch (per-sample operating points).
        Validation runs here, on the caller's thread."""
        self._validate([image], None if kernel is None else [kernel],
                       None if mask is None else [mask])
        self._validate_point(lambda_, zeta)
        fut: "Future[np.ndarray]" = Future()
        self._queue.put((image, kernel, mask, lambda_, zeta, fut))
        # queued before the worker is ensured: a racing close() then fails
        # this future instead of stranding it
        self._ensure_worker()
        return fut

    def _ensure_worker(self) -> None:
        with self._wlock:
            if self._worker is None or not self._worker.is_alive():
                self._shutdown = False
                self._worker = threading.Thread(target=self._drain, daemon=True)
                self._worker.start()

    def close(self) -> None:
        """Stop the worker and fail the futures still queued.  Idempotent; a
        later ``submit`` starts a new worker."""
        with self._wlock:
            self._shutdown = True
            worker, self._worker = self._worker, None
        if worker is not None:
            worker.join(timeout=5.0)
        while True:
            try:
                *_, fut = self._queue.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RequestError("service closed before request was served"))

    def _announce(self, n: int) -> int:
        """Under a mesh: rank 0's ``n``, on every rank."""
        t = torch.tensor([n], dtype=torch.int64)
        dist.broadcast(t, src=0, group=self._rounds)
        return int(t)

    def _collect(self) -> list:
        """The requests of one coalescing round: the first queued one and
        whatever follows within ``max_wait_ms``, up to four service batches
        (so that restore() overlaps one chunk's fetch with the next chunk's
        trajectory under load)."""
        try:
            group = [self._queue.get(timeout=0.1)]
        except queue.Empty:
            return []
        deadline = time.perf_counter() + self._max_wait
        while len(group) < 4 * self.batch:
            remain = deadline - time.perf_counter()
            if remain <= 0:
                break
            try:
                group.append(self._queue.get(timeout=remain))
            except queue.Empty:
                break
        return group

    def _drain(self) -> None:
        while True:
            if self._rounds is None:
                if self._shutdown:
                    return
                group = self._collect()
                if not group:
                    continue
            else:
                # rank 0 announces every round: its size, -1 when it found
                # nothing (so no rank waits in a collective for long), 0 to
                # stop; the others then take the same requests in the same
                # order (every rank submits the same ones)
                if self._leader:
                    group = [] if self._shutdown else self._collect()
                    n = len(group) if group else (0 if self._shutdown else -1)
                n = self._announce(n if self._leader else 0)
                if n == 0:
                    return
                if n < 0:
                    continue
                if not self._leader:
                    group = [self._queue.get() for _ in range(n)]
            # requests with and without kernels or masks cannot share a batch
            subgroups: dict[tuple, list] = {}
            for g in group:
                subgroups.setdefault((g[1] is not None, g[2] is not None), []).append(g)
            for sub in subgroups.values():
                images = [g[0] for g in sub]
                kernels = [g[1] for g in sub] if sub[0][1] is not None else None
                masks = [g[2] for g in sub] if sub[0][2] is not None else None
                lams = [g[3] for g in sub]
                zetas = [g[4] for g in sub]
                lam = (None if all(v is None for v in lams) else
                       [self.cfg.lambda_ if v is None else v for v in lams])
                zeta = (None if all(v is None for v in zetas) else
                        [self.cfg.zeta if v is None else v for v in zetas])
                # a seed block per launch: coalesced batches must not share
                # one noise stream
                with self._wlock:
                    self._seed_tick += 1
                    seed = self._seed_tick << 12
                try:
                    results = self.restore(images, kernels, masks, seed=seed,
                                           lambda_=lam, zeta=zeta)
                    for (*_, fut), out in zip(sub, results):
                        fut.set_result(out)
                except Exception as e:  # noqa: BLE001 — fail the futures, keep serving
                    for *_, fut in sub:
                        if not fut.done():
                            fut.set_exception(e)

    # ------------------------------------------------------------------
    def warmup(self, hw: tuple[int, int]) -> float:
        """One service batch of zeros at ``hw`` (allocations, cuDNN's
        algorithm choice); returns its seconds."""
        t0 = time.perf_counter()
        self.restore([np.zeros(hw + (self.cfg.n_channels,), np.float32)] * self.batch)
        return time.perf_counter() - t0


def serve_folder(cfg: TaskConfig, in_dir: str, out_dir: str, *,
                 device: Optional[torch.device | str] = None, use_mesh: bool = True,
                 seed: int = 0, allow_random_weights: bool = False) -> dict:
    """Restore every image under ``in_dir`` into ``out_dir`` as
    ``restored_<name>`` (degraded with the config's task pipeline), batch
    ``bi`` from seed ``seed + bi``, dispatching batch i+1 before writing
    batch i.  Under a mesh a short last batch is padded to split over the
    data ranks, and rank 0 alone writes."""
    runner = Runner(cfg, device=device, use_mesh=use_mesh)
    if runner.weights_provenance == "random" and not allow_random_weights:
        raise _random_weights_error(cfg)
    paths = im.list_images(in_dir)
    if not paths:
        raise FileNotFoundError(f"no images under {in_dir!r}")
    batches = make_batches(prepare_images(cfg, paths), cfg.batch_size,
                           pad_to_batch=runner.mesh is not None)
    os.makedirs(out_dir, exist_ok=True)
    n, t0 = 0, time.perf_counter()

    def consume(bi, batch, out, _t0):
        nonlocal n
        if isinstance(out, tuple):
            out = out[0]
        if runner.mesh is None or dist.get_rank() == 0:
            im.imsave_batch(out.cpu().numpy()[:len(batch.names)], batch.names, out_dir,
                            "restored_")
        n += len(batch.names)

    overlap_dispatch(
        batches, lambda bi, b: runner.restore_batch(b, seed=seed + bi, fetch=False),
        consume)
    dt = time.perf_counter() - t0
    return {"n_images": n, "seconds": dt, "images_per_sec": n / dt}
