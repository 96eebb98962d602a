"""Drives the program under test (``diffpir_tpu_torch``) through one cell.

Set-up builds the port's ``Runner`` for the cell's configuration and
traffic, puts the seed's weights into its UNet through the port's own
checkpoint converter, and warms up with a two-step trajectory of the cell's
shapes (recording the GroupNorm and attention calls of one forward).  The
window then sends requests through ``Runner.restore``, the entry every
restore of the port goes through:

* ``offline``: batches back to back through the port's ``overlap_dispatch``
  (batch i + 1 dispatched before batch i is fetched), as ``Runner.evaluate``
  does;
* ``closed``: one client; each request is dispatched, fetched to the host,
  and only then is the next one made.

Requests are started while the window's seconds last; the window ends when
the last one started has been fetched.  With ``--trace 1``, after the
window, one bounded stretch (one request offline, three closed) runs twice,
as requests one after another: first untraced, then under the profiler.
The window's host-clock metrics are the profiler's to leave untouched; the
profiled stretch gives the card's own work per request, and the two
stretches' seconds per request give the tracing's overhead.
"""

from __future__ import annotations

import copy
import sys
import time

import numpy as np
import torch

from benchmark import arith, traffic as gen
from benchmark.flops import unet_flops
from benchmark.reference.diffpir import quad_timesteps
from benchmark.weights import state_dict

__all__ = ["Program", "device_activities", "read_trace", "kernel_bounds"]

# requests of a closed loop's profiled stretch: a few, so the host's work
# between requests is in it
TRACE_REQUESTS_CLOSED = 3
CONFIG_KEYS = ("image_size", "in_channels", "model_channels", "out_channels",
               "num_res_blocks", "channel_mult", "num_heads", "num_head_channels",
               "use_scale_shift_norm", "resblock_updown")


class Program:
    """The port, built for one cell and one seed on ``device``."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from diffpir_tpu_torch.config import load_config
        from diffpir_tpu_torch.runner import Runner

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        task = traffic["task"]
        over = dict(task=task, model_name=config["model_name"], dtype=config["dtype"],
                    iter_num=traffic["nfe"], skip_type=traffic["skip_type"],
                    lambda_=traffic["lambda"], zeta=traffic["zeta"], eta=traffic["eta"],
                    noise_level_img=traffic["noise_level_img"], batch_size=traffic["batch"],
                    sf=traffic.get("sf", 1), save_E=False, save_L=False)
        if task == "sr":
            over["sr_mode"] = traffic["sr_mode"]
        if task == "deblur":
            over["ty_init"] = traffic.get("ty_init", True)
        if task == "inpaint":
            over["recover_known"] = traffic.get("recover_known", False)
        self.cfg = load_config(None, overrides=over)
        t0 = time.perf_counter()
        self.runner = Runner(self.cfg, device=self.device)
        self._check_config()
        t1 = time.perf_counter()
        self.load_weights(seed)
        t2 = time.perf_counter()
        self.nfe = len(quad_timesteps(1000, traffic["nfe"])) - 1
        self.flops_per_image = unet_flops(config)
        self.calls = self._warm_up()
        print(f"set-up: Runner {t1 - t0:.3f} s, weights {t2 - t1:.3f} s, warm-up "
              f"{time.perf_counter() - t2:.3f} s", file=sys.stderr)

    def _check_config(self) -> None:
        """The port's UNet has the configuration's sizes, or the run stops."""
        mc = self.runner.model.cfg
        port = dict(image_size=mc.image_size, in_channels=mc.in_channels,
                    model_channels=mc.model_channels, out_channels=mc.out_channels,
                    num_res_blocks=mc.num_res_blocks, channel_mult=list(mc.channel_mult),
                    num_heads=mc.num_heads, num_head_channels=mc.num_head_channels,
                    use_scale_shift_norm=mc.use_scale_shift_norm,
                    resblock_updown=mc.resblock_updown)
        want = {k: self.config[k] for k in CONFIG_KEYS}
        if port != want or sorted(mc.attention_resolutions) != sorted(self.config["attention_ds"]):
            raise RuntimeError(f"the port's {self.config['model_name']} is {port}, "
                               f"attention at {mc.attention_resolutions}; the "
                               f"configuration states {want}")

    def load_weights(self, seed: int) -> None:
        """The seed's weights, made on the device in guided-diffusion's
        layout, through the port's checkpoint converter into its UNet."""
        from diffpir_tpu_torch.models.convert import convert_state_dict

        sd = state_dict(self.config, seed, self.device)
        self.runner.model.load_state_dict(convert_state_dict(sd))
        del sd
        self.seed = seed

    def _warm_up(self) -> list:
        """A two-step trajectory of the cell's shapes; returns the GroupNorm
        and attention calls of its first forward."""
        from diffpir_tpu_torch.models.unet import AttentionBlock, GroupNorm32

        calls, handles = [], []

        def gn_hook(mod, args, kwargs):
            film = kwargs.get("film", args[1] if len(args) > 1 else None)
            calls.append(("gn", tuple(args[0].shape), str(args[0].dtype).split(".")[1],
                          film is not None, mod.fuse_silu))

        def attn_hook(mod, args):
            b, hh, ww, c = args[0].shape
            calls.append(("attn", b, hh * ww, mod.num_heads, c // mod.num_heads,
                          str(args[0].dtype).split(".")[1]))

        def first_forward_done(mod, args, out):
            for h in handles:
                h.remove()

        for m in self.runner.model.modules():
            if isinstance(m, GroupNorm32):
                handles.append(m.register_forward_pre_hook(gn_hook, with_kwargs=True))
            elif isinstance(m, AttentionBlock):
                handles.append(m.register_forward_pre_hook(attn_hook))
        handles.append(self.runner.model.register_forward_hook(first_forward_done))
        cfg = self.runner.cfg
        short = copy.copy(cfg)
        short.iter_num = 3      # quad skip: t = 999, 292, 0, two forwards
        self.runner.cfg = short
        try:
            self.fetch(self.restore(self.request(-1)))
        finally:
            self.runner.cfg = cfg
            for h in handles:
                h.remove()
        return calls

    # --- one request ------------------------------------------------------
    def request(self, r: int) -> dict:
        return gen.make_request(self.traffic, self.seed, r, self.device)

    def restore(self, req: dict) -> torch.Tensor:
        t = self.traffic
        return self.runner.restore(req["y"], req["mask"], t["lambda"], t["zeta"], 0,
                                   noise=req["noise"], kernel=req["kernel"])

    @staticmethod
    def fetch(out: torch.Tensor) -> np.ndarray:
        return out.cpu().numpy()

    # --- windows ----------------------------------------------------------
    def window(self, seconds: float, count: int | None = None) -> dict:
        """Requests from index 0 while ``seconds`` last (or exactly ``count``
        of them); returns their outputs on the host and the host-clock
        record."""
        from diffpir_tpu_torch.runner import overlap_dispatch

        outputs, restores, latencies = {}, [], []
        t0 = time.perf_counter()

        def requests():
            r = 0
            while (r < count if count is not None
                   else time.perf_counter() - t0 < seconds):
                yield r
                r += 1

        def dispatch(i, r):
            req = self.request(r)
            t_in = time.perf_counter()
            out = self.restore(req)
            restores.append((t_in, time.perf_counter()))
            return out

        def consume(i, r, out, t_dispatch):
            outputs[r] = self.fetch(out)
            latencies.append(time.perf_counter() - t_dispatch)

        if self.traffic["loop"] == "offline":
            overlap_dispatch(requests(), dispatch, consume)
        elif self.traffic["loop"] == "closed":
            for r in requests():
                t_in = time.perf_counter()
                consume(r, r, dispatch(r, r), t_in)
        else:
            raise ValueError(f"unknown loop {self.traffic['loop']!r}")
        t1 = time.perf_counter()
        return {"start": t0, "end": t1, "outputs": outputs, "restores": restores,
                "latencies": latencies, "requests": len(outputs),
                "images": len(outputs) * self.traffic["batch"]}

    def stretch_requests(self) -> int:
        return 1 if self.traffic["loop"] == "offline" else TRACE_REQUESTS_CLOSED

    def untraced_stretch(self, first: int) -> tuple[dict, float]:
        """The stretch's requests, from ``first``, one after another without
        the profiler; returns their outputs and the stretch's seconds."""
        n, outputs = self.stretch_requests(), {}
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        for r in range(first, first + n):
            outputs[r] = self.fetch(self.restore(self.request(r)))
        return {"outputs": outputs, "requests": n}, time.perf_counter() - s0

    def traced_stretch(self, first: int) -> tuple[dict, dict]:
        """The stretch under ``torch.profiler`` with device activity only
        (recording host operations would slow the host further); the
        benchmark's spans are timed on the host clock and put on the
        device's timeline by a marker kernel launched on an idle card.
        Returns the stretch's outputs and its trace."""
        from torch.profiler import ProfilerActivity, profile

        n, outputs, spans = self.stretch_requests(), {}, []

        def timed(name, fn):
            t0 = time.perf_counter()
            out = fn()
            spans.append((name, t0, time.perf_counter()))
            return out

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t_mark = time.perf_counter()
            torch.cuda._sleep(1)    # ATen's "spin_kernel": the clocks' marker
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            for r in range(first, first + n):
                req = timed("bench.inputs", lambda: self.request(r))
                out = timed("bench.dispatch", lambda: self.restore(req))
                outputs[r] = timed("bench.fetch", lambda: self.fetch(out))
            s1 = time.perf_counter()
        trace = read_trace(device_activities(prof), n * self.nfe, t_mark, (s0, s1), spans)
        trace["requests"] = n
        return {"outputs": outputs, "requests": n}, trace


MARKER = "spin_kernel"


def device_activities(prof) -> list[tuple[str, float, float]]:
    """(name, start us, end us) of every activity on the card in a profile
    (kernels, copies, sets), read from the profiler's raw events."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda or getattr(ev, "is_user_annotation", lambda: False)():
            continue
        start = ev.start_ns() / 1e3
        out.append((ev.name(), start, start + ev.duration_ns() / 1e3))
    return out


def read_trace(activities: list, nfe: int, t_mark: float, stretch: tuple, spans: list) -> dict:
    """The card's activities, and the stretch and the spans (host seconds)
    on the card's timeline (microseconds), aligned by the marker kernel's
    start."""
    kernels, marker = [], None
    for name, start, end in sorted(activities, key=lambda a: a[1]):
        if MARKER in name and marker is None:
            marker = start
        else:
            kernels.append((name, start, end))
    if marker is None or not kernels:
        raise RuntimeError("the profiler recorded no marker or no device activity")
    off = marker - t_mark * 1e6
    return {"kernels": kernels, "nfe": nfe,
            "stretch_us": (stretch[0] * 1e6 + off, stretch[1] * 1e6 + off),
            "spans": [(n, a * 1e6 + off, b * 1e6 + off) for n, a, b in spans]}


def kernel_bounds(calls: list) -> dict:
    """The least time of one forward's GroupNorm and attention calls, by
    class, from their recorded shapes."""
    out = {"groupnorm": 0.0, "attention": 0.0}
    for c in calls:
        if c[0] == "gn":
            _, shape, dtype, film, silu = c
            out["groupnorm"] += arith.bound_s(*arith.gn_cost(shape, dtype, film, silu), dtype)
        else:
            _, b, t, heads, ch, dtype = c
            out["attention"] += arith.bound_s(*arith.attn_cost(b, t, heads, ch, dtype), dtype)
    return out
