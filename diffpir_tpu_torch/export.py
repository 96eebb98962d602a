"""Ahead-of-time export of restore programs (``torch.export``) and bundles.

Port of ``diffpir_tpu/export.py``.  The JAX package serialises the whole
trajectory as one ``lax.scan`` program.  ``torch.export`` unrolls a Python
loop, and 100 unrolled UNet forwards are not a workable program, so a port
bundle holds three exported programs and keeps the loop on the host:

  * ``prologue(y, kernel, mask, n0) -> (x_init, *prox_state)``: the task's
    x init (``Runner.initial_x``) and the tensors its data prox is built from
    (``Runner.prox_state``: the FFT solve's complex64 spectra, or the
    observations the masked average, the first-order step or cubic
    back-projection read);
  * ``step(params, x, y, mask, state, coef, flags, t, noise, lambda, zeta)
    -> x``: one step of the trajectory, every per-step value a tensor (a
    row of the mode's step tables, the 0-d timestep, the step's draws, the
    (B,) operating point), so one program serves every step.  DiffPIR,
    repaint and vanilla: one (step, inner repeat) (``sampler.diffpir_step``,
    ``sampler.step_tables``); ``pred_x_prev``: one ancestral or DDIM step
    and, for inpainting, the masked average (``sampler.xprev_step``,
    ``xprev_tables``); DPS_y0 and DPS_yt: the step and its gradient
    correction (``guidance.dps_y0_step``, ``dps_yt_step``, ``dps_tables``).
    ``test_mode`` 1-4 wraps the UNet calls of any of them
    (``Runner.wrap_test_mode``: pad, split, x8 at the bundle's shapes);
  * ``epilogue(x, y, mask) -> x01``: ``recover_known`` and the map to [0, 1].

The UNet's GroupNorm and attention are the operators
``diffpir_tpu_torch::groupnorm_silu`` and ``::legacy_qkv_attention``
(``kernels/``), one opaque node per call: on the card each launches its CUDA
kernel, on the CPU it runs its plain version.  A program whose graph holds a
plain version inline is refused.  The collectives of a mesh are the
operators of ``parallel/collectives.py``; over a ``space`` axis the
GroupNorm halves (``::groupnorm_partial_stats``, ``::groupnorm_apply_stats``,
``::groupnorm_merge_stats``) and ``::halo_rows`` are operators too.  A
gradient, which ``torch.export`` does not trace, is recorded with
``make_fx`` as an aten graph, backward included, and the step calls that
graph: the first-order prox's, and the whole DPS step (DPS_y0
differentiates through the UNet: each kernel operator's autograd formula
records one backward operator node per forward node, the plain version
recomputed and differentiated).

  * ``export_restore``: the program archive (``.pt2``: the three programs
    and the step tables) as bytes;
  * ``save_bundle`` / ``load_bundle``: a directory with the archive, the
    parameters (``params.npz``, a flat list in ``named_parameters`` order,
    bf16 as its raw 16 bits) and ``manifest.json``; ``load_bundle`` returns
    ``LoadedRestore``, a callable ``(y, kernel, mask, seed) -> restored`` that
    draws the noise in ``Runner.restore``'s order and imports none of the
    port's model, sampler or runner modules;
  * ``LoadedRestore.save_aot``: the programs already on this host's device,
    and on the card the built kernel library, so a later boot neither moves
    a program nor runs ``nvcc``.

Parameters stay inputs of the step program (``torch.func.functional_call``),
so ``reload_params`` refreshes a checkpoint without a re-export.  A bundle
exported on one device loads on the other (``platforms``;
``torch.export.passes.move_to_device_pass``).  Mesh bundles (``data``,
``model`` and ``space`` axes) record the mesh and each parameter's spec
(``parallel/tp.py``); their programs are a rank's, with the model and space
axes' collectives inside, and under a process group of the recorded size
the loader shards the parameters, gives each data rank its rows (a space
rank takes whole images: the UNet splits them inside) and gathers the
output.  Every rank of a mesh exports (a recorded gradient runs the
collectives); rank 0 writes.  ``log_process`` bundles return only the
final image, as the JAX package's.

    python -m diffpir_tpu_torch.export --opt configs/demo256_inpaint.yaml \\
        --out bundle/ [--batch B] [--hw H W] [--kernel KH KW] \\
        [--platforms cuda cpu] [--set K=V] [--cpu] [--dynamic-point] \\
        [--allow-random-weights] [--aot]
"""

from __future__ import annotations

import io
import json
import os
import shutil
import time
import warnings
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# importing the kernel and collective modules registers their operators,
# which a loaded program calls
from diffpir_tpu_torch.kernels import attention as _attention  # noqa: F401
from diffpir_tpu_torch.kernels import groupnorm as _groupnorm  # noqa: F401
from diffpir_tpu_torch.kernels._common import OP_IMPLS, OPS_NAMESPACE, operators
from diffpir_tpu_torch.parallel import collectives as coll
from diffpir_tpu_torch.parallel.mesh import make_mesh, set_current_mesh, shard_tensor

__all__ = ["export_restore", "save_bundle", "load_bundle", "LoadedRestore",
           "program_report", "expected_report"]

_MANIFEST = "manifest.json"
_PROGRAM = "program.pt2"
_PARAMS = "params.npz"
_TABLES = "steps"            # the archive's extra file holding the step tables
_AOT = "aot.{platform}.pt2"
_AOT_LIB = "aot.cuda.so"     # the built kernel library, beside its digest
_PROGRAMS = ("prologue", "step", "epilogue")
# the operators that stand for a kernel (or its backward, or the sharded
# GroupNorm's host-side merge); every other operator of the namespace is a
# collective
_FORWARD_OPS = ("groupnorm_silu", "legacy_qkv_attention", "groupnorm_partial_stats",
                "groupnorm_apply_stats", "groupnorm_merge_stats")
_KERNEL_OPS = _FORWARD_OPS + tuple(k + "_backward" for k in _FORWARD_OPS)
# the draws of one step, by mode (the manifest's noise_order after "init")
_PER_ROW = {"DiffPIR": ["rp", "n1", "n2", "n3"], "xprev": ["xprev"],
            "DPS_y0": ["samp"], "DPS_yt": ["samp", "yt"]}


def _check_exportable(runner, allow_random_weights: bool) -> None:
    cfg = runner.cfg
    if (getattr(runner, "weights_provenance", "random") == "random"
            and not allow_random_weights):
        # a shipped bundle over the zoo's random-init fallback would serve
        # garbage forever; refuse unless explicitly a fixture
        raise RuntimeError(
            f"no trained weights found for model {cfg.model_name!r} — refusing to "
            f"export a random-weight bundle (pass allow_random_weights=True for test "
            f"fixtures)")
    if runner.device.type == "meta":
        raise RuntimeError("an abstract Runner has no weights to export")
    if runner.model.kernels != "cuda":
        raise ValueError("export the kernel route (kernels='cuda'): the plain route "
                         "would inline the plain versions into the program")


def program_report(ep) -> dict:
    """Counts of an exported program's calls: each kernel operator and its
    backward (``_KERNEL_OPS``), the collectives, and ``plain_nodes``, the
    nodes only a plain version makes (GroupNorm's ``rsqrt``, attention's
    ``softmax``), which must be 0."""
    out = dict.fromkeys(_KERNEL_OPS, 0)
    out.update(collectives=0, plain_nodes=0, call_function=0)
    for node in ep.graph.nodes:
        if node.op != "call_function":
            continue
        out["call_function"] += 1
        name = str(node.target)
        if name.startswith("diffpir_tpu_torch."):
            op = name.split(".")[1]
            if op in out:
                out[op] += 1
            else:
                out["collectives"] += 1
        elif "rsqrt" in name or "softmax" in name:
            out["plain_nodes"] += 1
    return out


def _mode(cfg) -> str:
    if cfg.model_output_type == "pred_x_prev":
        return "xprev"
    if cfg.generate_mode in ("DPS_y0", "DPS_yt"):
        return cfg.generate_mode
    return "DiffPIR"


def expected_report(runner, forwards: int) -> dict:
    """The kernel operator nodes a step program of ``runner``'s mode holds
    when a step makes ``forwards`` UNet calls: each GroupNorm and attention
    call of a forward once (the sharded GroupNorm's halves and merge over a
    ``space`` axis), and once more as its backward in DPS_y0."""
    gn, attn = _unet_calls(runner.model)
    space = runner.mesh is not None and runner.mesh.axis_size("space") > 1
    fwd = {"legacy_qkv_attention": attn * forwards}
    if space:
        fwd.update({k: gn * forwards for k in ("groupnorm_partial_stats",
                                                "groupnorm_apply_stats",
                                                "groupnorm_merge_stats")})
    else:
        fwd["groupnorm_silu"] = gn * forwards
    want = dict.fromkeys(_KERNEL_OPS, 0)
    want.update(fwd)
    if _mode(runner.cfg) == "DPS_y0":
        want.update({k + "_backward": v for k, v in fwd.items()})
    return want


def _strip_asserts(ep) -> None:
    """Drop the metadata assertions the trace inserts before each cast: they
    check nothing a fixed-shape program needs and cost a host call each."""
    g = ep.graph_module.graph
    for node in list(g.nodes):
        if node.op == "call_function" and "_assert_tensor_metadata" in str(node.target):
            g.erase_node(node)
    ep.graph_module.recompile()


def _unet_calls(model) -> tuple[int, int]:
    """(GroupNorm, attention) calls of one forward: each module runs once."""
    from diffpir_tpu_torch.models.unet import AttentionBlock, GroupNorm32

    mods = list(model.modules())
    return (sum(isinstance(m, GroupNorm32) for m in mods),
            sum(isinstance(m, AttentionBlock) for m in mods))


class _Prologue(torch.nn.Module):
    def __init__(self, runner, state: str):
        super().__init__()
        self.__dict__["runner"] = runner     # not a submodule: no lifted weights
        self.state = state                   # "prox", "kernel" or "none"

    def forward(self, y, kernel, mask, n0):
        r = self.runner
        x = r.initial_x(y, mask, n0)
        state = {"prox": lambda: r.prox_state(y, kernel, mask),
                 "kernel": lambda: (kernel,), "none": tuple}[self.state]()
        # a program's outputs are its own tensors, not its inputs
        return (x,) + tuple(s.clone() if any(s is a for a in (y, kernel, mask)) else s
                            for s in state)


def _unet_call(runner, names, params):
    """The runner's denoiser with the UNet called on ``params`` (the step
    program's inputs), wrapped in ``test_mode`` as the runner's is."""
    import dataclasses

    weights = dict(zip(names, params))
    return dataclasses.replace(runner.den, model=runner.wrap_test_mode(
        lambda xv, tv: torch.func.functional_call(runner.model, weights, (xv, tv))))


class _Step(torch.nn.Module):
    """A DiffPIR, repaint or vanilla (step, inner repeat)."""

    def __init__(self, runner, names, prox, repaint: bool, setback: bool):
        super().__init__()
        self.__dict__["runner"] = runner
        self.__dict__["prox"] = prox         # state -> prox_fn, or None
        self.names = list(names)
        self.repaint, self.setback = repaint, setback

    def forward(self, params, x, y, mask, state, coef, flags, t, noise, lam, zeta):
        from diffpir_tpu_torch.sampler import diffpir_step

        den = _unet_call(self.runner, self.names, params)
        zeta_b = zeta.reshape(-1, 1, 1, 1)
        # the draws of one row in the manifest's noise order
        noise = list(noise)
        rp = noise.pop(0) if self.repaint else None
        n1, n2 = noise.pop(0), noise.pop(0)
        n3 = noise.pop(0) if self.setback else None
        return diffpir_step(
            den, None if self.prox is None else self.prox(state), x, coef, flags, t, n1,
            n2, sqrt_zeta=torch.sqrt(zeta_b), sqrt_1m_zeta=torch.sqrt(1.0 - zeta_b),
            lam_b=lam.reshape(-1, 1, 1, 1), rp=rp, n3=n3,
            y2=(2.0 * y - 1.0).float() if self.repaint else None,
            mask=mask if self.repaint else None)


class _XprevStep(torch.nn.Module):
    """A ``pred_x_prev`` step: ancestral or DDIM, and for inpainting the
    masked average (deblur and SR take no data term in this mode)."""

    def __init__(self, runner, names):
        super().__init__()
        self.__dict__["runner"] = runner
        self.names = list(names)
        self.inpaint = runner.cfg.task == "inpaint"

    def forward(self, params, x, y, mask, state, coef, flags, t, noise, lam, zeta):
        from diffpir_tpu_torch.sampler import model_fn, xprev_step

        r = self.runner
        return xprev_step(
            r.diffusion, model_fn(_unet_call(r, self.names, params)), x, coef, flags, t,
            noise[0], ddim=r.cfg.ddim_sample,
            y2=(2.0 * y - 1.0).float() if self.inpaint else None,
            mask=mask if self.inpaint else None, lam_b=lam.reshape(-1, 1, 1, 1))


class _RecordedStep(torch.nn.Module):
    """A step whose graph ``make_fx`` recorded (a DPS step: its gradient)."""

    def __init__(self, gm):
        super().__init__()
        self.gm = gm

    def forward(self, params, x, y, mask, state, coef, flags, t, noise, lam, zeta):
        return self.gm(params, x, y, coef, t, noise, lam, *state)


class _Epilogue(torch.nn.Module):
    def __init__(self, recover_known: bool):
        super().__init__()
        self.recover_known = recover_known

    def forward(self, x, y, mask):
        # as sampler.diffpir_sample ends
        if self.recover_known:
            x = mask * (2.0 * y - 1.0).float() + (1.0 - mask) * x
        return x * 0.5 + 0.5


def _traced_prox(runner, state, x0, tau):
    """``state -> prox_fn`` for the step program.  The first-order prox's
    gradient is recorded as an aten graph (``make_fx`` traces
    ``torch.autograd.grad``; ``torch.export`` does not) that the step calls."""
    cfg = runner.cfg
    if cfg.sub_1_analytic or cfg.task == "inpaint":
        return runner.prox_from_state
    from torch.fx.experimental.proxy_tensor import make_fx

    with operators():
        gm = make_fx(lambda x, t, *st: runner.prox_from_state(st)(x, t))(x0, tau, *state)
    return lambda st: (lambda x, t: gm(x, t, *st))


def _recorded_dps(runner, names, lam_const: Optional[float], example):
    """The whole DPS step as an aten graph (``make_fx``): DPS_y0's gradient
    runs back through the UNet, so the graph holds each kernel operator's
    backward node.  ``lam_const`` is the fixed operating point's lambda
    (None: the per-sample input)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from diffpir_tpu_torch.guidance import dps_y0_step, dps_yt_step, make_degrade_op
    from diffpir_tpu_torch.sampler import model_fn

    cfg, mesh = runner.cfg, runner.mesh
    sf = cfg.sf if cfg.task == "sr" else 1
    batch_sum = None
    if mesh is not None and mesh.axis_size("data") > 1:
        batch_sum = lambda v: coll.all_reduce_sum(v, mesh, "data")  # noqa: E731

    def step(params, x, y, coef, t, noise, lam, *state):
        model = model_fn(_unet_call(runner, names, params))
        op = make_degrade_op(cfg.task, kernel=state[0] if state else None,
                             hr_hw=(y.shape[1] * sf, y.shape[2] * sf), sf=cfg.sf)
        if cfg.generate_mode == "DPS_y0":
            meas = y if cfg.task == "deblur" else 2.0 * y - 1.0
            return dps_y0_step(runner.diffusion, model, op, x, t, noise[0], meas,
                               batch_sum)
        lam_b = lam.reshape(-1, 1, 1, 1) if lam_const is None else lam_const
        return dps_yt_step(runner.diffusion, model, op, x, coef, t, noise[0], noise[1],
                           y, task=cfg.task, lam_b=lam_b)

    with operators():
        gm = make_fx(step)(*example)
    # a view recorded on the card's tensors may not hold for the strides
    # torch.export's fake tensors give the same values (cuDNN's backward
    # returns channels_last where the meta kernel returns contiguous):
    # reshape, which views where it can
    _views_to_reshape(gm)
    return gm


_VIEWS = ("aten.view.default", "aten._unsafe_view.default")


def _views_to_reshape(gm) -> None:
    """Every view node of ``gm`` as ``aten.reshape`` (a view where the
    strides allow, else a copy)."""
    for node in gm.graph.nodes:
        if node.op == "call_function" and str(node.target) in _VIEWS:
            node.target = torch.ops.aten.reshape.default
    gm.recompile()


def _export_programs(runner, *, batch: int, height: int, width: int,
                     kernel_hw: tuple[int, int], lambda_: float, dynamic_point: bool):
    """The three ExportedPrograms, the step tables and the noise order, for
    this rank's rows of a ``batch``."""
    from diffpir_tpu_torch.guidance import dps_tables
    from diffpir_tpu_torch.sampler import STEP_COLUMNS, step_tables, xprev_tables

    cfg = runner.cfg
    mesh = runner.mesh
    mode = _mode(cfg)
    n_data = 1 if mesh is None else mesh.axis_size("data")
    if batch % n_data:
        raise ValueError(f"a batch of {batch} does not split over {n_data} data ranks")
    b, c = batch // n_data, cfg.n_channels
    sf = cfg.sf if cfg.task == "sr" else 1
    dev = runner.device
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.zeros((b, height, width, c), **f32)
    kh, kw = kernel_hw
    kern = torch.zeros((b, kh, kw), **f32)
    kern[:, kh // 2, kw // 2] = 1.0
    hr = (b, height * sf, width * sf, c)
    mask = torch.ones(hr, **f32)
    n0 = torch.zeros(hr, **f32)
    use_prox = mode == "DiffPIR" and cfg.generate_mode == "DiffPIR"
    repaint = mode == "DiffPIR" and cfg.generate_mode == "repaint"
    setback = mode == "DiffPIR" and cfg.iter_num_U > 1
    plan = runner._plan(1.0 if dynamic_point else lambda_)
    tables = {"DiffPIR": lambda: step_tables(runner.den, plan, cfg.iter_num_U),
              "xprev": lambda: xprev_tables(plan)}.get(mode, lambda: dps_tables(plan))()
    names = [n for n, _ in runner.model.named_parameters()]
    params = [p.detach() for _, p in runner.model.named_parameters()]
    # the diffusion's tables, made now under the device the tensors report
    # (cuda:0, not cuda): made inside the trace, the cache would keep the
    # trace's fake tensors
    runner.diffusion._tables(y.device)
    per_row = [k for k in _PER_ROW[mode] if (k != "rp" or repaint)
               and (k != "n3" or setback)]
    shapes = {"yt": [b, height, width, c]}
    # the UNet calls of one step (test_mode makes several), counted while
    # the step is recorded and traced
    forwards = [0]
    hook = runner.model.register_forward_pre_hook(
        lambda m, a: forwards.__setitem__(0, forwards[0] + 1))
    try:
        with torch.no_grad():
            state_kind = ("prox" if use_prox else
                          "kernel" if mode.startswith("DPS") and cfg.task == "deblur"
                          else "none")
            prologue = _Prologue(runner, state_kind)
            x, *state = prologue(y, kern, mask, n0)
            ep_pro = torch.export.export(prologue, (y, kern, mask, n0))
            lam = torch.ones((b,), **f32)
            zeta = torch.full((b,), float(cfg.zeta), **f32)
            noise = [torch.zeros(tuple(shapes.get(k, hr)), **f32) for k in per_row]
            coef, flags = (torch.from_numpy(tables.coef[0]).to(dev),
                           torch.from_numpy(tables.flags[0]).to(dev))
            t0 = torch.from_numpy(tables.t[:1]).to(dev)[0]
            args = (params, x, y, mask, list(state), coef, flags, t0, noise, lam, zeta)
            forwards[0] = 0
            if mode == "DiffPIR":
                prox = None
                if use_prox:
                    rho = STEP_COLUMNS.index("rho")
                    tau = (torch.from_numpy(tables.coef[0, rho:rho + 1]).to(dev)
                           * lam.reshape(-1, 1, 1, 1))
                    prox = _traced_prox(runner, tuple(state), x.clone(), tau)
                step = _Step(runner, names, prox, repaint, setback)
            elif mode == "xprev":
                step = _XprevStep(runner, names)
            else:
                lam_const = None if dynamic_point else float(lambda_)
                step = _RecordedStep(_recorded_dps(
                    runner, names, lam_const,
                    (params, x.clone(), y, coef, t0, noise, lam, *state)))
            ep_step = torch.export.export(step, args)
        recover = cfg.task == "inpaint" and cfg.recover_known and mode in ("DiffPIR",
                                                                          "xprev")
        with torch.no_grad():
            ep_epi = torch.export.export(_Epilogue(recover), (x, y, mask))
    finally:
        hook.remove()
    for ep in (ep_pro, ep_step, ep_epi):
        _strip_asserts(ep)
        # the archive would otherwise keep the trace's inputs: a copy of the
        # parameters, which params.npz holds
        ep.example_inputs = None
    rep = program_report(ep_step)
    want = expected_report(runner, forwards[0])
    if rep["plain_nodes"] or any(rep[k] != v for k, v in want.items()):
        raise RuntimeError(f"the step program does not hold the kernels as operators "
                           f"({rep}; {forwards[0]} UNet calls a step give {want})")
    # a recorded step's views are reshapes at run time too (_bind_kernels)
    return ({"prologue": ep_pro, "step": ep_step, "epilogue": ep_epi}, tables,
            dict(init=list(hr), per_row=per_row, shapes=shapes, forwards=forwards[0],
                 reshape_views=mode.startswith("DPS")))


def _archive(programs: dict, tables, noise: dict) -> bytes:
    from torch.export.pt2_archive._package import package_pt2

    buf = io.BytesIO()
    steps = dict(coef=tables.coef.tolist(), flags=tables.flags.tolist(),
                 t=tables.t.tolist(), noise=noise)
    package_pt2(buf, exported_programs=programs, extra_files={_TABLES: json.dumps(steps)})
    return buf.getvalue()


def export_restore(runner, *, batch: int, height: int, width: int,
                   kernel_hw: tuple[int, int] = (1, 1),
                   lambda_: Optional[float] = None, dynamic_point: bool = False,
                   platforms: Sequence[str] = ("cuda", "cpu"),
                   allow_random_weights: bool = False) -> bytes:
    """The program archive of a whole-batch restore, as bytes.

    ``height``/``width`` are the observation's (the low-resolution input for
    SR); ``kernel_hw`` is the PSF shape the program takes.  The exported
    calling convention is that of ``LoadedRestore``.  ``dynamic_point=True``
    builds the step tables at lambda 1 and scales rho by a per-sample (B,)
    lambda at call time, as the live per-sample path does; otherwise the
    tables hold ``lambda_`` and the loader passes lambda 1.  zeta is an
    input of the step program either way (``save_bundle`` records the
    bundle's).  Refuses random weights unless ``allow_random_weights``.
    """
    cfg = runner.cfg
    _check_exportable(runner, allow_random_weights)
    bad = set(platforms) - {"cuda", "cpu"}
    if bad:
        raise ValueError(f"unknown platforms {sorted(bad)} (cuda, cpu)")
    lambda_ = cfg.lambda_ if lambda_ is None else lambda_
    programs, tables, noise = _export_programs(
        runner, batch=batch, height=height, width=width, kernel_hw=tuple(kernel_hw),
        lambda_=lambda_, dynamic_point=dynamic_point)
    return _archive(programs, tables, noise)


def _full_params(runner) -> tuple[list, list, list]:
    """(names, unsharded parameters, specs): a model axis's shards are
    gathered from every rank of it (a collective)."""
    model, mesh = runner.model, runner.mesh
    specs = getattr(model, "param_specs", {})
    names, full, spec_list = [], [], []
    for name, p in model.named_parameters():
        spec = tuple(specs.get(name, ()))
        p = p.detach()
        for dim, axis in enumerate(spec):
            if axis is not None:
                p = coll.all_gather(p.contiguous(), mesh, axis, dim)
        names.append(name)
        full.append(p)
        spec_list.append(list(spec))
    return names, full, spec_list


def _to_numpy(p: torch.Tensor) -> np.ndarray:
    p = p.detach().cpu().contiguous()
    if p.dtype == torch.bfloat16:
        return p.view(torch.int16).numpy().view(np.uint16)
    return p.numpy()


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def save_bundle(runner, path: str, *, batch: int, height: int, width: int,
                kernel_hw: tuple[int, int] = (1, 1), lambda_: Optional[float] = None,
                zeta: Optional[float] = None, dynamic_point: bool = False,
                platforms: Sequence[str] = ("cuda", "cpu"),
                allow_random_weights: bool = False) -> str:
    """Write a self-contained serving bundle directory: the program archive,
    the unsharded parameters and the manifest.  Under a mesh every rank calls
    it (the model axis's shards are gathered); rank 0 writes."""
    cfg = runner.cfg
    mesh = runner.mesh
    lambda_ = float(cfg.lambda_ if lambda_ is None else lambda_)
    zeta = float(cfg.zeta if zeta is None else zeta)
    # every rank refuses what rank 0 would, before the collective gather
    _check_exportable(runner, allow_random_weights)
    names, full, specs = _full_params(runner)
    writer = mesh is None or not dist.is_initialized() or dist.get_rank() == 0
    # every rank of a mesh exports: a recorded gradient (DPS) runs the
    # collectives of its program, which need every rank; rank 0 writes
    # zeta is an input of the step program: the manifest records the
    # bundle's, which the loader passes
    blob = export_restore(runner, batch=batch, height=height, width=width,
                          kernel_hw=kernel_hw, lambda_=lambda_,
                          dynamic_point=dynamic_point, platforms=platforms,
                          allow_random_weights=allow_random_weights)
    if writer:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, _PROGRAM), "wb") as f:
            f.write(blob)
        np.savez(os.path.join(path, _PARAMS),
                 **{str(i): _to_numpy(p) for i, p in enumerate(full)})
        mesh_info = None
        if mesh is not None:
            mesh_info = dict(axis_names=list(mesh.axis_names),
                             shape=[int(mesh.shape[a]) for a in mesh.axis_names],
                             param_specs=specs)
        manifest = dict(
            task=cfg.task, sf=cfg.sf if cfg.task == "sr" else 1,
            n_channels=cfg.n_channels, batch=batch, height=height, width=width,
            kernel_hw=list(kernel_hw), platforms=list(platforms),
            model_name=cfg.model_name, iter_num=cfg.iter_num, treedef=names,
            mesh=mesh_info, dynamic_point=dynamic_point, lambda_=lambda_, zeta=zeta,
            # the port's own keys
            iter_num_U=cfg.iter_num_U, generate_mode=cfg.generate_mode,
            model_output_type=cfg.model_output_type, ddim_sample=cfg.ddim_sample,
            test_mode=cfg.test_mode,
            param_dtypes=[str(p.dtype).replace("torch.", "") for p in full],
            noise_order=["init"] + _PER_ROW[_mode(cfg)],
            exported_on=runner.device.type, torch=torch.__version__)
        with open(os.path.join(path, _MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
    if mesh is not None and dist.is_initialized():
        dist.barrier(group=mesh.host_group)
    return path


# CPython (3.11, 3.12) keeps each thread's frames on chunks of 16 KiB and
# frees a chunk when the frame that opened it returns.  A frame that ends a
# few hundred bytes short of a chunk's end therefore maps and unmaps a chunk
# on every call it makes.  A step program's forward (one local per node:
# 8-15 KiB) makes about a thousand calls a step, so at an unlucky depth of
# its caller a bundle ran 2.5-5x slower, all of it host time (ROADMAP C6).
# A frame larger than a power of two of at least a chunk always opens a
# chunk of its own, twice that size, which leaves room for its calls.
_FRAME_SLOT = 8               # bytes per slot of a frame
_CHUNK = 16 * 1024            # bytes per chunk


def _own_chunk(fn) -> None:
    """Pad ``fn``'s frame (its value stack) so that every call of it opens
    a data-stack chunk of its own with room for the calls it makes."""
    code = fn.__code__
    n_vars = len(code.co_varnames) + len(code.co_cellvars) + len(code.co_freevars)
    size = _CHUNK
    while size < (n_vars + code.co_stacksize) * _FRAME_SLOT:
        size *= 2
    # 512 bytes more than the power of two: too big for a chunk of that size
    fn.__code__ = code.replace(co_stacksize=max(
        code.co_stacksize, (size + 512) // _FRAME_SLOT - n_vars))


def _bind_kernels(gm, device: torch.device, reshape_views: bool = False):
    """A copy of ``gm`` whose operator nodes (the kernels, their backwards
    and the collectives) call the implementation the dispatcher would pick
    on ``device`` directly (``_launch`` on the card, the plain version on
    the CPU), as the eager wrappers do, without the dispatcher's call into
    a Python implementation on every call; the program file keeps the
    operators.  ``reshape_views``: the views of a recorded step
    (``_recorded_dps``) as reshapes, since the real strides may differ
    from those the trace saw."""
    key = "CUDA" if device.type == "cuda" else "CPU"
    graph = torch.fx.Graph()
    graph.output(graph.graph_copy(gm.graph, {}))
    for node in graph.nodes:
        parts = str(node.target).split(".")
        if (node.op == "call_function" and parts[0] == OPS_NAMESPACE
                and (parts[1], key) in OP_IMPLS):
            node.target = OP_IMPLS[(parts[1], key)]
    bound = torch.fx.GraphModule(gm, graph)
    if reshape_views:
        _views_to_reshape(bound)
    _own_chunk(type(bound).forward)
    return bound


class _Program:
    """One exported program, called through its graph: the lifted weights
    and constants first, then the caller's flat inputs (what
    ``ExportedProgram.module()`` does, without its per-call input checks),
    its kernel operators bound to their implementations on ``device``."""

    def __init__(self, ep, device: torch.device, reshape_views: bool = False):
        from torch.export.graph_signature import InputKind

        specs = ep.graph_signature.input_specs
        kinds = [s.kind for s in specs]
        n_lifted = sum(k != InputKind.USER_INPUT for k in kinds)
        if any(k == InputKind.USER_INPUT for k in kinds[:n_lifted]):
            raise RuntimeError("an exported program's lifted inputs are not first")
        tables = {**ep.state_dict, **ep.constants}
        self.lifted = [tables[s.target] for s in specs[:n_lifted]]
        self.gm = _bind_kernels(ep.graph_module, device, reshape_views)
        self.ep = ep

    def __call__(self, *flat):
        return self.gm(*self.lifted, *flat)


def _load_archive(blob_or_path, device: torch.device, move: bool):
    from torch.export.pt2_archive._package import load_pt2

    contents = load_pt2(blob_or_path)
    steps = json.loads(contents.extra_files[_TABLES])
    programs = {}
    for name in _PROGRAMS:
        ep = contents.exported_programs[name]
        if move:
            from torch.export.passes import move_to_device_pass

            ep = move_to_device_pass(ep, device)
        programs[name] = ep
    return programs, steps


class LoadedRestore:
    """A bundle's programs bound to its parameters on one device.

    ``loaded(y, kernel=None, mask=None, seed=0, lambda_=None, zeta=None,
    fetch=True)`` with numpy arrays (or tensors) at exactly the manifest
    shapes returns the restored batch in [0, 1].  ``device`` defaults to the
    card (raising when there is none); ``device="cpu"`` runs on the CPU.
    ``boot_timings`` holds the seconds of each boot phase: ``manifest_s``,
    ``params_load_s``, ``aot_load_s`` (a sidecar boot) and
    ``program_load_s`` (the portable archive, read at the first call when
    no sidecar serves it).
    """

    def __init__(self, path: str, *, use_aot: bool = True,
                 device: Optional[torch.device | str] = None):
        from diffpir_tpu_torch import resolve_device

        self._path = path
        self.device = resolve_device(cpu=False) if device is None else torch.device(device)
        self.boot_timings: dict = {}
        t = time.perf_counter()
        with open(os.path.join(path, _MANIFEST)) as f:
            self.manifest = json.load(f)
        self.boot_timings["manifest_s"] = round(time.perf_counter() - t, 3)
        m = self.manifest
        if self.device.type not in m["platforms"]:
            raise RuntimeError(f"the bundle was exported for {m['platforms']}, not "
                               f"{self.device.type}")
        self._programs = None
        self._steps = None
        self._steps_dev = None
        self._mesh = None
        info = m.get("mesh")
        if info is not None:
            shape = info["shape"]
            n = int(np.prod(shape))
            world = dist.get_world_size() if dist.is_initialized() else 1
            if world < n:
                raise RuntimeError(f"bundle was exported for a {shape} mesh ({n} devices); "
                                   f"this host has {world}")
            self._mesh = make_mesh(shape, info["axis_names"])
        elif use_aot:
            self._load_aot()
        t = time.perf_counter()
        self._params = self._read_params(os.path.join(path, _PARAMS))
        self.boot_timings["params_load_s"] = round(time.perf_counter() - t, 3)

    # ------------------------------------------------------------------
    def _load_aot(self) -> None:
        platform = self.device.type
        p = os.path.join(self._path, _AOT.format(platform=platform))
        if not os.path.exists(p):
            return
        t = time.perf_counter()
        try:
            if platform == "cuda":
                from diffpir_tpu_torch.kernels import build

                lib = os.path.join(self._path, _AOT_LIB)
                with open(lib + ".sha256") as f:
                    if not build.use_library(lib, f.read().strip()):
                        raise RuntimeError("the kernel library was built from other "
                                           "sources, flags or torch")
            programs, self._steps = _load_archive(p, self.device, move=False)
            self._programs = self._bind(programs)
        except Exception as e:  # a stale or foreign sidecar: the portable path serves
            warnings.warn(f"ignoring AOT sidecar {p}: {e!r}")
            self._programs = self._steps = None
            return
        self.boot_timings["aot_load_s"] = round(time.perf_counter() - t, 3)

    def _ensure_programs(self) -> None:
        """Read the portable archive (lazily: an AOT-hit boot never does)."""
        if self._programs is not None:
            return
        t = time.perf_counter()
        programs, self._steps = _load_archive(
            os.path.join(self._path, _PROGRAM), self.device,
            move=self.manifest["exported_on"] != self.device.type)
        self._programs = self._bind(programs)
        self.boot_timings["program_load_s"] = round(time.perf_counter() - t, 3)

    def _bind(self, programs: dict) -> dict:
        reshape = self._steps["noise"].get("reshape_views", False)
        return {k: _Program(ep, self.device, reshape and k == "step")
                for k, ep in programs.items()}

    def _read_params(self, path: str) -> list:
        m = self.manifest
        with np.load(path) as z:
            flat = [z[str(i)] for i in range(len(z.files))]
        dtypes = m["param_dtypes"]
        if len(flat) != len(dtypes):
            raise ValueError("params layout does not match the exported program")
        info = m.get("mesh")
        out = []
        for i, (a, dt) in enumerate(zip(flat, dtypes)):
            p = _from_numpy(a, dt)
            if info is not None:
                p = shard_tensor(p, info["param_specs"][i], self._mesh)
            p = p.to(self.device)
            # convolution weights as the UNet keeps them (models/unet.py Conv)
            out.append(p.contiguous(memory_format=torch.channels_last) if p.ndim == 4
                       else p.contiguous())
        return out

    @property
    def mesh(self):
        """The mesh a mesh bundle runs over (None for a one-device bundle)."""
        return self._mesh

    @property
    def programs(self) -> dict:
        """The loaded ExportedPrograms by name (reads the archive if needed)."""
        self._ensure_programs()
        return {k: p.ep for k, p in self._programs.items()}

    def save_aot(self, path: Optional[str] = None) -> str:
        """Write this host's sidecar: the programs moved to its device
        (``aot.<platform>.pt2``) and, on the card, the built kernel library
        (``aot.cuda.so`` and its digest).  Single-device bundles only."""
        if self.manifest.get("mesh"):
            raise ValueError("AOT sidecar is unsupported for mesh bundles")
        self._ensure_programs()
        out_dir = path or self._path
        platform = self.device.type
        out = os.path.join(out_dir, _AOT.format(platform=platform))
        from torch.export.pt2_archive._package import package_pt2

        package_pt2(out, exported_programs={k: p.ep for k, p in self._programs.items()},
                    extra_files={_TABLES: json.dumps(self._steps)})
        if platform == "cuda":
            from diffpir_tpu_torch.kernels import build

            lib = os.path.join(out_dir, _AOT_LIB)
            shutil.copyfile(build.library_path(), lib)
            with open(lib + ".sha256", "w") as f:
                f.write(build.library_digest() + "\n")
        return out

    def reload_params(self, path: Optional[str] = None) -> None:
        """Re-read ``params.npz`` (a checkpoint refresh without re-export):
        ``path`` may be another bundle directory or a bare npz whose flat
        layout matches this bundle's program."""
        p = os.path.join(path or self._path, _PARAMS)
        if not os.path.exists(p) and path and path.endswith(".npz"):
            p = path
        try:
            flat = self._read_params(p)
        except (ValueError, KeyError, TypeError) as e:
            raise ValueError("params layout does not match the exported program") from e
        if any(a.shape != b.shape or a.dtype != b.dtype
               for a, b in zip(flat, self._params)):
            raise ValueError("params layout does not match the exported program")
        self._params = flat

    # ------------------------------------------------------------------
    def __call__(self, y, kernel=None, mask=None, seed: int = 0, lambda_=None,
                 zeta=None, fetch: bool = True):
        """``lambda_``/``zeta`` (scalar or per-sample ``(batch,)``) are only
        accepted by bundles exported with ``dynamic_point=True``; they
        default to the operating point recorded in the manifest.
        ``fetch=False`` returns the tensor on the bundle's device without
        waiting for it."""
        m = self.manifest
        B, H, W, C = m["batch"], m["height"], m["width"], m["n_channels"]
        sf = m["sf"]
        if not m.get("dynamic_point") and (lambda_ is not None or zeta is not None):
            raise ValueError(
                "this bundle bakes its operating point (lambda="
                f"{m.get('lambda_')}, zeta={m.get('zeta')}); re-export with "
                "dynamic_point=True to choose (lambda, zeta) at call time")
        dev = self.device

        def dev_f32(a):
            return torch.as_tensor(a if torch.is_tensor(a) else np.asarray(a, np.float32),
                                   dtype=torch.float32).to(dev)

        y = dev_f32(y)
        if tuple(y.shape) != (B, H, W, C):
            raise ValueError(f"y must be {(B, H, W, C)}, got {tuple(y.shape)}")
        kh, kw = m["kernel_hw"]
        if kernel is None:
            # identity (delta) PSF at size//2, psf_to_otf's centre: no blur
            kernel = np.zeros((B, kh, kw), np.float32)
            kernel[:, kh // 2, kw // 2] = 1.0
        if mask is None:
            mask = np.ones((B, H * sf, W * sf, C), np.float32)
        kernel, mask = dev_f32(kernel), dev_f32(mask)
        if tuple(kernel.shape) != (B, kh, kw):
            raise ValueError(f"kernel must be {(B, kh, kw)}, got {tuple(kernel.shape)}")
        if tuple(mask.shape) != (B, H * sf, W * sf, C):
            raise ValueError(f"mask must be {(B, H * sf, W * sf, C)}, got "
                             f"{tuple(mask.shape)}")
        if m.get("dynamic_point"):
            lam = m["lambda_"] if lambda_ is None else lambda_
            zet = m["zeta"] if zeta is None else zeta
        else:
            lam, zet = 1.0, m["zeta"]
        lam = dev_f32(np.broadcast_to(np.asarray(lam, np.float32), (B,)).copy())
        zet = dev_f32(np.broadcast_to(np.asarray(zet, np.float32), (B,)).copy())
        out = self._run(y, kernel, mask, lam, zet, seed)
        return out.cpu().numpy() if fetch else out

    def _run(self, y, kernel, mask, lam, zeta, seed: int) -> torch.Tensor:
        self._ensure_programs()
        dev = self.device
        if self._steps_dev is None:
            s = self._steps
            flags = np.asarray(s["flags"], bool)
            self._steps_dev = (torch.tensor(s["coef"], dtype=torch.float32, device=dev),
                               torch.from_numpy(flags).to(dev),
                               torch.tensor(s["t"], dtype=torch.int32, device=dev),
                               flags)
        coef, flags, ts, flags_host = self._steps_dev
        noise_spec = self._steps["noise"]
        mesh = self._mesh
        if mesh is not None:
            set_current_mesh(mesh)
        n_data = 1 if mesh is None else mesh.axis_size("data")
        b = y.shape[0]
        per = b // n_data
        r = 0 if mesh is None else mesh.axis_index("data")
        rows = slice(r * per, (r + 1) * per)
        gen = torch.Generator(device=dev).manual_seed(seed)

        def draw(shape):
            # the global batch's draw (Runner.restore), this rank's rows of it
            return torch.randn((b,) + tuple(shape[1:]), generator=gen, device=dev,
                               dtype=torch.float32)[rows]

        y, kernel, mask, lam, zeta = (a[rows] for a in (y, kernel, mask, lam, zeta))
        pro, step, epi = (self._programs[k] for k in _PROGRAMS)
        shape = noise_spec["init"]
        shapes = noise_spec.get("shapes", {})
        with torch.no_grad():
            x, *state = pro(y, kernel, mask, draw(shape))
            per_row = noise_spec["per_row"]
            zeros = torch.zeros_like(x) if "n3" in per_row else None
            for k in range(len(ts)):
                noise = []
                for which in per_row:
                    if which == "n3" and not flags_host[k, 2]:
                        noise.append(zeros)
                    else:
                        noise.append(draw(shapes.get(which, shape)))
                (x,) = step(*self._params, x, y, mask, *state, coef[k], flags[k], ts[k],
                            *noise, lam, zeta)
            (out,) = epi(x, y, mask)
        if n_data > 1:
            out = coll.all_gather(out, mesh, "data", 0)
        return out


# the restore's loop and everything under it at one place of a chunk of its
# own, whatever the caller's depth
_own_chunk(LoadedRestore.__call__)


def load_bundle(path: str, *, device: Optional[torch.device | str] = None,
                use_aot: bool = True) -> LoadedRestore:
    """Load a ``save_bundle`` directory; see ``LoadedRestore``."""
    return LoadedRestore(path, use_aot=use_aot, device=device)


def main(argv: Optional[list] = None) -> None:
    """CLI: write a serving bundle for a task config.

    python -m diffpir_tpu_torch.export --opt configs/deblur.yaml --out bundle/ \\
        --batch 8 --hw 256 256 --kernel 25 25 [--platforms cuda cpu] [--cpu]
    """
    import argparse

    from diffpir_tpu_torch import resolve_device
    from diffpir_tpu_torch.config import load_config, parse_overrides
    from diffpir_tpu_torch.parallel import multihost
    from diffpir_tpu_torch.runner import Runner

    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--opt", required=True, help="task YAML config")
    ap.add_argument("--out", required=True, help="bundle output directory")
    ap.add_argument("--batch", type=int, default=None,
                    help="batch size (default: the config's batch_size)")
    ap.add_argument("--hw", type=int, nargs=2, metavar=("H", "W"), default=(256, 256),
                    help="observation height and width")
    ap.add_argument("--kernel", type=int, nargs=2, metavar=("KH", "KW"), default=(1, 1),
                    help="PSF shape the program takes")
    ap.add_argument("--platforms", nargs="+", default=["cuda", "cpu"])
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    ap.add_argument("--cpu", action="store_true", help="export (and --aot) on the CPU")
    ap.add_argument("--dynamic-point", action="store_true",
                    help="take (lambda, zeta) per sample at call time instead of "
                         "recording one operating point")
    ap.add_argument("--allow-random-weights", action="store_true",
                    help="export without a trained checkpoint (test fixtures only)")
    ap.add_argument("--aot", action="store_true",
                    help="also write this host's sidecar (LoadedRestore.save_aot) so "
                         "serving processes boot without moving a program or nvcc")
    args = ap.parse_args(argv)
    device = resolve_device(args.cpu)
    # under torchrun every rank builds its shard of a mesh bundle
    multihost.initialize(backend="gloo" if args.cpu else None)
    rank, world = multihost.process_shard_info()
    if world > 1 and device.type == "cuda":
        device = multihost.rank_device()
    cfg = load_config(args.opt, parse_overrides(args.set))
    runner = Runner(cfg, device=device)
    t0 = time.perf_counter()
    path = save_bundle(runner, args.out, batch=args.batch or cfg.batch_size,
                       height=args.hw[0], width=args.hw[1], kernel_hw=tuple(args.kernel),
                       dynamic_point=args.dynamic_point, platforms=tuple(args.platforms),
                       allow_random_weights=args.allow_random_weights)
    if rank:
        return
    size = os.path.getsize(os.path.join(path, _PROGRAM))
    print(f"wrote {path} (program {size / 1e6:.2f} MB, platforms {args.platforms}, "
          f"exported in {time.perf_counter() - t0:.1f}s)")
    if args.aot:
        t0 = time.perf_counter()
        out = LoadedRestore(path, use_aot=False, device=device).save_aot()
        print(f"wrote {out} ({os.path.getsize(out) / 1e6:.2f} MB, in "
              f"{time.perf_counter() - t0:.1f}s)")


if __name__ == "__main__":
    main()
