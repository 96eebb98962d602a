"""Diffusion training loop: AdamW, EMA, microbatch accumulation, checkpoints.

Port of ``diffpir_tpu/train/loop.py`` (reference
``guided_diffusion/train_util.py``) on one device:

  * the model holds fp32 master weights (``UNet(..., param_dtype=float32)``)
    and computes in ``TrainConfig.compute_dtype``, casting them at each call;
    both CUDA kernels run inside their ``autograd.Function``s, which give
    every parameter gradient;
  * microbatching sums the gradients of equal chunks and divides by their
    number (a ragged split raises, as in the JAX package);
  * AdamW with optax's semantics: b1 0.9, b2 0.999, eps 1e-8, weight decay
    added to the update of every parameter (no mask), the learning rate read
    at the step count before the update and annealed linearly to 0 over
    ``lr_anneal_steps``; ``grad_clip`` scales by ``max_norm / norm`` when
    the global norm reaches it; the logged ``grad_norm`` is the norm before
    clipping;
  * one EMA copy per rate, ``e * r + p * (1 - r)`` after the update;
  * uniform or loss-second-moment timestep sampling (``train/samplers.py``).

A state is a dict ``{params, opt_state, ema, step[, sampler_state]}``.  Its
``params`` are the model's own parameters, and a step updates the state's
tensors in place (the JAX package donates its state to the step).  Random
draws come from a ``torch.Generator``, or are handed in (``t``, ``noise``).
``fit`` seeds one generator per dispatch from (seed, step), as the JAX
package folds the step into its key, so a resumed run draws what an
unbroken one would.  Checkpoints are ``torch.save`` files; the JAX
package's orbax checkpoints are not read (the EMA ``.flax.npz`` of
``train/demo.py`` is what both packages share).

Under a mesh (``Trainer(mesh=)``, ``parallel/mesh.py``; ``diffpir_tpu/train/
loop.py:59-71``) every rank is given the global batch and the same
generator: the timesteps and noise are drawn for the global batch, each
microbatch is a slice of it, and each ``data`` rank computes its rows of
every microbatch; the gradients are summed over ``data`` and the loss is the
global mean.  The parameters, the Adam moments and the EMA are sharded
fsdp-style over ``model``: each parameter's largest dim that the axis
divides (``_param_sharding_rule``) is split, each rank updates its slice,
and the slices are gathered into the model before each step.  The
loss-second-moment sampler takes the gathered per-sample losses in global
row order, so every rank keeps the same sampler state.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

import torch.distributed as dist

from diffpir_tpu_torch.diffusion import Diffusion
from diffpir_tpu_torch.models.unet import UNet
from diffpir_tpu_torch.models.zoo import init_train_
from diffpir_tpu_torch.parallel import collectives as coll
from diffpir_tpu_torch.train import samplers

__all__ = ["TrainConfig", "TrainState", "Trainer", "dryrun_train_step"]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4
    weight_decay: float = 0.0
    ema_rates: Sequence[float] = (0.9999,)
    microbatch: int = -1              # -1 = no microbatching
    lr_anneal_steps: int = 0
    schedule_sampler: str = "uniform"  # uniform | loss-second-moment
    compute_dtype: str = "bfloat16"
    grad_clip: float = 0.0


# {params, opt_state: {count, mu, nu}, ema: tuple per rate, step, sampler_state?}
TrainState = dict


def _param_sharding_rule(shape, size: int) -> Optional[int]:
    """fsdp-style: the largest dim of ``shape`` that ``size`` divides (the
    JAX package's order of the dims), or None to replicate."""
    if size == 1 or not len(shape):
        return None
    for d in np.argsort(shape)[::-1]:
        if shape[d] % size == 0 and shape[d] >= size:
            return int(d)
    return None


def _dispatch_seed(seed: int, step: int) -> int:
    """The seed of ``fit``'s generator for the dispatch that starts at
    ``step`` (the counterpart of ``jax.random.fold_in(key, step)``)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)


class Trainer:
    """Bind (model, diffusion, optimizer) for one device, or for this rank
    of ``mesh`` (axes ``data`` and ``model``)."""

    def __init__(self, model: UNet, diffusion: Diffusion, cfg: TrainConfig,
                 mesh: Any = None):
        if mesh is not None and mesh.axis_size("space") > 1:
            raise ValueError("training splits the batch over data and the state "
                             "over model; a space axis is for inference")
        self.mesh = mesh
        if cfg.schedule_sampler not in ("uniform", "loss-second-moment"):
            raise ValueError(f"unknown schedule_sampler {cfg.schedule_sampler!r}")
        self.dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        if model.dtype != self.dtype:
            raise ValueError(f"the model computes in {model.dtype}, the config asks "
                             f"for {cfg.compute_dtype}")
        low = [(n, p.dtype) for n, p in model.named_parameters()
               if p.dtype != torch.float32]
        if low:
            raise ValueError("training needs fp32 master weights "
                             f"(UNet(..., param_dtype=torch.float32)); {low[0][0]} is "
                             f"{low[0][1]}")
        self.model = model
        self.diffusion = diffusion
        self.cfg = cfg
        self.T = diffusion.schedule.num_timesteps
        self.device = next(model.parameters()).device

    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = 0) -> TrainState:
        """A fresh state over the model's parameters: JAX's training
        initialisation from ``seed`` (``zoo.init_train_``), or the weights
        the model holds when ``seed`` is None; zero Adam moments, EMA copies
        of the parameters, step 0."""
        if seed is not None:
            init_train_(self.model, seed)
        full = dict(self.model.named_parameters())
        for p in full.values():
            p.requires_grad_(True)
        # this rank's slices (views of the model's parameters, so an update in
        # place reaches the model): all of each without a model axis
        params = {n: self._local(p) for n, p in full.items()}
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}  # noqa: E731
        state = dict(params=params,
                     opt_state=dict(count=0, mu=zeros(), nu=zeros()),
                     ema=tuple({n: p.detach().clone() for n, p in params.items()}
                               for _ in self.cfg.ema_rates),
                     step=0)
        if self.cfg.schedule_sampler == "loss-second-moment":
            state["sampler_state"] = samplers.loss_aware_init(self.T, device=self.device)
        return state

    # ------------------------------------------------------------------
    def _draws(self, state, batch, generator, t, noise):
        lsm = self.cfg.schedule_sampler == "loss-second-moment"
        if (t is None or noise is None) and generator is None:
            raise ValueError("pass a generator, or both t and noise")
        b = batch.shape[0]
        if t is None:
            if lsm:
                t, weights = samplers.loss_aware_sample(state["sampler_state"], b,
                                                        generator)
            else:
                t, weights = samplers.uniform_sample(b, self.T, generator, self.device)
        else:
            t = torch.as_tensor(t, device=self.device).long()
            weights = (samplers.importance_weights(state["sampler_state"], t) if lsm
                       else torch.ones((b,), dtype=torch.float32, device=self.device))
        if noise is None:
            noise = torch.randn(batch.shape, generator=generator, device=self.device)
        return t, weights, torch.as_tensor(noise, device=self.device).float()

    def _loss(self, batch, t, weights, noise, size: Optional[int] = None):
        """The weighted loss of ``batch``'s rows, over the ``size`` rows of
        their microbatch (by default the rows themselves: no data axis)."""
        def model_fn(x, tv):
            return self.model(x.to(self.dtype), tv)

        terms = self.diffusion.training_losses(model_fn, batch, t, noise)
        if size is None or batch.shape[0] == size:
            return (terms["loss"] * weights).mean(), terms["loss"]
        return (terms["loss"] * weights).sum() / size, terms["loss"]

    def _lr(self, count: int) -> float:
        """optax's ``linear_schedule(lr, 0, lr_anneal_steps)`` in fp32."""
        cfg = self.cfg
        if not cfg.lr_anneal_steps:
            return cfg.lr
        n = np.float32(cfg.lr_anneal_steps)
        frac = np.float32(1.0) - np.float32(min(max(count, 0), cfg.lr_anneal_steps)) / n
        return float(np.float32(cfg.lr) * frac)

    # ------------------------------------------------------------------
    def _axis(self, axis: str) -> int:
        return 1 if self.mesh is None else self.mesh.axis_size(axis)

    def _local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a full parameter-shaped tensor over ``model``
        (a view), or the tensor itself."""
        n = self._axis("model")
        d = _param_sharding_rule(tuple(full.shape), n)
        if d is None:
            return full
        k = full.shape[d] // n
        return full.narrow(d, self.mesh.axis_index("model") * k, k)

    def _gather_params(self) -> None:
        """Refresh the model's parameters from every rank's updated slice."""
        n = self._axis("model")
        if n == 1:
            return
        with torch.no_grad():
            for p in self.model.parameters():
                d = _param_sharding_rule(tuple(p.shape), n)
                if d is not None:
                    p.copy_(coll.all_gather(self._local(p), self.mesh, "model", d))

    def train_step(self, state: TrainState, batch: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None):
        """One optimisation step (gradients accumulated over microbatches).
        ``t`` and ``noise`` (the batch's shape) are drawn from ``generator``
        unless given.  Returns (state, {"loss", "grad_norm"}) with the
        metrics as device scalars.  Under a mesh ``batch`` (and ``t``,
        ``noise``) are the global batch's, on every rank."""
        cfg = self.cfg
        batch = torch.as_tensor(batch, device=self.device).float()
        b = batch.shape[0]
        mb = cfg.microbatch if cfg.microbatch > 0 else b
        if b > mb and b % mb:
            raise ValueError(
                f"batch size {b} must be a multiple of microbatch {mb} "
                f"(or <= it); pad the batch or adjust cfg.microbatch")
        t, weights, noise = self._draws(state, batch, generator, t, noise)
        n_micro = max(b // mb, 1)
        size = b if n_micro == 1 else mb
        n_data = self._axis("data")
        if size % n_data:
            raise ValueError(f"microbatches of {size} do not split over {n_data} "
                             "data ranks")
        self._gather_params()
        params = list(self.model.parameters())
        r, per = self.mesh.axis_index("data") if n_data > 1 else 0, size // n_data
        grads, per_ex = None, []
        for i in range(n_micro):
            lo = i * size + r * per
            part = slice(lo, lo + per) if n_micro > 1 or n_data > 1 else slice(None)
            loss, per_rows = self._loss(batch[part], t[part], weights[part], noise[part],
                                        size)
            g = torch.autograd.grad(loss, params)
            grads = list(g) if grads is None else torch._foreach_add(grads, g)
            per_ex.append(coll.all_gather(per_rows.detach(), self.mesh, "data"))
        per_ex = torch.cat(per_ex)
        with torch.no_grad():
            if n_data > 1:
                grads = [coll.all_reduce_sum(g, self.mesh, "data") for g in grads]
            if n_micro > 1:
                torch._foreach_div_(grads, float(n_micro))
            grad_norm = self._update(state, list(state["params"].values()), grads)
            if cfg.schedule_sampler == "loss-second-moment":
                state["sampler_state"] = samplers.loss_aware_update(
                    state["sampler_state"], t, per_ex)
        state["step"] += 1
        return state, {"loss": per_ex.mean(), "grad_norm": grad_norm}

    def _update(self, state: TrainState, params, grads) -> torch.Tensor:
        """Clip, AdamW and EMA of this rank's slices, in place; ``grads`` are
        the full gradients.  Returns the global gradient norm."""
        cfg = self.cfg
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        grads = [self._local(g) for g in grads]
        if cfg.grad_clip:
            keep = grad_norm < cfg.grad_clip
            grads = [torch.where(keep, g, g / grad_norm * cfg.grad_clip) for g in grads]
        opt = state["opt_state"]
        lr = self._lr(opt["count"])
        opt["count"] += 1
        mu, nu = list(opt["mu"].values()), list(opt["nu"].values())
        torch._foreach_mul_(mu, _B1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - _B1))
        torch._foreach_mul_(nu, _B2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                   1 - _B2))
        count = np.float32(opt["count"])
        bc1 = float(np.float32(1) - np.float32(_B1) ** count)
        bc2 = float(np.float32(1) - np.float32(_B2) ** count)
        upd = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, _EPS)
        torch._foreach_div_(upd, den)
        if cfg.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(params, cfg.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)
        # e * r + p * (1 - r) with the first product fused into the sum, as
        # XLA compiles it: the EMA of a parameter near 1 moves by a few ulps
        # a step, so the rounding shows
        for rate, ema in zip(cfg.ema_rates, state["ema"]):
            new = torch._foreach_mul(params, 1 - rate)
            torch._foreach_add_(new, list(ema.values()), alpha=rate)
            ema.update(zip(ema, new))
        return grad_norm

    def train_steps(self, state: TrainState, batches: torch.Tensor,
                    generator: Optional[torch.Generator] = None, *,
                    t: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None):
        """K ``train_step``s over ``batches`` (K, B, ...), drawing from one
        generator in turn (or from ``t`` (K, B) and ``noise`` (K, B, ...));
        the metrics come back stacked, shape (K,)."""
        out = []
        for k in range(batches.shape[0]):
            state, m = self.train_step(state, batches[k], generator,
                                       t=None if t is None else t[k],
                                       noise=None if noise is None else noise[k])
            out.append(m)
        return state, {key: torch.stack([m[key] for m in out]) for key in out[0]}

    def train_steps_from_pool(self, state: TrainState, pool: torch.Tensor,
                              idx: torch.Tensor,
                              generator: Optional[torch.Generator] = None, *,
                              t: Optional[torch.Tensor] = None,
                              noise: Optional[torch.Tensor] = None):
        """``train_steps(state, pool[idx])`` with the batches gathered on the
        device from ``pool`` (N, ...); ``idx`` is (K, B) int32."""
        idx = torch.as_tensor(idx, device=pool.device)
        out = []
        for k in range(idx.shape[0]):
            state, m = self.train_step(state, pool.index_select(0, idx[k]), generator,
                                       t=None if t is None else t[k],
                                       noise=None if noise is None else noise[k])
            out.append(m)
        return state, {key: torch.stack([m[key] for m in out]) for key in out[0]}

    # ------------------------------------------------------------------
    def fit(self, state: TrainState, data_iterator=None, *, steps: int, seed: int = 0,
            pool: Optional[Any] = None, batch_size: Optional[int] = None,
            pool_seed: int = 0, ckpt_dir: Optional[str] = None,
            save_fn: Optional[Callable[[TrainState], None]] = None,
            save_interval: int = 10_000, log_interval: int = 100,
            mesh: Any = None, steps_per_call: int = 1) -> TrainState:
        """Run the training loop (reference ``TrainLoop.run_loop``): steps,
        kv-logging of the mean loss and grad_norm every ``log_interval``
        steps, and ``save(state, ckpt_dir)`` and ``save_fn(state)`` every
        ``save_interval`` steps and at the end.

        Data comes from exactly one of ``data_iterator`` (yields (images
        NHWC in [-1, 1], labels or None) numpy batches, as
        ``train.datasets.load_data``) or ``pool`` + ``batch_size`` (a fixed
        (N, H, W, C) dataset moved to the device once; each dispatch ships
        only the int32 indices ``numpy.random.default_rng(pool_seed)``
        draws).  ``steps_per_call`` steps go into each dispatch; the log and
        save intervals fire when a dispatch crosses them.

        Under a mesh (the Trainer's, or ``mesh`` here when it has no
        ``model`` axis, which would shard the state) every rank must see the
        same global batches, as ``pool`` and a seeded ``data_iterator`` give
        them; only rank 0 logs and writes checkpoints.
        """
        from diffpir_tpu_torch.utils import kvlogger

        if mesh is not None and mesh is not self.mesh:
            if self.mesh is not None or mesh.axis_size("model") > 1:
                raise ValueError("fit(mesh=) takes a data-parallel mesh for a Trainer "
                                 "built without one; a model axis shards the state, so "
                                 "give it to Trainer(mesh=) before init_state")
            self.mesh = mesh
        main = self.mesh is None or not dist.is_initialized() or dist.get_rank() == 0
        K = max(steps_per_call, 1)
        if (pool is None) == (data_iterator is None):
            raise ValueError("fit() needs exactly one of data_iterator / pool")
        if pool is not None:
            if not batch_size:
                raise ValueError("fit(pool=...) requires batch_size")
            pool = torch.as_tensor(pool).float().to(self.device)
            pool_rng = np.random.default_rng(pool_seed)

        metric_buf: list = []
        i = 0
        saved_at = -1
        while i < steps:
            k_eff = min(K, steps - i)
            gen = torch.Generator(self.device).manual_seed(_dispatch_seed(seed, i))
            if pool is not None:
                idx = torch.from_numpy(pool_rng.integers(
                    0, pool.shape[0], (k_eff, batch_size)).astype(np.int32))
                state, m = self.train_steps_from_pool(
                    state, pool, idx.to(self.device), gen)
                metric_buf.append({k: v.mean() for k, v in m.items()})
            elif k_eff == 1:
                batch_np, _labels = next(data_iterator)
                state, m = self.train_step(state, torch.from_numpy(batch_np), gen)
                metric_buf.append(m)
            else:
                stack = np.stack([next(data_iterator)[0] for _ in range(k_eff)])
                state, m = self.train_steps(state, torch.from_numpy(stack), gen)
                metric_buf.append({k: v.mean() for k, v in m.items()})
            prev, i = i, i + k_eff
            # the metrics stay on the device between log points: a float()
            # per step would wait for the card every step
            if i // log_interval > prev // log_interval and not main:
                metric_buf.clear()
            elif i // log_interval > prev // log_interval:
                for m in metric_buf:
                    kvlogger.logkv_mean("loss", float(m["loss"]))
                    kvlogger.logkv_mean("grad_norm", float(m["grad_norm"]))
                metric_buf.clear()
                kvlogger.logkv("step", int(state["step"]))
                kvlogger.dumpkvs()
            if i // save_interval > prev // save_interval:
                saved_at = i
                if ckpt_dir:
                    self.save(state, ckpt_dir)
                if save_fn is not None:
                    save_fn(state)
        if saved_at != i:
            if ckpt_dir:
                self.save(state, ckpt_dir)
            if save_fn is not None:
                save_fn(state)
        return state

    # ------------------------------------------------------------------
    def save(self, state: TrainState, ckpt_dir: str, step: Optional[int] = None) -> str:
        """``torch.save`` the whole state (parameters, Adam moments and
        count, EMA, step, sampler state) to ``ckpt_dir/step_{step:08d}``,
        through a temporary file renamed into place.  Under a mesh the
        slices are gathered on every rank and rank 0 writes."""
        step = int(state["step"]) if step is None else step
        path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step:08d}"))
        self._gather_params()
        full = dict(self.model.named_parameters())

        def cpu(d):
            return {n: self._full(v, full[n]).detach().cpu() for n, v in d.items()}

        opt = state["opt_state"]
        blob = dict(params={n: p.detach().cpu() for n, p in full.items()},
                    opt_state=dict(count=int(opt["count"]), mu=cpu(opt["mu"]),
                                   nu=cpu(opt["nu"])),
                    ema=[cpu(e) for e in state["ema"]], step=int(state["step"]))
        if "sampler_state" in state:
            blob["sampler_state"] = {k: v.detach().cpu()
                                     for k, v in state["sampler_state"]._asdict().items()}
        if self.mesh is not None and dist.is_initialized() and dist.get_rank() != 0:
            return path
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = path + ".tmp"
        torch.save(blob, tmp)
        os.replace(tmp, path)
        return path

    def _full(self, v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """The full tensor of this rank's slice ``v`` of a tensor shaped as
        the parameter ``like``."""
        d = _param_sharding_rule(tuple(like.shape), self._axis("model"))
        if d is None:
            return v
        return coll.all_gather(v.contiguous(), self.mesh, "model", d)

    def restore(self, path: str) -> TrainState:
        """The state saved at ``path``, its parameters loaded into the model."""
        blob = torch.load(path, map_location="cpu", weights_only=True)
        params = dict(self.model.named_parameters())
        if set(blob["params"]) != set(params):
            raise ValueError(f"{path} holds the parameters of another model")
        dev = self.device

        def on_dev(d):  # this rank's slices
            return {n: self._local(d[n].to(dev)).clone() for n in params}

        with torch.no_grad():
            for n, p in params.items():
                p.copy_(blob["params"][n])
                p.requires_grad_(True)
        opt = blob["opt_state"]
        state = dict(params={n: self._local(p) for n, p in params.items()},
                     opt_state=dict(count=opt["count"], mu=on_dev(opt["mu"]),
                                    nu=on_dev(opt["nu"])),
                     ema=tuple(on_dev(e) for e in blob["ema"]), step=blob["step"])
        if "sampler_state" in blob:
            state["sampler_state"] = samplers.LossSecondMomentState(
                **{k: v.to(dev) for k, v in blob["sampler_state"].items()})
        return state


def dryrun_train_step(n_devices: int) -> float:
    """One sharded train step on tiny shapes (``diffpir_tpu/train/loop.py:
    368-406``): the batch over ``data``, the parameters, Adam moments and
    EMA fsdp-sharded over ``model`` (2 when ``n_devices`` is even), fp32,
    microbatches of 4, the loss-second-moment sampler.  Returns the loss, a
    global-batch mean, so every rank and the one-rank run agree on it.  Run
    in a group of ``n_devices`` ranks; with no group and ``n_devices`` > 1
    it starts one of gloo ranks on the CPU and returns rank 0's loss."""
    from diffpir_tpu_torch.models.unet import UNetConfig
    from diffpir_tpu_torch.parallel.mesh import make_mesh
    from diffpir_tpu_torch.parallel.multihost import rank_device, spawn
    from diffpir_tpu_torch.diffusion import ModelMeanType, ModelVarType
    from diffpir_tpu_torch.schedule import NoiseSchedule

    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices > 1 and world == 1:
        return spawn("diffpir_tpu_torch.train.loop:dryrun_train_step", n_devices,
                     [n_devices])[0]
    if world != n_devices:
        raise ValueError(f"dryrun_train_step({n_devices}) runs on {n_devices} ranks, "
                         f"this group has {world}")
    mesh = None
    if n_devices > 1:
        model_axis = 2 if n_devices % 2 == 0 else 1
        mesh = make_mesh((n_devices // model_axis, model_axis), ("data", "model"))
    device = rank_device()
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    ucfg = UNetConfig(image_size=16, model_channels=32, out_channels=6,
                      num_res_blocks=1, attention_resolutions=(2,),
                      channel_mult=(1, 2), num_heads=4, num_head_channels=16,
                      dropout=0.0)
    model = UNet(ucfg, dtype=torch.float32, param_dtype=torch.float32).to(device)
    diff = Diffusion(NoiseSchedule.named("linear", 100), ModelMeanType.EPSILON,
                     ModelVarType.LEARNED_RANGE)
    tcfg = TrainConfig(lr=1e-4, ema_rates=(0.999,), microbatch=4,
                       compute_dtype="float32", schedule_sampler="loss-second-moment")
    trainer = Trainer(model, diff, tcfg, mesh=mesh)
    state = trainer.init_state(0)
    batch = torch.from_numpy(
        np.random.default_rng(0).standard_normal((8, 16, 16, 3)).astype(np.float32))
    gen = torch.Generator(device).manual_seed(1)
    state, metrics = trainer.train_step(state, batch, gen)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"non-finite loss {loss}"
    assert int(state["step"]) == 1
    return loss
