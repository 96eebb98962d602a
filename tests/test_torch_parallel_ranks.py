"""What the ranks of the port's mesh tests run (``parallel.multihost.spawn``
starts them as gloo ranks on the CPU, two threads each).  Imports neither
JAX nor the JAX package, so a rank starts in about two seconds; the tests
(``test_torch_parallel.py``, ``test_torch_tp.py``) compare what comes back
with the unsharded port and with JAX.  It holds no test of its own."""

import os

import numpy as np
import torch
import torch.distributed as dist

from diffpir_tpu_torch.config import load_config
from diffpir_tpu_torch.models.unet import UNet
from diffpir_tpu_torch.models.zoo import TINY_TEST_CONFIG, flax_to_torch, load_params_npz
from diffpir_tpu_torch.parallel.mesh import make_mesh
from diffpir_tpu_torch.parallel.tp import shard_unet_params
from diffpir_tpu_torch.runner import Runner, _dryrun_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY32 = os.path.join(ROOT, "assets", "demo", "tiny_demo32.flax.npz")
MESHES = [((4,), ("data",)), ((2, 2), ("data", "model")), ((2, 2), ("data", "space"))]


def _cfg(task, model_name, mesh_shape=None, mesh_axes=None, **kw):
    return load_config(None, overrides=dict(
        task=task, model_name=model_name, iter_num=2, iter_num_U=1, batch_size=4,
        noise_level_img=0.0, seed=0, dtype="float32", save_L=False, save_E=False,
        mesh_shape=mesh_shape, mesh_axes=mesh_axes,
        **(dict(sf=2, sr_mode="blur") if task == "sr" else {}), **kw))


def _is_root() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def sharded_forward(path: str, shape, axes) -> None:
    """The tiny UNet (the tiny_demo32 prior's parameters) sharded under the
    mesh, on the inputs in ``path``; rank 0 writes the output beside them."""
    with np.load(path) as z:
        x, t = torch.from_numpy(z["x"]), torch.from_numpy(z["t"])
    model = UNet(TINY_TEST_CONFIG)
    model.load_state_dict(flax_to_torch(load_params_npz(TINY32)))
    mesh = make_mesh(tuple(shape), tuple(axes))
    shard_unet_params(model.eval(), mesh)
    model.set_mesh(mesh)
    with torch.no_grad():
        out = model(x, t).numpy()
    if _is_root():
        np.save(path + f".{'x'.join(axes)}.npy", out)


def suite4(workdir: str) -> dict:
    """Everything the 4-rank group of ``test_torch_parallel.py`` checks."""
    res: dict = {}
    # restores of the three tasks under dp, dp x tp and dp x sp, against the
    # unsharded port (rank 0 runs that too)
    for task in ("inpaint", "deblur", "sr"):
        batch = _dryrun_batch(np.random.default_rng(1), 4, 64, task)
        ref = None
        if _is_root():
            ref = Runner(_cfg(task, "tiny_test"), device="cpu",
                         use_mesh=False).restore_batch(batch)
        for shape, axes in MESHES:
            runner = Runner(_cfg(task, "tiny_test", shape, axes), device="cpu")
            assert runner.mesh is not None and runner.mesh.shape == dict(zip(axes, shape))
            out = runner.restore_batch(batch)
            if ref is not None:
                res[f"{task} {'x'.join(axes)}"] = float(np.abs(out - ref).max())
                res[f"{task} shape"] = list(out.shape)
    # the forwards for the JAX comparison (inputs written by the test)
    for shape, axes in (((2, 2), ("data", "model")), ((2, 2), ("data", "space"))):
        sharded_forward(os.path.join(workdir, "fwd.npz"), shape, axes)
    # heights that do not halve down every level on each space rank
    runner = Runner(_cfg("inpaint", "tiny_test", (2, 2), ("data", "space")), device="cpu")
    try:
        runner.restore_batch(_dryrun_batch(np.random.default_rng(2), 4, 40, "inpaint"))
        res["uneven"] = "no error"
    except ValueError as e:
        res["uneven"] = str(e)
    # training: the sharded dry-run step, and each rank's slices after it
    from diffpir_tpu_torch.train.loop import dryrun_train_step

    res["train_loss"] = dryrun_train_step(4)
    res["slices"] = train_slices()
    # the JAX package's dry run (restores, the mesh-bundle stage, then the
    # service's coalescing round)
    from diffpir_tpu_torch.runner import dryrun_restore

    dryrun_restore(4, bundle=True)
    res["dryrun_restore"] = "ok"
    return res


def train_slices() -> dict:
    """One step of a data x model (2 x 2) Trainer against the same step on
    one rank: the largest difference of this rank's parameter, Adam moment
    and EMA slices from the one-rank update, and the losses."""
    from diffpir_tpu_torch.diffusion import Diffusion, ModelMeanType, ModelVarType
    from diffpir_tpu_torch.models.unet import UNetConfig
    from diffpir_tpu_torch.schedule import NoiseSchedule
    from diffpir_tpu_torch.train.loop import TrainConfig, Trainer

    ucfg = UNetConfig(image_size=16, model_channels=32, out_channels=6, num_res_blocks=1,
                      attention_resolutions=(2,), channel_mult=(1, 2), num_heads=4,
                      num_head_channels=16)
    tcfg = TrainConfig(lr=1e-3, ema_rates=(0.9,), microbatch=4, compute_dtype="float32",
                       schedule_sampler="loss-second-moment", weight_decay=0.01,
                       grad_clip=1.0)
    diff = Diffusion(NoiseSchedule.named("linear", 100), ModelMeanType.EPSILON,
                     ModelVarType.LEARNED_RANGE)
    batch = torch.from_numpy(
        np.random.default_rng(5).standard_normal((8, 16, 16, 3)).astype(np.float32))

    def step(mesh):
        model = UNet(ucfg, param_dtype=torch.float32)
        trainer = Trainer(model, diff, tcfg, mesh=mesh)
        state = trainer.init_state(3)
        state, m = trainer.train_step(state, batch, torch.Generator().manual_seed(7))
        return trainer, state, m

    trainer, state, m = step(make_mesh((2, 2), ("data", "model")))
    _, ref, mref = step(None)
    worst, sliced = 0.0, 0
    for name, p in state["params"].items():
        full = ref["params"][name]
        for a, b in ((p, trainer._local(full)),
                     (state["opt_state"]["mu"][name], trainer._local(ref["opt_state"]["mu"][name])),
                     (state["opt_state"]["nu"][name], trainer._local(ref["opt_state"]["nu"][name])),
                     (state["ema"][0][name], trainer._local(ref["ema"][0][name]))):
            worst = max(worst, float((a - b).abs().max()))
        sliced += p.shape != full.shape
    return {"max_diff": worst, "sliced": sliced, "n": len(state["params"]),
            "loss": float(m["loss"]), "ref_loss": float(mref["loss"]),
            "grad_norm": float(m["grad_norm"]), "ref_grad_norm": float(mref["grad_norm"]),
            "sampler": float((state["sampler_state"].history
                              - ref["sampler_state"].history).abs().max())}


def suite8(workdir: str) -> dict:
    """The 8-rank group of ``test_torch_tp.py``: the 2 x 2 x 2 inpaint
    against the unsharded port, and a dp x tp (2 x 4) deblur restore fed the
    JAX package's draws, for the JAX Runner comparison."""
    res: dict = {}
    batch = _dryrun_batch(np.random.default_rng(1), 4, 64, "inpaint")
    ref = None
    if _is_root():
        ref = Runner(_cfg("inpaint", "tiny_test"), device="cpu",
                     use_mesh=False).restore_batch(batch)
    out = Runner(_cfg("inpaint", "tiny_test", (2, 2, 2), ("data", "model", "space")),
                 device="cpu").restore_batch(batch)
    if ref is not None:
        res["dp x tp x sp"] = float(np.abs(out - ref).max())
    with np.load(os.path.join(workdir, "jax_deblur.npz")) as z:
        d = {k: z[k] for k in z.files}
    cfg = load_config(str(d["config"]), dict(
        cwd=ROOT, save_E=False, save_L=False, model_name="tiny_demo32",
        testset_name="demo32", iter_num=int(d["iter_num"]), ty_init=True,
        mesh_shape=(2, 4), mesh_axes=("data", "model")))
    runner = Runner(cfg, device="cpu")

    def noise(i, u, which, shape):
        key = "init" if which == "init" else f"{which}_{i}_{u}"
        return torch.from_numpy(d[key])

    t = lambda a: torch.from_numpy(a)  # noqa: E731
    got = runner.restore(t(d["img_L"]), t(d["mask"]), cfg.lambda_, cfg.zeta, 3,
                         noise=noise, kernel=t(d["kernel"]))
    if _is_root():
        np.save(os.path.join(workdir, "port_deblur.npy"), got.numpy())
    return res


def export_suite4(workdir: str) -> dict:
    """The 4-rank group of ``test_torch_export_mesh.py``: mesh bundles of the
    tiny inpaint restore under (4,) data, (2, 2) data x model, a
    dynamic-point (4,) data mesh and (2, 2) data x space, and of the tiny
    DPS_y0 deblur restore under (2, 2) data x model, each loaded and run on
    the group against the unsharded runner (rank 0 runs that).  The bundles
    stay under ``workdir``.  (The dry run's mesh-bundle stage runs in
    ``suite4``.)"""
    from diffpir_tpu_torch.export import load_bundle, program_report, save_bundle

    res: dict = {}
    batches = {task: _dryrun_batch(np.random.default_rng(2), 4, 32, task)
               for task in ("inpaint", "deblur")}
    refs = {}
    if _is_root():
        ref_runner = Runner(_cfg("inpaint", "tiny_test"), device="cpu", use_mesh=False)
        refs["inpaint", False] = ref_runner.restore_batch(batches["inpaint"], seed=5)
        refs["inpaint", True] = ref_runner.restore_batch(batches["inpaint"], lambda_=9.0,
                                                         seed=5)
        refs["deblur", False] = Runner(
            _cfg("deblur", "tiny_test", generate_mode="DPS_y0"), device="cpu",
            use_mesh=False).restore_batch(batches["deblur"], seed=5)
    for name, task, shape, axes, dynamic, over in (
            ("data", "inpaint", (4,), ("data",), False, {}),
            ("dataxmodel", "inpaint", (2, 2), ("data", "model"), False, {}),
            ("data_dynamic", "inpaint", (4,), ("data",), True, {}),
            ("dataxspace", "inpaint", (2, 2), ("data", "space"), False, {}),
            ("dps_dataxmodel", "deblur", (2, 2), ("data", "model"), False,
             dict(generate_mode="DPS_y0"))):
        batch = batches[task]
        runner = Runner(_cfg(task, "tiny_test", list(shape), list(axes), **over),
                        device="cpu")
        path = save_bundle(runner, os.path.join(workdir, name), batch=4, height=32,
                           width=32, kernel_hw=tuple(batch.kernel.shape[1:]),
                           dynamic_point=dynamic, platforms=("cpu",),
                           allow_random_weights=True)
        loaded = load_bundle(path, device="cpu")
        got = loaded(batch.img_L, kernel=batch.kernel, mask=batch.mask, seed=5,
                     **({"lambda_": 9.0} if dynamic else {}))
        if _is_root():
            res[name] = float(np.abs(got - refs[task, dynamic]).max())
            res[f"{name} mesh"] = loaded.manifest["mesh"]
            res[f"{name} shape"] = list(got.shape)
            res[f"{name} report"] = program_report(loaded.programs["step"])
    return res

def _grad(loss_fn, x):
    xv = x.clone().requires_grad_()
    (g,) = torch.autograd.grad(loss_fn(xv), xv)
    return g


def collective_grads() -> dict:
    """The gradient of a scalar through each collective over a 2-rank axis
    against the same scalar's unsharded gradient (``grad_suite2``): every
    rank computes the scalar alike, so a replicated input gets the whole
    gradient and a rank's block its block's."""
    from diffpir_tpu_torch.models.unet import Conv
    from diffpir_tpu_torch.parallel import collectives as coll

    mesh = make_mesh((2,), ("space",))
    r = mesh.axis_index("space")
    g = torch.Generator().manual_seed(11)
    x = torch.randn((2, 8, 6, 4), generator=g)          # the whole tensor
    w = torch.randn((2, 2, 8, 6, 4), generator=g)       # one weight a rank
    blk = slice(4 * r, 4 * r + 4)
    res = {}
    # axis_block (replicated -> block) then the all-reduce of the partial sums
    got = _grad(lambda v: coll.all_reduce_sum(
        (w[0, :, blk] * coll.axis_block(v, mesh, "space", dim=1)).sum(), mesh, "space"), x)
    res["axis_block+all_reduce_sum"] = float((got - w[0]).abs().max())
    # all_gather (block -> replicated), the scalar computed alike everywhere
    got = _grad(lambda v: (w[0] * coll.all_gather(v, mesh, "space", dim=1)).sum(),
                x[:, blk])
    res["all_gather"] = float((got - w[0][:, blk]).abs().max())
    # grad_all_reduce: a replicated input whose uses differ per rank
    got = _grad(lambda v: coll.all_reduce_sum(
        (w[r] * coll.grad_all_reduce(v, mesh, "space")).sum(), mesh, "space"), x)
    res["grad_all_reduce"] = float((got - w.sum(0)).abs().max())
    # halo_rows, through a 3x3 convolution of the split rows
    conv = Conv(4, 5)
    torch.nn.init.normal_(conv.weight, generator=g)
    gy = torch.randn((2, 8, 6, 5), generator=g)
    ref = _grad(lambda v: (gy * conv(v)).sum(), x)
    conv.space = mesh
    got = _grad(lambda v: coll.all_reduce_sum((gy[:, blk] * conv(v)).sum(), mesh, "space"),
                x[:, blk])
    res["halo_rows"] = float((got - ref[:, blk]).abs().max())
    return res


def unet_grads() -> dict:
    """d||1.7 x - 0.9 eps(x)|| / dx through the tiny_demo32 UNet sharded
    under model = 2 and under space = 2 against the unsharded gradient."""
    gen = np.random.default_rng(3)
    x = torch.from_numpy(gen.standard_normal((2, 32, 32, 3)).astype(np.float32))
    t = torch.tensor([999, 300])

    def grad(mesh):
        model = UNet(TINY_TEST_CONFIG)
        model.load_state_dict(flax_to_torch(load_params_npz(TINY32)))
        model.requires_grad_(False)
        if mesh is not None:
            shard_unet_params(model, mesh)
            model.set_mesh(mesh)
        return _grad(lambda v: (1.7 * v - 0.9 * model(v, t)[..., :3]).square().sum().sqrt(), x)

    ref = grad(None)
    res = {"scale": float(ref.abs().max())}
    for axis in ("model", "space"):
        res[axis] = float((grad(make_mesh((2,), (axis,))) - ref).abs().max())
    return res


def grad_suite2(workdir: str) -> dict:
    """The 2-rank group of ``test_torch_mesh_grad.py``: gradients through
    each collective and through the sharded UNet, then DPS_y0 deblur
    restores under model = 2 and space = 2 against the unsharded restore
    (rank 0 runs that), and the space one's bundle."""
    from diffpir_tpu_torch.export import load_bundle, program_report, save_bundle

    res = {"collectives": collective_grads(), "unet": unet_grads()}
    for task in ("deblur",):
        batch = _dryrun_batch(np.random.default_rng(4), 2, 32, task)
        over = dict(generate_mode="DPS_y0")
        ref = Runner(_cfg(task, "tiny_test", **over), device="cpu",
                     use_mesh=False).restore_batch(batch, seed=3)
        for axis in ("model", "space"):
            runner = Runner(_cfg(task, "tiny_test", [2], [axis], **over), device="cpu")
            out = runner.restore_batch(batch, seed=3)
            res[f"dps {task} {axis}"] = float(np.abs(out - ref).max())
            res[f"dps {task} shape"] = list(out.shape)
            if task == "deblur" and axis == "space":
                # the DPS_y0 bundle over the space axis: its step program
                # records the gradient through the collectives and halves
                path = save_bundle(runner, os.path.join(workdir, "dps_space"), batch=2,
                                   height=32, width=32, kernel_hw=(7, 7),
                                   platforms=("cpu",), allow_random_weights=True)
                loaded = load_bundle(path, device="cpu")
                got = loaded(batch.img_L, kernel=batch.kernel, seed=3)
                res["dps bundle space"] = float(np.abs(got - ref).max())
                res["dps bundle space report"] = program_report(loaded.programs["step"])
    return res
