"""The port's ``Trainer`` against the JAX package's, the slice as a whole.

Both start from the same non-zero weights (the port's ``init_random_``,
carried to JAX by ``zoo.torch_to_flax``) and take the same draws: JAX's
``t`` and noise, made from its key as its step makes them, are handed to the
port.  After each of three steps: the loss and ``grad_norm`` within 1e-5
relative; each parameter's and each EMA's change since step 0 (over the
entries whose gradient is not 0 but for rounding, see test_step_matches_jax),
and Adam's ``mu`` and ``nu``, within 1e-3 relative L2; after the first step each
gradient leaf (Adam's ``mu`` is exactly (1 - b1) times it) within 1e-4
relative L2; the loss-second-moment counts bit-equal and its history (the
per-example losses) within 1e-5.  fp32 on the CPU, at the 16-px model of
``dryrun_train_step`` (``diffpir_tpu/train/loop.py:383-386``) with 64 base
channels instead of 32: with 32 channels in 32 groups GroupNorm normalises
each channel alone, so a conv bias in front of it has a gradient of 0 up to
rounding, and Adam's first step turns that rounding into steps of +-lr
whose signs differ between the packages.  Two JAX
configurations cover the cases: the uniform sampler alone, and microbatches
of 2 with ``grad_clip``, ``lr_anneal_steps``, weight decay, two EMA rates and
the loss-second-moment sampler; each is compiled once, in a module-scope
fixture.  The rest holds the port to itself (``train_steps``, the pool
path, save/restore, refusals) and ``fit``'s schedule to JAX's.
"""

import csv
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffpir_tpu.diffusion import Diffusion as JDiffusion
from diffpir_tpu.models.unet import UNet as JUNet
from diffpir_tpu.models.unet import UNetConfig as JUNetConfig
from diffpir_tpu.models.zoo import _flatten, _unflatten
from diffpir_tpu.schedule import NoiseSchedule as JSchedule
from diffpir_tpu.train import loop as jloop
from diffpir_tpu.train import samplers as jsamplers
from diffpir_tpu.utils import kvlogger as jkv
from diffpir_tpu_torch.diffusion import Diffusion as TDiffusion
from diffpir_tpu_torch.models import zoo as tzoo
from diffpir_tpu_torch.models.unet import UNet as TUNet
from diffpir_tpu_torch.models.unet import UNetConfig as TUNetConfig
from diffpir_tpu_torch.schedule import NoiseSchedule as TSchedule
from diffpir_tpu_torch.train import loop as tloop
from diffpir_tpu_torch.utils import kvlogger as tkv

UNET = dict(image_size=16, model_channels=64, out_channels=6, num_res_blocks=1,
            attention_resolutions=(2,), channel_mult=(1, 2), num_heads=4,
            num_head_channels=16, dropout=0.0)
B, SHAPE, T, STEPS = 4, (4, 16, 16, 3), 100, 3
CONFIGS = {
    "uniform": dict(lr=1e-3, ema_rates=(0.99,), compute_dtype="float32"),
    "micro_clip_anneal_lsm": dict(lr=1e-3, weight_decay=0.1, ema_rates=(0.9, 0.99),
                                  microbatch=2, lr_anneal_steps=2, grad_clip=0.5,
                                  schedule_sampler="loss-second-moment",
                                  compute_dtype="float32"),
}



@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Parallel test workers each start one PyTorch thread per core, which
    oversubscribes the cores; two threads for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

def _relative_l2(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _port(cfg: dict, seed: int = 0):
    model = tzoo.init_random_(TUNet(TUNetConfig(**UNET), param_dtype=torch.float32), seed)
    diff = TDiffusion(TSchedule.named("linear", T), "epsilon", "learned_range")
    trainer = tloop.Trainer(model, diff, tloop.TrainConfig(**cfg))
    return trainer, trainer.init_state(seed=None)


def _flat(d) -> dict:
    """A dict of the port's tensors -> flat JAX-layout numpy arrays."""
    return tzoo.torch_to_flax(d)


def _adam(opt_state):
    """The ScaleByAdamState inside optax's (possibly chained) state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, tuple):
        for s in opt_state:
            found = _adam(s)
            if found is not None:
                return found
    return None


def _jax_draws(jtrainer, jstate, key):
    """(t, noise) as JAX's step draws them from ``key``."""
    cfg = jtrainer.cfg
    k_t, k_noise = jax.random.split(key)
    if cfg.schedule_sampler == "loss-second-moment":
        t, _ = jsamplers.loss_aware_sample(jstate["sampler_state"], k_t, B)
    else:
        t, _ = jsamplers.uniform_sample(k_t, B, T)
    mb = cfg.microbatch if cfg.microbatch > 0 else B
    n_micro = max(B // mb, 1)
    if n_micro == 1:
        noise = jax.random.normal(k_noise, SHAPE, jnp.float32)
    else:
        noise = jnp.concatenate([
            jax.random.normal(jax.random.fold_in(k_noise, i), (mb,) + SHAPE[1:],
                              jnp.float32) for i in range(n_micro)])
    return np.array(t), np.array(noise)


@pytest.fixture(scope="module")
def runs():
    """Per config: the JAX and port states' snapshots after each step."""
    out = {}
    for name, cfg in CONFIGS.items():
        trainer, state = _port(cfg)
        params0 = _flat(state["params"])
        jtr = jloop.Trainer(JUNet(JUNetConfig(**UNET), dtype=jnp.float32),
                            JDiffusion(JSchedule.named("linear", T), "epsilon",
                                       "learned_range"),
                            jloop.TrainConfig(**cfg))
        jparams = jax.tree_util.tree_map(jnp.asarray, _unflatten(params0))
        jstate = dict(params=jparams, opt_state=jtr.tx.init(jparams),
                      ema=tuple(jax.tree_util.tree_map(jnp.copy, jparams)
                                for _ in cfg["ema_rates"]),
                      step=jnp.zeros((), jnp.int32))
        if cfg.get("schedule_sampler") == "loss-second-moment":
            jstate["sampler_state"] = jsamplers.loss_aware_init(T)
        rng = np.random.default_rng(0)
        snaps = []
        for k in range(STEPS):
            batch = np.clip(rng.standard_normal(SHAPE) * 0.5, -1, 1).astype(np.float32)
            key = jax.random.PRNGKey(10 + k)
            t, noise = _jax_draws(jtr, jstate, key)
            jstate, jm = jtr.train_step(jstate, jnp.asarray(batch), key)
            state, tm = trainer.train_step(state, torch.from_numpy(batch),
                                           t=torch.from_numpy(t),
                                           noise=torch.from_numpy(noise))
            adam = _adam(jstate["opt_state"])
            snap = dict(
                jax=dict(loss=float(jm["loss"]), grad_norm=float(jm["grad_norm"]),
                         params=_flatten(jax.device_get(jstate["params"])),
                         ema=[_flatten(jax.device_get(e)) for e in jstate["ema"]],
                         mu=_flatten(jax.device_get(adam.mu)),
                         nu=_flatten(jax.device_get(adam.nu)), step=int(jstate["step"])),
                port=dict(loss=float(tm["loss"]), grad_norm=float(tm["grad_norm"]),
                          params=_flat(state["params"]),
                          ema=[_flat(e) for e in state["ema"]],
                          mu=_flat(state["opt_state"]["mu"]),
                          nu=_flat(state["opt_state"]["nu"]), step=state["step"]))
            if "sampler_state" in state:
                snap["jax"]["sampler"] = [np.array(a) for a in jstate["sampler_state"]]
                snap["port"]["sampler"] = [a.numpy().copy() for a in state["sampler_state"]]
            snaps.append(snap)
        out[name] = dict(params0=params0, snaps=snaps)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("step", range(STEPS))
def test_step_matches_jax(runs, name, step):
    run = runs[name]
    j, p = run["snaps"][step]["jax"], run["snaps"][step]["port"]
    assert p["step"] == j["step"] == step + 1
    for k in ("loss", "grad_norm"):
        assert p[k] == pytest.approx(j[k], rel=1e-5), k
    p0 = run["params0"]
    lr = CONFIGS[name]["lr"]
    for leaf in p0:
        # Adam moves an entry whose gradient is 0 but for rounding (the key
        # part of each qkv bias: softmax ignores a constant added to all of
        # a query's logits) by about lr * g / eps, so its rounding decides;
        # those entries are held to Adam's step bound, the others to 1e-3
        g0 = np.abs(run["snaps"][0]["jax"]["mu"][leaf])
        live = g0 > 1e-5 * g0.max()
        for got, ref in [(p["params"][leaf], j["params"][leaf])] + [
                (pe[leaf], je[leaf]) for pe, je in zip(p["ema"], j["ema"])]:
            d_got, d_ref = got - p0[leaf], ref - p0[leaf]
            assert _relative_l2(d_got[live], d_ref[live]) <= 1e-3, leaf
            assert np.abs(d_got[~live]).max(initial=0) <= 1.01 * lr * (step + 1), leaf
        assert _relative_l2(p["mu"][leaf], j["mu"][leaf]) <= 1e-3, leaf
        assert _relative_l2(p["nu"][leaf], j["nu"][leaf]) <= 1e-3, leaf
    if "sampler" in j:
        (jh, jc), (ph, pc) = j["sampler"], p["sampler"]
        np.testing.assert_array_equal(pc, jc)
        np.testing.assert_allclose(ph, jh, rtol=1e-5, atol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_first_step_gradients_match_jax(runs, name):
    """After one step mu = (1 - b1) g: each leaf of the (accumulated,
    clipped) gradient within 1e-4 relative L2."""
    j, p = runs[name]["snaps"][0]["jax"], runs[name]["snaps"][0]["port"]
    for leaf in j["mu"]:
        assert _relative_l2(p["mu"][leaf], j["mu"][leaf]) <= 1e-4, leaf


def test_the_cases_exercise_their_branches(runs):
    """The clip config clipped (its grad_norm above grad_clip) and the
    sampler took every example of each step, a repeated timestep included."""
    snaps = runs["micro_clip_anneal_lsm"]["snaps"]
    assert snaps[0]["port"]["grad_norm"] > CONFIGS["micro_clip_anneal_lsm"]["grad_clip"]
    counts = snaps[-1]["port"]["sampler"][1]
    assert counts.sum() == B * STEPS


def _batches(k, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1, 1, (k,) + SHAPE).astype(np.float32))


def _equal_states(a, b):
    assert a["step"] == b["step"] and a["opt_state"]["count"] == b["opt_state"]["count"]
    for part in ("params",):
        for n in a[part]:
            assert torch.equal(a[part][n], b[part][n]), n
    for n in a["params"]:
        assert torch.equal(a["opt_state"]["mu"][n], b["opt_state"]["mu"][n]), n
        assert torch.equal(a["opt_state"]["nu"][n], b["opt_state"]["nu"][n]), n
        for ea, eb in zip(a["ema"], b["ema"]):
            assert torch.equal(ea[n], eb[n]), n
    if "sampler_state" in a:
        for x, y in zip(a["sampler_state"], b["sampler_state"]):
            assert torch.equal(x, y)


CFG = CONFIGS["micro_clip_anneal_lsm"]


def test_train_steps_is_k_train_steps_bit_for_bit():
    batches = _batches(3)
    tr_a, st_a = _port(CFG)
    tr_b, st_b = _port(CFG)
    st_a, m_a = tr_a.train_steps(st_a, batches, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    m_b = []
    for k in range(3):
        st_b, m = tr_b.train_step(st_b, batches[k], gen)
        m_b.append(m)
    _equal_states(st_a, st_b)
    for key in ("loss", "grad_norm"):
        assert torch.equal(m_a[key], torch.stack([m[key] for m in m_b]))


def test_train_steps_from_pool_is_train_steps_of_the_gathered_batches():
    pool = _batches(1)[0].repeat(3, 1, 1, 1) * torch.linspace(0.2, 1, 12)[:, None, None, None]
    idx = torch.from_numpy(np.random.default_rng(2).integers(0, 12, (2, B)).astype(np.int32))
    tr_a, st_a = _port(CFG)
    tr_b, st_b = _port(CFG)
    st_a, m_a = tr_a.train_steps_from_pool(st_a, pool, idx, torch.Generator().manual_seed(6))
    st_b, m_b = tr_b.train_steps(st_b, pool[idx.long()], torch.Generator().manual_seed(6))
    _equal_states(st_a, st_b)
    assert all(torch.equal(m_a[k], m_b[k]) for k in m_a)


def test_save_restore_continue_equals_an_unbroken_run(tmp_path):
    batches = _batches(3, seed=3)
    gens = [torch.Generator().manual_seed(20 + k) for k in range(3)]
    tr, st = _port(CFG)
    for k in range(3):
        st, _ = tr.train_step(st, batches[k], gens[k])
    gens = [torch.Generator().manual_seed(20 + k) for k in range(3)]
    tr_a, st_a = _port(CFG)
    for k in range(2):
        st_a, _ = tr_a.train_step(st_a, batches[k], gens[k])
    path = tr_a.save(st_a, str(tmp_path))
    assert os.path.basename(path) == "step_00000002"
    tr_b, _ = _port(CFG, seed=7)  # other weights, all replaced by restore
    st_b = tr_b.restore(path)
    _equal_states(st_b, st_a)
    st_b, _ = tr_b.train_step(st_b, batches[2], gens[2])
    _equal_states(st_b, st)


def test_refusals():
    tr, st = _port(dict(CFG, microbatch=3))
    with pytest.raises(ValueError, match="multiple of microbatch"):
        tr.train_step(st, _batches(1)[0], torch.Generator().manual_seed(0))
    # the mesh paths (tests/test_torch_parallel.py) refuse a space axis, a
    # model axis handed to fit() after the state was made, and a dry run on
    # a group of another size
    from diffpir_tpu_torch.parallel.mesh import abstract_mesh

    with pytest.raises(ValueError, match="space axis"):
        tloop.Trainer(tr.model, tr.diffusion, tr.cfg,
                      mesh=abstract_mesh((1, 2), ("data", "space")))
    with pytest.raises(ValueError, match="model axis shards the state"):
        tr.fit(st, steps=1, pool=np.zeros((4, 16, 16, 3), np.float32), batch_size=4,
               mesh=abstract_mesh((1, 2), ("data", "model")))
    with pytest.raises(ValueError, match="runs on 0 ranks"):
        tloop.dryrun_train_step(0)
    with pytest.raises(ValueError, match="fp32 master"):
        tloop.Trainer(TUNet(TUNetConfig(**UNET)).to(torch.bfloat16), tr.diffusion,
                      tr.cfg)
    with pytest.raises(ValueError, match="generator"):
        tr.train_step(st, _batches(1)[0][:2])


def _fakes(to_array, calls):
    """Stand-ins for the step methods fit dispatches to: each records what
    it was handed and returns call-dependent metrics."""
    def metrics(k, single):
        base = np.arange(k, dtype=np.float32) + 0.25 * len(calls)
        m = {"loss": base, "grad_norm": 2 * base}
        return {n: to_array(v[:1].reshape(()) if single else v) for n, v in m.items()}

    def step(state, batch, _key):
        calls.append(np.asarray(batch))
        return dict(state, step=state["step"] + 1), metrics(1, True)

    def steps(state, batches, _key):
        calls.append(np.asarray(batches))
        k = batches.shape[0]
        return dict(state, step=state["step"] + k), metrics(k, False)

    def pool_steps(state, _pool, idx, _key):
        calls.append(np.asarray(idx))
        k = idx.shape[0]
        return dict(state, step=state["step"] + k), metrics(k, False)

    return dict(train_step=step, train_steps=steps, train_steps_from_pool=pool_steps)


def _iterator(seed=0):
    rng = np.random.default_rng(seed)
    while True:
        yield rng.standard_normal((2, 3, 3, 3)).astype(np.float32), None


@pytest.mark.parametrize("source,per_call", [("pool", 3), ("iterator", 1),
                                             ("iterator", 3)])
def test_fit_schedule_matches_jax(tmp_path, source, per_call):
    """fit's dispatches (pool indices or batches), log rows (CSV and JSON,
    byte for byte) and save crossings for 7 steps, K 3 (or 1), log 2, save
    5.  The steps are stand-ins here; the real ones are held above."""
    jtr = jloop.Trainer(JUNet(JUNetConfig(**UNET)),
                        JDiffusion(JSchedule.named("linear", T)),
                        jloop.TrainConfig(**CONFIGS["uniform"]))
    ptr, _ = _port(CONFIGS["uniform"])
    seen = {}
    for pkg, trainer, to_array, kv, key in (
            ("jax", jtr, jnp.asarray, jkv, {"key": jax.random.PRNGKey(0)}),
            ("port", ptr, torch.from_numpy, tkv, {"seed": 0})):
        calls, saves = [], []
        for name, fn in _fakes(to_array, calls).items():
            setattr(trainer, name, fn)
        data = (dict(pool=np.zeros((10, 3, 3, 3), np.float32), batch_size=4, pool_seed=3)
                if source == "pool" else dict(data_iterator=_iterator()))
        kv.reset()
        kv.configure(str(tmp_path / pkg), ["csv", "json"])
        try:
            trainer.fit({"step": 0}, steps=7, save_fn=lambda s: saves.append(s["step"]),
                        save_interval=5, log_interval=2, steps_per_call=per_call,
                        **key, **data)
        finally:
            kv.reset()
        files = [(tmp_path / pkg / f).read_text() for f in ("progress.csv",
                                                             "progress.json")]
        seen[pkg] = (calls, saves, files)
    (jc, js, jf), (pc, ps, pf) = seen["jax"], seen["port"]
    assert len(pc) == len(jc) == (3 if per_call == 3 else 7)
    assert all(np.array_equal(a, b) for a, b in zip(pc, jc))
    assert ps == js == [int(x) for x in js] and ps[-1] == 7
    assert pf == jf and pf[0].count("\n") > 1


def test_fit_trains_checkpoints_and_restores(tmp_path):
    """The real fit from a pool: 4 steps in dispatches of 3 and 1, a
    checkpoint at each save crossing (steps 3 and 4), the last one restoring
    the returned state bit for bit; finite logged metrics."""
    tr, st = _port(CONFIGS["uniform"])
    tkv.reset()
    tkv.configure(str(tmp_path / "log"), ["csv"])
    try:
        st = tr.fit(st, steps=4, seed=3, pool=_batches(1)[0].repeat(2, 1, 1, 1).numpy(),
                    batch_size=B, ckpt_dir=str(tmp_path / "ckpt"), save_interval=2,
                    log_interval=2, steps_per_call=3)
    finally:
        tkv.reset()
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_00000003", "step_00000004"]
    rows = list(csv.DictReader(open(tmp_path / "log" / "progress.csv")))
    assert [int(r["step"]) for r in rows] == [3, 4]
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    tr_b, _ = _port(CONFIGS["uniform"], seed=5)
    _equal_states(tr_b.restore(str(tmp_path / "ckpt" / "step_00000004")), st)
