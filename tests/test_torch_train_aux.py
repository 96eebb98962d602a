"""The training slice's smaller parts against the JAX package: the
loss-second-moment sampler (bit-equal updates, repeated timesteps
included), the kvlogger's files (byte for byte with the clock fixed), the
model summaries, the training initialisation (the same zero-initialised
set, each layer's standard deviation within 5 %), a port-written
``.flax.npz`` in the JAX zoo (an equal forward at 1e-4), and two properties
of the port's UNet: ``use_remat`` changes no forward or gradient (1e-6),
and fp32 master weights computing in bf16 give today's bf16-stored forward
bit for bit."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffpir_tpu.models import summary as jsummary
from diffpir_tpu.models import zoo as jzoo
from diffpir_tpu.models.unet import UNet as JUNet
from diffpir_tpu.models.unet import UNetConfig as JUNetConfig
from diffpir_tpu.train import samplers as jsamplers
from diffpir_tpu.utils import kvlogger as jkv
from diffpir_tpu_torch.models import summary as tsummary
from diffpir_tpu_torch.models import zoo as tzoo
from diffpir_tpu_torch.models.unet import UNet as TUNet
from diffpir_tpu_torch.models.unet import UNetConfig as TUNetConfig
from diffpir_tpu_torch.train import samplers as tsamplers
from diffpir_tpu_torch.utils import kvlogger as tkv

UNET = dict(image_size=16, model_channels=32, out_channels=6, num_res_blocks=1,
            attention_resolutions=(2,), channel_mult=(1, 2), num_heads=4,
            num_head_channels=16, dropout=0.0)



@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Parallel test workers each start one PyTorch thread per core, which
    oversubscribes the cores; two threads for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

def _sampler_state(T=6, H=3, seed=0):
    """A partly filled history: some rows full, some growing, some empty."""
    rng = np.random.default_rng(seed)
    counts = np.array([H, 0, 1, H, 2, 0][:T], np.int32)
    hist = np.where(np.arange(H)[None] < counts[:, None],
                    rng.random((T, H)), 0.0).astype(np.float32)
    return hist, counts


def test_loss_aware_update_is_bit_equal_to_jax():
    hist, counts = _sampler_state()
    t = np.array([0, 1, 1, 1, 2, 4, 4, 0, 5], np.int32)   # 1 and 4 repeat
    losses = np.random.default_rng(1).random(t.shape).astype(np.float32)
    ref = jsamplers.loss_aware_update(
        jsamplers.LossSecondMomentState(jnp.asarray(hist), jnp.asarray(counts)),
        jnp.asarray(t), jnp.asarray(losses))
    got = tsamplers.loss_aware_update(
        tsamplers.LossSecondMomentState(torch.from_numpy(hist), torch.from_numpy(counts)),
        torch.from_numpy(t), torch.from_numpy(losses))
    np.testing.assert_array_equal(got.history.numpy(), np.asarray(ref.history))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    assert got.counts.dtype == torch.int32


@pytest.mark.parametrize("warm", [False, True])
def test_loss_aware_weights_match_jax(warm):
    hist, counts = _sampler_state()
    if warm:
        counts[:] = hist.shape[1]
        hist = np.random.default_rng(2).random(hist.shape).astype(np.float32)
    jstate = jsamplers.LossSecondMomentState(jnp.asarray(hist), jnp.asarray(counts))
    tstate = tsamplers.LossSecondMomentState(torch.from_numpy(hist),
                                             torch.from_numpy(counts))
    t, w = jsamplers.loss_aware_sample(jstate, jax.random.PRNGKey(0), 7)
    got = tsamplers.importance_weights(tstate, torch.from_numpy(np.array(t)))
    np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6)
    tt, tw = tsamplers.loss_aware_sample(tstate, 7, torch.Generator().manual_seed(0))
    assert tt.shape == (7,) and torch.equal(tw, tsamplers.importance_weights(tstate, tt))
    tu, wu = tsamplers.uniform_sample(5, 6, torch.Generator().manual_seed(0))
    assert tu.min() >= 0 and tu.max() < 6 and torch.equal(wu, torch.ones(5))


def test_kvlogger_files_equal_jax(tmp_path, monkeypatch):
    """The same calls through both loggers, the clock fixed: every file
    (human log, JSON, CSV with a key added later, TensorBoard events) equal
    byte for byte."""
    now = {"t": 1.7e9}

    def fake_time():
        return now["t"]

    outs = {}
    for name, kv in (("jax", jkv), ("port", tkv)):
        monkeypatch.setattr(kv.time, "time", fake_time)
        now["t"] = 1.7e9
        kv.reset()
        kv.configure(str(tmp_path / name), ["log", "json", "csv", "tensorboard"])
        kv.logkv("step", 1)
        kv.logkv_mean("loss", 2.0)
        kv.logkv_mean("loss", 4.5)
        with kv.profile_kv("io"):
            now["t"] += 0.5
        kv.log("a line", 3)
        first = kv.dumpkvs()
        kv.logkv("step", 2)
        kv.logkv("new_key", 7)
        kv.logkv_mean("loss", 1.25)

        @kv.profile("work")
        def work():
            now["t"] += 0.25

        work()
        second = kv.dumpkvs()
        kv.reset()
        files = {}
        for root, _, names in os.walk(tmp_path / name):
            for f in names:
                path = os.path.join(root, f)
                with open(path, "rb") as fh:
                    files[os.path.relpath(path, tmp_path / name)] = fh.read()
        outs[name] = (first, second, files)
    assert outs["port"] == outs["jax"]
    assert {os.path.basename(f).split(".")[0] for f in outs["port"][2]} == {
        "log", "progress", "events"}


def _jax_params(cfg: dict, seed: int = 0):
    model = JUNet(JUNetConfig(**cfg), dtype=jnp.float32)
    args = [jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,), jnp.int32)]
    if cfg.get("num_classes"):
        args.append(jnp.zeros((1,), jnp.int32))
    return model, jax.jit(model.init)(jax.random.PRNGKey(seed), *args)["params"]


def test_summaries_match_jax():
    tmodel = tzoo.init_random_(TUNet(TUNetConfig(**UNET)), 0)
    flat = tzoo.torch_to_flax(tmodel.state_dict())
    tree = jzoo._unflatten(flat)
    assert tsummary.count_params(tmodel) == jsummary.count_params(tree)
    assert tsummary.describe_model(tmodel, "m") == jsummary.describe_model(tree, "m")
    assert tsummary.describe_params(flat) == jsummary.describe_params(tree)
    assert tsummary.count_params(flat) == tsummary.count_params(tmodel.state_dict())


def test_init_train_matches_jax_in_distribution():
    """The same zero-initialised leaves, and each other leaf's mean and
    standard deviation within 5 % of JAX's (biases 0, GroupNorm scale 1,
    lecun-normal weights, the class embedding N(0, 1/features))."""
    cfg = dict(UNET, num_classes=10)
    _, jparams = _jax_params(cfg)
    ref = jzoo._flatten(jax.device_get(jparams))
    got = tzoo.torch_to_flax(tzoo.init_train_(TUNet(TUNetConfig(**cfg)), 0).state_dict())
    assert set(got) == set(ref)
    zero = {k for k, v in ref.items() if not np.any(v)}
    assert {k for k, v in got.items() if not np.any(v)} == zero
    assert {k.split("/")[-2] for k in zero if k.endswith("kernel")} == {
        "conv2", "proj", "out_conv"}
    for k in set(ref) - zero:
        r, g = ref[k], got[k]
        if np.all(r == 1.0):
            assert np.all(g == 1.0), k
            continue
        assert abs(g.std() / r.std() - 1) <= 0.05, k
        assert abs(g.mean()) <= 0.1 * r.std() + 0.05 * abs(r.mean()), k
        if k.endswith("kernel"):  # truncated at two of the normal's deviations
            bound = 2 * np.sqrt(1.0 / np.prod(r.shape[:-1])) / 0.87962566103423978
            assert np.abs(r).max() <= bound * (1 + 1e-6), k
            assert np.abs(g).max() <= bound * (1 + 1e-6), k


def test_port_npz_loads_in_the_jax_zoo(tmp_path):
    tmodel = tzoo.init_random_(TUNet(TUNetConfig(**UNET)), 3)
    path = str(tmp_path / "m.flax.npz")
    tzoo.save_params_npz(tzoo.torch_to_flax(tmodel.state_dict()), path)
    params = jzoo.load_params_npz(path)
    model, ref_params = _jax_params(UNET)
    shape = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), ref_params)
    assert jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), params) == shape
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([5, 600], np.int32)
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    # and back: the round trip through the JAX layout is exact
    sd = tzoo.flax_to_torch(tzoo.load_params_npz(path))
    assert all(torch.equal(sd[k], v) for k, v in tmodel.state_dict().items())


def test_remat_changes_no_forward_or_gradient():
    model = tzoo.init_random_(TUNet(TUNetConfig(**UNET)), 4)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 16, 16, 3))
                         .astype(np.float32))
    t = torch.tensor([10, 500])
    out = {}
    for remat in (False, True):
        model.cfg = dataclasses.replace(model.cfg, use_remat=remat)
        model.zero_grad()
        y = model(x, t)
        y.square().mean().backward()
        out[remat] = (y.detach(), {n: p.grad.clone() for n, p in model.named_parameters()})
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=1e-6)
    for n, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][n], g, rtol=0, atol=1e-6)


def test_remat_recomputes_each_block_in_the_backward(monkeypatch):
    """With use_remat every ResBlock and AttentionBlock runs under
    torch.utils.checkpoint when a gradient is taken, and never under
    no_grad."""
    import torch.utils.checkpoint as ckpt

    model = tzoo.init_random_(TUNet(TUNetConfig(**dict(UNET, use_remat=True))), 4)
    wrapped = []
    orig = ckpt.checkpoint
    monkeypatch.setattr(ckpt, "checkpoint",
                        lambda fn, *a, **kw: wrapped.append(type(fn).__name__)
                        or orig(fn, *a, **kw))
    x, t = torch.zeros((1, 16, 16, 3)), torch.tensor([3])
    with torch.no_grad():
        model(x, t)
    assert wrapped == []
    model(x, t).sum().backward()
    n_res = sum(type(m).__name__ == "ResBlock" for m in model.modules())
    n_attn = sum(type(m).__name__ == "AttentionBlock" for m in model.modules())
    assert sorted(set(wrapped)) == ["AttentionBlock", "ResBlock"]
    assert len(wrapped) == n_res + n_attn


def test_fp32_masters_in_bf16_equal_the_bf16_stored_unet():
    sd = tzoo.init_random_(TUNet(TUNetConfig(**UNET)), 6).state_dict()
    stored = TUNet(TUNetConfig(**UNET), dtype=torch.bfloat16)
    masters = TUNet(TUNetConfig(**UNET), dtype=torch.bfloat16, param_dtype=torch.float32)
    stored.load_state_dict(sd)
    masters.load_state_dict(sd)
    assert {p.dtype for p in masters.parameters()} == {torch.float32}
    assert stored.input_blocks_0_0.weight.dtype == torch.bfloat16
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 16, 16, 3))
                         .astype(np.float32))
    t = torch.tensor([20, 800])
    with torch.no_grad():
        assert torch.equal(masters(x, t), stored(x, t))
