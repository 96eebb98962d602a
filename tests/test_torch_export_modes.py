"""Bundles of the modes ``pred_x_prev`` (ancestral and DDIM), DPS_y0 and
DPS_yt (``diffpir_tpu_torch/export.py``) against ``Runner.restore_batch``,
their step programs' operator counts, the manifest against the JAX
package's for one of them, and each kernel operator's backward against its
``autograd.Function``'s.

A bundle's step program runs the same aten operations as the live runner
in the same order with the same draws (``sampler.xprev_step``,
``guidance.dps_y0_step`` and ``dps_yt_step`` are the live loops' steps), so
on the CPU it equals the live restore bit for bit; DPS records its step
with ``make_fx`` (DPS_y0's gradient runs back through the UNet: each kernel
operator then has one backward node per forward node).  The live runner's
modes are held to the JAX package in ``test_torch_runner_modes.py``,
``test_torch_sampler.py`` and ``test_torch_guidance.py``.  DPS applies to deblurring and SR (the JAX
package has no inpainting operator for it); SR runs as a dynamic-point
DPS_yt bundle.  Each bundle is exported once, at 32 px with three plan
steps; two torch threads."""

import json
import os

import numpy as np
import pytest
import torch

from diffpir_tpu_torch.export import expected_report, load_bundle, program_report, save_bundle
from diffpir_tpu_torch.kernels import attention as kat
from diffpir_tpu_torch.kernels import groupnorm as kgn
from diffpir_tpu_torch.runner import Runner

from test_torch_export import B, _batch, _cfg, _over

MODES = {
    # name: (task, config overrides, save_bundle keywords)
    "xprev_inpaint": ("inpaint", dict(model_output_type="pred_x_prev"), {}),
    "xprev_inpaint_ddim": ("inpaint", dict(model_output_type="pred_x_prev",
                                           ddim_sample=True), {}),
    "xprev_deblur": ("deblur", dict(model_output_type="pred_x_prev"), {}),
    "xprev_deblur_ddim": ("deblur", dict(model_output_type="pred_x_prev",
                                         ddim_sample=True), {}),
    "dps_y0_deblur": ("deblur", dict(generate_mode="DPS_y0"), {}),
    "dps_yt_deblur": ("deblur", dict(generate_mode="DPS_yt", noise_level_img=12.75), {}),
    "dps_yt_sr_dynamic": ("sr", dict(generate_mode="DPS_yt", sf=2, sr_mode="blur",
                                     noise_level_img=12.75), dict(dynamic_point=True)),
}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """name -> (runner, batch, loaded bundle), each exported at first use."""
    td = tmp_path_factory.mktemp("export_modes")
    cache = {}

    def get(name):
        if name not in cache:
            task, over, kw = MODES[name]
            runner = Runner(_cfg(task, **over), device="cpu")
            sf = over.get("sf", 1)
            batch = _batch(task, np.random.default_rng(len(cache)), sf=sf)
            path = save_bundle(runner, str(td / name), batch=B,
                               height=batch.img_L.shape[1], width=batch.img_L.shape[2],
                               kernel_hw=tuple(batch.kernel.shape[1:]), platforms=("cpu",),
                               allow_random_weights=True, **kw)
            cache[name] = (runner, batch, load_bundle(path, device="cpu"))
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(MODES))
def test_mode_bundle_equals_runner(bundles, name):
    runner, batch, loaded = bundles(name)
    want = runner.restore_batch(batch, seed=7)
    got = loaded(batch.img_L, kernel=batch.kernel, mask=batch.mask, seed=7)
    assert got.shape == want.shape == batch.img_H.shape
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(MODES))
def test_step_program_holds_forward_and_backward_operators(bundles, name):
    """One operator node per GroupNorm and attention call of the step's one
    UNet forward, and in DPS_y0 one backward node per forward node; no
    plain-version node and no collective."""
    runner, _, loaded = bundles(name)
    rep = program_report(loaded.programs["step"])
    assert rep["groupnorm_silu"] == 45 and rep["legacy_qkv_attention"] == 4, rep
    backward = 45 if MODES[name][1].get("generate_mode") == "DPS_y0" else 0
    assert rep["groupnorm_silu_backward"] == backward, rep
    assert rep["legacy_qkv_attention_backward"] == backward * 4 // 45, rep
    assert rep["plain_nodes"] == 0 and rep["collectives"] == 0
    assert all(rep[k] == v for k, v in expected_report(runner, 1).items()), rep


def test_noise_order_and_mode_keys(bundles):
    for name, order in (("xprev_deblur_ddim", ["init", "xprev"]),
                        ("dps_y0_deblur", ["init", "samp"]),
                        ("dps_yt_deblur", ["init", "samp", "yt"])):
        m = bundles(name)[2].manifest
        assert m["noise_order"] == order, name
        assert m["model_output_type"] == MODES[name][1].get("model_output_type",
                                                            "pred_xstart")
    # the y_t draw has the observation's shape (SR: the low resolution)
    steps = bundles("dps_yt_sr_dynamic")[2]._steps
    assert steps["noise"]["shapes"]["yt"] == [B, 16, 16, 3]
    assert steps["noise"]["init"] == [B, 32, 32, 3]


def test_dynamic_point_dps_yt_bundle(bundles):
    """Per-sample lambda at call time as the live per-sample path runs it
    (bit for bit), and the recorded point (lambda scales rho at call time:
    ulps from the live scalar path, as the JAX package's test allows)."""
    runner, batch, loaded = bundles("dps_yt_sr_dynamic")
    kw = dict(kernel=batch.kernel, mask=batch.mask, seed=3)
    lams = [runner.cfg.lambda_, 3.0]
    np.testing.assert_array_equal(loaded(batch.img_L, lambda_=lams, **kw),
                                  runner.restore_batch(batch, lambda_=lams, seed=3))
    np.testing.assert_allclose(loaded(batch.img_L, **kw),
                               runner.restore_batch(batch, seed=3), rtol=0, atol=1e-5)


def test_manifest_matches_jax_for_pred_x_prev(bundles, tmp_path):
    """The JAX package's save_bundle of the pred_x_prev DDIM deblur config
    writes the port's manifest, but for ``platforms`` and ``treedef``."""
    from diffpir_tpu.config import load_config as jload_config
    from diffpir_tpu.export import save_bundle as jsave_bundle
    from diffpir_tpu.runner import Runner as JRunner

    task, over, _ = MODES["xprev_deblur_ddim"]
    _, batch, loaded = bundles("xprev_deblur_ddim")
    jpath = jsave_bundle(JRunner(jload_config(None, overrides=_over(task, **over)),
                                 use_mesh=False),
                         str(tmp_path / "jax"), batch=B, height=batch.img_L.shape[1],
                         width=batch.img_L.shape[2],
                         kernel_hw=tuple(batch.kernel.shape[1:]), platforms=("cpu",),
                         allow_random_weights=True)
    with open(os.path.join(jpath, "manifest.json")) as f:
        jman = json.load(f)
    for key in jman:
        if key not in ("platforms", "treedef"):
            assert loaded.manifest[key] == jman[key], key


def _operator_cases():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 4, 6, 64), generator=g)
    scale, bias = 1.0 + 0.1 * torch.randn(64, generator=g), torch.randn(64, generator=g)
    fs, fb = 0.3 * torch.randn((2, 64), generator=g), 0.3 * torch.randn((2, 64), generator=g)
    parts = torch.stack([kgn.groupnorm_partial_stats_plain(v, 32) for v in x.chunk(2, 1)])
    stats = kgn.merge_partial_stats(parts, False)
    qkv = torch.randn((2, 24, 3 * 2 * 16), generator=g)
    ops = torch.ops.diffpir_tpu_torch
    return {
        "groupnorm_silu": (
            lambda *t: ops.groupnorm_silu(*t, 32, 1e-5, True),
            lambda *t: kgn.GroupNormSiLUFunction.apply(*t, 32, 1e-5, True),
            (x, scale, bias, fs, fb)),
        "legacy_qkv_attention": (lambda q: ops.legacy_qkv_attention(q, 2),
                                 lambda q: kat.LegacyQKVAttentionFunction.apply(q, 2),
                                 (qkv,)),
        "groupnorm_partial_stats": (lambda v: ops.groupnorm_partial_stats(v, 32),
                                    lambda v: kgn.PartialStatsFunction.apply(v, 32), (x,)),
        "groupnorm_apply_stats": (
            lambda *t: ops.groupnorm_apply_stats(*t, True),
            lambda *t: kgn.ApplyStatsFunction.apply(*t, True),
            (x, scale, bias, stats, fs, fb)),
        "groupnorm_merge_stats": (lambda p: ops.groupnorm_merge_stats(p, False, 1e-5),
                                  lambda p: kgn.merge_partial_stats(p, False), (parts,)),
    }


@pytest.mark.parametrize("op", ["groupnorm_silu", "legacy_qkv_attention",
                                "groupnorm_partial_stats", "groupnorm_apply_stats",
                                "groupnorm_merge_stats"])
def test_operator_backward_equals_function(monkeypatch, op):
    """Each operator's autograd formula (its backward operator) gives the
    gradients of its ``autograd.Function`` (whose CUDA forward is ``_launch``,
    here the plain version) for every tensor input, fp32 at 1e-6; the merge,
    which has no kernel, against autograd of the plain merge."""
    monkeypatch.setattr(kgn, "_launch", kgn._plain_call)
    monkeypatch.setattr(kat, "_launch", kat.legacy_qkv_attention_plain)
    via_op, via_fn, ins = _operator_cases()[op]
    gen = torch.Generator().manual_seed(1)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in ins]
        y = fn(*leaves)
        return y, torch.autograd.grad(y, leaves, torch.randn(y.shape, generator=gen))

    y_op, g_op = grads(via_op)
    gen.manual_seed(1)
    y_fn, g_fn = grads(via_fn)
    torch.testing.assert_close(y_op, y_fn, rtol=0, atol=0)
    for a, b in zip(g_op, g_fn):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
