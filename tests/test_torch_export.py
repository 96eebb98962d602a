"""The port's export (``diffpir_tpu_torch/export.py``): the cases of
``tests/test_export.py`` on the port's bundles, the manifest against the JAX
package's ``save_bundle`` for the same config, the kernels as operators in
the exported graph.  The other modes' bundles are in
``tests/test_torch_export_modes.py``.

A port bundle runs the same aten operations as ``Runner.restore_batch`` in
the same order, with the same draws, so on the CPU it equals the live
restore bit for bit (held at 1e-6); a dynamic-point bundle scales rho by
lambda at call time where the live scalar path builds its plan at lambda,
which costs ulps (held at 1e-5, as the JAX test does).  The module exports
three port bundles and one JAX bundle, each once."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from diffpir_tpu_torch.config import load_config
from diffpir_tpu_torch.data import Batch
from diffpir_tpu_torch.export import export_restore, load_bundle, program_report, save_bundle
from diffpir_tpu_torch.kernels import build
from diffpir_tpu_torch.kernels.attention import legacy_qkv_attention_plain
from diffpir_tpu_torch.kernels.groupnorm import groupnorm_silu_plain
from diffpir_tpu_torch.runner import Runner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _over(task, **kw):
    base = dict(task=task, model_name="tiny_test", iter_num=3, iter_num_U=1,
                batch_size=B, noise_level_img=0.02, seed=0, dtype="float32",
                save_E=False, save_L=False)
    base.update(kw)
    return base


def _cfg(task, **kw):
    return load_config(None, overrides=_over(task, **kw))


def _batch(task, rng, b=B, h=H, sf=1):
    img_H = rng.integers(0, 256, (b, h, h, 3)).astype(np.uint8)
    mask = np.ones((b, h, h, 3), np.float32)
    kernel = np.ones((b, 1, 1), np.float32)
    if task == "inpaint":
        mask = (rng.uniform(size=(b, h, h, 3)) > 0.3).astype(np.float32)
        img_L = img_H.astype(np.float32) * mask / 255.0
    else:
        k = np.zeros((5, 5), np.float32)
        k[1:4, 1:4] = 1.0 / 9.0
        kernel = np.broadcast_to(k, (b, 5, 5)).copy()
        img_L = (img_H.astype(np.float32) / 255.0)[:, ::sf, ::sf]
    return Batch(img_H=img_H, img_L=img_L.astype(np.float32), kernel=kernel, mask=mask,
                 names=[f"im{i}" for i in range(b)])


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """Three port bundles, each with its runner and batch: inpaint and deblur
    (FFT prox) at a fixed point, and a dynamic-point deblur with the
    first-order prox."""
    td = tmp_path_factory.mktemp("export")
    out = {}
    for name, task, over, kw in (
            ("inpaint", "inpaint", {}, {}),
            ("deblur", "deblur", {}, {}),
            ("dynamic", "deblur", dict(noise_level_img=12.75, sub_1_analytic=False,
                                       lambda_=20.0), dict(dynamic_point=True))):
        runner = Runner(_cfg(task, **over), device="cpu")
        batch = _batch(task, np.random.default_rng(len(out)))
        path = save_bundle(runner, str(td / name), batch=B, height=batch.img_L.shape[1],
                           width=batch.img_L.shape[2],
                           kernel_hw=tuple(batch.kernel.shape[1:]), platforms=("cpu",),
                           allow_random_weights=True, **kw)
        out[name] = (runner, batch, path, load_bundle(path, device="cpu"))
    return out


@pytest.mark.parametrize("name", ["inpaint", "deblur"])
def test_bundle_matches_runner(bundles, name):
    runner, batch, _, loaded = bundles[name]
    want = runner.restore_batch(batch, seed=7)
    got = loaded(batch.img_L, kernel=batch.kernel, mask=batch.mask, seed=7)
    assert got.shape == want.shape == batch.img_H.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_manifest_matches_jax(bundles, tmp_path):
    """The JAX package's save_bundle on the same config writes the same
    manifest, but for ``platforms`` (tpu/cpu there, cuda/cpu here) and
    ``treedef`` (the port's is the ordered parameter names)."""
    from diffpir_tpu.config import load_config as jload_config
    from diffpir_tpu.export import save_bundle as jsave_bundle
    from diffpir_tpu.runner import Runner as JRunner

    _, batch, _, loaded = bundles["inpaint"]
    jpath = jsave_bundle(JRunner(jload_config(None, overrides=_over("inpaint")),
                                 use_mesh=False),
                         str(tmp_path / "jax"), batch=B, height=H, width=H,
                         platforms=("cpu",), allow_random_weights=True)
    with open(os.path.join(jpath, "manifest.json")) as f:
        jman = json.load(f)
    man = loaded.manifest
    for key in jman:
        if key not in ("platforms", "treedef"):
            assert man[key] == jman[key], key
    assert man["platforms"] == ["cpu"]
    runner = bundles["inpaint"][0]
    assert man["treedef"] == [n for n, _ in runner.model.named_parameters()]
    assert man["noise_order"] == ["init", "rp", "n1", "n2", "n3"]


def test_manifest_and_validation(bundles):
    _, batch, _, loaded = bundles["inpaint"]
    assert loaded.manifest["task"] == "inpaint" and loaded.manifest["batch"] == B
    with pytest.raises(ValueError, match="y must be"):
        loaded(np.zeros((1, H, H, 3), np.float32))
    with pytest.raises(ValueError, match="mask must be"):
        loaded(batch.img_L, mask=batch.mask[:, :16])
    # defaults: an identity kernel and an all-ones mask
    out = loaded(np.random.default_rng(1).uniform(size=(B, H, H, 3)).astype(np.float32))
    assert np.isfinite(out).all()
    with pytest.raises(RuntimeError, match="exported for"):
        load_bundle(bundles["inpaint"][2], device="meta")


def test_reload_params_refreshes_checkpoint(bundles, tmp_path):
    """A params.npz of the same layout changes the output without a
    re-export; another layout is refused."""
    runner, batch, path, _ = bundles["inpaint"]
    loaded = load_bundle(path, device="cpu")
    out1 = loaded(batch.img_L, mask=batch.mask, seed=1)
    with np.load(os.path.join(path, "params.npz")) as z:
        moved = {k: z[k] + np.float32(0.01) for k in z.files}
    np.savez(tmp_path / "moved.npz", **moved)
    loaded.reload_params(str(tmp_path / "moved.npz"))
    out2 = loaded(batch.img_L, mask=batch.mask, seed=1)
    assert np.abs(out1 - out2).max() > 0
    params = list(runner.model.parameters())
    orig = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p in params:
            p.add_(0.01)
    try:
        want = runner.restore_batch(batch, seed=1)
    finally:
        with torch.no_grad():
            for p, o in zip(params, orig):
                p.copy_(o)
    np.testing.assert_allclose(out2, want, rtol=0, atol=1e-6)
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **{"0": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="layout"):
        loaded.reload_params(bad)


def test_dynamic_point_bundle(bundles):
    """Per-sample (lambda, zeta) at call time (the first-order prox, whose
    gradient the program holds as a recorded aten graph), against the live
    path; a fixed-point bundle refuses call-time points."""
    runner, batch, _, loaded = bundles["dynamic"]
    assert loaded.manifest["dynamic_point"] is True
    lam = runner.cfg.lambda_
    kw = dict(kernel=batch.kernel, mask=batch.mask, seed=7)
    want_def = runner.restore_batch(batch, seed=7)
    np.testing.assert_allclose(loaded(batch.img_L, **kw), want_def, rtol=0, atol=1e-5)
    want_hi = runner.restore_batch(batch, lambda_=50.0, seed=7)
    np.testing.assert_allclose(loaded(batch.img_L, lambda_=50.0, **kw), want_hi,
                               rtol=0, atol=1e-5)
    got_vec = loaded(batch.img_L, lambda_=[lam, 50.0], **kw)
    np.testing.assert_allclose(got_vec[0], want_def[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_vec[1], want_hi[1], rtol=0, atol=1e-5)
    # per-sample lambda and zeta exactly as the live per-sample path runs them
    pts = dict(lambda_=[lam, 50.0], zeta=[0.3, 0.8])
    np.testing.assert_allclose(loaded(batch.img_L, **pts, **kw),
                               runner.restore_batch(batch, seed=7, **pts), rtol=0, atol=1e-6)
    fixed = bundles["deblur"][3]
    with pytest.raises(ValueError, match="dynamic_point"):
        fixed(batch.img_L, kernel=batch.kernel, lambda_=3.0)


def test_export_refuses_random_weights(tmp_path):
    runner = Runner(_cfg("inpaint"), device="cpu")
    assert runner.weights_provenance == "random"
    with pytest.raises(RuntimeError, match="random"):
        save_bundle(runner, str(tmp_path / "nope"), batch=B, height=H, width=H,
                    platforms=("cpu",))
    assert not (tmp_path / "nope").exists()


def test_graph_holds_the_kernels_as_operators(bundles):
    """One operator node per GroupNorm and attention call of a forward, no
    plain-version node, and the parameters as inputs, not constants."""
    runner, _, _, loaded = bundles["inpaint"]
    step = loaded.programs["step"]
    rep = program_report(step)
    gn = sum(type(m).__name__ == "GroupNorm32" for m in runner.model.modules())
    attn = sum(type(m).__name__ == "AttentionBlock" for m in runner.model.modules())
    assert (rep["groupnorm_silu"], rep["legacy_qkv_attention"]) == (gn, attn) == (45, 4)
    assert rep["plain_nodes"] == 0 and rep["collectives"] == 0
    assert not step.state_dict
    n_params = len(list(runner.model.parameters()))
    users = [s for s in step.graph_signature.input_specs if s.kind.name == "USER_INPUT"]
    assert len(users) >= n_params
    # the loaded copy calls each kernel's implementation directly
    bound = loaded._programs["step"].gm
    assert not [n for n in bound.graph.nodes if str(n.target).startswith(
        ("diffpir_tpu_torch.groupnorm_silu", "diffpir_tpu_torch.legacy_qkv_attention"))]
    for name in ("prologue", "epilogue"):
        r = program_report(loaded.programs[name])
        assert r["groupnorm_silu"] == r["legacy_qkv_attention"] == r["plain_nodes"] == 0
    # the detector sees an inlined plain version, as the plain route traces it

    class PlainNorm(torch.nn.Module):
        def forward(self, x, scale, bias):
            return groupnorm_silu_plain(x, scale, bias, num_groups=2)

    x = torch.zeros((1, 4, 4, 8))
    ep = torch.export.export(PlainNorm(), (x, torch.ones(8), torch.zeros(8)))
    assert program_report(ep)["plain_nodes"] > 0
    plain = Runner(_cfg("inpaint"), device="cpu", kernels="plain")
    with pytest.raises(ValueError, match="kernel route"):
        export_restore(plain, batch=1, height=H, width=H, allow_random_weights=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_operators_run_the_plain_versions_on_the_cpu(dtype):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 8, 8, 64), generator=g).to(dtype)
    scale, bias = torch.randn(64, generator=g), torch.randn(64, generator=g)
    fs, fb = torch.randn((2, 64), generator=g), torch.randn((2, 64), generator=g)
    for film in ((None, None), (fs, fb)):
        got = torch.ops.diffpir_tpu_torch.groupnorm_silu(x, scale, bias, *film, 32, 1e-5,
                                                         True)
        want = groupnorm_silu_plain(x, scale, bias, *film, num_groups=32, do_silu=True)
        assert got.dtype == dtype and torch.equal(got, want)
    qkv = torch.randn((2, 16, 3 * 4 * 8), generator=g).to(dtype)
    got = torch.ops.diffpir_tpu_torch.legacy_qkv_attention(qkv, 4)
    assert got.dtype == dtype and torch.equal(got, legacy_qkv_attention_plain(qkv, 4))


def test_loading_imports_no_model_sampler_or_runner(bundles):
    """A fresh process loads and runs a bundle with the port's model,
    sampler and runner modules absent from sys.modules."""
    path = bundles["inpaint"][2]
    code = ("import sys, numpy as np, torch\n"
            "torch.set_num_threads(2)\n"
            "from diffpir_tpu_torch.export import load_bundle\n"
            f"loaded = load_bundle({path!r}, device='cpu')\n"
            f"out = loaded(np.zeros(({B}, {H}, {H}, 3), np.float32))\n"
            "bad = sorted(m for m in sys.modules if m.startswith(("
            "'diffpir_tpu_torch.models', 'diffpir_tpu_torch.sampler', "
            "'diffpir_tpu_torch.runner', 'diffpir_tpu_torch.guidance')))\n"
            "print(bad, out.shape, sorted(loaded.boot_timings))\n"
            "sys.exit(1 if bad or not np.isfinite(out).all() else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[] (2, 32, 32, 3)" in proc.stdout
    assert "program_load_s" in proc.stdout


def test_bundle_calls_open_data_stack_chunks_of_their_own(bundles):
    """A loaded program's forward and the restore loop each have a frame
    larger than one of the interpreter's 16 KiB data-stack chunks, so each
    call opens a chunk of its own with room for the calls it makes: no
    caller's depth puts them at a chunk's end, where every call they make
    would map and unmap a chunk (ROADMAP C6)."""
    from diffpir_tpu_torch.export import LoadedRestore

    loaded = bundles["inpaint"][3]
    loaded.programs  # binds the programs
    fns = [type(p.gm).forward for p in loaded._programs.values()] + [LoadedRestore.__call__]
    for fn in fns:
        code = fn.__code__
        slots = (len(code.co_varnames) + len(code.co_cellvars) + len(code.co_freevars)
                 + code.co_stacksize)
        assert slots * 8 > 16 * 1024, fn


def test_entry_points_refuse_to_run_without_a_card(bundles, monkeypatch, tmp_path):
    from diffpir_tpu_torch import export

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_bundle(bundles["inpaint"][2])
    with pytest.raises(RuntimeError, match="--cpu"):
        export.main(["--opt", os.path.join(ROOT, "configs", "demo32_inpaint.yaml"),
                     "--out", str(tmp_path / "b")])


def test_kernel_library_sidecar_is_checked_against_its_digest(monkeypatch, tmp_path):
    """A library built elsewhere loads only under the digest of these
    sources, flags and torch version; anything else loads nothing (and the
    first launch builds from the sources)."""
    digest = build.library_digest()
    assert len(digest) == 64 and digest == build.library_digest()
    assert not build.use_library(str(tmp_path / "missing.so"), "0" * 64)
    monkeypatch.setattr(torch, "__version__", "0.0.0")
    assert build.library_digest() != digest
