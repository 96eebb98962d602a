"""The port stands alone: it imports neither JAX, Flax, optax, orbax, PyYAML,
Pillow nor
the JAX package, runs its CLI end to end on the CPU when asked, refuses to
run without a card otherwise, and builds its kernels without PyTorch's
extension builder."""

import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import diffpir_tpu_torch
from diffpir_tpu_torch import main as tmain
from diffpir_tpu_torch.kernels import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "diffpir_tpu_torch")
FORBIDDEN = ("jax", "flax", "optax", "orbax", "yaml", "PIL", "diffpir_tpu")


def test_import_pulls_in_no_forbidden_module():
    code = ("import sys, diffpir_tpu_torch, diffpir_tpu_torch.main, "
            "diffpir_tpu_torch.runner, diffpir_tpu_torch.kernels.build, "
            "diffpir_tpu_torch.models.convert, diffpir_tpu_torch.inference, "
            "diffpir_tpu_torch.serve, diffpir_tpu_torch.server_http, "
            "diffpir_tpu_torch.train, diffpir_tpu_torch.train.datasets, "
            "diffpir_tpu_torch.train.demo, diffpir_tpu_torch.models.summary, "
            "diffpir_tpu_torch.utils.kvlogger, diffpir_tpu_torch.metrics, "
            "diffpir_tpu_torch.inception, diffpir_tpu_torch.models.variants, "
            "diffpir_tpu_torch.ops.boundary, diffpir_tpu_torch.utils.raster, "
            "diffpir_tpu_torch.parallel, diffpir_tpu_torch.parallel.mesh, "
            "diffpir_tpu_torch.parallel.collectives, diffpir_tpu_torch.parallel.tp, "
            "diffpir_tpu_torch.parallel.multihost, diffpir_tpu_torch.export\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_use_no_forbidden_import_or_extension_builder():
    paths = glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True)
    assert os.path.join(PKG, "parallel", "multihost.py") in paths
    assert os.path.join(PKG, "export.py") in paths
    for path in paths + [os.path.join(ROOT, "chip_smoke.py"),
                         os.path.join(ROOT, "tests", "test_torch_parallel_ranks.py")]:
        with open(path) as f:
            src = f.read()
        for mod in FORBIDDEN:
            assert not re.search(rf"^\s*(import|from)\s+{mod}(\.|\s|$)", src, re.M), (path, mod)
        assert "cpp_extension" not in src, path


def test_entry_points_refuse_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        diffpir_tpu_torch.resolve_device(cpu=False)
    with pytest.raises(RuntimeError, match="--cpu"):
        tmain.main(["--opt", os.path.join(ROOT, "configs", "demo32_inpaint.yaml"),
                    "--no-sweep", "--set", "save_E=false", "--set", "save_L=false"])
    from diffpir_tpu_torch.config import load_config
    from diffpir_tpu_torch.runner import Runner

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Runner(load_config(os.path.join(ROOT, "configs", "demo32_inpaint.yaml")))
    from diffpir_tpu_torch import server_http
    from diffpir_tpu_torch.serve import RestorationService

    with pytest.raises(RuntimeError, match="no CUDA device"):
        RestorationService(load_config(os.path.join(ROOT, "configs",
                                                     "demo32_inpaint.yaml")))
    with pytest.raises(RuntimeError, match="--cpu"):
        server_http.main(["--opt", os.path.join(ROOT, "configs", "demo32_inpaint.yaml"),
                          "--port", "0"])
    from diffpir_tpu_torch.train import demo

    with pytest.raises(RuntimeError, match="--cpu"):
        demo.main(["--arch", "tiny", "--steps", "1", "--out", os.devnull])


def test_cli_runs_end_to_end_on_cpu(capsys):
    opt = os.path.join(ROOT, "configs", "demo32_inpaint.yaml")
    results = tmain.main(["--opt", opt, "--cpu", "--no-sweep", "--set", "iter_num=5",
                          "--set", "save_E=false", "--set", "save_L=false",
                          "--set", f"cwd={ROOT}", "--json"])
    assert len(results) == 1
    r = results[0]
    assert r["n_images"] == 4 and r["device"] == "cpu"
    assert np.isfinite(r["psnr"]) and 10.0 < r["psnr"] < 60.0
    assert 0.0 < r["ssim"] <= 1.0
    assert '"psnr"' in capsys.readouterr().out


def test_cli_profile_writes_a_chrome_trace(tmp_path, capsys):
    """--profile DIR: the run under torch.profiler, its trace in
    DIR/trace.json (on the CPU: CPU activity only)."""
    opt = os.path.join(ROOT, "configs", "demo32_inpaint.yaml")
    out = tmp_path / "profile"
    tmain.main(["--opt", opt, "--cpu", "--no-sweep", "--set", "iter_num=2",
                "--set", "save_E=false", "--set", "save_L=false", "--set", f"cwd={ROOT}",
                "--profile", str(out)])
    with open(out / "trace.json") as f:
        trace = json.load(f)
    names = {ev.get("name", "") for ev in trace["traceEvents"]}
    assert any("conv" in n for n in names), sorted(names)[:20]
    capsys.readouterr()


def test_runner_saves_pngs_that_pillow_reads(tmp_path):
    from diffpir_tpu_torch.config import load_config
    from diffpir_tpu_torch.runner import Runner

    cfg = load_config(os.path.join(ROOT, "configs", "demo32_inpaint.yaml"),
                      dict(iter_num=3, cwd=ROOT))
    cfg.E_path = str(tmp_path)
    Runner(cfg, device="cpu").evaluate(save=True)
    saved = sorted(os.listdir(tmp_path))
    pngs = [p for p in saved if p.endswith(".png")]
    assert len(pngs) == 8, saved  # restored + degraded, 4 images each
    for name in pngs:
        with Image.open(tmp_path / name) as im:
            assert im.size == (32, 32) and im.mode == "RGB"
    assert any(p.endswith(".log") for p in saved)


def test_find_nvcc_reports_where_it_looked(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent/cuda")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="/nonexistent/cuda/bin/nvcc.*"
                                           "/usr/local/cuda/bin/nvcc"):
        build.find_nvcc()


def test_ctypes_signatures_match_the_c_sources():
    """Each exported C function exists in csrc/ with as many parameters as its
    ctypes argtypes (a mismatch would pass pointers into the wrong slots)."""
    sources = ""
    for path in glob.glob(os.path.join(PKG, "kernels", "csrc", "*.cu")):
        with open(path) as f:
            sources += f.read()
    for name, argtypes in build._SIGNATURES.items():
        m = re.search(rf'extern "C" int {name}\(([^)]*)\)', sources)
        assert m, name
        params = [p for p in m.group(1).split(",") if p.strip()]
        assert len(params) == len(argtypes), name
        for param, argtype in zip(params, argtypes):
            is_ptr = "*" in param
            assert is_ptr == (argtype is build.ctypes.c_void_p), (name, param)
            if "float" in param and not is_ptr:
                assert argtype is build.ctypes.c_float, (name, param)


def test_resolve_model_runs_on_the_cpu_only_when_asked(monkeypatch):
    from diffpir_tpu_torch.models import zoo

    res = zoo.resolve_model("tiny_demo32", os.path.join(ROOT, "model_zoo"),
                            device="cpu")
    assert res.provenance == "demo"
    assert {p.device.type for p in res.model.parameters()} == {"cpu"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zoo.resolve_model("tiny_demo32", os.path.join(ROOT, "model_zoo"))


def test_spill_report_is_read_from_the_ptxas_log():
    log = ("ptxas info    : Used 128 registers, used 1 barriers\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads\n")
    assert build.spill_bytes(log) == 20
    assert build.spill_bytes(log.splitlines()[1]) == 0
    with pytest.raises(ValueError, match="no ptxas spill report"):
        build.spill_bytes("")


def test_profile_nfe_classes_kernels_and_needs_a_card(monkeypatch):
    from diffpir_tpu_torch import profile_nfe

    assert profile_nfe.classify("gn_stats<bf16, false>") == "groupnorm"
    assert profile_nfe.classify("void attn_bf16<64, 2>(...)") == "attention"
    assert profile_nfe.classify("void attn_bf16_any<128>(CUtensorMap_st, ...)") == "attention"
    assert profile_nfe.classify("void attn_wide<8>(CUtensorMap_st, ...)") == "attention"
    assert profile_nfe.classify("sm90_xmma_fprop_implicit_gemm_bf16") == "convolution"
    assert profile_nfe.classify("sm90_xmma_gemm_bf16bf16_bf16f32") == "matmul"
    assert profile_nfe.classify("elementwise_kernel") == "other"
    # busy time is the union of the intervals: overlaps count once
    assert profile_nfe.busy_us([(5, 9), (0, 2), (1, 3), (6, 7), (10, 10.5)]) == 7.5
    assert profile_nfe.busy_us([]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_nfe.main([])
