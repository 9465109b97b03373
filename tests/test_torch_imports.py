"""The port stands alone: importing every ``repro_torch`` module pulls in
neither ``jax`` nor the JAX package, needs no compiler, and the serving entry
points refuse to run without a CUDA device unless the CPU is asked for."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SNIPPET = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    names.append(m.name)
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
assert "triton" not in sys.modules
for n in ("repro_torch.kernels.demm_block_spmm", "repro_torch.kernels.demm_spmm",
          "repro_torch.kernels.demm_q8", "repro_torch.kernels.demm_xwT",
          "repro_torch.paged", "repro_torch.paged.engine",
          "repro_torch.paged.kv_cache", "repro_torch.paged.prefill",
          "repro_torch.paged.scheduler"):
    assert n in names, n
print("IMPORTED", len(names))
"""


def _run(snippet):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    return subprocess.run([sys.executable, "-c", snippet], env=env,
                          capture_output=True, text=True, timeout=300)


def test_every_module_imports_without_jax_or_the_jax_package():
    proc = _run(_SNIPPET)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split("IMPORTED")[1]) >= 30


def test_chip_smoke_imports_only_the_port():
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    for line in src.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            mod = s.split()[1]
            assert mod != "jax" and not mod.startswith("jax.")
            assert mod != "repro" and not mod.startswith("repro.")


def test_serving_refuses_to_start_without_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.serve import main, run_serve
    from repro_torch.models.families import build_model
    from repro_torch.paged import PagedServeConfig
    from repro_torch.serve import ServeConfig, make_engine

    cfg = get_arch("stablelm_3b").reduced()
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_serve(model, cfg.vocab_size)             # default device: cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine(model, ServeConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine(model, PagedServeConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_serve(model, cfg.vocab_size, paged=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, device="cuda")
    with pytest.raises(SystemExit):
        main(["--requests", "1"])                    # CLI default: cuda
    with pytest.raises(SystemExit):
        main(["--requests", "1", "--paged"])


def test_cli_runs_on_the_cpu_when_asked(tmp_path, capsys):
    from repro_torch.launch.serve import main
    out = tmp_path / "m.json"
    main(["--device", "cpu", "--requests", "2", "--max-new", "3",
          "--max-len", "24", "--packed", "--quantize", "int8",
          "--backend", "reference", "--sparsity", "4:16",
          "--metrics-out", str(out), "--trace-out", str(tmp_path / "t.jsonl")])
    assert "served" in capsys.readouterr().out
    import json
    snap = json.loads(out.read_text())
    assert any(c["name"] == "kernel_dispatch_total"
               and c["labels"] == {"backend": "reference", "op": "xwT_q8"}
               for c in snap["counters"])
    assert snap["meta"]["platform"] in ("cpu", "gpu")
    for bad in ("pallas", "pallas_interpret", "auto"):
        with pytest.raises(SystemExit):
            main(["--device", "cpu", "--packed", "--backend", bad])
    assert "not a registered xwT variant" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--packed", "--layout", "block",
              "--quantize", "int8", "--backend", "block_spmm"])
    assert "not a registered xwT_block_q8 variant" in capsys.readouterr().err


def test_cli_serves_the_block_layout_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.serve import main
    out = tmp_path / "m.json"
    main(["--device", "cpu", "--requests", "2", "--max-new", "3",
          "--max-len", "24", "--packed", "--layout", "block",
          "--backend", "cuda", "--metrics-out", str(out)])
    assert "served" in capsys.readouterr().out
    import json
    snap = json.loads(out.read_text())
    # backend cuda on CPU tensors: the wrapper ran its plain version
    assert any(c["name"] == "kernel_dispatch_total"
               and c["labels"] == {"backend": "cuda", "op": "xwT_block"}
               for c in snap["counters"])


def test_kernel_library_build_fails_loudly_without_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    if _build._lib is not None:
        pytest.skip("library already loaded in this process")
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc")
    with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
        _build.load_library()


def test_from_jax_params_defaults_to_the_card():
    """The tree converter is an entry point of the port: without a card its
    default device raises instead of building on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from repro_torch.configs.base import get_arch
    from repro_torch.convert import from_jax_params

    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_params({"layers": {}}, get_arch("stablelm_3b").reduced())


def test_kernel_build_hashes_every_cuda_source():
    """A source or header left off ``_build.SOURCES`` / ``HEADERS`` would not
    enter the library's hash, and an edited file would leave a stale library
    in place."""
    from repro_torch.kernels import _build
    on_disk = {p.name for p in _build.CSRC.iterdir()
               if p.suffix in (".cu", ".cuh")}
    assert set(_build.SOURCES) == {n for n in on_disk if n.endswith(".cu")}
    assert set(_build.HEADERS) == {n for n in on_disk if n.endswith(".cuh")}
