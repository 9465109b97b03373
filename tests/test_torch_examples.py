"""The port's quickstart and its benchmark entry point run as a user runs
them, on the CPU by request (``--device cpu``), each in its own process with
its own time limit; without ``--device`` they refuse to start on a machine
with no CUDA device."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "2"
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_quickstart_on_the_cpu():
    proc = _run(["examples/torch_quickstart.py", "--device", "cpu"], 120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    assert "DeMM row-wise product-first == dense matmul  [ok]" in out
    assert "ops.demm_spmm (backend reference) == oracle  [ok]" in out
    assert "packed-DeMM serving (backend reference): generated" in out
    assert out.rstrip().endswith("quickstart complete.")


def test_benchmark_run_on_the_cpu_prints_the_reference_rows():
    """``python -m benchmarks.torch_run --device cpu``: the figure rows (the
    JAX package's numbers), the byte rows of ``kernel_bench.py``'s cases in
    the port's storage, and the roofline stand-in."""
    proc = _run(["-m", "benchmarks.torch_run", "--device", "cpu"], 120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rows = {}
    for line in proc.stdout.splitlines():
        parts = line.split(",", 2)
        if len(parts) == 3 and not line.startswith("=="):
            rows[parts[0]] = (float(parts[1]), parts[2])
    assert rows["fig6_improvement_vs_S2TA"][0] == 17.15
    assert rows["fig6_improvement_vs_VEGETA"][0] == 56.14
    assert rows["fig6_improvement_vs_SPOTS"][0] == 65.18
    for key, val in (("fig8_1:8_vs_S2TA", 8.69), ("fig8_1:8_vs_VEGETA", 21.14),
                     ("fig8_1:4_vs_S2TA", 1.82), ("fig8_1:4_vs_VEGETA", 15.99),
                     ("fig8_1:2_vs_S2TA", -3.30),
                     ("fig8_1:2_vs_VEGETA", 15.56)):
        assert rows[key][0] == val, key
    # 8:128 in bf16 values + int32 indices: 128*2 / (8*6) = 5.33x
    assert rows["kernel_mlp_gate_decode_bytes_dense_over_packed"] == (
        5.33, "w_bytes 35389440 -> 6635520")
    assert rows["kernel_finegrained_1:4_bytes_dense_over_packed"][0] == 1.33
    assert rows["roofline_skipped"][0] == 0
    assert not any(k.endswith("_h100_us") for k in rows)    # no card rows
    assert "== total: 18 benchmark rows ==" in proc.stdout


def test_benchmark_run_refuses_to_start_without_a_card(capsys):
    import torch

    from benchmarks import torch_run

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(SystemExit) as exc:
        torch_run.main([])
    assert exc.value.code == 2
    out, err = capsys.readouterr()
    assert "no CUDA device" in err
    assert "fig6" not in out


SCRIPTS = ["examples/torch_quickstart.py", "examples/torch_prune_and_pack.py",
           "examples/torch_serve_decode.py",
           "examples/torch_train_sparse_lm.py", "benchmarks/torch_run.py",
           "benchmarks/torch_fig6_resnet50.py",
           "benchmarks/torch_fig8_finegrained.py",
           "benchmarks/torch_train_bench.py"]


@pytest.mark.parametrize("script", SCRIPTS)
def test_scripts_import_only_the_port_and_default_to_the_card(script):
    """Every port script imports neither ``jax`` nor the JAX package, and
    every one that runs tensors takes ``--device`` with ``cuda`` as its
    default."""
    src = open(os.path.join(REPO, script)).read()
    for line in src.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            mod = s.split()[1]
            assert mod != "jax" and not mod.startswith("jax."), line
            assert mod != "repro" and not mod.startswith("repro."), line
    if "fig" not in script:
        assert 'add_argument("--device", default="cuda"' in src
