"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port; top-level module names are compared
whole (the port's name begins with the JAX package's)."""

import ast
import json
import subprocess
import sys
import textwrap
import types
from pathlib import Path

from harness import driver

BENCH = Path(__file__).resolve().parents[1]
PORT = "csl_gan_tpu_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        bad = set(_imports(p)) & set(driver.FORBIDDEN)
        assert not bad, (p, bad)


def test_the_reference_imports_nothing_of_the_port():
    for p in (BENCH / "reference").glob("*.py"):
        names = set(_imports(p))
        assert PORT not in names and "harness" not in names, (p, names)
        assert not names & set(driver.FORBIDDEN), p


def test_the_check_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, f"{PORT}.fake", types.ModuleType("x"))
    assert f"{PORT}.fake" not in driver.forbidden_modules()
    monkeypatch.setitem(sys.modules, "csl_gan_tpu.fake", types.ModuleType("y"))
    assert "csl_gan_tpu.fake" in driver.forbidden_modules()


def test_a_run_loads_the_port_and_no_jax(tmp_path, data_root):
    """A whole CPU run in a fresh interpreter: afterwards the port is loaded
    and nothing forbidden is."""
    from bench_cases import tiny
    code = textwrap.dedent(f"""
        import json, sys, time
        sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent)!r}]
        import torch
        torch.set_num_threads(2)
        from harness import driver
        res = driver.run("mnist-acgan-mlp.gc-k1.b600", 3, 0.2, False, time.time(), device="cpu",
                         overrides={json.dumps(tiny("mnist-acgan-mlp.gc-k1.b600", data_root))},
                         log=lambda *a: None)
        print(json.dumps({{"correct": res["correct"], "forbidden": driver.forbidden_modules(),
                          "port": "{PORT}" in sys.modules}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"TMPDIR": str(tmp_path), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "forbidden": [], "port": True}
