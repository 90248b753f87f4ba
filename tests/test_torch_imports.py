"""The port stays a port: importing any module of csl_gan_tpu_torch, or
chip_smoke.py, pulls in neither JAX (jax, flax, optax) nor the JAX package
csl_gan_tpu, nor msgpack, PIL or scikit-learn, which the card's machine may
lack: the port writes its checkpoints and PNGs itself, reads CelebA JPEGs
with PIL only inside the decoder (chip_smoke.py writes its JPEG files with
it inside its CelebA phase), and imports scikit-learn only inside
``downstream.main``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "csl_gan_tpu")
OPTIONAL = ("msgpack", "PIL", "sklearn")
# Where an optional package may be imported, inside a function only (PIL also
# in chip_smoke.py, whose CelebA phase writes its JPEG files with it).
LAZY = {"PIL": ("csl_gan_tpu_torch/data/celeba.py", "chip_smoke.py"),
        "sklearn": ("csl_gan_tpu_torch/downstream.py",)}
SOURCES = sorted((REPO / "csl_gan_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import csl_gan_tpu_torch\n"
        "for m in pkgutil.walk_packages(csl_gan_tpu_torch.__path__, 'csl_gan_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN + OPTIONAL!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path}: imports {n}"


def _imports(tree):
    """(module name, at module level) of every absolute import."""
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name, id(node) in top) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module, id(node) in top


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_optional_packages_only_inside_their_functions(path):
    rel = str(path.relative_to(REPO))
    for name, top in _imports(ast.parse(path.read_text(), filename=str(path))):
        root = name.split(".")[0]
        if root in OPTIONAL:
            assert not top and rel in LAZY.get(root, ()), f"{rel}: imports {name}"
