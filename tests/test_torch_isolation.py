"""psg_tpu_torch stands alone: importing every one of its modules loads
neither JAX nor any module of psg_tpu, and chip_smoke.py imports neither."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "psg_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py"))

_PROBE = """
import importlib, json, sys
for name in {modules!r}:
    importlib.import_module(name)
print(json.dumps(sorted(m for m in sys.modules
                        if m == "jax" or m.startswith(("jax.", "jaxlib", "psg_tpu."))
                        or m == "psg_tpu")))
"""


def _imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_modules_are_all_found():
    assert "psg_tpu_torch.serve.generator" in MODULES
    assert "psg_tpu_torch.ops.spatial_xattn" in MODULES
    assert len(MODULES) >= 30


def test_importing_the_port_loads_no_jax_and_no_psg_tpu():
    out = subprocess.run([sys.executable, "-c", _PROBE.format(modules=MODULES)],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", ["chip_smoke.py", *(
    str(p.relative_to(ROOT)) for p in sorted(PORT.rglob("*.py")))])
def test_no_jax_or_psg_tpu_import_in_source(path):
    roots = _imported_roots(ROOT / path)
    assert not roots & {"jax", "jaxlib", "flax", "optax", "psg_tpu"}, roots
