"""The PyTorch port stands alone: importing it loads neither JAX nor any
module of the JAX package, and no file of the port (nor chip_smoke.py)
imports them."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "rayforce_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "rayforce_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_import_loads_no_jax():
    code = ("import sys, rayforce_tpu_torch, rayforce_tpu_torch.engine."
            "select, rayforce_tpu_torch.engine.sortagg, "
            "rayforce_tpu_torch.engine.wide, rayforce_tpu_torch.entry\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for nm in names:
            assert nm.split(".")[0] not in FORBIDDEN, \
                f"{os.path.relpath(path, ROOT)}:{node.lineno} imports {nm}"
