"""The PyTorch port stands alone: no file of ``pingpong_tpu_torch/`` and
not ``chip_smoke.py`` imports JAX or the JAX package, and importing every
module of the port loads neither."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "pingpong_tpu")


def port_files():
    return sorted((ROOT / "pingpong_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("__import__", "import_module")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_port_file_imports_jax_or_the_jax_package():
    files = port_files()
    assert len(files) > 20
    bad = [(p.relative_to(ROOT), m) for p in files
           for m in imported_modules(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"forbidden imports: {bad}"


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "pingpong_tpu_torch").rglob("*.py"))
    # only modules that the port's imports load count: a site hook of the
    # interpreter may have loaded others before
    code = ("import importlib, sys\n"
            "before = set(sys.modules)\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in set(sys.modules) - before\n"
            f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
