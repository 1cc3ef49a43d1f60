"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX nor any module of the reference package, and no source of the
port (nor ``chip_smoke.py``) imports them."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        yield ".".join(p for p in rel.parts if p != "__init__")


def test_import_loads_neither_jax_nor_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {list(_port_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout


def test_sources_import_neither_jax_nor_reference():
    pattern = re.compile(
        r"^\s*(import\s+(jax|repro)\b(?!_torch)"
        r"|from\s+(jax|repro)\b(?!_torch)[\w.]*\s+import)", re.M)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [f"{f}: {m.group(0).strip()}" for f in files
                 for m in pattern.finditer(f.read_text())]
    assert not offenders, offenders
