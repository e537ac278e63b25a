"""The port stands alone: every `repro_torch` module imports with JAX and
the JAX package blocked, and no file of the port (nor `chip_smoke.py`)
imports either."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_torch)|from\s+(jax|repro)\b(?!_torch))",
    re.M)


def modules():
    return sorted(
        ".".join(("repro_torch",) + p.relative_to(PORT).with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def test_every_module_imports_without_jax():
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "loaded = [k for k, v in sys.modules.items() if v is not None]\n"
            "assert not [k for k in loaded\n"
            "            if k == 'jax' or k.startswith(('jax.', 'repro.'))]\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_file_imports_jax_or_the_jax_package():
    assert len(FILES) > 20
    bad = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
           for p in FILES for m in FORBIDDEN.finditer(p.read_text())]
    assert not bad, bad


def test_scan_catches_forbidden_imports():
    for line in ("import jax", "from jax import numpy", "import repro",
                 "from repro.pm import planner", "    import jax.numpy"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.pm import x",
                 "import jaxtyping", "# see repro.pm.planner"):
        assert not FORBIDDEN.search(line), line
