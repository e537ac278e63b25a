"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: `repro_torch` is not `repro`), and the
plain reference loads nothing of the port."""

import ast
import os
import subprocess
import sys

from portbench import harness

ROOT = harness.ROOT


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    bad = []
    for p in sorted(harness.HERE.rglob("*.py")):
        for node in ast.walk(ast.parse(p.read_text())):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            bad += [f"{p.name}: {n}" for n in names
                    if n.split(".")[0] in harness.FORBIDDEN]
    assert not bad, bad


def loaded_after(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({k.split('.')[0] for k in sys.modules})))"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_a_run_loads_neither_jax_nor_the_jax_package():
    top = loaded_after(
        "from portbench.tests import smallcells\n"
        "for n in ('nemotron-train-zipf', 'nemotron-serve-uniform'):\n"
        "    smallcells.run(n, seconds=0.3)\n"
        "from portbench import harness\n"
        "for m in harness.spec()['per_layer']:\n"
        "    harness.reader(m['name'])\n"
        "assert not harness.forbidden_modules()\n")
    assert "repro_torch" in top
    assert not top & set(harness.FORBIDDEN), top & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    top = loaded_after(
        "import torch\n"
        "from portbench.reference import dense, ssm1, steps\n"
        "from portbench.tests import smallcells\n"
        "c = smallcells.cell('falcon-mamba-train-zipf').config\n"
        "steps.init_params(c, 0, 'cpu')\n")
    assert not top & (set(harness.FORBIDDEN) | {"repro_torch"}), top
