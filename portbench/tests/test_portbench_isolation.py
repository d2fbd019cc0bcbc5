"""What the benchmark loads and imports.

- A run loads no module whose top-level name is ``jax``, ``jaxlib``,
  ``flax`` or ``tpufusion`` (the JAX package), compared whole: the port's
  ``tpufusion_torch`` starts with ``tpufusion`` and must not trip it. The
  harness makes the same check at the end of every window.
- No source under ``portbench/`` imports those, nor the repository's
  ``tests``, ``benchmarks``, ``bench`` or ``chip_smoke``; the reference
  imports nothing of the port, and only ``program.py`` (and the tests that
  plant faults in it) imports the port.
- In a directory holding only ``BENCHMARK.json`` and ``portbench/`` a run
  exits with another code than 0 and prints no result.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
NEVER = {"jax", "jaxlib", "flax", "tpufusion", "tests", "benchmarks", "bench", "chip_smoke"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _sources():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def test_sources_import_nothing_they_must_not():
    files = _sources()
    assert len(files) > 20
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in NEVER, (f, name)
            if "reference" in f.parts or f.name in ("weights.py", "traffic.py", "flops.py"):
                assert top != "tpufusion_torch" and name != "portbench.program", (f, name)
            if top == "tpufusion_torch":  # the fault tests plant faults in the port
                assert f.name == "program.py" or "tests" in f.parts, (f, name)


def test_banned_modules_compare_whole_names():
    sys.modules.setdefault("tpufusion_torch_probe", sys)  # a name that starts alike
    try:
        assert "tpufusion" not in harness.banned_modules()
    finally:
        del sys.modules["tpufusion_torch_probe"]


def test_a_cpu_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench.tests import tiny\n"
            "out = tiny.run('car512.whitebox')\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'tpufusion'})\n"
            "assert out['correct'] and not bad, (out['checked'], bad)\n"
            "assert 'tpufusion_torch' in sys.modules\n") % str(ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]


def test_without_the_port_a_run_fails_and_prints_nothing(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", "car512.whitebox",
                        "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
