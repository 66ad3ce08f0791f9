"""What a benchmark run imports, and what the harness reads."""

import ast
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "port_bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "quantum_computations_tpu"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Everything a run imports, loaded in a fresh process (a CPU cell at a
    tiny grid), compared by whole top-level names."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from port_bench.harness.bench import Cell, run_cell, forbidden_modules\n"
        "import port_bench.run, port_bench.calibrate\n"
        "for name in ('rb_d8_10db', 'grover_04_12db'):\n"
        "    cell = Cell(name); cell.traffic = dict(cell.traffic, batch=1)\n"
        "    run_cell(cell, 3, 0.1, False, device='cpu', config_overrides="
        "{'grid_points': 64, 'grid_span': 10.0, 'max_bond_dim': 4})\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "assert not forbidden_modules(), forbidden_modules()\n" % str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert "quantum_computations_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_no_benchmark_file_imports_jax_and_the_reference_imports_nothing_of_the_port():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
    for path in (BENCH / "reference").rglob("*.py"):
        assert _imports(path) <= {"__future__", "contextlib", "math", "bisect", "numpy",
                                  "torch"}, path


def test_no_benchmark_file_reads_the_jax_era_results():
    """No mention of the JAX package's results: the ``benchmarks`` folder,
    the root ``bench.py`` or a ``BENCH_*.json``."""
    words = re.compile(r"\bbenchmarks/|(?<![\w/.])bench\.py|\bBENCH_\w*\.json")
    for path in BENCH.rglob("*"):
        if path.suffix not in (".py", ".json", ".sh") or path.parent.name == "tests":
            continue
        assert not words.search(path.read_text()), path
