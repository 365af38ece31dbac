"""Nothing the benchmark runs imports JAX or the JAX package: neither its
own files (read statically) nor anything a run loads (read from
``sys.modules`` after a run, in a fresh process). Names are compared whole,
by the part before the first dot: ``repro_torch`` is not ``repro``."""
import ast
import subprocess
import sys

from bench_tiny import BENCH, ROOT

BANNED = {"jax", "jaxlib", "flax", "repro"}


def _imported(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in sorted(BENCH.rglob("*.py")):
        bad = {n for n in _imported(path) if n.split(".")[0] in BANNED}
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_names_are_compared_whole():
    from harness.run import banned_modules

    before = set(sys.modules)
    fake = ["repro", "repro.core", "jaxlib.xla", "repro_torch_x", "jaxx"]
    for name in fake:
        sys.modules.setdefault(name, type(sys)(name))
    try:
        found = set(banned_modules())
    finally:
        for name in fake:
            if name not in before:
                del sys.modules[name]
    assert {"repro", "repro.core", "jaxlib.xla"} <= found
    assert not {"repro_torch_x", "jaxx"} & found
    assert not any(m.split(".")[0] == "repro_torch" for m in found)


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run (the system, the harness, the reference and the
    comparison) in a fresh process, then its ``sys.modules``."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from bench_tiny import tiny_root, run_tiny\n"
        "from pathlib import Path\n"
        "r, _, _ = run_tiny(tiny_root(Path(%r)), 'g64-multikey', "
        "seconds=0.1, trace=True)\n"
        "assert r['correct']\n"
        "from harness.run import banned_modules\n"
        "print(sorted(m for m in sys.modules "
        "if m.split('.')[0] == 'repro_torch')[:1], banned_modules())\n"
    ) % (str(BENCH / "tests"), str(BENCH), str(tmp_path / "root"))
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip().endswith("['repro_torch'] []")
