"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (ceracoder_tpu_torch begins with ceracoder_tpu),
and the reference loads nothing of the program it judges."""

import ast
import subprocess
import sys

from benchmark import harness

# the reference and what judges the program's output with it
REFERENCE_FILES = (sorted((harness.BENCH / "reference").rglob("*.py"))
                   + [harness.BENCH / name for name in
                      ("camera.py", "check.py", "stream.py")])


def _tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_banned_import_in_any_file():
    for path in harness.BENCH.rglob("*.py"):
        assert not _tops(path) & set(harness.BANNED), path


def test_reference_imports_nothing_of_the_program():
    for path in REFERENCE_FILES:
        assert _tops(path) <= {"__future__", "numpy", "torch", "math",
                               "multiprocessing", "os", "concurrent",
                               "dataclasses", "random", "benchmark"}, path


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.hevc.bands, "
            "benchmark.camera; print(sorted({m.split('.')[0] for m in "
            "sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True).stdout
    tops = set(eval(out))
    assert "ceracoder_tpu_torch" not in tops
    assert not tops & set(harness.BANNED)


def test_banned_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ceracoder_tpu_torch_fake.x", sys)
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "ceracoder_tpu.fake", sys)
    assert harness.banned_modules() == ["ceracoder_tpu"]


def test_no_result_without_the_program_or_a_card(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/, and
    on a host without a card, run.py exits non-zero and prints no result."""
    import shutil
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "hevc_1080p60.live", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
