"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole), the reference imports nothing of the port, and the
harness imports nothing of the bench programs."""

import ast
import subprocess
import sys

from conftest import REPO

LEX = REPO / "lexbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "lexls_tpu"}
BENCH_PROGRAMS = {"bench_torch", "bench_extra_torch", "chip_smoke", "bench", "bench_extra"}


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    """Every ``.py`` under ``lexbench/``, its tests too.  Only a test may
    import ``chip_smoke``, to hold the frozen work counts to the originals."""
    for f in LEX.rglob("*.py"):
        names = imported(f)
        assert not names & FORBIDDEN, (f, names & FORBIDDEN)
        if "tests" not in f.relative_to(LEX).parts:
            assert not names & BENCH_PROGRAMS, (f, names & BENCH_PROGRAMS)


def test_the_reference_imports_nothing_of_the_port():
    for f in (LEX / "reference").rglob("*.py"):
        assert imported(f) <= {"__future__", "dataclasses", "enum", "typing", "numpy", "scipy"}


def test_top_level_names_are_compared_whole():
    from lexbench.harness import cli

    assert cli.forbidden_modules(["lexls_tpu_torch", "lexls_tpu_torch.ops", "jaxtyping",
                                  "numpy"]) == []
    assert cli.forbidden_modules(["lexls_tpu.oracle", "jax.numpy", "flax"]) == [
        "flax", "jax", "lexls_tpu"]


def test_a_cpu_rehearsal_loads_no_jax(tmp_path):
    """A tiny cell run on the CPU in a fresh process leaves no module of
    JAX or of the JAX package in ``sys.modules``."""
    script = f"""
import sys
sys.path.insert(0, {str(REPO)!r}); sys.path.insert(0, {str(LEX / 'tests')!r})
from pathlib import Path
import conftest
from lexbench.harness import spec, cli

def main():
    bench, root = conftest.make_root(Path({str(tmp_path)!r}), entries=("warm_fused",))
    cell = spec.load_cell("tiny.warm_fused", bench, root)
    res = cli.run_cell(cell, 7, 0.3, True, device="cpu")
    print("FORBIDDEN", cli.forbidden_modules(), res["correct"])

if __name__ == "__main__":
    main()
"""
    (tmp_path / "rehearse.py").write_text(script)
    out = subprocess.run([sys.executable, str(tmp_path / "rehearse.py")], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN [] True" in out.stdout, out.stdout[-2000:]


def test_without_a_card_the_command_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, "lexbench/run.py", "--workload", "ik100_f32.warm_b384",
                          "--seed", "1", "--seconds", "1"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
