"""The port as an installed package: the wheel built from the tree ships the
CUDA sources of ``lexls_tpu_torch/csrc``, and an installed copy imported
outside the checkout finds them, builds into the user's cache and solves
on the CPU without importing anything of ``lexls_tpu``.

The wheel is built and installed by ``chip_smoke.install_port``, which the
card's ``installed`` phase runs too: ``pip wheel`` from a copy of the tree
(``pyproject.toml``, ``README.md`` and both packages) in a temporary
directory, since building in place writes ``build/lib`` and ``*.egg-info``
into the checkout, then ``pip install --target``; pip never looks at an
index.

The package's import layers are read from its sources with ``ast``: the
kernels' layer (``ops/``) and the active-set step below it
(``active_set.py``) import nothing of the solver tiers and their callers,
no module imports a package module inside a function, and no two modules
import each other.

The test tree's one root ``conftest.py`` marks ``slow`` exactly the cases
of ``tests/test_tracker.py`` it lists, and no more than 20."""

import ast
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import zipfile

import pytest
import torch

from lexls_tpu_torch.ops import _build

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

torch.set_num_threads(1)

CSRC_FILES = sorted(p.name for p in (ROOT / "lexls_tpu_torch" / "csrc").iterdir()
                    if p.suffix in (".cu", ".cuh"))

PKG = ROOT / "lexls_tpu_torch"
# module name -> (its source file, whether it is a package's __init__)
SOURCES = {".".join(("lexls_tpu_torch",) + p.relative_to(PKG).with_suffix("").parts[
    :-1 if p.name == "__init__.py" else None]): (p, p.name == "__init__.py")
    for p in sorted(PKG.rglob("*.py"))}
# what the kernels' layer and the active-set step must not import
ABOVE_THE_STEP = ("lexlsi", "tracker", "sequence", "parallel", "api", "wset")


@pytest.fixture(scope="module")
def installed(tmp_path_factory):
    """(the wheel, the directory it was installed into)."""
    tmp = tmp_path_factory.mktemp("wheel")
    target = tmp / "site"
    wheel = chip_smoke.install_port(str(ROOT), str(tmp), str(target))
    return pathlib.Path(wheel), target


def _run_outside(code, target, tmp_path, **env):
    """``code`` in a fresh interpreter whose working directory is
    ``tmp_path`` and whose path holds ``target`` but not the checkout;
    returns the JSON object it prints last."""
    keep = {k: v for k, v in os.environ.items()
            if k not in ("PYTHONPATH", "XDG_CACHE_HOME", "HOME")}
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(keep, PYTHONPATH=str(target), PYTHONNOUSERSITE="1", **env))
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_wheel_holds_every_csrc_file(installed):
    wheel, target = installed
    names = zipfile.ZipFile(wheel).namelist()
    assert CSRC_FILES and sorted(n.rsplit("/", 1)[1] for n in names
                                 if n.startswith("lexls_tpu_torch/csrc/")) == CSRC_FILES
    assert sorted(p.name for p in (target / "lexls_tpu_torch" / "csrc").iterdir()) == CSRC_FILES


def test_installed_port_solves_outside_the_checkout(installed, tmp_path):
    """Imported from the install: the package, its sources and its build
    directory where they belong, a small solve on the CPU PROBLEM_SOLVED,
    the card's default raising where there is none, and no module of
    ``lexls_tpu`` loaded."""
    _, target = installed
    cache = tmp_path / "cache"
    got = _run_outside(f"""
        import json, os, sys
        import numpy as np
        import torch
        import lexls_tpu_torch as lt
        from lexls_tpu_torch.ops import _build

        rng = np.random.default_rng(0)
        n = 6
        A1 = rng.standard_normal((4, n)); c1 = A1 @ rng.standard_normal(n)
        A2 = rng.standard_normal((3, n)); c2 = rng.standard_normal(3)
        prob = lt.build_general_hierarchy([(A1, c1 - .1, c1 + .1), (A2, c2 - .05, c2 + .05)])
        res = lt.solve(prob, device="cpu")
        raised = None
        if not torch.cuda.is_available():
            try:
                lt.solve(prob)
            except lt.LexLSError:
                raised = True
        print(json.dumps(dict(
            file=lt.__file__, csrc=sorted(p.name for p in _build.CSRC.glob("*.cu")),
            build_dir=str(_build.BUILD_DIR), status=int(res.status), raised=raised,
            card=torch.cuda.is_available(),
            path=[p for p in sys.path if os.path.realpath(p or ".") == {str(ROOT)!r}],
            jax_package=sorted(m for m in sys.modules if m.split(".")[0] == "lexls_tpu"))))
    """, target, tmp_path, XDG_CACHE_HOME=str(cache), HOME=str(tmp_path))
    assert pathlib.Path(got["file"]).is_relative_to(target)
    assert got["csrc"] == [f for f in CSRC_FILES if f.endswith(".cu")]
    assert pathlib.Path(got["build_dir"]) == cache / "lexls_tpu_torch"
    assert got["status"] == 0 and got["path"] == [] and got["jax_package"] == []
    assert got["raised"] or got["card"]


def test_installed_build_dir_without_xdg(installed, tmp_path):
    """Without ``XDG_CACHE_HOME`` an installed copy builds under
    ``~/.cache/lexls_tpu_torch``."""
    _, target = installed
    got = _run_outside("""
        import json
        from lexls_tpu_torch.ops import _build
        print(json.dumps(str(_build.BUILD_DIR)))
    """, target, tmp_path, HOME=str(tmp_path))
    assert pathlib.Path(got) == tmp_path / ".cache" / "lexls_tpu_torch"


def test_checkout_builds_at_its_root():
    """In a checkout (a ``pyproject.toml`` beside the package) the kernels
    build into ``build/lexls_tpu_torch/``, which ``.gitignore`` lists."""
    assert _build.BUILD_DIR == ROOT / "build" / "lexls_tpu_torch"
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_build_without_sources_names_csrc(monkeypatch, tmp_path):
    """A package without its ``csrc/*.cu`` raises naming the directory,
    before it looks for nvcc."""
    def no_nvcc():
        raise AssertionError("nvcc was looked for")

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    _build.build.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=str(tmp_path)):
            _build.build()
    finally:
        _build.build.cache_clear()
    assert not (tmp_path / "out").exists()


def _package_imports(name):
    """[(imported package module, inside a function)] of module ``name``:
    ``from a import b`` counts ``a.b`` where that is a module, else ``a``."""
    path, is_init = SOURCES[name]
    package = name if is_init else name.rpartition(".")[0]
    found = []

    def visit(node, in_function):
        if isinstance(node, ast.Import):
            found.extend((a.name, in_function) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                up = package.split(".")[:len(package.split(".")) - node.level + 1]
                base = ".".join(up + ([node.module] if node.module else []))
            subs = [f"{base}.{a.name}" for a in node.names if f"{base}.{a.name}" in SOURCES]
            found.extend((t, in_function) for t in (subs or [base]))
        inner = in_function or isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                                 ast.Lambda))
        for child in ast.iter_child_nodes(node):
            visit(child, inner)

    visit(ast.parse(path.read_text()), False)
    return [(t, f) for t, f in found if t == "lexls_tpu_torch" or t.startswith("lexls_tpu_torch.")]


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_module_keeps_its_layer(name):
    """The module's imports keep the port's layers: under ``ops/`` and in
    ``active_set`` nothing of the tiers or their callers; no package
    module imported inside a function (an import that dodges a cycle);
    and no module it imports imports it back (``sequence`` and
    ``parallel.batch``, ``lexlsi`` and ``ops``, ...)."""
    imports = _package_imports(name)
    if name.startswith("lexls_tpu_torch.ops") or name == "lexls_tpu_torch.active_set":
        above = [t for t, _ in imports if t.split(".")[1:2] and t.split(".")[1] in ABOVE_THE_STEP]
        assert not above, f"{name} imports {above}, a layer above the kernels"
    inside = [t for t, in_function in imports if in_function]
    assert not inside, f"{name} imports {inside} inside a function"
    back = [t for t, _ in imports if t != name and t in SOURCES
            and name in (u for u, _ in _package_imports(t))]
    assert not back, f"{name} and {back} import each other"


def _tracker_ids(marker_expr):
    """The ids that ``-m marker_expr`` collects from ``tests/test_tracker.py``."""
    out = subprocess.run([sys.executable, "-m", "pytest", "--collect-only", "-q", "-o", "addopts=",
                          "-p", "no:cacheprovider", "-m", marker_expr, "tests/test_tracker.py"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode in (0, 5), out.stdout + out.stderr  # 5: every case deselected
    return [line for line in out.stdout.splitlines() if "::" in line]


def test_tracker_slow_marks_are_the_root_conftest_list():
    """``-m slow`` collects exactly the root ``conftest.py``'s
    ``TRACKER_SLOW``, so a renamed or misspelt entry fails here instead of
    silently running in tier-1; the list holds at most 20 cases, each once,
    each a case of a parametrised function that keeps an unmarked case."""
    spec = importlib.util.spec_from_file_location("_root_conftest", ROOT / "conftest.py")
    root_conftest = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_conftest)
    listed = root_conftest.TRACKER_SLOW
    assert len(listed) <= 20 and len(set(listed)) == len(listed)
    collected = _tracker_ids("slow")
    missing = sorted(set(listed) - set(collected))
    assert not missing, f"tests/test_tracker.py collects no case named {missing}"
    assert sorted(collected) == sorted(listed)
    kept = {i.partition("[")[0] for i in _tracker_ids("not slow")}
    for case in listed:
        function, bracket, _ = case.partition("[")
        assert bracket and function in kept, f"{case}: its function keeps no unmarked case"
