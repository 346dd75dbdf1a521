"""Nothing the benchmark runs holds JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from perfbench import cells

FORBIDDEN = set(cells.FORBIDDEN)


def _imports(path) -> set:
    """Top-level names of every module ``path`` imports (absolute)."""
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources(root):
    return sorted(p for p in root.rglob("*.py") if "__pycache__" not in
                  p.parts)


def test_no_forbidden_import_in_the_port_or_the_harness():
    for root in (cells.ROOT / "tpuseg_torch", cells.HERE):
        for path in _sources(root):
            bad = _imports(path) & FORBIDDEN
            assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources(cells.HERE / "reference"):
        names = _imports(path)
        assert not names & (FORBIDDEN | {"tpuseg_torch"}), path
        # what it imports of the benchmark is the reference itself
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("perfbench"):
                assert node.module.startswith("perfbench.reference"), path


def _module_level_imports(path) -> set:
    """Top-level names of the modules ``path`` imports outside its
    functions (absolute)."""
    out = set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _program_imports_outside(path, allowed) -> list:
    """Functions of ``path`` other than ``allowed`` that import the
    program."""
    bad = []
    for fn in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(fn, ast.FunctionDef) and fn.name not in allowed:
            for node in ast.walk(fn):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else
                        [node.module] if isinstance(node, ast.ImportFrom)
                        else [])
                if any(m.split(".")[0] == "tpuseg_torch" for m in mods):
                    bad.append(fn.name)
    return bad


@pytest.mark.parametrize("path", _sources(cells.HERE / "arch")
                         + _sources(cells.HERE / "generators"),
                         ids=lambda p: f"{p.parent.name}/{p.name}")
def test_architectures_and_generators_keep_the_program_to_build(path):
    """An architecture's reference, state and work, and every traffic
    generator, import nothing of the program: an architecture reaches it
    only inside ``build``, where the program's model is made."""
    assert not _module_level_imports(path) & (FORBIDDEN | {"tpuseg_torch"})
    allowed = {"build"} if path.parent.name == "arch" else set()
    assert not _program_imports_outside(path, allowed)


def test_a_process_running_the_harness_holds_none():
    """Import every module of the harness, every metric and the program's
    modules that the drivers reach, then list what the process holds."""
    code = (
        "import sys\n"
        "from perfbench import cells, control, infer_cell, train_cell, run\n"
        "[cells.load_metric(n) for n in cells.metric_names()]\n"
        "[cells.load_module(d, p.stem) for d in ('arch', 'generators')\n"
        " for p in (cells.HERE / d).glob('*.py')]\n"
        "import tpuseg_torch.infer.pipeline, tpuseg_torch.train.step\n"
        "import tpuseg_torch.data.prefetch, tpuseg_torch.data.sampler\n"
        "import tpuseg_torch.ops.calibrate, tpuseg_torch.models\n"
        "print(cells.forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH=str(cells.ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=str(cells.ROOT), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    before = set(cells.forbidden_modules())
    monkeypatch.setitem(sys.modules, "tpuseg_torch_like", sys)
    assert set(cells.forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "jax.not_a_module", sys)
    assert set(cells.forbidden_modules()) == before | {"jax"}
