"""No module of the harness or the reference, nor any module a run loads,
has a top-level name of JAX or of the JAX package (compared whole: the
port's name begins with the JAX package's); the reference imports nothing
of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.lib.runner import FORBIDDEN_MODULES

BENCH_DIR = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH_DIR.rglob("*.py"))


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_forbidden_import(path):
    assert not set(_top_level_imports(path)) & set(FORBIDDEN_MODULES)


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    allowed = {"__future__", "contextlib", "dataclasses", "math", "typing", "warnings",
               "numpy", "torch", "perfbench"}
    names = set(_top_level_imports(path))
    assert names <= allowed, names - allowed
    tree = ast.parse(path.read_text())
    own = [n.module for n in ast.walk(tree)
           if isinstance(n, ast.ImportFrom) and n.module and n.module.startswith("perfbench")]
    assert all(m.startswith("perfbench.reference") for m in own), own


def test_a_run_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench.lib import runner, corpus\n"
            "import protgram_directgcn_torch.pipeline.trainer\n"
            "import protgram_directgcn_torch.graph.builder\n"
            "print(runner.forbidden_modules())" % str(BENCH_DIR.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole():
    import perfbench.lib.runner as runner

    sys.modules.setdefault("protgram_directgcn_tpu_lookalike_test", sys)
    try:
        assert "protgram_directgcn_tpu_lookalike_test" not in runner.forbidden_modules()
    finally:
        del sys.modules["protgram_directgcn_tpu_lookalike_test"]
