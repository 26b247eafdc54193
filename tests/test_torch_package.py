"""The port's package rules: what it imports, and no silent CPU fallback.

Imports are read from the source (an AST scan): JAX is already imported in
this test process, so ``sys.modules`` cannot tell what the port imports.
"""

import ast
from pathlib import Path

import pytest
import torch

from protgram_directgcn_torch.config import Config
from protgram_directgcn_torch.ops import hyper_kernels as hk
from protgram_directgcn_torch.pipeline.trainer import HierarchicalTrainer
from protgram_directgcn_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "h5py", "matplotlib", "sklearn",
             "networkx", "pandas", "protgram_directgcn_tpu")
# Absent on the card's machine, so the port may name them only in an import
# guarded by ``except ImportError`` (the embeddings file falls back to .npz,
# the evaluation plots are skipped).
OPTIONAL = ("h5py", "matplotlib")
PORT_FILES = sorted((ROOT / "protgram_directgcn_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _catches_import_error(handler: ast.ExceptHandler) -> bool:
    types = handler.type.elts if isinstance(handler.type, ast.Tuple) else [handler.type]
    return any(isinstance(t, ast.Name) and t.id in ("ImportError", "ModuleNotFoundError")
               for t in types)


def _guarded_optional_imports(path: Path):
    """The OPTIONAL modules that ``path`` imports only inside the body of a
    ``try`` with an ``except ImportError`` handler."""
    tree = ast.parse(path.read_text(), filename=str(path))
    guarded = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Try) and any(_catches_import_error(h) for h in node.handlers):
            guarded.update(id(sub) for stmt in node.body for sub in ast.walk(stmt))
    seen = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in OPTIONAL:
                seen.setdefault(top, []).append(id(node) in guarded)
    return {top for top, flags in seen.items() if all(flags)}


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    assert path.exists()
    allowed = _guarded_optional_imports(path)
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN and m.split(".")[0] not in allowed]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_allows_only_guarded_optional_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(
        "try:\n    import h5py\nexcept ImportError:\n    h5py = None\n"
        "try:\n    import sklearn\nexcept ImportError:\n    sklearn = None\n"
        "def plots():\n    try:\n        import matplotlib.pyplot as plt\n"
        "    except ImportError:\n        return None\n"
    )
    # sklearn is never optional
    assert _guarded_optional_imports(probe) == {"h5py", "matplotlib"}
    probe.write_text(
        "try:\n    import h5py\nexcept ImportError:\n    h5py = None\n"
        "def f():\n    import h5py\n"
    )
    assert _guarded_optional_imports(probe) == set()  # one unguarded import
    probe.write_text("try:\n    import h5py\nexcept ValueError:\n    pass\n")
    assert _guarded_optional_imports(probe) == set()
    probe.write_text("import matplotlib\n")
    assert _guarded_optional_imports(probe) == set()


def test_scan_sees_every_import_form(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import jax.numpy as jnp\nfrom flax import struct\n"
        "def f():\n    import h5py\n    __import__('optax')\n"
        "    importlib.import_module('sklearn.decomposition')\n"
        "from protgram_directgcn_tpu.ops import spmm\n"
    )
    assert {m.split(".")[0] for m in _imported_modules(probe)} == {
        "jax", "flax", "h5py", "optax", "sklearn", "protgram_directgcn_tpu"}


def test_entry_points_raise_without_cuda(monkeypatch, toy_fasta, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HierarchicalTrainer(Config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    from protgram_directgcn_torch.__main__ import main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--fasta", str(toy_fasta), "--out", str(tmp_path), "--stages", "graph,gcn"])
    assert not (tmp_path / "1_graph_objects").exists()  # failed before any work
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_convert_defaults_to_the_card(monkeypatch):
    import numpy as np

    from protgram_directgcn_torch import convert

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"w": np.ones((2, 3), np.float32)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.params_from_jax(tree)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.hyper_from_jax(None)
    assert convert.params_from_jax(tree, device="cpu")["w"].device == torch.device("cpu")


def test_ell_from_jax_defaults_to_the_card(monkeypatch):
    import numpy as np

    from protgram_directgcn_torch import convert
    from protgram_directgcn_torch.ops import spmm

    adj = spmm.build_ell(np.array([0, 1]), np.array([1, 0]), np.ones(2, np.float32), 2,
                         device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.ell_from_jax(adj)
    assert convert.ell_from_jax(adj, device="cpu").idx.device == torch.device("cpu")


def test_kernel_wrappers_never_fall_back_off_cpu():
    x = torch.zeros(3, 4, 5, device="meta")
    w = torch.zeros(3, 4, 3, device="meta")
    d = torch.zeros(3, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hk.k1(w, x)
    with pytest.raises(ValueError, match="unsupported device"):
        hk.k2(d, w, x, x)


def test_build_artifacts_are_ignored_by_git():
    ignored = (ROOT / ".gitignore").read_text().splitlines()
    assert "protgram_directgcn_torch/_build/" in ignored
    assert hk.BUILD_DIR == ROOT / "protgram_directgcn_torch" / "_build"


def test_ppi_and_word2vec_entry_points_raise_without_cuda(monkeypatch, toy_fasta, tmp_path):
    import numpy as np

    from protgram_directgcn_torch import convert
    from protgram_directgcn_torch.__main__ import main
    from protgram_directgcn_torch.bench.gnn_benchmarker import GNNBenchmarker
    from protgram_directgcn_torch.models.mlp import MLPConfig, MLPTrainer
    from protgram_directgcn_torch.models.zoo import GCN
    from protgram_directgcn_torch.pipeline.ppi import PPIPipeline, run_sanity_check_ppi
    from protgram_directgcn_torch.pipeline.word2vec import SkipGramModel, Word2VecEmbedder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "e.npz"
    np.savez(path, P1=np.ones(4, np.float16))
    for make in (lambda: PPIPipeline(Config()), lambda: Word2VecEmbedder(Config()),
                 lambda: MLPTrainer(MLPConfig(input_dim=4)), lambda: SkipGramModel(["A"], 4),
                 lambda: run_sanity_check_ppi(Config(), path),
                 lambda: convert.mlp_params_from_jax({"w1": np.ones((2, 2), np.float32)}),
                 lambda: convert.skipgram_params_from_jax(
                     {"in": np.ones((2, 2), np.float32), "out": np.ones((2, 2), np.float32)}),
                 lambda: GNNBenchmarker(Config()),
                 lambda: GCN(np.array([[0], [1]]), 2, 3, 4, 2),
                 lambda: convert.zoo_params_from_jax(
                     "GCN", {"layers": [{"w": np.ones((2, 2), np.float32),
                                         "b": np.zeros(2, np.float32)}]})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    for stages in ("word2vec", "benchmark", "ppi", "dummy", "graph,gcn,word2vec,benchmark,ppi"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--fasta", str(toy_fasta), "--out", str(tmp_path / "o"), "--stages", stages])
    assert not (tmp_path / "o").exists()  # failed before any work
    from protgram_directgcn_torch.pipeline.transformer import TransformerEmbedder

    # The transformer stage, once refused as unported, now runs: it too
    # raises without CUDA before any work, and runs with --device cpu
    # (no local checkpoint: the residue-projection fallback).
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TransformerEmbedder(Config())
    for stages in ("transformer", "graph,benchmark,transformer"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--fasta", str(toy_fasta), "--out", str(tmp_path / "o"), "--stages", stages])
    assert not (tmp_path / "o").exists()
    done = main(["--fasta", str(toy_fasta), "--out", str(tmp_path / "t"), "--stages",
                 "transformer", "--device", "cpu"])
    assert done["transformer"].fallback and len(done["transformer_paths"]) == 1
