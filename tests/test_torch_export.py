"""Port parity: the export after pooling (PCA and the embeddings file).

- ``apply_pca`` against sklearn's ``StandardScaler`` + ``PCA`` on the same
  seeded data, before the float16 cast: rtol 1e-5, atol 1e-6, signs as
  sklearn's ``svd_flip`` sets them.  Where sklearn's "auto" solver is
  covariance_eigh or full, the port's torch float64 SVD against sklearn in
  float64; where it is randomized, the port's numpy ``randomized_svd``
  against sklearn on the float32 input the JAX package passes it, with the
  same ``random_state`` (the sketch depends on both).  The float16 output
  within one float16 ulp of sklearn's and of the JAX package's
  ``apply_pca`` (sklearn on float32 input; one ulp at the column's largest
  magnitude).
- ``write_embeddings``: H5 where h5py imports, ``.npz`` where it does not,
  read back key for key.
- ``run()`` to n = 4 on the toy FASTA (``--device cpu``): the port writes
  the files the JAX package's ``run()`` writes, with the same keys and
  shapes, and returns the final path.
"""

import h5py
import numpy as np
import pytest
from sklearn.decomposition import PCA
from sklearn.preprocessing import StandardScaler

from protgram_directgcn_torch.__main__ import main as t_main
from protgram_directgcn_torch.utils import embeddings as t_emb
from protgram_directgcn_torch.utils import io as t_io
from protgram_directgcn_tpu.config import Config as JConfig
from protgram_directgcn_tpu.graph.builder import NgramGraphBuilder as JBuilder
from protgram_directgcn_tpu.pipeline.trainer import HierarchicalTrainer as JTrainer
from protgram_directgcn_tpu.utils import embeddings as j_emb


def _embeddings(n: int, dim: int, seed: int, constant_col: bool = False):
    rng = np.random.default_rng(seed)
    # Correlated columns with distinct variances, as pooled embeddings have.
    mat = rng.normal(size=(n, dim)) @ rng.normal(size=(dim, dim)) * rng.uniform(0.5, 2, dim)
    mat = mat.astype(np.float32)
    if constant_col:
        mat[:, 1] = 0.25
    return {f"P{i:04d}": mat[i] for i in range(n)}


CASES = [
    # (proteins, dim, target)
    (600, 40, 16),  # sklearn: covariance_eigh (tall and skinny)
    (120, 30, 12),  # full SVD
    (50, 8, 64),  # target > dim
    (5, 12, 64),  # target > n_samples
    # Randomized: max(N, D) > 500, N < 10·D and k < 0.8·min(N, D).
    (1000, 128, 64),  # the default target on a 128-wide export (7 power iterations: no)
    (600, 200, 16),  # k < 0.1·min(N, D): 7 power iterations
    (300, 800, 40),  # wide: sklearn sketches the transpose
]
SEED = 42  # Config.random_state, which run() passes to apply_pca


def _sklearn_pca(mat: np.ndarray, k: int) -> np.ndarray:
    """sklearn's scores in float64, or, where its solver is randomized, on
    the float32 input with the run's seed, as the JAX package calls it."""
    if t_emb._pca_solver(*mat.shape, k) == "randomized":
        mat = mat.astype(np.float32)
        pca = PCA(n_components=k, random_state=SEED)
    else:
        mat = mat.astype(np.float64)
        pca = PCA(n_components=k, random_state=0)
    out = pca.fit_transform(StandardScaler().fit_transform(mat))
    assert (pca._fit_svd_solver == "randomized") == (mat.dtype == np.float32)
    return out


@pytest.mark.parametrize("n,dim,target", CASES)
@pytest.mark.parametrize("constant_col", [False, True])
def test_pca_matches_sklearn_before_the_cast(n, dim, target, constant_col):
    emb = _embeddings(n, dim, seed=n + dim, constant_col=constant_col)
    got = t_emb.apply_pca(emb, target, SEED, output_dtype=np.float64)
    k = min(target, dim, n)
    want = _sklearn_pca(np.stack(list(emb.values())), k)
    assert list(got) == list(emb)
    out = np.stack(list(got.values()))
    assert out.shape == (n, k) and out.dtype == np.float64
    if n <= k:
        # The last component of n centred samples spans nothing: its scores
        # are rounding noise in both, of either sign.
        out, want = out[:, : n - 1], want[:, : n - 1]
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,dim,target", CASES)
def test_pca_float16_matches_jax(n, dim, target):
    """The float16 output: within one float16 ulp of sklearn's float64
    result cast to float16 (both round the same float64 values), and
    within one float16 ulp at each column's largest magnitude of the JAX
    package's ``apply_pca``, which runs sklearn in float32: its rounding
    there, ~1e-6 of a column's scale, can pass an element's own ulp where
    the element is near zero."""
    emb = _embeddings(n, dim, seed=7 * n + dim)
    got = t_emb.apply_pca(emb, target, SEED)
    want = j_emb.apply_pca(emb, target, random_seed=SEED)
    k = min(target, dim, n)
    exact = _sklearn_pca(np.stack(list(emb.values())), k).astype(np.float16)
    assert list(got) == list(want)
    a = np.stack(list(got.values()))
    b = np.stack(list(want.values()))
    assert a.dtype == b.dtype == np.float16 and a.shape == b.shape == exact.shape
    if n <= k:
        a, b, exact = a[:, : n - 1], b[:, : n - 1], exact[:, : n - 1]
    a32 = a.astype(np.float32)
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(exact))).astype(np.float32)
    assert (np.abs(a32 - exact.astype(np.float32)) <= ulp).all()
    col_ulp = np.spacing(np.abs(b).max(axis=0)).astype(np.float32)
    assert (np.abs(a32 - b.astype(np.float32)) <= col_ulp).all()


def test_pca_without_embeddings_returns_none():
    assert t_emb.apply_pca({}, 8) is None
    assert t_emb.apply_pca({"P": np.zeros(0, np.float32)}, 8) is None


@pytest.mark.parametrize("h5", [True, False])
def test_write_embeddings_round_trip(tmp_path, monkeypatch, h5):
    emb = {k: v.astype(np.float16) for k, v in _embeddings(6, 5, seed=1).items()}
    if not h5:
        monkeypatch.setattr(t_io, "h5py", None)
    path = t_io.write_embeddings(tmp_path / "sub" / "gcn_n3_embeddings.h5", emb)
    if h5:
        assert path == str(tmp_path / "sub" / "gcn_n3_embeddings.h5")
        with h5py.File(path, "r") as f:
            back = {k: f[k][()] for k in f.keys()}
    else:
        assert path == str(tmp_path / "sub" / "gcn_n3_embeddings.npz")
        with np.load(path) as z:
            back = {k: z[k] for k in z.files}
        with pytest.raises(RuntimeError, match="needs h5py"):
            t_io.read_embeddings(tmp_path / "absent.h5")
    assert sorted(back) == sorted(emb)
    again = t_io.read_embeddings(path)
    for k, v in emb.items():
        assert back[k].dtype == again[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)
        np.testing.assert_array_equal(again[k], v)


def _read(path):
    if path.endswith(".h5"):
        with h5py.File(path, "r") as f:
            return {k: f[k][()] for k in f.keys()}
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("h5", [True, False])
def test_run_writes_the_jax_files(toy_fasta, tmp_path, monkeypatch, h5):
    sets = {"gcn.hidden_layer_dims": [8, 4], "gcn.one_gram_init_dim": 8,
            "gcn.epochs_per_level": 2, "gcn.run_sanity_check_ppi": False,
            "graph_builder.ngram_max_n": 4}
    jcfg = JConfig().apply_overrides(sets)
    jcfg.paths.input_fasta = toy_fasta
    jcfg.paths.base_output_dir = tmp_path / "jax"
    JBuilder(jcfg).run()
    j_path = JTrainer(jcfg).run()
    if not h5:
        monkeypatch.setattr(t_io, "h5py", None)
    argv = ["--fasta", str(toy_fasta), "--out", str(tmp_path / "port"), "--stages", "graph,gcn",
            "--device", "cpu"]
    for key, value in sets.items():
        argv += ["--set", f"{key}={str(value).replace(' ', '').lower()}"]
    result = t_main(argv)
    t_path = result["embeddings_path"]
    trainer = result["trainer"]
    assert trainer.level_stats[4]["task"] == "community"
    suffix = ".h5" if h5 else ".npz"
    j_dir, t_dir = jcfg.paths.gcn_embeddings_dir, tmp_path / "port" / "2_gcn_embeddings"
    assert t_path == str(t_dir / (j_path.rsplit("/", 1)[1][: -len(".h5")] + suffix))
    for name in ("gcn_n4_embeddings", j_path.rsplit("/", 1)[1][: -len(".h5")]):
        want = _read(str(j_dir / f"{name}.h5"))
        got = _read(str(t_dir / f"{name}{suffix}"))
        assert sorted(got) == sorted(want) and len(got) == 3
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    pooled = _read(str(t_dir / f"gcn_n4_embeddings{suffix}"))
    for k, v in result["pooled"].items():
        np.testing.assert_array_equal(pooled[k], v)
