"""Configuration of the ported stages (graph, gcn, word2vec, ppi, benchmark).

Same field names and defaults as protgram_directgcn_tpu/config.py:20-341 for
what the port runs (paths, stage toggles, graph builder, GCN trainer,
Word2Vec, PPI evaluation, the GNN zoo benchmark, the node-sharded
training of ``parallel``), and the same dotted
``--set`` overrides.  Each of
these sections keeps every field of the JAX package, so ``--set`` lines
written for it apply here.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional


@dataclass
class PathsConfig:
    """Filesystem layout (reference: config.py:29-46)."""

    project_root: Path = field(default_factory=lambda: Path(".").resolve())
    base_data_dir: Optional[Path] = None
    base_output_dir: Optional[Path] = None
    input_fasta: Optional[Path] = None
    interactions_positive: Optional[Path] = None
    interactions_negative: Optional[Path] = None

    def __post_init__(self):
        if self.base_data_dir is None:
            self.base_data_dir = self.project_root / "data"
        if self.base_output_dir is None:
            self.base_output_dir = self.base_data_dir / "results"
        if self.input_fasta is None:
            self.input_fasta = self.base_data_dir / "sequences/uniprot_sprot.fasta"
        if self.interactions_positive is None:
            self.interactions_positive = self.base_data_dir / "ground_truth/positive_interactions.csv"
        if self.interactions_negative is None:
            self.interactions_negative = self.base_data_dir / "ground_truth/negative_interactions.csv"

    @property
    def graph_objects_dir(self) -> Path:
        return self.base_output_dir / "1_graph_objects"

    @property
    def gcn_embeddings_dir(self) -> Path:
        return self.base_output_dir / "2_gcn_embeddings"

    @property
    def word2vec_embeddings_dir(self) -> Path:
        return self.base_output_dir / "2_word2vec_embeddings"

    @property
    def transformer_embeddings_dir(self) -> Path:
        return self.base_output_dir / "2_transformer_embeddings"

    @property
    def evaluation_results_dir(self) -> Path:
        return self.base_output_dir / "3_evaluation_results"

    @property
    def benchmarking_results_dir(self) -> Path:
        return self.base_output_dir / "4_benchmarking_results"

    @property
    def id_mapping_output_file(self) -> Path:
        return self.base_output_dir / "mappings/gcn_id_mapping.tsv"


@dataclass
class StagesConfig:
    """Workflow stage toggles (reference: config.py:20-26)."""

    run_gcn_pipeline: bool = True
    run_word2vec_pipeline: bool = False
    run_transformer_pipeline: bool = False
    run_benchmarking_pipeline: bool = False
    run_main_ppi_evaluation: bool = False
    run_dummy_test: bool = False
    cleanup_dummy_data: bool = False


@dataclass
class GraphBuilderConfig:
    """N-gram graph ETL knobs (reference: config.py:60-61, 85)."""

    ngram_max_n: int = 3
    workers: int = field(default_factory=lambda: max(1, (os.cpu_count() or 2) - 4))
    propagation_epsilon: float = 1e-9
    add_boundary_spaces: bool = True
    sequences_per_shard: int = 50_000
    # Use the C++ ETL (native.py) where it builds; numpy otherwise (the same
    # graphs, byte for byte).
    use_native: bool = True


@dataclass
class GCNConfig:
    """DirectGCN model + hierarchical trainer knobs (reference: config.py:60-113)."""

    hidden_layer_dims: List[int] = field(default_factory=lambda: [256, 128, 64])
    one_gram_init_dim: int = 512
    epochs_per_level: int = 500
    lr: float = 1e-3
    dropout_rate: float = 0.5
    weight_decay: float = 1e-4
    l2_reg_lambda: float = 1e-7
    use_lr_scheduler: bool = True
    lr_scheduler_patience: int = 10
    lr_scheduler_factor: float = 0.5
    use_early_stopping: bool = True
    early_stopping_patience: int = 25
    early_stopping_min_delta: float = 1e-5
    propagation_epsilon: float = 1e-9
    max_pe_len: int = 512
    use_vector_coeffs: bool = True
    task_types_per_level: Dict[int, str] = field(
        default_factory=lambda: {1: "next_node", 2: "next_node", 3: "next_node"}
    )
    default_task_type: str = "community"
    closest_aa_k_hops: int = 3
    use_cluster_training: bool = True
    cluster_training_threshold_nodes: int = 10_000
    target_nodes_per_cluster: int = 500
    min_clusters: int = 2
    max_clusters: int = 500
    cluster_device_budget_bytes: int = 4 << 30
    cluster_dense_max_budget: int = 1024
    cluster_auto_fullbatch: bool = True
    apply_pca: bool = True
    pca_target_dim: int = 64
    run_sanity_check_ppi: bool = True
    sanity_check_epochs: int = 10
    sanity_check_test_split: float = 0.2
    checkpoint_every_epochs: int = 100
    compute_dtype: str = "auto"
    node_param_dtype: str = "auto"
    node_param_factored: str = "auto"
    remat: Any = "auto"
    spmm_mode: str = "auto"
    oversize_policy: str = "degrade"


@dataclass
class Word2VecConfig:
    """Skip-gram residue embedder knobs (reference: config.py:116-123)."""

    vector_size: int = 100
    window: int = 5
    min_count: int = 1
    epochs: int = 5
    negative: int = 5
    pooling_strategy: str = "mean"
    apply_pca: bool = True
    batch_size: int = 8192
    # SGD whose rate decays linearly from lr to min_alpha (gensim's schedule).
    lr: float = 0.025
    min_alpha: float = 1e-4
    # Frequent-word subsampling threshold (gensim ``sample``); 0 disables.
    sample: float = 1e-3


@dataclass
class EvalConfig:
    """PPI link-prediction evaluation knobs (reference: config.py:136-172)."""

    early_stopping_patience: int = 10
    perform_h5_integrity_check: bool = True
    # Standardize edge features per CV fold on the train fold's statistics.
    standardize_features: bool = False
    sample_negative_pairs: Optional[int] = 100_000
    embedding_files_to_evaluate: List[Dict[str, Any]] = field(default_factory=list)
    edge_embedding_method: str = "concatenate"
    n_folds: int = 5
    mlp_dense1_units: int = 128
    mlp_dropout1_rate: float = 0.4
    mlp_dense2_units: int = 64
    mlp_dropout2_rate: float = 0.4
    mlp_l2_reg: float = 1e-5
    batch_size: int = 1024
    epochs: int = 300
    learning_rate: float = 1e-3
    k_values_for_table: List[int] = field(default_factory=lambda: [50, 100])
    # Above this many bytes of vectors, PPI evaluation streams them from
    # the store (host LRU cache) and builds edge features per batch.
    max_in_memory_feature_bytes: int = 2 << 30
    main_embedding_for_stats: str = "ProtGramDirectGCN"
    statistical_test_alpha: float = 0.05
    plot_training_history: bool = True


@dataclass
class BenchmarkConfig:
    """GNN zoo benchmark suite knobs (reference: config.py:49-57)."""

    node_classification_datasets: List[str] = field(
        default_factory=lambda: ["KarateClub", "Cora", "CiteSeer", "PubMed", "Cornell", "Texas",
                                 "Wisconsin"]
    )
    save_embeddings: bool = True
    apply_pca_to_embeddings: bool = True
    pca_target_dim: int = 64
    test_on_undirected: bool = True
    split_ratios: Dict[str, float] = field(
        default_factory=lambda: {"train": 0.1, "val": 0.1, "test": 0.8})
    # Every benchmark model (zoo + DirectGCN) trains with Adam(lr 1e-3,
    # wd 5e-4) for 300 epochs (reference: gnn_benchmarker.py:334-339).
    epochs: int = 300
    lr: float = 0.001
    weight_decay: float = 5e-4
    # Directory holding real dataset raw files (<Name>/raw/...) in the
    # Planetoid/WebKB layouts; seeded synthetic stand-ins where absent.
    dataset_root: Optional[Path] = None
    # Datasets whose rows are averaged over ``n_seeds`` seeds (init and
    # split re-drawn).
    seed_average_datasets: List[str] = field(default_factory=lambda: ["KarateClub"])
    n_seeds: int = 10
    # The ProtGramDirectGCN_norm row: the deep DirectGCN on the
    # sqrt-normalized 𝒜 operators, with a decoder width floor.
    normalized_row: bool = True
    norm_row_dropout: float = 0.2
    norm_row_decoder_floor: int = 8


@dataclass
class ParallelConfig:
    """Node-sharded training (config.py:307-341 of the JAX package).  The
    port runs one process per device under ``torch.distributed``
    (``parallel/``): ``mesh_nodes`` is the number of node shards, which
    must equal the world size; None trains on one device."""

    mesh_nodes: Optional[int] = None
    mesh_feats: int = 1
    # "hypercube": the hypercube format sharded along its key axis (falls
    # back to "halo" per level where the format does not apply); "halo":
    # edge-partitioned propagation with a ring halo exchange; "gspmd": not
    # ported (ROADMAP Queue 1, item 13b).
    mode: str = "halo"
    # Kept for the JAX package's settings; nothing reads it.
    partition_strategy: str = "block"
    # One exchange for a layer's three matrices in hypercube mode: "auto"
    # takes it on the card, "on"/"off" force either way.
    hyper_tri: str = "auto"
    # Check a checksum of every exchanged halo chunk on both ends.
    debug_checksums: bool = False

    def check(self) -> None:
        """Raise NotImplementedError for the settings the port lacks."""
        if int(self.mesh_feats) > 1 or self.mode == "gspmd":
            raise NotImplementedError(
                f"parallel.mesh_feats={self.mesh_feats} / parallel.mode={self.mode!r}: "
                "feature-sharded weights and the gspmd mode are not ported yet "
                "(ROADMAP Queue 1, item 13b)")
        if self.mode not in ("halo", "hypercube"):
            raise ValueError(f"unknown parallel.mode: {self.mode!r}")


@dataclass
class Config:
    """Top-level configuration (the sections the port reads)."""

    random_state: int = 42
    debug_verbose: bool = False
    paths: PathsConfig = field(default_factory=PathsConfig)
    stages: StagesConfig = field(default_factory=StagesConfig)
    graph_builder: GraphBuilderConfig = field(default_factory=GraphBuilderConfig)
    gcn: GCNConfig = field(default_factory=GCNConfig)
    word2vec: Word2VecConfig = field(default_factory=Word2VecConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    benchmark: BenchmarkConfig = field(default_factory=BenchmarkConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    id_mapping_mode: str = "regex"  # 'regex' | 'none'

    def apply_overrides(self, overrides: Dict[str, Any]) -> "Config":
        """Apply dotted-path overrides, e.g. {"gcn.lr": 3e-4}."""
        for key, value in overrides.items():
            obj: Any = self
            parts = key.split(".")
            for part in parts[:-1]:
                obj = getattr(obj, part)
            leaf = parts[-1]
            if not hasattr(obj, leaf):
                raise KeyError(f"Unknown config key: {key}")
            current = getattr(obj, leaf)
            if isinstance(current, Path) and isinstance(value, str):
                value = Path(value)
            setattr(obj, leaf, value)
        return self

    @classmethod
    def from_json(cls, path: os.PathLike) -> "Config":
        with open(path) as f:
            overrides = json.load(f)
        return cls().apply_overrides(_flatten(overrides))


def _flatten(nested: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for k, v in nested.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict) and not k.endswith("_per_level"):
            flat.update(_flatten(v, key + "."))
        else:
            flat[key] = v
    return flat
