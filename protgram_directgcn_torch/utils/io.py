"""FASTA parsing, interaction pairs, protein-id mapping, the embeddings
file and its store, and the package logger.

JAX-free copy of what the port needs from protgram_directgcn_tpu/utils/io.py
(parse_fasta :38, the interaction pairs :85-149, the regex id map :172-287,
write_h5_embeddings :295, EmbeddingStore and check_h5_integrity :305-368).
h5py is optional: where it does not import, the embeddings go to ``.npz``,
and the store and the integrity check read either.
"""

from __future__ import annotations

import logging
import os
import re
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

try:  # optional: absent on some machines, where write_embeddings writes .npz
    import h5py
except ImportError:
    h5py = None

logger = logging.getLogger("protgram_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)
    logger.propagate = False


def parse_fasta(path: Union[str, os.PathLike]) -> Iterator[Tuple[str, str]]:
    """Stream (protein_id, sequence) from a FASTA file.

    The id is the accession between the first two '|' (``sp|ID|...``), else
    the first whitespace token (reference: data_utils.py:181-213).  Sequence
    lines are upper-cased and concatenated.
    """
    protein_id: Optional[str] = None
    parts: List[str] = []
    with open(path, "r", encoding="utf-8", errors="ignore") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if protein_id and parts:
                    yield protein_id, "".join(parts)
                header = line[1:]
                bar = header.split("|")
                protein_id = bar[1] if len(bar) > 1 and bar[1] else header.split()[0]
                parts = []
            elif protein_id is not None:
                parts.append(line.upper())
    if protein_id and parts:
        yield protein_id, "".join(parts)


def _parse_pair_line(line: str) -> Optional[Tuple[str, str]]:
    parts = [p.strip() for p in line.strip().replace('"', "").split(",")]
    if len(parts) < 2:
        parts = [p.strip() for p in line.strip().replace('"', "").split("\t")]
    if len(parts) >= 2 and parts[0] and parts[1]:
        return parts[0], parts[1]
    return None


def load_interaction_pairs(path: Union[str, os.PathLike], label: int,
                           sample_n: Optional[int] = None,
                           random_state: Optional[int] = None) -> List[Tuple[str, str, int]]:
    """(p1, p2, label) pairs of a CSV/TSV file; with ``sample_n``, that many
    drawn without replacement by ``default_rng(random_state)`` and kept in
    file order (reference: data_utils.py:63-96)."""
    if not os.path.exists(path):
        logger.warning("Interaction file not found: %s", path)
        return []
    pairs: List[Tuple[str, str, int]] = []
    with open(path, "r", encoding="utf-8", errors="ignore") as f:
        for line in f:
            parsed = _parse_pair_line(line)
            if parsed:
                pairs.append((parsed[0], parsed[1], label))
    if sample_n is not None and 0 < sample_n < len(pairs):
        rng = np.random.default_rng(random_state)
        idx = rng.choice(len(pairs), size=sample_n, replace=False)
        pairs = [pairs[i] for i in sorted(idx)]
    return pairs


def stream_interaction_pairs(path: Union[str, os.PathLike], label: int, batch_size: int,
                             sample_n: Optional[int] = None,
                             random_state: Optional[int] = None
                             ) -> Iterator[List[Tuple[str, str, int]]]:
    """The pairs of a file in lists of ``batch_size``; with ``sample_n``,
    only the lines of that many line numbers drawn by
    ``default_rng(random_state)`` (reference: data_utils.py:98-144)."""
    if not os.path.exists(path):
        logger.warning("Interaction file not found: %s", path)
        return
    keep: Optional[Set[int]] = None
    if sample_n is not None:
        with open(path, "r", encoding="utf-8", errors="ignore") as f:
            total = sum(1 for _ in f)
        if 0 < sample_n < total:
            rng = np.random.default_rng(random_state)
            keep = set(rng.choice(total, sample_n, replace=False).tolist())
    batch: List[Tuple[str, str, int]] = []
    with open(path, "r", encoding="utf-8", errors="ignore") as f:
        for i, line in enumerate(f):
            if keep is not None and i not in keep:
                continue
            parsed = _parse_pair_line(line)
            if parsed:
                batch.append((parsed[0], parsed[1], label))
                if len(batch) == batch_size:
                    yield batch
                    batch = []
    if batch:
        yield batch


def get_required_ids_from_files(paths: Sequence[Union[str, os.PathLike]]) -> Set[str]:
    """Every protein id of the interaction files (reference: data_utils.py:33-61)."""
    required: Set[str] = set()
    for path in paths:
        if not os.path.exists(path):
            logger.warning("File not found during ID gathering: %s", path)
            continue
        with open(path, "r", encoding="utf-8", errors="ignore") as f:
            for line in f:
                parsed = _parse_pair_line(line)
                if parsed:
                    required.update(parsed)
    return required


_UNIPROT_RE = re.compile(r"^(?:sp|tr)\|([OPQ]?[A-Z0-9]{5,9}(?:-\d+)?)\|", re.IGNORECASE)
_UNIREF_RE = re.compile(r"^(UniRef\d{2,3})_([A-Z0-9]+)", re.IGNORECASE)
_PLAIN_RE = re.compile(r"^([OPQ]?[A-Z0-9]{5,9}(?:-\d+)?)")


def extract_canonical_id(header: str) -> Optional[str]:
    """Canonical UniProt accession from a FASTA header
    (reference: data_utils.py:322-331)."""
    hid = header.strip().lstrip(">")
    m = _UNIPROT_RE.match(hid)
    if m:
        return m.group(1)
    m = _UNIREF_RE.match(hid)
    if m:
        return m.group(2)
    first = hid.split()[0] if hid.split() else hid
    m = _PLAIN_RE.match(first)
    if m:
        return m.group(1)
    return first or None


def generate_regex_id_map(
    fasta_path: Union[str, os.PathLike], output_file: Optional[Union[str, os.PathLike]] = None
) -> Dict[str, str]:
    """FASTA-id → canonical-accession map via header regexes
    (reference: data_utils.py:333-391).  Writes a TSV if output_file given."""
    id_map: Dict[str, str] = {}
    with open(fasta_path, "r", encoding="utf-8", errors="ignore") as f:
        for line in f:
            if not line.startswith(">"):
                continue
            header = line[1:].strip()
            bar = header.split("|")
            record_id = bar[1] if len(bar) > 1 and bar[1] else header.split()[0]
            canonical = extract_canonical_id(header)
            if not canonical:
                continue
            if record_id != canonical:
                id_map.setdefault(record_id, canonical)
            first_word = header.split()[0]
            if first_word != canonical:
                id_map.setdefault(first_word, canonical)
    if output_file and id_map:
        os.makedirs(os.path.dirname(str(output_file)) or ".", exist_ok=True)
        with open(output_file, "w", encoding="utf-8") as f:
            for orig, mapped in id_map.items():
                f.write(f"{orig}\t{mapped}\n")
    return id_map


def ensure_dir(path: Union[str, os.PathLike]) -> Path:
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    return p


def write_embeddings(path: Union[str, os.PathLike], embeddings: Dict[str, np.ndarray]) -> str:
    """Write ``{protein_id: vector}``, one dataset (H5) or array (``.npz``)
    per key, and return the path written: ``path`` as H5 where h5py imports
    (utils/io.py:295-305 of the JAX package), else ``path`` with the suffix
    ``.npz`` (read it back with ``np.load``)."""
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    items = {k: v for k, v in embeddings.items() if v is not None}
    if h5py is not None:
        with h5py.File(path, "w") as hf:
            for key, vec in items.items():
                hf.create_dataset(key, data=vec)
        return str(path)
    out = str(Path(path).with_suffix(".npz"))
    with open(out, "wb") as f:  # np.savez would append .npz to a str path
        np.savez(f, **items)
    logger.info("h5py is not installed: wrote %s as .npz", out)
    return out


def read_embeddings(path: Union[str, os.PathLike]) -> Dict[str, np.ndarray]:
    """``{protein_id: vector}`` from a file :func:`write_embeddings` wrote
    (H5 needs h5py; ``.npz`` needs numpy alone)."""
    if str(path).endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    if h5py is None:
        raise RuntimeError(f"reading {path} needs h5py, which is not installed")
    with h5py.File(path, "r") as hf:
        return {k: hf[k][()] for k in hf.keys()}


class EmbeddingStore:
    """Dict-like read access to an embeddings file, as a context manager;
    values come back as float16 (utils/io.py:305-346 of the JAX package).
    An H5 file is read a key at a time; a ``.npz`` file is read whole on
    entry (its members are small, and a zip member read a key at a time
    costs more than the vector)."""

    def __init__(self, path: Union[str, os.PathLike]):
        self.path = str(path)
        self._file = None
        self._arrays: Optional[Dict[str, np.ndarray]] = None
        self._keys: Optional[Set[str]] = None

    def __enter__(self) -> "EmbeddingStore":
        if not os.path.exists(self.path):
            raise FileNotFoundError(f"Embedding file not found: {self.path}")
        if self.path.endswith(".npz"):
            self._arrays = read_embeddings(self.path)
            self._keys = set(self._arrays)
        else:
            if h5py is None:
                raise RuntimeError(f"reading {self.path} needs h5py, which is not installed")
            self._file = h5py.File(self.path, "r")
            self._keys = set(self._file.keys())
        return self

    def __exit__(self, *exc):
        if self._file is not None:
            self._file.close()
        self._file = self._arrays = self._keys = None

    def _check(self):
        if self._keys is None:
            raise RuntimeError("EmbeddingStore used outside of context manager.")

    def __contains__(self, key: str) -> bool:
        self._check()
        return key in self._keys

    def __getitem__(self, key: str) -> np.ndarray:
        self._check()
        if key not in self._keys:
            raise KeyError(f"Key '{key}' not found in {self.path}")
        if self._arrays is not None:
            return self._arrays[key].astype(np.float16)
        return self._file[key][:].astype(np.float16)

    def __len__(self) -> int:
        return len(self._keys) if self._keys is not None else 0

    def get_keys(self) -> Set[str]:
        self._check()
        return set(self._keys)


def check_h5_integrity(path: Union[str, os.PathLike], num_samples: int = 5,
                       rng: Optional[np.random.Generator] = None) -> bool:
    """Spot-check an embeddings file (H5 or ``.npz``) for empty, NaN or Inf
    vectors, as stored: ``num_samples`` keys drawn by ``rng``
    (``default_rng(0)``) (reference: data_utils.py:444-491).  True if
    healthy."""
    path = str(path)
    is_npz = path.endswith(".npz")
    if not os.path.exists(path) or (not is_npz and (h5py is None or not h5py.is_hdf5(path))):
        logger.error("H5 integrity: %s missing or not HDF5", path)
        return False
    rng = rng or np.random.default_rng(0)
    if is_npz:
        return _vectors_healthy(path, read_embeddings(path), num_samples, rng)
    with h5py.File(path, "r") as hf:
        return _vectors_healthy(path, hf, num_samples, rng)


def _vectors_healthy(path: str, vectors, num_samples: int, rng: np.random.Generator) -> bool:
    keys = list(vectors.keys())
    if not keys:
        logger.warning("H5 integrity: %s has no embeddings", path)
        return False
    ok = True
    for i in rng.choice(len(keys), min(num_samples, len(keys)), replace=False):
        emb = np.asarray(vectors[keys[i]][()])
        if emb.size == 0 or np.isnan(emb).any() or np.isinf(emb).any():
            logger.warning("H5 integrity: bad vector for key %s in %s", keys[i], path)
            ok = False
    return ok
