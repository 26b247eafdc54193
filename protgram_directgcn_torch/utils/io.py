"""FASTA parsing, protein-id mapping, the embeddings file and the package
logger.

JAX-free copy of what the slice needs from protgram_directgcn_tpu/utils/io.py
(parse_fasta :38, the regex id map :172-287, write_h5_embeddings :295).
h5py is optional: where it does not import, the embeddings go to ``.npz``.
"""

from __future__ import annotations

import logging
import os
import re
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Union

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
