"""Plain PyTorch n-gram graph of a FASTA corpus and its three DirectGCN
propagation operators, written from the published method and independent of
the program under test.  Runs on the device it is given.

- Each sequence is one text; the first gets a leading space and every one a
  trailing space.  Nodes are the distinct n-character windows of the texts,
  sorted; an edge joins each window to the next one of the same text, and
  its weight counts how often that pair occurs.
- Row normalisation ``A_n = D^-1 A`` of the out-weights; the propagation
  matrix ``sqrt(0.5 (A_n∘² + A_n∘²ᵀ) + eps) + I`` over the union pattern
  (eps only at stored entries); ``in`` is the same built from ``Aᵀ``.
- The undirected operator ``D^-1/2 (A + I) D^-1/2`` over the unique pairs of
  the symmetrised pattern, unit weights, one self-loop appended per node
  (a node with its own self-edge keeps both), summed at the end.

Arithmetic is float32 as the method states; sums of float32 terms are taken
in float64 and rounded once, and each holds at most two terms or integers,
so they are exact whatever the order a device sums them in; square roots
are taken in float64 and rounded once too.  A product with
an operator given by entries (src, tgt, w) sums ``w * x[src]`` into row
``tgt``.  The node space is the sorted vocabulary, or the character
hypercube ``[alphabet^n]`` where node (c_1..c_n) sits at
``sum code(c_i) * A^(n-i)`` over the sorted alphabet of the vocabulary.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

Entries = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # src, tgt int64; float32 weight
_MAX_N = 7  # n-gram keys are big-endian bytes in an int64


def read_fasta(path: str) -> List[str]:
    """Sequences of a FASTA file: the lines after each header, stripped,
    upper-cased and joined."""
    seqs: List[str] = []
    parts: List[str] = []
    header = False
    with open(path, "r", encoding="utf-8", errors="ignore") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if header and parts:
                    seqs.append("".join(parts))
                header, parts = True, []
            elif header:
                parts.append(line.upper())
    if header and parts:
        seqs.append("".join(parts))
    return seqs


@dataclasses.dataclass
class Graph:
    n: int
    vocab_keys: torch.Tensor  # [N] int64, big-endian bytes of each n-gram, sorted
    src: torch.Tensor  # [E] int64
    tgt: torch.Tensor  # [E] int64
    weight: torch.Tensor  # [E] float32 pair counts

    @property
    def num_nodes(self) -> int:
        return len(self.vocab_keys)

    def chars(self) -> torch.Tensor:
        """[N, n] characters (byte values) of each node."""
        shifts = 8 * torch.arange(self.n - 1, -1, -1, device=self.vocab_keys.device)
        return (self.vocab_keys[:, None] >> shifts[None, :]) & 0xFF

    def hypercube_positions(self) -> Tuple[torch.Tensor, int]:
        """Each node's hypercube id and the hypercube's size."""
        chars = self.chars()
        alphabet = torch.unique(chars)
        codes = torch.searchsorted(alphabet, chars.contiguous())
        a = len(alphabet)
        pows = a ** torch.arange(self.n - 1, -1, -1, device=chars.device)
        return (codes * pows).sum(1), a ** self.n


def ngram_graph(seqs: List[str], n: int, device="cpu") -> Graph:
    if not 1 <= n <= _MAX_N:
        raise ValueError(f"n = {n} outside 1..{_MAX_N}")
    texts = [(" " + s if i == 0 else s) + " " for i, s in enumerate(seqs)]
    lens = torch.tensor([len(t) for t in texts], dtype=torch.int64, device=device)
    buf = torch.frombuffer(bytearray("".join(texts).encode("latin-1")),
                           dtype=torch.uint8).to(device).long()
    starts = torch.cumsum(lens, 0) - lens
    windows = torch.clamp(lens - n + 1, min=0)
    text_of = torch.repeat_interleave(torch.arange(len(texts), device=device), windows)
    first = torch.cumsum(windows, 0) - windows
    pos = starts[text_of] + (torch.arange(len(text_of), device=device) - first[text_of])
    keys = torch.zeros(len(pos), dtype=torch.int64, device=device)
    for i in range(n):
        keys = keys * 256 + buf[pos + i]
    vocab_keys, ids = torch.unique(keys, sorted=True, return_inverse=True)
    same = text_of[1:] == text_of[:-1]
    num = len(vocab_keys)
    pairs, counts = torch.unique(ids[:-1][same] * num + ids[1:][same], sorted=True,
                                 return_counts=True)
    return Graph(n=n, vocab_keys=vocab_keys, src=pairs // num, tgt=pairs % num,
                 weight=counts.float())


def _coalesce(src: torch.Tensor, tgt: torch.Tensor, w: torch.Tensor, n: int) -> Entries:
    """Duplicate (src, tgt) entries summed, in row-major order."""
    keys, inv = torch.unique(src * n + tgt, sorted=True, return_inverse=True)
    vals = torch.zeros(len(keys), dtype=torch.float64, device=w.device)
    vals.index_add_(0, inv, w.double())
    return keys // n, keys % n, vals.float()


def propagation_matrix(src: torch.Tensor, tgt: torch.Tensor, w: torch.Tensor, n: int,
                       eps: float) -> Entries:
    """``sqrt(0.5 (A_n∘² + A_n∘²ᵀ) + eps) + I`` of the weights (src -> tgt)."""
    row_sum = torch.zeros(n, dtype=torch.float64, device=w.device)
    row_sum.index_add_(0, src, w.double())
    row_sum = row_sum.float()
    inv = torch.where(row_sum != 0, 1.0 / row_sum, torch.zeros_like(row_sum))
    a_n = inv[src] * w.float()
    sq = a_n * a_n
    r, c, s = _coalesce(torch.cat([src, tgt]), torch.cat([tgt, src]), torch.cat([sq, sq]), n)
    # The float32 argument's root, taken in float64 and rounded once: the
    # correctly rounded float32 root, whatever a device's float32 kernel gives.
    vals = torch.sqrt((0.5 * s + torch.tensor(eps, dtype=torch.float32)).double()).float()
    loops = torch.arange(n, device=w.device)
    return _coalesce(torch.cat([r, loops]), torch.cat([c, loops]),
                     torch.cat([vals, torch.ones(n, device=w.device)]), n)


def undirected_matrix(src: torch.Tensor, tgt: torch.Tensor, n: int) -> Entries:
    keys = torch.unique(src * n + tgt)
    r, c = keys // n, keys % n
    sym = torch.unique(torch.cat([keys, c * n + r]))
    loops = torch.arange(n, device=src.device)
    rows = torch.cat([sym // n, loops])
    cols = torch.cat([sym % n, loops])
    deg = torch.bincount(cols, minlength=n).float()
    dinv = torch.where(deg > 0, deg ** -0.5, torch.zeros_like(deg))
    return _coalesce(rows, cols, dinv[rows] * dinv[cols], n)


def operators(g: Graph, eps: float) -> Tuple[Entries, Entries, Entries]:
    """(in, out, undirected) entries over the vocabulary's node ids."""
    n = g.num_nodes
    return (propagation_matrix(g.tgt, g.src, g.weight, n, eps),
            propagation_matrix(g.src, g.tgt, g.weight, n, eps),
            undirected_matrix(g.src, g.tgt, n))
