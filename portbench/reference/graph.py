"""The reference's own view of a graph: CSR rows and arc membership.

Built from the arcs the benchmark generated, never from the program's
tables. An undirected load adds the reverse of every arc; rows are sorted by
destination and keep multi-arcs, which is the row order the node2vec
semantics fix (a draw takes entry j of its row).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RefGraph(NamedTuple):
    offsets: torch.Tensor    # i64 [V+1]
    cols: torch.Tensor       # i64 [E], sorted within each row
    keys: torch.Tensor       # i64 [U]: the distinct arcs, src * V + dst, sorted
    num_vertices: int

    @property
    def degrees(self) -> torch.Tensor:
        return self.offsets[1:] - self.offsets[:-1]

    def member(self, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        """Whether (src, dst) is an arc, elementwise."""
        q = src.to(torch.int64) * self.num_vertices + dst.to(torch.int64)
        pos = torch.searchsorted(self.keys, q).clamp_max(
            max(self.keys.numel() - 1, 0))
        return (self.keys.numel() > 0) & (self.keys[pos] == q)


def build(src: np.ndarray, dst: np.ndarray, num_vertices: int,
          symmetrize: bool, device) -> RefGraph:
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    V = int(num_vertices)
    key = src * V + dst
    key.sort(kind="stable")
    deg = np.bincount(key // V, minlength=V)
    offsets = np.zeros(V + 1, dtype=np.int64)
    np.cumsum(deg, out=offsets[1:])
    put = lambda a: torch.as_tensor(a).to(device)
    return RefGraph(put(offsets), put(key % V), put(np.unique(key)), V)
