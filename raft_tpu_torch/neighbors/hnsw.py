"""HNSW interop: export a CAGRA graph as an hnswlib-loadable index.

Counterpart of ``raft_tpu.neighbors.hnsw`` (the reference's
``raft::neighbors::hnsw``, which serializes a CAGRA graph as a
base-layer-only hnswlib index for CPU search). The file is written by the
native C++ layer (``native.hnswlib_write``), byte for byte the JAX
package's. ``load`` parses it back on the host; ``search`` runs either the
CAGRA searcher over the same graph on the card (``engine="xla"``, the JAX
package's name for it: ``cagra.search``, whose auto plan takes the
``fused_cagra_topk`` kernel) or hnswlib's layer-0 ef-search in the native
C++ layer (``engine="cpu"``).
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np
import torch

from raft_tpu_torch import native
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import resolve_device
from raft_tpu_torch.neighbors import cagra
from raft_tpu_torch.ops.distance import DistanceType

#: hnswlib's saveIndex header: offsetLevel0, max_elements, cur_element_count,
#: size_data_per_element, label_offset, offsetData, maxlevel, enterpoint,
#: maxM, maxM0, M, mult, ef_construction
_HEADER = struct.Struct("<QQQQQQiIQQQdQ")
_SPACES = {"l2": DistanceType.L2Expanded, "ip": DistanceType.InnerProduct}


def from_cagra(cagra_index: cagra.Index, path: str,
               compat: str = "hnswlib") -> None:
    """Serialize a CAGRA index as a base-layer-only hnswlib file (the
    reference's ``hnsw::from_cagra``). ``compat="hnswlib"`` (default) is
    loadable and searchable by stock hnswlib; ``compat="raft"`` reproduces
    the reference serializer byte for byte (its output needs the
    base_layer_only loader)."""
    space = ("ip" if cagra_index.metric == DistanceType.InnerProduct
             else "l2")
    native.hnswlib_write(path, cagra_index.dataset.detach().cpu().numpy(),
                         cagra_index.graph.detach().cpu().numpy(),
                         space=space, compat=compat)


class Index:
    """A loaded base-layer hnsw graph: dataset [n, dim] float32 and links
    [n, maxM0] int32 (-1 padded), host arrays, and the device the
    ``"xla"`` engine searches on."""

    def __init__(self, dataset: np.ndarray, graph: np.ndarray,
                 device=None):
        self.dataset = dataset
        self.graph = graph
        self.device = resolve_device(device)
        self._cagra: Dict[str, cagra.Index] = {}  # by space

    def cagra_index(self, space: str) -> cagra.Index:
        """The graph and dataset as a CAGRA index on ``device`` (made once
        per space)."""
        if space not in self._cagra:
            params = cagra.IndexParams(graph_degree=self.graph.shape[1],
                                       metric=_SPACES[space])
            self._cagra[space] = cagra.Index(
                params, torch.from_numpy(self.dataset).to(self.device),
                torch.from_numpy(self.graph).to(self.device))
        return self._cagra[space]


def load(path: str, device=None) -> Index:
    """Parse an hnswlib index file written by :func:`from_cagra` (hnswlib's
    saveIndex layout: the header, then one level-0 block an element,
    ``[link count u32][maxM0 links u32][dim f32][label u64]``), all
    elements at once. ``device`` is where the ``"xla"`` engine searches
    (CUDA unless the caller asks for the CPU)."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        (_, _, n, size_per_elem, label_offset, offset_data, _, _, _, max_m0,
         _, _, _) = _HEADER.unpack(f.read(_HEADER.size))
        blocks = np.fromfile(f, np.uint8, n * size_per_elem)
    if blocks.size != n * size_per_elem:
        raise ValueError(f"{path}: truncated: {blocks.size} of "
                         f"{n * size_per_elem} element bytes")
    blocks = blocks.reshape(n, size_per_elem)
    dim = (label_offset - offset_data) // 4
    count = np.ascontiguousarray(blocks[:, :4]).view("<u4")[:, 0]
    links = np.ascontiguousarray(blocks[:, 4:4 + 4 * max_m0]).view("<u4")
    graph = np.where(np.arange(max_m0)[None, :] < count[:, None],
                     links.astype(np.int32), np.int32(-1))
    data = np.ascontiguousarray(
        blocks[:, offset_data:offset_data + 4 * dim]).view("<f4")
    return Index(data.astype(np.float32), graph.astype(np.int32), device)


@tracing.range("hnsw.search")
def search(index: Index, queries, k: int, ef: int = 64, space: str = "l2",
           engine: str = "xla") -> Tuple[torch.Tensor, torch.Tensor]:
    """Search the loaded base-layer graph → (distances [nq, k], ids
    [nq, k] int32).

    ``engine="xla"`` (default) runs the CAGRA searcher over the same graph
    on ``index.device`` with ``itopk_size=max(ef, k)`` (hnswlib's
    base-layer search is a greedy beam search with ef as its beam);
    ``engine="cpu"`` runs the native C++ layer-0 ef-search (hnswlib's
    searchBaseLayerST, entry point 0 as in the exported files; l2 only)
    on the host and returns CPU tensors.

    ``space`` must match the space the index was exported with ('l2' or
    'ip'): the hnswlib file format does not record it."""
    if space not in _SPACES:
        raise ValueError(f"unknown space {space!r}; use 'l2' or 'ip'")
    if engine == "cpu":
        if space != "l2":
            raise ValueError("engine='cpu' supports space='l2' only")
        q = (queries.detach().cpu().numpy() if isinstance(queries,
                                                          torch.Tensor)
             else np.asarray(queries))
        q = np.asarray(q, np.float32)
        if q.ndim == 1:
            q = q[None]
        if q.shape[1] != index.dataset.shape[1]:
            raise ValueError(f"query dim {q.shape[1]} != index dim "
                             f"{index.dataset.shape[1]}")
        d, i = native.graph_greedy_search(index.dataset, index.graph, q, k,
                                          ef=ef)
        return torch.from_numpy(d), torch.from_numpy(i)
    if engine != "xla":
        raise ValueError(f"unknown engine {engine!r}; use 'xla' or 'cpu'")
    return cagra.search(index.cagra_index(space), queries, k,
                        cagra.SearchParams(itopk_size=max(ef, k)))
