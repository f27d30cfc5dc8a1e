"""Graph partitioner for agglomerated multigrid levels.

The port's copy of `partition_cells` (and its Morton ordering) from
parelagmc_tpu/fem/agglomeration.py, numpy/scipy only: the METIS analog that
ops/coef_multigrid.build_coef_mg_graph coarsens an arbitrary cell complex
with. The agglomerated finite-element levels of that module belong to the
unstructured stack and are not part of this package yet.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _morton_order(centroids: np.ndarray) -> np.ndarray:
    """Deterministic space-filling order of points (Morton/Z-curve)."""
    x = np.asarray(centroids, dtype=np.float64)
    lo = x.min(axis=0)
    span = np.maximum(x.max(axis=0) - lo, 1e-300)
    bits = 16
    q = np.minimum(((x - lo) / span * (2**bits - 1)).astype(np.uint64), 2**bits - 1)
    d = x.shape[1]
    code = np.zeros(x.shape[0], dtype=np.uint64)
    for b in range(bits):
        for a in range(d):
            code |= ((q[:, a] >> np.uint64(b)) & np.uint64(1)) << np.uint64(b * d + a)
    return np.argsort(code, kind="stable")


def partition_cells(
    cell_adj: sp.csr_matrix,
    centroids: np.ndarray,
    coarsening_factor: int,
    min_frac: float = 0.25,
) -> np.ndarray:
    """Partition cells into ~n/coarsening_factor contiguous agglomerates.

    Reference semantics: Utilities.cpp:125-155 (METIS KWAY, fixed seed,
    contiguous parts, num_partitions = nElements / coarsening_factor).
    Deterministic: Morton-ordered balanced chunks + connectivity fixup.
    """
    n = centroids.shape[0]
    factor = max(int(coarsening_factor), 2)
    order = _morton_order(centroids)

    # Greedy graph growing (contiguous by construction): seeds are taken in
    # Morton order; each part BFS-grows over unassigned neighbors until it
    # holds `factor` cells. Deterministic: FIFO frontier, neighbors visited
    # in index order.
    adj = cell_adj.tocsr()
    indptr, indices = adj.indptr, adj.indices
    labels = np.full(n, -1, dtype=np.int64)
    seed_ptr = 0
    part = 0
    from collections import deque

    while True:
        while seed_ptr < n and labels[order[seed_ptr]] >= 0:
            seed_ptr += 1
        if seed_ptr >= n:
            break
        seed = order[seed_ptr]
        frontier = deque([seed])
        labels[seed] = part
        size = 1
        while frontier and size < factor:
            c = frontier.popleft()
            for nb in indices[indptr[c] : indptr[c + 1]]:
                if labels[nb] < 0:
                    labels[nb] = part
                    frontier.append(nb)
                    size += 1
                    if size >= factor:
                        break
        part += 1
    coo = cell_adj.tocoo()

    # Merge undersized fragments into the smallest adjacent agglomerate.
    min_size = max(1, int(factor * min_frac))
    for _ in range(64):
        sizes = np.bincount(labels)
        small = np.nonzero(sizes < min_size)[0]
        if small.size == 0 or sizes.size <= 1:
            break
        la, lb = labels[coo.row], labels[coo.col]
        cross = la != lb
        moved = False
        for s in small:
            nbr = np.unique(lb[cross & (la == s)])
            nbr = nbr[nbr != s]
            if nbr.size == 0:
                continue
            tgt = nbr[np.argmin(sizes[nbr])]
            labels[labels == s] = tgt
            sizes = np.bincount(labels, minlength=sizes.size)
            moved = True
        if not moved:
            break
    # Compact label ids.
    uniq, labels = np.unique(labels, return_inverse=True)
    return labels.astype(np.int64)
