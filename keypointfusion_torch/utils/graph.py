"""Skeleton graph utilities (port of keypointfusion_tpu/utils/graph.py,
host numpy code): the symmetric normalized adjacency of a skeleton."""

from __future__ import annotations

import numpy as np

from keypointfusion_torch.utils.vis import HAND_SKELETON


def adj_matrix_from_edges(num_joints: int, edges, sparse: bool = False):
    """D^-1/2 (A + I) D^-1/2 of an undirected edge list, float32 [J,J];
    a scipy CSR matrix when `sparse`."""
    a = np.zeros((num_joints, num_joints), np.float32)
    for i, j in edges:
        a[i, j] = 1.0
        a[j, i] = 1.0
    a += np.eye(num_joints, dtype=np.float32)
    d = a.sum(1)
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(d, 1e-12))
    norm = a * d_inv_sqrt[:, None] * d_inv_sqrt[None, :]
    if sparse:
        import scipy.sparse as sp
        return sp.csr_matrix(norm)
    return norm


def hand_adjacency(num_joints: int = 21) -> np.ndarray:
    """The adjacency of the MANO-order hand skeleton (utils/vis.py)."""
    return adj_matrix_from_edges(num_joints, HAND_SKELETON)
