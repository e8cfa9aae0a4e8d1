"""Host-side graph helpers of ``glass_tpu/native.py``.

The JAX package binds its C++ library (``native/libglass_host.so``) and
falls back to numpy and scipy where it is unbuilt. The port has the
fallbacks only; binding the library is ROADMAP Queue 1 item 1.
"""

from __future__ import annotations

import numpy as np


def rcm_ordering(edge_index: np.ndarray, n_node: int) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (perm[i] = old id at new slot i):
    the scipy branch of ``glass_tpu/native.py:113-129``."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    row = np.ascontiguousarray(edge_index[0], dtype=np.int64)
    col = np.ascontiguousarray(edge_index[1], dtype=np.int64)
    m = coo_matrix((np.ones(row.shape[0]), (row, col)), shape=(n_node, n_node))
    return reverse_cuthill_mckee(m.tocsr(), symmetric_mode=True).astype(np.int64)
