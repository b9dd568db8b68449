"""Assignment utilities (vestigial-parity for GMW): a copy of
``dcd_tpu/utils/assignment.py``, numpy only.

The reference ships a Hungarian + RANSAC-P3P helper
(``GMW/utilities/hungarian_algorithm.py``, scipy linear_sum_assignment +
cv2 solvePnPRansac) that its pipeline never calls. The assignment solver
is implemented here natively (shortest-augmenting-path / Jonker-Volgenant,
O(n³)) and cross-checked against scipy in tests; the cv2 P3P solver has no
counterpart in this image and is intentionally out of scope — the
declarative :mod:`dcd_tpu_torch.models.blind_pnp` covers pose solving.
"""

from __future__ import annotations

import numpy as np


def hungarian_assignment(cost: np.ndarray):
    """Min-cost bipartite assignment via shortest augmenting paths
    (Jonker-Volgenant, the e-maxx potentials formulation). Accepts an
    (n, m) cost matrix (any aspect), returns (row_idx, col_idx) sorted by
    row — the same contract as scipy's linear_sum_assignment, which the
    tests use as the oracle."""
    cost = np.asarray(cost, np.float64)
    if cost.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    transposed = cost.shape[0] > cost.shape[1]
    if transposed:
        cost = cost.T
    n, m = cost.shape

    INF = np.inf
    u = np.zeros(n + 1)
    v = np.zeros(m + 1)
    p = np.zeros(m + 1, dtype=np.int64)  # p[j] = row matched to column j
    way = np.zeros(m + 1, dtype=np.int64)

    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(m + 1, INF)
        used = np.zeros(m + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            cur = cost[i0 - 1, :] - u[i0] - v[1:]  # (m,)
            free = ~used[1:]
            better = free & (cur < minv[1:])
            minv[1:][better] = cur[better]
            way[1:][better] = j0
            # delta over free columns
            masked = np.where(free, minv[1:], INF)
            j1 = int(np.argmin(masked)) + 1
            delta = masked[j1 - 1]
            u[p[used]] += delta
            v[used] -= delta
            minv[1:][free] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0 != 0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1

    rows = np.empty(n, dtype=np.int64)
    cols = np.empty(n, dtype=np.int64)
    k = 0
    for j in range(1, m + 1):
        if p[j] != 0:
            rows[k] = p[j] - 1
            cols[k] = j - 1
            k += 1
    if transposed:
        rows, cols = cols, rows
    order = np.argsort(rows)
    return rows[order], cols[order]


def assignment_from_transport(P: np.ndarray):
    """Hard correspondence from a transport matrix (maximize mass)."""
    return hungarian_assignment(-np.asarray(P))
