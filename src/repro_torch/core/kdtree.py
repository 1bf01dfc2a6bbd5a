"""KD-PASS: greedy max-variance k-d refinement for d > 1 (paper §4.4, §5.4).

Start at the root of a k-d tree over a uniform sample and repeatedly split
the leaf whose approximate max-variance query is largest until k leaves
exist (Lemma A.7). Oracles (Appendix A): SUM/COUNT take the max over the
2d median half-boxes (d-dimensional Lemma A.3); AVG sub-splits a leaf's
samples into cells of ~delta*m and scores the largest cell variance
(§A.4). Leaf depths stay within 2 of each other (§5.4). Host float64
numpy; full-dataset row assignment is a vectorized descent.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class _Node:
    idx: np.ndarray          # sample indices in this node
    lo: np.ndarray
    hi: np.ndarray
    depth: int
    node_id: int
    split_dim: int = -1
    split_val: float = 0.0
    left: int = -1
    right: int = -1
    score: float = 0.0
    leaf_no: int = -1


def _score_sum(vals: np.ndarray, coords: np.ndarray) -> float:
    """d-dimensional Lemma A.3 oracle: max over 2d median half-boxes."""
    n_i = vals.shape[0]
    if n_i <= 1:
        return 0.0
    best = 0.0
    for dim in range(coords.shape[1]):
        v = vals[np.argsort(coords[:, dim], kind="stable")]
        h = n_i // 2
        for seg in (v[:h], v[h:]):
            if seg.size == 0:
                continue
            sq, sqq = seg.sum(), (seg * seg).sum()
            best = max(best, (n_i * sqq - sq * sq) / n_i)
    return best


def _score_avg(vals: np.ndarray, coords: np.ndarray, cell: int) -> float:
    """§A.4 second algorithm: k-d split to ~cell-sized cells, max V_avg."""
    n_i = vals.shape[0]
    if n_i < 2 * cell or n_i <= 1:
        return 0.0
    best = 0.0
    stack = [np.arange(n_i)]
    while stack:
        sel = stack.pop()
        if sel.size <= max(2 * cell - 1, 2):
            seg = vals[sel]
            n_q = seg.size
            sq, sqq = seg.sum(), (seg * seg).sum()
            best = max(best, (n_i * sqq - sq * sq) / (n_i * max(n_q, 1) ** 2))
            continue
        sub = coords[sel]
        dim = int(np.argmax(sub.max(axis=0) - sub.min(axis=0)))
        order = np.argsort(sub[:, dim], kind="stable")
        h = sel.size // 2
        stack.append(sel[order[:h]])
        stack.append(sel[order[h:]])
    return best


def kd_partition(c: np.ndarray, a: np.ndarray, k: int, m: int = 4096,
                 kind: str = "sum", delta_frac: float = 0.01, seed: int = 0,
                 max_depth_spread: int = 2,
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Greedy KD-PASS partitioning. Returns (assign (N,) int32,
    boxes (k, d, 2))."""
    c = np.asarray(c, dtype=np.float64)
    if c.ndim == 1:
        c = c[:, None]
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    n, d = c.shape
    rng = np.random.default_rng(seed)
    m_eff = min(m, n)
    sidx = rng.choice(n, size=m_eff, replace=False)
    sc, sa = c[sidx], a[sidx]
    cell = max(2, int(round(delta_frac * m_eff)))

    def score(idx: np.ndarray) -> float:
        if kind == "avg":
            return _score_avg(sa[idx], sc[idx], cell)
        return _score_sum(sa[idx] if kind == "sum" else np.ones(idx.size),
                          sc[idx])

    nodes: list[_Node] = []
    root = _Node(idx=np.arange(m_eff), lo=sc.min(axis=0), hi=sc.max(axis=0),
                 depth=0, node_id=0)
    root.score = score(root.idx)
    nodes.append(root)
    leaves = [0]

    while len(leaves) < k:
        depths = [nodes[i].depth for i in leaves if nodes[i].idx.size >= 2]
        if not depths:
            break
        dmin = min(depths)
        eligible = [i for i in leaves
                    if nodes[i].idx.size >= 2
                    and nodes[i].depth <= dmin + max_depth_spread]
        if not eligible:
            break
        pick = max(eligible, key=lambda i: nodes[i].score)
        node = nodes[pick]
        sub = sc[node.idx]
        dim = int(np.argmax(sub.max(axis=0) - sub.min(axis=0)))
        order = np.argsort(sub[:, dim], kind="stable")
        h = node.idx.size // 2
        left_idx = node.idx[order[:h]]
        right_idx = node.idx[order[h:]]
        split_val = 0.5 * (sub[order[h - 1], dim] + sub[order[h], dim])
        lo_l, hi_l = node.lo.copy(), node.hi.copy()
        lo_r, hi_r = node.lo.copy(), node.hi.copy()
        hi_l[dim] = split_val
        lo_r[dim] = split_val
        lid, rid = len(nodes), len(nodes) + 1
        lnode = _Node(left_idx, lo_l, hi_l, node.depth + 1, lid)
        rnode = _Node(right_idx, lo_r, hi_r, node.depth + 1, rid)
        lnode.score = score(left_idx)
        rnode.score = score(right_idx)
        nodes.extend([lnode, rnode])
        node.split_dim, node.split_val = dim, float(split_val)
        node.left, node.right = lid, rid
        leaves.remove(pick)
        leaves.extend([lid, rid])

    # Number leaves and build flat split arrays for the vectorized descent.
    for no, i in enumerate(leaves):
        nodes[i].leaf_no = no
    split_dim = np.array([nd.split_dim for nd in nodes], dtype=np.int64)
    split_val = np.array([nd.split_val for nd in nodes], dtype=np.float64)
    left = np.array([nd.left for nd in nodes], dtype=np.int64)
    right = np.array([nd.right for nd in nodes], dtype=np.int64)
    leaf_no = np.array([nd.leaf_no for nd in nodes], dtype=np.int64)

    cur = np.zeros(n, dtype=np.int64)
    for _ in range(max(nd.depth for nd in nodes) + 1):
        internal = split_dim[cur] >= 0
        if not internal.any():
            break
        dims = np.maximum(split_dim[cur], 0)
        go_right = c[np.arange(n), dims] > split_val[cur]
        cur = np.where(internal, np.where(go_right, right[cur], left[cur]),
                       cur)
    assign = leaf_no[cur].astype(np.int32)

    boxes = np.stack([np.stack([nodes[i].lo, nodes[i].hi], axis=-1)
                      for i in leaves], axis=0)
    return assign, boxes


__all__ = ["kd_partition"]
