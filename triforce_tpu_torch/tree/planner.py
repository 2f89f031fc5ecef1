"""Offline Sequoia-style tree planner — the port's own copy of
``triforce_tpu/tree/planner.py`` (numpy only; the port imports nothing of
the JAX package).

Given a per-position acceptance vector ``p`` (p[b] = probability the b-th
child of a node is accepted given its b-1 elder siblings were rejected),
find the speculation-tree shape that maximises expected accepted tokens per
verify, then pick the (budget, depth) minimising expected time per accepted
token from measured draft/verify times.

The output ``GrowMap`` is static data: ``tree/spectree.py`` turns its masks
and index tables into device tensors once per engine.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence

import numpy as np

NEG = -np.inf


@dataclasses.dataclass(frozen=True)
class GrowMap:
    """Static speculation-tree description.

    node 0 is the root (the committed ``next_token``); nodes are numbered in
    BFS order.
    """

    size: int                      # total nodes
    roots: tuple                   # per grow level: node ids to expand
    branches: tuple                # per grow level: #children of each root
    successors: np.ndarray         # [size, max_children] child ids, -1 pad
    mask: np.ndarray               # [size, size] bool; row i = ancestors of i
    depth: np.ndarray              # [size] distance from node 0

    @property
    def num_levels(self) -> int:
        return len(self.roots)

    @property
    def max_children(self) -> int:
        return self.successors.shape[1]

    def level_slices(self):
        """(start, count) of each level's NEW nodes in BFS order: level i's
        children occupy nodes [start_i, start_i + sum(branches[i]))."""
        out, start = [], 1
        for br in self.branches:
            n = int(sum(br))
            out.append((start, n))
            start += n
        return out

    def save(self, path: str) -> None:
        blob = {
            "size": self.size,
            "roots": [list(map(int, r)) for r in self.roots],
            "branches": [list(map(int, b)) for b in self.branches],
            "successors": self.successors.tolist(),
            "mask": self.mask.astype(int).tolist(),
            "depth": self.depth.tolist(),
        }
        with open(path, "w") as f:
            json.dump(blob, f)

    @staticmethod
    def load(path: str) -> "GrowMap":
        with open(path) as f:
            blob = json.load(f)
        return GrowMap(
            size=blob["size"],
            roots=tuple(tuple(r) for r in blob["roots"]),
            branches=tuple(tuple(b) for b in blob["branches"]),
            successors=np.asarray(blob["successors"], np.int32),
            mask=np.asarray(blob["mask"], bool),
            depth=np.asarray(blob["depth"], np.int32),
        )


def modeled_acceptance_vector(accept_rate: float,
                              max_branch: int) -> np.ndarray:
    """A modeled stand-in for the reference's *measured*
    ``acceptance-rate-vector.pt``: position-b acceptance assuming each extra
    sibling samples from the residual with roughly the same success rate,
    p[b] = a * (1 - a)^(b-1). Replace with a measured vector (e.g. from
    ``measure_acceptance_vector``) for production planning.
    """
    a = float(accept_rate)
    p = np.zeros(max_branch + 1)
    for b in range(1, max_branch + 1):
        p[b] = a * (1.0 - a) ** (b - 1)
    return p


def plan_tree(p: np.ndarray, max_budget: int, max_depth: int):
    """DP over expected accepted length.

    T[m, l, b] = best expected accepted tokens for a tree of m nodes, depth
    <= l whose root has exactly b children (reference tree_search.py:31-50).
    Returns (T, choice) where choice[m, l, b] = the subtree split y chosen.
    """
    max_branch = len(p) - 1
    T = np.full((max_budget + 1, max_depth + 1, max_branch + 1), NEG)
    choice = np.zeros_like(T, dtype=np.int32)
    T[1, 1:, 0] = 1.0

    for m in range(2, max_budget + 1):
        Tm1_best = T[: m, :, :].max(axis=2)  # [m, depth+1]
        for l in range(2, max_depth + 1):
            T[m, l, 1] = 1.0 + p[1] * Tm1_best[m - 1, l - 1]
            for b in range(2, max_branch + 1):
                ys = np.arange(1, m)
                # an infeasible child subtree (-inf) kills the split even at
                # p[b] == 0 — and 0 * -inf would otherwise poison the DP
                # with NaNs (hit by MEASURED acceptance vectors whose tail
                # branches never accept)
                sub = Tm1_best[m - ys, l - 1]
                term = np.where(np.isfinite(sub), p[b] * sub, NEG)
                vals = T[ys, l, b - 1] + term
                y = int(np.argmax(vals))
                T[m, l, b] = vals[y]
                choice[m, l, b] = y + 1
    return T, choice


def _subtree_splits(T, choice, m: int, l: int, b: int) -> List[tuple]:
    """Recover the (size, depth, branch) of each child subtree of a root with
    state (m, l, b) (reference's branch_map). Children are returned in
    sampling order (first-born first)."""
    out: List[tuple] = []
    while b > 0:
        if b == 1:
            sub_m = m - 1
        else:
            y = int(choice[m, l, b])
            sub_m = m - y
        sub_l = l - 1
        sub_b = int(T[sub_m, sub_l].argmax())
        out.append((sub_m, sub_l, sub_b))
        if b == 1:
            break
        m, b = y, b - 1
    out.reverse()
    return out


def build_grow_map(T, choice, m: int, l: int,
                   b: Optional[int] = None) -> GrowMap:
    """Expand the DP solution for (m nodes, depth l) into the BFS tree
    structure the SpecTree consumes (reference tree_search.py:88-132)."""
    if b is None:
        b = int(T[m, l].argmax())

    states = [(m, l, b)]
    parents = [-1]
    depth = [0]
    active = [True]
    successors: List[List[int]] = [[]]
    mask = np.zeros((m, m), dtype=bool)
    roots, branches = [], []
    num_nodes = 1

    while True:
        frontier, frontier_branches = [], []
        for i in range(len(active)):
            if not active[i]:
                continue
            active[i] = False
            if parents[i] != -1:
                mask[i] = mask[parents[i]]
            mask[i, i] = True
            sm, sl, sb = states[i]
            frontier.append(i)
            frontier_branches.append(sb)
            kids = list(range(num_nodes, num_nodes + sb))
            successors[i].extend(kids)
            for sub in _subtree_splits(T, choice, sm, sl, sb):
                states.append(sub)
            successors.extend([[] for _ in kids])
            parents.extend([i] * sb)
            depth.extend([depth[i] + 1] * sb)
            num_nodes += sb
        if not frontier:
            break
        roots.append(tuple(frontier))
        branches.append(tuple(frontier_branches))
        active.extend([True] * sum(frontier_branches))

    assert num_nodes == m, (num_nodes, m)
    # drop trailing all-leaf levels (no children to grow)
    while roots and sum(branches[-1]) == 0:
        roots.pop()
        branches.pop()

    max_c = max((len(s) for s in successors), default=1) or 1
    succ = np.full((m, max_c), -1, dtype=np.int32)
    for i, s in enumerate(successors):
        succ[i, : len(s)] = s
    return GrowMap(size=m, roots=tuple(roots), branches=tuple(branches),
                   successors=succ, mask=mask,
                   depth=np.asarray(depth, np.int32))


def choose_tree(p: np.ndarray, valid_budgets: Sequence[int],
                verify_times: Sequence[float], draft_time: float,
                max_depth: int = 24):
    """Pick (budget, depth) minimising time per accepted token from measured
    per-tree-size verify times (reference tree_search.py:55-75), then build
    the grow map."""
    max_budget = max(valid_budgets)
    T, choice = plan_tree(p, max_budget, max_depth)
    results = T.max(axis=2)  # [budget+1, depth+1]
    best, best_pair = np.inf, None
    for budget, t_verify in zip(valid_budgets, verify_times):
        for d in range(1, max_depth + 1):
            ac = results[budget, d]
            if ac <= 0:
                continue
            cost = (d * draft_time + t_verify) / ac
            if cost < best:
                best, best_pair = cost, (budget, d)
    m, l = best_pair
    return build_grow_map(T, choice, m, l), best, best_pair


def main(argv=None):
    """Offline planning CLI (reference: python tree/tree_search.py --config).

    Reads a JSON config {acceptance_rate | acceptance_vector, max_depth,
    max_budget, draft_time, valid_budget, target_time, dst} and writes the
    chosen grow map to dst."""
    import argparse
    import json as _json

    p = argparse.ArgumentParser(prog="triforce_tpu_torch.tree.planner")
    p.add_argument("--config", required=True)
    args = p.parse_args(argv)
    with open(args.config) as f:
        cfg = _json.load(f)
    if "acceptance_vector" in cfg:
        pvec = np.asarray(cfg["acceptance_vector"], np.float64)
    else:
        pvec = modeled_acceptance_vector(cfg.get("acceptance_rate", 0.8),
                                         cfg.get("max_branch", 4))
    gm, cost, (m, l) = choose_tree(
        pvec, cfg["valid_budget"], cfg["target_time"], cfg["draft_time"],
        max_depth=cfg.get("max_depth", 24))
    gm.save(cfg["dst"])
    print(f"planned tree: {m} nodes, depth {l}, "
          f"{cost * 1e3:.1f} ms/token expected -> {cfg['dst']}")


if __name__ == "__main__":
    main()
