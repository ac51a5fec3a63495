"""Minimum-cost slot→server assignment for labeled placement.

The reference solves label-constrained chunk placement with an
auction-style linear assignment optimizer
(src/common/linear_assignment_optimizer.h) because greedy label
matching can strand constrained slots: with slots {A, _} and servers
{s1:A}, a greedy wildcard pass that grabs s1 first leaves the A slot
unplaceable even though a perfect assignment exists. This module is the
same idea with the classic Hungarian algorithm (O(n^3), n = slots ≤ 40
per goal — microseconds at that size).

Costs are integers: a label mismatch dominates everything, then fuller
servers cost more (spreads data), then a small caller-supplied jitter
keeps repeated placements from hammering one server.
"""

from __future__ import annotations

MISMATCH = 10**9  # label violation: worth any amount of imbalance


def solve(cost: list[list[int]]) -> list[int]:
    """Hungarian algorithm: ``cost[i][j]`` = cost of slot i on column j.

    Returns per-slot column indices minimizing total cost. Requires
    len(cost) <= len(cost[0]); columns may stay unused.
    """
    n, m = len(cost), len(cost[0])
    assert n <= m, "need at least as many columns as slots"
    INF = float("inf")
    # potentials + matching, the classic O(n^2 m) shortest-augmenting-path
    # formulation (1-indexed internals)
    u = [0.0] * (n + 1)
    v = [0.0] * (m + 1)
    match = [0] * (m + 1)  # column -> row matched (0 = free)
    way = [0] * (m + 1)
    for i in range(1, n + 1):
        match[0] = i
        j0 = 0
        minv = [INF] * (m + 1)
        used = [False] * (m + 1)
        while True:
            used[j0] = True
            i0, delta, j1 = match[j0], INF, 0
            for j in range(1, m + 1):
                if not used[j]:
                    cur = cost[i0 - 1][j - 1] - u[i0] - v[j]
                    if cur < minv[j]:
                        minv[j] = cur
                        way[j] = j0
                    if minv[j] < delta:
                        delta = minv[j]
                        j1 = j
            for j in range(m + 1):
                if used[j]:
                    u[match[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if match[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            match[j0] = match[j1]
            j0 = j1
    out = [0] * n
    for j in range(1, m + 1):
        if match[j]:
            out[match[j] - 1] = j - 1
    return out


def assign_slots(
    slot_labels: list[str],
    servers: list,
    jitter,
    wildcard: str = "_",
    load=None,
) -> list[int]:
    """Optimal distinct-server choice for one slice's slots.

    ``servers`` expose ``.label`` and ``.free_space``; ``jitter(i, j)``
    -> small int noise. ``load(j)`` (optional) -> observed load score
    for column j in [0, 1+] (heartbeat health + queue depth + heat
    share); a loaded server costs as much extra as full fullness would,
    so placement leans away from hot servers without ever violating a
    label. Requires len(servers) >= len(slot_labels); the caller
    handles the fewer-servers-than-slots case (repeats allowed)
    separately. Returns server indices per slot; mismatched labels are
    only used when no matching assignment exists (placed beats
    unplaced).
    """
    max_free = max((s.free_space for s in servers), default=0) or 1
    cost = []
    for i, want in enumerate(slot_labels):
        row = []
        for j, s in enumerate(servers):
            c = 0 if (want == wildcard or s.label == want) else MISMATCH
            # fuller servers cost more: scale fullness into [0, 1000]
            c += 1000 - (s.free_space * 1000) // max_free
            if load is not None:
                # observed load scales into the same [0, 1000] band as
                # fullness (load 0 — the heat-off state — adds nothing)
                c += min(int(load(j) * 1000), 1000)
            c += int(jitter(i, j))
            row.append(c)
        cost.append(row)
    return solve(cost)
