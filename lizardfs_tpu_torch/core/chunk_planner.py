"""Whole-chunk read planner: choose among a chunk's representations.

The port's copy of the JAX package's ``core/chunk_planner.py`` (tests pin the two
together).

The master may hold several SLICES of one chunk at once — a standard
copy plus ec parts mid-conversion after a goal change, or two striped
layouts during rebalancing. The reference's ChunkReadPlanner
(src/common/chunk_read_planner.cc) scores every representation and
picks the cheapest healthy one before the per-slice planner takes over;
round 1 read whichever slice type happened to be listed first and mixed
parts across types. This module is that missing stage: group locations
by slice type, score each group with the shared per-chunkserver health
registry, and rank.

Ranking: viability first (enough parts to serve at all), then
completeness (no recovery needed), then mean part health (flaky-server
demotion), then fewer network ops (std over striped), then fewer
recoveries.
"""

from __future__ import annotations

from dataclasses import dataclass

from lizardfs_tpu_torch.core import geometry

Addr = tuple[str, int]


@dataclass
class SliceCandidate:
    type: geometry.SliceType
    # part index -> [(addr, wire part id), ...] copies of that part
    copies: dict[int, list[tuple[Addr, int]]]
    complete: bool
    health: float
    recovery_parts: int

    def sort_key(self):
        # health quantized to 0.1 so tiny score noise doesn't override
        # the structural preferences (completeness, fewer ops)
        return (
            self.complete,
            round(self.health, 1),
            1 if self.type.is_standard else 0,
            -self.recovery_parts,
        )


def candidates(
    locations,
    score_fn,
    avoid: set[Addr] = frozenset(),
) -> list[SliceCandidate]:
    """Rank a chunk's slice representations, best first.

    ``locations`` are PartLocation messages; ``score_fn(addr) -> float``
    is the health score (core.cs_stats). Replicas in ``avoid`` (already
    failed this read) don't count toward viability unless they are the
    only copy left.
    """
    groups: dict[int, dict[int, list[tuple[Addr, int]]]] = {}
    for pl in locations:
        cpt = geometry.ChunkPartType.from_id(pl.part_id)
        addr = (pl.addr.host, pl.addr.port)
        groups.setdefault(int(cpt.type), {}).setdefault(cpt.part, []).append(
            (addr, pl.part_id)
        )

    out: list[SliceCandidate] = []
    for type_id, copies in groups.items():
        t = geometry.SliceType(type_id)
        usable = {
            p for p, locs in copies.items()
            if any(a not in avoid for a, _ in locs)
        }
        if t.is_standard:
            viable = 0 in usable
            needed = {0}
        else:
            d = t.data_parts
            first_data = 1 if t.is_xor else 0
            needed = {first_data + i for i in range(d)}
            # any d distinct parts reconstruct the data (xor: level of
            # level+1; ec: k of k+m)
            viable = len(usable) >= d
        if not viable:
            continue
        missing_data = len(needed - usable)
        part_scores = [
            max(score_fn(a) for a, _ in locs) for locs in copies.values()
        ]
        out.append(SliceCandidate(
            type=t,
            copies=copies,
            complete=len(usable) >= t.expected_parts,
            health=sum(part_scores) / len(part_scores),
            recovery_parts=missing_data,
        ))
    out.sort(key=SliceCandidate.sort_key, reverse=True)
    if not out and avoid:
        # every slice lost a needed part to the blacklist: desperation
        # pass ignoring it (a flaky replica beats a failed read)
        return candidates(locations, score_fn)
    return out
