"""Query-to-partition routing for the grouped IVF scan (counterpart of
qadc_tpu/index/routing.py).

(query, assignment) pairs are grouped BY PARTITION into groups of up to G
pairs, so the grouped scan reads each probed partition once for up to G
pairs. Every group is either full or the last group of its partition's run,
so n_groups <= min(P, Q*ma) + ceil(Q*ma / G).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RoutedBatch:
    """Routing of (Q, ma) assignments into partition groups.

    Attributes:
      group_part: (gcap,) int32 partition scanned by each group (0 if unused).
      group_valid: (gcap,) bool.
      qa_group: (Q, ma) int32 group holding each (query, assignment) pair.
      qa_slot: (Q, ma) int32 that pair's slot within the group.
      n_groups: () int64 live group count (a tensor: reading it would wait
        for the device).
      group_size: G.
      gcap: group capacity.
    """

    group_part: torch.Tensor
    group_valid: torch.Tensor
    qa_group: torch.Tensor
    qa_slot: torch.Tensor
    n_groups: torch.Tensor
    group_size: int
    gcap: int

    def slot_pairs(self) -> torch.Tensor:
        """(gcap, G) int32 flat pair id (q*ma + a) in each slot, -1 if empty."""
        g = self.group_size
        qa = self.qa_group.numel()
        out = torch.full((self.gcap * g,), -1, dtype=torch.int32,
                         device=self.group_part.device)
        slot = (self.qa_group.reshape(qa) * g + self.qa_slot.reshape(qa)).to(torch.int64)
        out[slot] = torch.arange(qa, dtype=torch.int32, device=out.device)
        return out.reshape(self.gcap, g)


def group_capacity(q: int, ma: int, part_count: int, group_size: int) -> int:
    qa = q * ma
    return min(part_count, qa) + -(-qa // group_size)


def route_queries(parts: torch.Tensor, part_count: int, group_size: int) -> RoutedBatch:
    """Route (Q, ma) partition assignments into groups of up to group_size."""
    q, ma = parts.shape
    qa = q * ma
    g = group_size
    gcap = group_capacity(q, ma, part_count, g)
    dev = parts.device

    flat_p = parts.reshape(qa).to(torch.int64)
    sp, order = torch.sort(flat_p, stable=True)
    new_run = torch.ones(qa, dtype=torch.bool, device=dev)
    new_run[1:] = sp[1:] != sp[:-1]
    idx = torch.arange(qa, dtype=torch.int64, device=dev)
    # Start of each element's run: running max over the run starts.
    run_start = torch.cummax(torch.where(new_run, idx, 0), dim=0).values
    pos = idx - run_start                      # position within the run
    new_group = new_run | (pos % g == 0)
    group_id = torch.cumsum(new_group.to(torch.int64), dim=0) - 1
    slot = pos % g
    n_groups = group_id[-1] + 1
    group_id = torch.clamp(group_id, max=gcap - 1)  # safety clamp (bound above)

    group_part = torch.zeros(gcap, dtype=torch.int32, device=dev)
    group_part[group_id] = sp.to(torch.int32)
    group_valid = torch.arange(gcap, device=dev) < n_groups
    qa_group = torch.empty(qa, dtype=torch.int32, device=dev)
    qa_group[order] = group_id.to(torch.int32)
    qa_slot = torch.empty(qa, dtype=torch.int32, device=dev)
    qa_slot[order] = slot.to(torch.int32)
    return RoutedBatch(
        group_part=group_part,
        group_valid=group_valid,
        qa_group=qa_group.reshape(q, ma),
        qa_slot=qa_slot.reshape(q, ma),
        n_groups=n_groups,
        group_size=g,
        gcap=gcap,
    )
