"""Locality-aware partition-to-actor assignment.

Port of ``xgboost_ray_tpu/data_sources/_distributed.py`` (the semantics of
``xgboost_ray/data_sources/_distributed.py``): a greedy assigner that first
hands each actor partitions on its own host (round-robin, bounded by even
min/max shares), then spills the rest round-robin. A "host" here is the
``torch.distributed`` process an actor's shard is loaded in: ``train()``
folds ``num_actors`` ranks onto the world's processes in contiguous groups,
so actor r lives on the process whose group holds r (all on process 0 at
world 1), and the assignment meets the reference tests' even and uneven
guarantees (``tests/test_data_source.py:38-166``).
"""

import math
from collections import defaultdict
from typing import Any, Dict, List, Sequence

import numpy as np

from xgboost_ray_tpu_torch import distributed


def get_actor_rank_hosts(num_actors: int) -> Dict[int, str]:
    """Host key per actor rank: the ``torch.distributed`` process it is
    folded onto."""
    groups = np.array_split(np.arange(num_actors), distributed.process_count())
    return {int(rank): f"process-{p}" for p, group in enumerate(groups)
            for rank in group}


def assign_partitions_to_actors(
    host_to_parts: Dict[str, Sequence[Any]],
    actor_rank_hosts: Dict[int, str],
) -> Dict[int, List[Any]]:
    """Greedy co-located assignment with even min/max per-actor bounds."""
    num_parts = sum(len(p) for p in host_to_parts.values())
    num_actors = len(actor_rank_hosts)
    min_parts = num_parts // num_actors
    max_parts = math.ceil(num_parts / num_actors)

    host_to_parts = {h: list(p) for h, p in host_to_parts.items()}
    assignment: Dict[int, List[Any]] = defaultdict(list)
    ranks = sorted(actor_rank_hosts)

    def deficit() -> int:
        """Partitions still owed to actors below their min share."""
        return sum(max(0, min_parts - len(assignment[r])) for r in ranks)

    # 1) co-located pass up to the min share, round-robin
    progress = True
    while progress:
        progress = False
        for rank in ranks:
            if len(assignment[rank]) >= min_parts:
                continue
            local = host_to_parts.get(actor_rank_hosts[rank])
            if local:
                assignment[rank].append(local.pop(0))
                progress = True

    # 2) co-located pass beyond min up to max — but an actor may only take an
    #    extra local partition if enough partitions remain for every actor
    #    still below min (the reference's expected maps encode exactly this
    #    reservation, tests/test_data_source.py:128-166)
    progress = True
    while progress:
        progress = False
        remaining = sum(len(p) for p in host_to_parts.values())
        for rank in ranks:
            if len(assignment[rank]) >= max_parts:
                continue
            local = host_to_parts.get(actor_rank_hosts[rank])
            if not local:
                continue
            if remaining - 1 < deficit():
                continue  # reserved for a starving (non-co-located) actor
            assignment[rank].append(local.pop(0))
            remaining -= 1
            progress = True

    # 3) spill the remainder: fill everyone to min first, then to max
    rest = [p for parts in host_to_parts.values() for p in parts]
    while rest:
        under_min = [r for r in ranks if len(assignment[r]) < min_parts]
        targets = under_min or [r for r in ranks if len(assignment[r]) < max_parts]
        if not targets:  # all at max; shouldn't happen, but don't loop forever
            assignment[ranks[0]].append(rest.pop(0))
            continue
        for rank in targets:
            if rest:
                assignment[rank].append(rest.pop(0))

    return dict(assignment)
