"""Skew-aware placement for entity-sharded random-effect solves (port of
``photon_ml_tpu/parallel/placement.py``: the knob, the planner, the
re-planner's arithmetic and the placement gauges).

The random-effect phase is parallel over entities, so spreading it over
processes is a placement question: which process owns which entities
(the out-of-core trainer) or which whole buckets (the in-memory solve).
The modular rule ``entity_id % P`` balances entity counts; under Zipf
traffic the head entities carry most rows, so one owner solves, and
receives through every visit's offset and score exchanges, a multiple of
the mean row load. ``plan_shard_placement`` balances Σ rows instead: LPT
(longest processing time first), the heaviest unit onto the lightest
shard. A unit may be a group of items that must share an owner (the
fusion groups of ``game/random_effect.py`` ``plan_fusion_groups``).

Everything here is deterministic host arithmetic on inputs that every
process holds identically (allreduced row counts, allgathered walls), so
every process computes the same plan with no further communication.

Knobs, read at call time and set identically on every process:

- ``PHOTON_RE_SHARD`` (env > module global ``RE_SHARD``, strict int
  parse): 0 (default) keeps the modular owners and the blocking exchanges;
  1 turns on skew-aware placement and the overlapped exchange schedule in
  ``game/streaming.py`` and the owned-bucket mode of
  ``game/random_effect.py``.
- ``PHOTON_RE_REPLAN_IMBALANCE`` (strict float, <= 0 off): the measured
  per-process solve-wall imbalance (max / mean) past which the streamed
  trainer re-plans between outer iterations.

- ``PHOTON_RE_SPLIT`` (strict int, <= 0 off): the sub-bucket split's
  target atom count. A capacity class heavier than Σ rows / value is cut
  into placement atoms of whole entities (``game/data.py``
  ``placement_atoms``), each placed on its own; a class's atoms stay one
  bucket for the solve, so the split moves owners, never lanes.
- ``PHOTON_RE_SPLIT_WEIGHT`` (``rows`` | ``bytes``, strict): the axis the
  split and the planner balance. ``rows`` is solve compute; ``bytes`` is
  combine wire bytes (one segment row a lane, so the lane count), with
  the split capping both axes.
- ``PHOTON_RE_DEVICE_SPLIT`` (strict int): 1 adds a second LPT level,
  ``plan_device_placement``, over a process's local devices.

All of them act only under owned-bucket placement (``PHOTON_RE_SHARD=1``).
"""

from __future__ import annotations

import heapq
import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from photon_ml_tpu_torch.obs.metrics import REGISTRY

# 0: modular owners and blocking exchanges; 1: skew-aware placement and
# the overlapped exchange schedule
RE_SHARD = 0

# the measured solve-wall imbalance (max / mean) that triggers a re-plan;
# 0 = off
REPLAN_IMBALANCE = 0.0

# the sub-bucket split's target atom count; 0 = whole capacity classes
RE_SPLIT = 0

# 1: a second LPT level over each process's local devices
RE_DEVICE_SPLIT = 0

# the placement weight axis: "rows" (solve compute) or "bytes" (combine
# wire bytes, one segment row a lane)
RE_SPLIT_WEIGHT = "rows"
_SPLIT_WEIGHT_MODES = ("rows", "bytes")


def re_shard_enabled() -> bool:
    """``PHOTON_RE_SHARD`` (env > module global), a strict int parse: a
    typo raises instead of running the default schedule."""
    env = os.environ.get("PHOTON_RE_SHARD")
    if env is not None and env != "":
        return int(env) != 0
    return int(RE_SHARD) != 0


def re_split_factor() -> int:
    """``PHOTON_RE_SPLIT`` (env > module global), a strict int parse; a
    value <= 0 turns the split off."""
    env = os.environ.get("PHOTON_RE_SPLIT")
    return max(int(env if env else RE_SPLIT), 0)


def re_device_split_enabled() -> bool:
    """``PHOTON_RE_DEVICE_SPLIT`` (env > module global), a strict int parse."""
    env = os.environ.get("PHOTON_RE_DEVICE_SPLIT")
    return int(env if env else RE_DEVICE_SPLIT) != 0


def re_split_weight() -> str:
    """``PHOTON_RE_SPLIT_WEIGHT`` (env > module global): ``rows`` or
    ``bytes``; any other name raises."""
    env = os.environ.get("PHOTON_RE_SPLIT_WEIGHT")
    mode = str(env if env else RE_SPLIT_WEIGHT)
    if mode not in _SPLIT_WEIGHT_MODES:
        raise ValueError(f"PHOTON_RE_SPLIT_WEIGHT must be one of {_SPLIT_WEIGHT_MODES}, got {mode!r}")
    return mode


def placement_weights(lanes, rows, dims=None) -> np.ndarray:
    """What the placement planners balance, by ``PHOTON_RE_SPLIT_WEIGHT``:
    each unit's active ``rows``, or under ``bytes`` its combine payload,
    ``lanes`` segment rows of ``dims`` floats each (its class's projected
    width; one float a row without a projection, ``dims`` None)."""
    if re_split_weight() == "bytes":
        w = np.asarray(lanes, np.float64)
        return w if dims is None else w * np.asarray(dims, np.float64)
    return np.asarray(rows, np.float64)


def replan_imbalance_threshold() -> float:
    """``PHOTON_RE_REPLAN_IMBALANCE`` (env > module global), a strict float
    parse; <= 0 turns the re-planner off. Every process must hold the same
    value: the decision is taken on each from allgathered walls."""
    env = os.environ.get("PHOTON_RE_REPLAN_IMBALANCE")
    v = float(env if (env is not None and env != "") else REPLAN_IMBALANCE)
    return v if v > 0.0 else 0.0


@dataclass(frozen=True)
class PlacementPlan:
    """``owner[i]`` is item i's shard (an entity or a bucket, by the
    caller's granularity); ``loads[s]`` is shard s's Σ rows."""

    owner: np.ndarray  # (n_items,) int64
    loads: np.ndarray  # (num_shards,) float64
    num_shards: int

    @property
    def balance(self) -> float:
        """max shard load / mean shard load (1.0 is even; a plan with no
        rows anywhere reads 1.0)."""
        mean = float(self.loads.mean()) if len(self.loads) else 0.0
        if mean <= 0.0:
            return 1.0
        return float(self.loads.max()) / mean

    def owned_items(self, shard: int) -> np.ndarray:
        """The items ``shard`` owns, ascending."""
        return np.flatnonzero(self.owner == shard)


def _add_loads(loads: np.ndarray, counts: np.ndarray, owner: np.ndarray) -> np.ndarray:
    np.add.at(loads, owner, counts)
    return loads


def plan_shard_placement(
    row_counts: Sequence[float] | np.ndarray,
    num_shards: int,
    groups: Sequence[Sequence[int]] | None = None,
    skew_aware: bool = True,
) -> PlacementPlan:
    """Assign items to ``num_shards`` shards, balancing Σ ``row_counts``.

    ``groups`` lists index sets that must share a shard; items no group
    names place as singletons after them, ascending. ``skew_aware`` is
    LPT: groups by total rows descending (ties: the group's first item,
    ascending), each onto the lightest shard (ties: the lowest shard id).
    ``skew_aware=False`` deals the groups round-robin in order, the
    baseline a comparison records. Identical inputs give the identical
    plan on every process."""
    counts = np.asarray(row_counts, np.float64)
    if counts.ndim != 1:
        raise ValueError(f"row_counts must be 1-D, got shape {counts.shape}")
    P = int(num_shards)
    if P < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    n = len(counts)
    if groups is None:
        group_list = [[i] for i in range(n)]
    else:
        group_list = [list(g) for g in groups]
        seen = np.zeros(n, bool)
        for g in group_list:
            for i in g:
                if not 0 <= i < n:
                    raise ValueError(f"group member {i} out of range [0, {n})")
                if seen[i]:
                    raise ValueError(f"item {i} appears in two groups")
                seen[i] = True
        group_list += [[i] for i in np.flatnonzero(~seen)]
    owner = np.zeros(n, np.int64)
    loads = np.zeros(P, np.float64)
    if P == 1 or n == 0:
        return PlacementPlan(owner=owner, loads=_add_loads(loads, counts, owner), num_shards=P)
    if groups is None and not skew_aware:
        # singletons dealt round-robin: the modular rule, summed in item order
        owner = modular_owner(n, P)
        return PlacementPlan(owner=owner, loads=np.bincount(owner, weights=counts, minlength=P), num_shards=P)
    totals = [float(counts[g].sum()) for g in group_list]
    if skew_aware:
        # a heap keyed (load, shard): equal loads go to the lowest shard id
        order = sorted(range(len(group_list)),
                       key=lambda gi: (-totals[gi], group_list[gi][0] if group_list[gi] else -1))
        heap = [(0.0, s) for s in range(P)]
        for gi in order:
            load, s = heapq.heappop(heap)
            load += totals[gi]
            loads[s] = load
            heapq.heappush(heap, (load, s))
            owner[group_list[gi]] = s
    else:
        for gi, g in enumerate(group_list):
            s = gi % P
            loads[s] += totals[gi]
            owner[g] = s
    return PlacementPlan(owner=owner, loads=loads, num_shards=P)


def modular_owner(num_items: int, num_shards: int) -> np.ndarray:
    """The modular rule's owner map, item i on shard i % num_shards: what
    ``plan_shard_placement(..., skew_aware=False)`` gives singletons, with
    no row counts (the knob-off layouts take no collective to find it)."""
    return np.arange(int(num_items), dtype=np.int64) % int(num_shards)


def plan_from_owner(owner: np.ndarray, row_counts: Sequence[float] | np.ndarray,
                    num_shards: int) -> PlacementPlan:
    """The plan of an existing owner map over these row counts (the
    re-planner's old plan, a forced map's gauges). An owner map of another
    length than the counts, or naming a shard outside [0, num_shards),
    raises with the offending value."""
    owner = np.asarray(owner, np.int64)
    counts = np.asarray(row_counts, np.float64)
    P = int(num_shards)
    if len(owner) != len(counts):
        raise ValueError(f"plan_from_owner: owner map length {len(owner)} != row_counts length {len(counts)} "
                         "— the map and the counts must describe the same items")
    if len(owner) and (owner.min() < 0 or owner.max() >= P):
        bad = owner[(owner < 0) | (owner >= P)][0]
        raise ValueError(f"plan_from_owner: owner value {int(bad)} outside [0, {P}) — the map names a shard "
                         "this plan does not have")
    return PlacementPlan(owner=owner, loads=_add_loads(np.zeros(P, np.float64), counts, owner), num_shards=P)


def plan_entity_placement(entity_row_counts: np.ndarray, num_shards: int,
                          skew_aware: bool = True) -> PlacementPlan:
    """Entity-granularity placement (the streamed trainer's unit): all of
    an entity's rows live at its owner."""
    return plan_shard_placement(entity_row_counts, num_shards, groups=None, skew_aware=skew_aware)


def replan_excluding(
    plan: PlacementPlan,
    lost_shards: Sequence[int],
    row_counts: Sequence[float] | np.ndarray,
    survivors: Sequence[int],
    groups: Sequence[Sequence[int]] | None = None,
    skew_aware: bool = True,
) -> tuple[PlacementPlan, np.ndarray]:
    """The same LPT plan over ``len(survivors)`` shards: ``(new_plan,
    migrated)``, the new owners in survivor-rank space (rank = position in
    the sorted survivors) and the items whose owner changed. With an empty
    lost set the survivors may reach past the old plan's shards (a joining
    shard: everything it receives counts as migrated); with lost shards a
    survivor outside the old range raises."""
    survivors = sorted(int(s) for s in survivors)
    lost = {int(s) for s in lost_shards}
    if set(survivors) & lost:
        raise ValueError(f"survivors {survivors} and lost shards {sorted(lost)} overlap")
    if not survivors:
        raise ValueError("no surviving shards to re-plan onto")
    bound = None if not lost else int(plan.num_shards)
    out_of_range = [s for s in survivors if s < 0 or (bound is not None and s >= bound)]
    if out_of_range:
        raise ValueError(
            f"replan_excluding: survivor {out_of_range[0]} outside the old plan's shard range "
            f"[0, {int(plan.num_shards)}) — the survivor list and the plan disagree about the topology "
            "(expansion past the range is legal only with an empty lost set, the rejoin signature)"
        )
    new_plan = plan_shard_placement(row_counts, len(survivors), groups=groups, skew_aware=skew_aware)
    rank_of = np.full(max(int(plan.num_shards), survivors[-1] + 1), -1, np.int64)
    for r, s in enumerate(survivors):
        rank_of[s] = r
    migrated = rank_of[plan.owner] != new_plan.owner
    return new_plan, migrated


def plan_device_placement(row_counts: Sequence[float] | np.ndarray, owner: np.ndarray, shard: int,
                          num_devices: int, groups: Sequence[Sequence[int]] | None = None,
                          skew_aware: bool = True) -> tuple[np.ndarray, PlacementPlan]:
    """The second placement level (``PHOTON_RE_DEVICE_SPLIT``): the items
    ``shard`` owns under the process-level ``owner`` map, placed on its
    ``num_devices`` local devices by the same LPT rule. ``groups`` (index
    sets that must share a device, e.g. the fusion groups of an unsplit
    prep) must be wholly owned or wholly not; a group that straddles the
    owner boundary is a desynced plan and raises. Returns ``(device,
    plan)``: ``device[i]`` is item i's local device ordinal, -1 where
    another process owns it, and ``plan`` the device-space sub-plan (its
    balance is the ``re_shard.device_balance`` gauge)."""
    counts = np.asarray(row_counts, np.float64)
    owner = np.asarray(owner, np.int64)
    if len(owner) != len(counts):
        raise ValueError(f"plan_device_placement: owner map length {len(owner)} != row_counts length "
                         f"{len(counts)}")
    D = int(num_devices)
    if D < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    owned = np.flatnonzero(owner == int(shard))
    device = np.full(len(owner), -1, np.int64)
    pos = np.full(len(owner), -1, np.int64)
    pos[owned] = np.arange(len(owned))
    sub_groups = None
    if groups is not None:
        sub_groups = []
        for g in groups:
            g = list(g)
            mine = [i for i in g if owner[i] == int(shard)]
            if mine and len(mine) != len(g):
                raise ValueError(f"plan_device_placement: group {g} straddles the owner boundary of shard "
                                 f"{int(shard)}: the process-level plan is group-atomic, so this plan is "
                                 "desynced")
            if mine:
                sub_groups.append([int(pos[i]) for i in mine])
    plan = plan_shard_placement(counts[owned], D, groups=sub_groups, skew_aware=skew_aware)
    device[owned] = plan.owner
    return device, plan


def record_device_placement_metrics(plan: PlacementPlan, prefix: str = "re_shard") -> None:
    """The device-level sub-plan's gauges: ``re_shard.device_balance``
    (max / mean over this process's device loads), ``re_shard.devices``
    and ``re_shard.device_rows.<d>``."""
    REGISTRY.gauge_set(f"{prefix}.device_balance", plan.balance)
    REGISTRY.gauge_set(f"{prefix}.devices", float(plan.num_shards))
    for d in range(plan.num_shards):
        REGISTRY.gauge_set(f"{prefix}.device_rows.{d}", float(plan.loads[d]))


def measured_entity_costs(entity_row_counts: np.ndarray, entity_owner: np.ndarray,
                          shard_walls: np.ndarray) -> np.ndarray:
    """Per-entity measured costs for a re-plan: each entity's rows times
    its owner's measured seconds a row (wall_p / Σ rows owned by p), so the
    entities of a slow shard cost more and LPT moves them off it. A shard
    with no rows or a zero wall takes the mean measured rate (a zero cost
    would let LPT pile its entities onto one shard)."""
    counts = np.asarray(entity_row_counts, np.float64)
    owner = np.asarray(entity_owner, np.int64)
    walls = np.asarray(shard_walls, np.float64)
    P = len(walls)
    if len(owner) != len(counts):
        raise ValueError(f"measured_entity_costs: owner map length {len(owner)} != row_counts length "
                         f"{len(counts)}")
    loads = np.zeros(P, np.float64)
    np.add.at(loads, owner, counts)
    rate = np.zeros(P, np.float64)
    ok = (loads > 0) & (walls > 0)
    rate[ok] = walls[ok] / loads[ok]
    rate[~ok] = float(rate[ok].mean()) if ok.any() else 1.0
    return counts * rate[owner]


def record_projection_metrics(lane_dims: Sequence[tuple[int, int]], full_dim: int, prefix: str = "re_project") -> None:
    """The projection's gauges (``PHOTON_RE_PROJECT``), from one (lanes,
    solved width) pair per bucket this process solves:
    ``re_project.mean_ratio``, Σ lanes·d_e / Σ lanes·d, and
    ``re_project.dims_saved_bytes``, the float32 coefficient-row bytes
    the narrower solves leave out, Σ lanes·(d − d_e)·4. Published only
    while the knob is on, so an unprojected run has no such gauge."""
    lanes_total = float(sum(k for k, _ in lane_dims))
    full = lanes_total * float(full_dim)
    kept = float(sum(k * d for k, d in lane_dims))
    REGISTRY.gauge_set(f"{prefix}.mean_ratio", kept / full if full > 0 else 1.0)
    REGISTRY.gauge_set(f"{prefix}.dims_saved_bytes", (full - kept) * 4.0)


def record_placement_metrics(plan: PlacementPlan, shard: int | None = None, prefix: str = "re_shard",
                             atoms: int | None = None, split_classes: int | None = None) -> None:
    """The plan's gauges in the registry: ``re_shard.rows`` (this shard's
    Σ rows when ``shard`` is given, else the largest), ``rows_max``,
    ``rows_mean``, ``balance``, ``shards``, ``atoms`` (the placement units,
    the item count by default) and ``split_classes`` (0 without a split).
    Every process publishes its own view."""
    loads = plan.loads
    rows_max = float(loads.max()) if len(loads) else 0.0
    rows_mean = float(loads.mean()) if len(loads) else 0.0
    REGISTRY.gauge_set(f"{prefix}.rows", rows_max if shard is None else float(loads[int(shard)]))
    REGISTRY.gauge_set(f"{prefix}.rows_max", rows_max)
    REGISTRY.gauge_set(f"{prefix}.rows_mean", rows_mean)
    REGISTRY.gauge_set(f"{prefix}.balance", plan.balance)
    REGISTRY.gauge_set(f"{prefix}.shards", float(plan.num_shards))
    REGISTRY.gauge_set(f"{prefix}.atoms", float(len(plan.owner) if atoms is None else atoms))
    REGISTRY.gauge_set(f"{prefix}.split_classes", float(split_classes or 0))
