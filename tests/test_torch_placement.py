"""The port's skew-aware placement (``photon_ml_tpu_torch/parallel/placement.py``)
held against the JAX package's ``photon_ml_tpu.parallel.placement`` on the
same seeded inputs: owners, loads and balance of every plan, the re-plan's
migration mask and the measured costs equal, exactly (the planner is host
arithmetic, so nothing differs). The cases mirror the reference's
``tests/test_placement.py`` ``TestPlanner``, ``TestKnob`` and
``TestValidation``, each as a parametrised case; the gauges and the
whole-bucket owner plan of the in-memory owned mode close the file.
"""

from __future__ import annotations

import numpy as np
import pytest

import photon_ml_tpu.parallel.placement as ref
import photon_ml_tpu_torch.parallel.placement as port


def _zipf_sizes(E: int = 64, base: float = 300.0, alpha: float = 1.1) -> np.ndarray:
    return np.maximum((base / (1 + np.arange(E)) ** alpha).astype(np.int64), 2)


def _seeded(seed: int, E: int = 40) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.maximum(rng.zipf(1.6, size=E) % 97, 1).astype(np.int64)


def _same_plan(a, b) -> None:
    np.testing.assert_array_equal(a.owner, b.owner)
    np.testing.assert_array_equal(a.loads, b.loads)
    assert a.num_shards == b.num_shards
    assert a.balance == b.balance
    for s in range(a.num_shards):
        np.testing.assert_array_equal(a.owned_items(s), b.owned_items(s))


# (row counts, shards, groups, skew_aware): the reference's planner cases
PLANNER_CASES = {
    "zipf_64_entities_4_shards": (_zipf_sizes(), 4, None, True),
    "zipf_64_entities_4_shards_round_robin": (_zipf_sizes(), 4, None, False),
    "uniform_rows": (np.full(64, 7), 4, None, True),
    "loads_match_owners": (_zipf_sizes(32), 4, None, True),
    "single_item_more_shards": ([10.0], 4, None, True),
    "empty": ([], 3, None, True),
    "single_shard": (_zipf_sizes(16), 1, None, True),
    "group_atomic": ([50, 1, 1, 1, 40, 30, 20, 10], 3, [[0, 1], [2, 3], [4], [5], [6, 7]], True),
    "unlisted_singletons": ([5, 5, 5, 5], 2, [[1, 2]], True),
    "all_ties": ([3, 3, 3, 3, 3, 3], 3, None, True),
    "round_robin_group_order": ([9, 1, 9, 1], 2, None, False),
    "seed_0_zipf_5_shards": (_seeded(0), 5, None, True),
    "seed_3_zipf_3_shards_groups": (_seeded(3), 3, [[i, i + 1] for i in range(0, 20, 2)], True),
    "seed_7_zipf_2_shards": (_seeded(7), 2, None, True),
    # fractional rows: the round-robin loads sum in the reference's item order
    "seed_5_fractional_round_robin": (np.random.default_rng(5).uniform(0.1, 1e3, size=97), 6, None, False),
}


@pytest.mark.parametrize("case", sorted(PLANNER_CASES))
def test_planner_matches_the_reference(case):
    rows, shards, groups, skew = PLANNER_CASES[case]
    _same_plan(port.plan_shard_placement(rows, shards, groups=groups, skew_aware=skew),
               ref.plan_shard_placement(rows, shards, groups=groups, skew_aware=skew))
    if groups is None:
        _same_plan(port.plan_entity_placement(np.asarray(rows), shards, skew_aware=skew),
                   ref.plan_entity_placement(np.asarray(rows), shards, skew_aware=skew))


@pytest.mark.parametrize("items, shards", [(0, 3), (1, 4), (24, 2), (25, 4), (138, 7)])
def test_modular_owner_is_the_round_robin_plan(items, shards):
    """The knob-off owner map (item i on shard i % P) is the reference's
    round-robin plan of singletons, whatever the rows."""
    rows = np.random.default_rng(items).uniform(0.0, 50.0, size=items)
    want = ref.plan_entity_placement(rows, shards, skew_aware=False).owner
    np.testing.assert_array_equal(port.modular_owner(items, shards), want)
    np.testing.assert_array_equal(want, np.arange(items) % shards)


def test_zipf_balance_bound():
    """The reference's acceptance bound: LPT within 1.15× max/mean where
    round-robin loses a shard to the head entities (≥ 1.5×)."""
    sizes = _zipf_sizes()
    sk, rr = port.plan_entity_placement(sizes, 4), port.plan_entity_placement(sizes, 4, skew_aware=False)
    assert sk.balance <= 1.15 and rr.balance >= 1.5
    for s in range(4):
        assert sk.loads[s] == sizes[sk.owned_items(s)].sum()


@pytest.mark.parametrize("args, match", [
    (([1, 2], 2, [[0], [0]]), "two groups"),
    (([1, 2], 2, [[5]]), "out of range"),
    (([1.0], 0, None), "num_shards"),
    ((np.ones((2, 2)), 2, None), "1-D"),
])
def test_planner_validation_matches_the_reference(args, match):
    for mod in (port, ref):
        with pytest.raises(ValueError, match=match):
            mod.plan_shard_placement(args[0], args[1], groups=args[2])


# (env value or None, module global, expected: bool or an exception type)
KNOB_CASES = {
    "default_off": (None, 0, False),
    "env_on": ("1", 0, True),
    "env_off_wins": ("0", 1, False),
    "env_strict": ("yes", 0, ValueError),
    "module_global": (None, 1, True),
    "empty_env_falls_back": ("", 1, True),
}


@pytest.mark.parametrize("case", sorted(KNOB_CASES))
def test_knob_matches_the_reference(case, monkeypatch):
    env, glob, want = KNOB_CASES[case]
    for mod in (port, ref):
        if env is None:
            monkeypatch.delenv("PHOTON_RE_SHARD", raising=False)
        else:
            monkeypatch.setenv("PHOTON_RE_SHARD", env)
        monkeypatch.setattr(mod, "RE_SHARD", glob)
        if isinstance(want, type):
            with pytest.raises(want):
                mod.re_shard_enabled()
        else:
            assert mod.re_shard_enabled() is want


@pytest.mark.parametrize("value, want", [(None, 0.0), ("1.5", 1.5), ("0", 0.0), ("-2", 0.0), ("junk", ValueError)])
def test_replan_threshold_matches_the_reference(value, want, monkeypatch):
    if value is None:
        monkeypatch.delenv("PHOTON_RE_REPLAN_IMBALANCE", raising=False)
    else:
        monkeypatch.setenv("PHOTON_RE_REPLAN_IMBALANCE", value)
    for mod in (port, ref):
        if isinstance(want, type):
            with pytest.raises(want):
                mod.replan_imbalance_threshold()
        else:
            assert mod.replan_imbalance_threshold() == want


@pytest.mark.parametrize("call, match", [
    (lambda m: m.plan_from_owner(np.array([0, 1, 0]), np.array([5.0, 5.0]), 2), r"length 3 != .*length 2"),
    (lambda m: m.plan_from_owner(np.array([0, 7]), np.array([5.0, 5.0]), 2), r"owner value 7"),
    (lambda m: m.plan_from_owner(np.array([0, -1]), np.array([5.0, 5.0]), 2), r"owner value -1"),
    (lambda m: m.replan_excluding(m.plan_entity_placement(np.ones(4), 2), [0], np.ones(4), survivors=[1, 5]),
     r"survivor 5 outside"),
    (lambda m: m.replan_excluding(m.plan_entity_placement(np.ones(4), 2), [1], np.ones(4), survivors=[0, 1]),
     "overlap"),
    (lambda m: m.replan_excluding(m.plan_entity_placement(np.ones(4), 2), [], np.ones(4), survivors=[]),
     "no surviving"),
    (lambda m: m.measured_entity_costs(np.ones(4), np.zeros(3, np.int64), np.ones(2)), "length"),
], ids=["owner_length", "owner_high", "owner_negative", "survivor_range", "survivor_overlap", "no_survivor",
        "costs_length"])
def test_validation_matches_the_reference(call, match):
    for mod in (port, ref):
        with pytest.raises(ValueError, match=match):
            call(mod)


def test_plan_from_owner_roundtrip():
    for mod in (port, ref):
        assert mod.plan_from_owner(np.array([1, 0, 1]), [2.0, 3.0, 4.0], 2).loads.tolist() == [3.0, 6.0]
    _same_plan(port.plan_from_owner(np.array([1, 0, 1]), [2.0, 3.0, 4.0], 2),
               ref.plan_from_owner(np.array([1, 0, 1]), [2.0, 3.0, 4.0], 2))


# (row counts, old shards, measured walls): a straggler's measured walls
REPLAN_CASES = {
    "zipf_straggler_1_of_2": (_zipf_sizes(48), 2, [1.0, 4.0]),
    "zipf_straggler_2_of_4": (_zipf_sizes(64), 4, [1.0, 1.0, 3.0, 1.0]),
    "seed_3_zero_wall": (_seeded(3), 3, [2.0, 0.0, 1.0]),
    "balanced_walls": (_seeded(7), 2, [1.0, 1.0]),
}


@pytest.mark.parametrize("case", sorted(REPLAN_CASES))
def test_replan_migrations_match_the_reference(case):
    counts, P, walls = REPLAN_CASES[case]
    out = []
    for mod in (port, ref):
        old = mod.plan_entity_placement(counts, P)
        costs = mod.measured_entity_costs(counts, old.owner, np.asarray(walls))
        new, migrated = mod.replan_excluding(mod.plan_from_owner(old.owner, counts, P), [], costs,
                                             survivors=range(P))
        out.append((old, costs, new, migrated))
    (po, pc, pn, pm), (ro, rc, rn, rm) = out
    _same_plan(po, ro)
    np.testing.assert_array_equal(pc, rc)
    _same_plan(pn, rn)
    np.testing.assert_array_equal(pm, rm)
    if case.startswith("zipf_straggler"):
        assert pm.any()  # a straggler's entities move


def test_replan_rejoin_expansion_matches_the_reference():
    """An empty lost set with a survivor past the old range (the rejoin
    signature): every item the joining shard takes counts as migrated."""
    counts = _zipf_sizes(24)
    out = [mod.replan_excluding(mod.plan_entity_placement(counts, 2), [], counts, survivors=[0, 1, 2])
           for mod in (port, ref)]
    _same_plan(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
    assert out[0][1][out[0][0].owner == 2].all()


@pytest.mark.parametrize("shard", [None, 0, 2])
def test_placement_gauges_match_the_reference(shard):
    from photon_ml_tpu.obs.metrics import REGISTRY as REF_REGISTRY
    from photon_ml_tpu_torch.obs.metrics import REGISTRY

    plan_args = (_zipf_sizes(16), 4)
    REGISTRY.reset("re_shard.")
    REF_REGISTRY.reset("re_shard.")
    port.record_placement_metrics(port.plan_entity_placement(*plan_args), shard=shard, atoms=7)
    ref.record_placement_metrics(ref.plan_entity_placement(*plan_args), shard=shard, atoms=7)
    got, want = REGISTRY.snapshot("re_shard.")["gauges"], REF_REGISTRY.snapshot("re_shard.")["gauges"]
    assert got == want and got["re_shard.shards"] == 4.0 and got["re_shard.atoms"] == 7.0


@pytest.mark.parametrize("seed, processes", [(0, 2), (3, 3), (11, 2), (11, 4)])
def test_whole_bucket_owners_match_the_reference(seed, processes, monkeypatch):
    """The in-memory owned mode's plan: whole buckets over the processes by
    Σ active rows, fusion groups (keyed by capacity) placed whole; the
    port's ``_plan_bucket_owners`` and ``plan_fusion_groups`` against the
    reference's on the same buckets (the reference reads its process count
    from the runtime, patched here)."""
    import photon_ml_tpu.parallel.multihost as ref_mh
    from photon_ml_tpu.game import random_effect as ref_re
    from photon_ml_tpu.game.data import bucket_entities as ref_bucket
    from photon_ml_tpu.game.data import group_by_entity as ref_group
    from photon_ml_tpu_torch.game import random_effect as port_re
    from photon_ml_tpu_torch.game.data import bucket_entities, group_by_entity

    rng = np.random.default_rng(seed)
    E = 60
    sizes = np.maximum((200.0 / (1 + np.arange(E)) ** 1.2).astype(np.int64), 1)
    ids = rng.permutation(np.repeat(np.arange(E), sizes)).astype(np.int64)
    kw = dict(capacities=(2, 4, 8, 16, 32, 64, 128, 256)) if seed == 11 else {}
    port_b = bucket_entities(group_by_entity(ids, num_entities=E), **kw)
    ref_b = ref_bucket(ref_group(ids, num_entities=E), **kw)
    keys = [int(r.shape[1]) for r in port_b.row_indices]
    lanes = [len(e) for e in port_b.entity_ids]
    assert port_re.plan_fusion_groups(keys, lanes) == ref_re.plan_fusion_groups(keys, lanes)
    monkeypatch.setattr(ref_mh, "effective_process_count", lambda: processes)
    monkeypatch.setattr(ref_mh, "effective_process_index", lambda: 0)
    np.testing.assert_array_equal(port_re._plan_bucket_owners(port_b, processes, 0),
                                  ref_re._plan_bucket_owners(ref_b))
