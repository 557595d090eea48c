"""Static exec shapes for the pruned pair schedule (paper §5.4).

A copy of the JAX package's ``core/md/schedule_opt.py`` (pure Python),
kept here so the port imports nothing of the reference.

The paper moves the pair-list prune to a low-priority stream so it cannot
block the next step's critical path.  In the port the prune (see
:func:`repro_torch.core.md.pair_schedule.prune_local`) runs between
``nstlist`` blocks, beside the rebin / migration, and the host reads its
small per-level histograms once per block.  ``bucket`` quantizes the
dynamic sizes it reports (surviving pairs, max cell occupancy) so a run
meets only a handful of distinct exec shapes.

``tier_plan`` turns the prune's cumulative per-level histogram (level
``l`` = per-pair slot bound quantized to ``ceil(bound / slot_quantum)``;
``cum[l-1]`` = pairs whose bound needs level >= ``l``) into a static
descending ladder of ``(n_rows, k_slots)`` tiers.  Because the prune
packs pairs front-first by DESCENDING level, a tier's rows can only hold
pairs whose own bound is <= the tier's ``k_slots``: per-pair bounds are
never truncated, only rounded up to the tier above.
"""
from typing import Sequence, Tuple

Tier = Tuple[int, int]          # (n_rows, k_slots)


def bucket(n: int, quantum: int, cap: int) -> int:
    """Round ``n`` up to a multiple of ``quantum``, clamped to [quantum, cap].

    Used by the engine to turn prune-reported dynamic sizes into stable
    static shapes: occupancy drifts by a few atoms between blocks, but the
    bucketed shape — hence the compiled program — stays put.
    """
    n = max(int(n), 1)
    b = -(-n // quantum) * quantum
    return int(min(max(b, quantum), cap))


def bucket0(n: int, quantum: int, cap: int) -> int:
    """``bucket`` that maps 0 to 0 (an empty tier is dropped, not padded)."""
    return 0 if int(n) <= 0 else bucket(n, quantum, cap)


def tier_plan(cum: Sequence[int], pair_bucket: int, cap_pairs: int,
              slot_quantum: int, capacity: int) -> Tuple[Tier, ...]:
    """Static tier ladder from a cumulative per-level pair histogram.

    ``cum[l-1]`` is the (mesh-global: the max over domains) count of surviving pairs
    whose per-pair slot bound needs level >= ``l`` (i.e. bound >
    ``(l-1) * slot_quantum``); it is non-increasing in ``l``.  Returns
    ``((n_rows, k_slots), ...)`` ordered deepest tier first, matching the
    prune's descending-level packing: tier boundaries are the bucketed
    cumulative counts, so row ``r`` of the packed worklist lands in a
    tier whose ``k_slots`` is >= the bound of every pair the prune can
    place there.  Empty tiers are dropped; the total row count is the
    bucketed ``cum[0]``.
    """
    L = len(cum)
    # bucketed cumulative boundary per level (monotone by construction:
    # cum is non-increasing in l and bucket0 is monotone)
    b = [bucket0(cum[lv], pair_bucket, cap_pairs) for lv in range(L)]
    for lv in range(L - 2, -1, -1):      # enforce monotonicity after clamp
        b[lv] = max(b[lv], b[lv + 1])
    tiers = []
    prev = 0
    for lv in range(L - 1, -1, -1):      # deepest level first
        n_rows = b[lv] - prev
        if n_rows > 0:
            tiers.append((n_rows, min((lv + 1) * slot_quantum, capacity)))
        prev = b[lv]
    return tuple(tiers)


def tier_rows(tiers: Sequence[Tier]) -> int:
    """Total packed rows a tier ladder evaluates."""
    return int(sum(n for n, _ in tiers))


def tier_slot_pairs(tiers: Sequence[Tier]) -> int:
    """Evaluated slot pairs of a tier ladder (sum of n * k^2)."""
    return int(sum(n * k * k for n, k in tiers))


def tier_cum(tiers: Sequence[Tier], slot_quantum: int,
             n_levels: int) -> Tuple[int, ...]:
    """Invert ``tier_plan``: cumulative row capacity per level.

    ``out[l-1]`` = rows available to pairs of level >= ``l`` — the static
    bound the rolling prune's overflow monitor compares its current
    survivor histogram against (a refresh whose level-``l`` survivors
    exceed ``out[l-1]`` would spill into a tier too shallow for them).
    """
    out = [0] * n_levels
    for n, k in tiers:
        lv = min(-(-k // slot_quantum), n_levels)      # tier's level
        for i in range(lv):
            out[i] += n
    return tuple(out)


def noop() -> None:
    """Placeholder hook marking where stream-priority tuning would sit."""
    return None
