"""Run layouts for slots to runs (ops/runs.py): the cases the CPU tests hold
against the JAX ``_run_ids`` and the card's tests hold the kernel pair to,
and the benchmark cells' real layouts.  numpy only: no JAX, no torch."""

import numpy as np


def from_counts(counts, num_slots):
    """(starts [R] int32, live [R] bool, num_slots) of runs of ``counts``
    slots laid end to end from slot 0, as the pairs stage lays them: each
    start the exclusive prefix of the counts, live where the count is
    positive."""
    counts = np.asarray(counts, np.int64)
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    return starts, counts > 0, int(num_slots)


def _random(seed, runs, hi, num_slots):
    counts = np.random.default_rng(seed).integers(0, hi, runs)
    return from_counts(counts, num_slots)


# name -> () -> (starts, live, num_slots)
CASES = {
    # twelve runs of 0-3 slots over 1, 7 and 40 slots
    "1": lambda: _random(47, 12, 4, 1),
    "7": lambda: _random(53, 12, 4, 7),
    "40": lambda: _random(86, 12, 4, 40),
    "all_dead": lambda: from_counts(np.zeros(9, np.int64), 30),
    # zero-count runs first and last; slots past the last live run
    "zero_count_ends": lambda: from_counts([0, 0, 0, 3, 1, 0, 2, 0, 0, 0], 9),
    # a live run that starts at num_slots and one past it
    "starts_at_and_past_end": lambda: from_counts([2, 3, 1, 4, 2], 6),
    "num_slots_1": lambda: from_counts([0, 0, 2, 1], 1),
    # no multiple of any CTA size (the kernel's tile is 8,192 slots)
    "ragged": lambda: _random(5, 9_000, 5, 3 * 8192 + 1001),
    # ~10^6 slots; the last runs cross the end
    "million": lambda: _random(11, 400_000, 6, 1_000_003),
}


def oracle(starts, live, num_slots):
    """Slot s -> the largest id i of a live run with 0 <= starts[i] <= s,
    -1 where there is none: the definition, by a running max over a seed
    built one run at a time."""
    seed = np.full(num_slots, -1, np.int64)
    for i in np.flatnonzero(live):
        if 0 <= starts[i] < num_slots:
            seed[starts[i]] = max(seed[starts[i]], i)
    return np.maximum.accumulate(seed).astype(np.int32) if num_slots else seed.astype(np.int32)


def _layout(seed, runs, live_share, mean, slots):
    """``runs`` runs, ``live_share`` of them with a count drawn around
    ``mean`` (at least 1), the rest 0, over ``slots`` slots."""
    rng = np.random.default_rng(seed)
    counts = np.where(rng.random(runs) < live_share, 1 + rng.poisson(mean - 1, runs), 0)
    return from_counts(counts, slots)


# The benchmark cells' two calls a frame: chunk slots over the Gaussians
# (pairs._chunk_capacity: pair_capacity / 8 plus min(N, that) x slack) and
# aligned blocks over the tiles (pair_capacity / 128 plus the tiles); the
# counts fill about the share of the slots the cells' frames do.
CELLS = {
    # 100k Gaussians, 2^21 pairs, 50 x 38 tiles: 362,144 + 18,284 slots
    "synth100k": lambda: (_layout(1, 100_000, 0.7, 3.0, 262_144 + 100_000),
                          _layout(2, 1_900, 0.95, 8.0, 16_384 + 1_900)),
    # 1.5M Gaussians, 2^23 pairs, slack 0.5: 1,572,864 + 67,436 slots
    "garden_c4": lambda: (_layout(3, 1_500_000, 0.5, 1.8, 1_048_576 + 524_288),
                          _layout(4, 1_900, 0.95, 16.0, 65_536 + 1_900)),
    # ~5.8M Gaussians, 2^26 pairs, 82 x 53 tiles: 14,188,608 + 528,634 slots
    "garden_mip360": lambda: (_layout(5, 5_800_000, 0.6, 1.4, 8_388_608 + 5_800_000),
                              _layout(6, 4_346, 0.97, 64.0, 524_288 + 4_346)),
}
