"""K2's walks over buckets larger than their candidate cap, compiled with
g++ against the CPU emulation of the CUDA subset they use and held
against their plain versions by equality (the fixture and the checks of
``test_torch_emulated.py``). The slowest of the emulated tests, in a
module of its own so that it runs beside the others.
"""

import numpy as np
import pytest

from repro_torch.data.synthetic import (
    synthetic_binary_codes_packed,
    synthetic_queries_packed,
)

from test_torch_emulated import (  # noqa: F401  (emu: a fixture)
    _batched_walk,
    _group_walk,
    _record_calls,
    emu,
)


@pytest.fixture(scope="module")
def dup_walk_calls():
    """30 distinct codes, each stored 100 times: buckets of 100 and more
    ids, over a small cap."""
    p, n = 64, 3000
    base = synthetic_binary_codes_packed(30, p, seed=5)
    db = base[np.arange(n) % 30]
    q = synthetic_queries_packed(base, p, 12, seed=6)
    return _record_calls(db, q, p)


@pytest.mark.parametrize("form", ["grid", "cluster"])
def test_emulated_walks_with_buckets_over_cap(emu, dup_walk_calls, form):
    """The walks with cap = 8 candidate slots an iteration over buckets of
    100 and more ids (both in the grid form, the one-group walk in the
    cluster form): entry 0 is taken in parts (the resume offset), and the
    walk runs into its budget."""
    for ce in (1, 3):
        if form == "grid":
            _batched_walk(emu, dup_walk_calls, ce, form, cap=8)
        _group_walk(emu, dup_walk_calls, ce, form, cap=8)
