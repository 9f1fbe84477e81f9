"""K2's batched walk (several z-groups in one launch) and the extraction
after it, compiled with g++ against the CPU emulation of the CUDA subset
they use and held against their plain versions by equality (the fixtures
and the checks of ``test_torch_emulated.py``), in a module of its own so
that it runs beside the other emulated tests.
"""

import pytest

from test_torch_emulated import (  # noqa: F401  (emu, walk_calls: fixtures)
    _batched_walk,
    emu,
    walk_calls,
)


@pytest.mark.parametrize("check_every", [1, 3])
def test_emulated_batched_walk_equals_plain(emu, walk_calls, check_every):
    _batched_walk(emu, walk_calls, check_every, "grid")
