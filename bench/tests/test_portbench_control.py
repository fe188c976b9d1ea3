"""The control of the comparison: the reference put in the program's place
in bfloat16 comes out as not correct, on three seeds, for each traffic mix
(at a small size here; bench/tools/control.py runs it at the cells' own)."""
import sys

import pytest

import portbench_small as small

sys.path.insert(0, str(small.BENCH / "tools"))
import control  # noqa: E402


@pytest.mark.parametrize("kind", ["batch", "paths"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_bfloat16_reference_is_not_correct(kind, seed):
    _wl, config, traffic = small.small(kind, check=48)
    ck = control.control(config, traffic, seed)
    assert not ck.correct
    assert ck.items["mismatches"]["value"] > 0
    assert ck.items["max_gap"]["value"] > 0
