"""Port parity, codecs/lab.py on the upper half of the 8-bit L range, every
a and b, against PIL bit for bit (the lower half and the files that use
it: tests/test_torch_codecs_lab.py)."""
import pytest

from test_torch_codecs_lab import assert_lab_sweep


@pytest.mark.parametrize("quarter", [2, 3])
def test_lab_to_rgb_full_sweep_upper(quarter):
    assert_lab_sweep(quarter)
