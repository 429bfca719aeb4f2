"""K1's staged footprints under translate_x and translate_y
(``tests/torch_warp_footprint.py``)."""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

import pytest
from torch_warp_footprint import SIZES, hold_footprint

from vision_toolbox_tpu_torch.ops import trivial_augment as ta


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("op", (ta.OP_TRANSLATE_X, ta.OP_TRANSLATE_Y))
def test_footprint_holds_every_tap_the_plain_warp_reads(op, size):
    hold_footprint(op, size)
