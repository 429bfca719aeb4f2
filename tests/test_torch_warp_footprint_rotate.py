"""K1's staged footprints under rotate
(``tests/torch_warp_footprint.py``), and the shared memory K1 sizes for the draw set."""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

import numpy as np
import pytest
from torch_parity import csrc_constant
from torch_warp_footprint import GEOMETRIC, SIZES, hold_footprint, program_rows

from vision_toolbox_tpu_torch.ops import trivial_augment as ta
from vision_toolbox_tpu_torch.ops import warp


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("op", (ta.OP_ROTATE,))
def test_footprint_holds_every_tap_the_plain_warp_reads(op, size):
    hold_footprint(op, size)


def test_stage_sizes_cover_the_draw_set():
    """The kernel sizes shared memory at the draw set's worst footprint:
    every geometric op at 401 magnitudes over [−1, 1], every tile at 176 px,
    stages at most STAGE_EDGE − 2 rows and columns (2 spare for a device
    program an ulp off the host's) within ``STAGE_FLOATS``; the
    constants are warp_shear3.cu's."""
    for name in ("TILE", "STAGE_EDGE", "ROW_PAD"):
        assert getattr(warp, name) == csrc_constant(name, "warp_shear3.cu"), name
    mags = np.linspace(-1, 1, 401, dtype=np.float32).tolist()
    side, floats = 0, 0
    for op in GEOMETRIC:
        for prog in program_rows(op, mags):
            for i0 in range(0, 176, warp.TILE):
                for j0 in range(0, 176, warp.TILE):
                    fp = warp.stage_footprint(prog, i0, j0, 176, 176)
                    if fp is not None:
                        side = max(side, fp.rows[1] - fp.rows[0] + 1, fp.cols[1] - fp.cols[0] + 1)
                        floats = max(floats, fp.floats)
    assert side <= warp.STAGE_EDGE - 2 and floats <= warp.STAGE_FLOATS, (side, floats)
    assert side == 74  # a rotation by 45°: the footprint the .cu's note sizes
