"""K1's staged footprints against the plain three-shear warp, shared by
``tests/test_torch_warp_footprint_{shear,translate,rotate}.py`` (one test
split over three files by op, so that pytest-xdist's ``loadfile`` can run
its 176 px cases on three workers).

K1 stages each output tile's footprint (``ops/warp.stage_footprint``, the
kernel's rule mirrored) and reads every tap from it; a tap it missed would
read stale shared memory on the card. Here the input outside a tile's
footprint is NaN and the plain three-pass warp runs on it: every tap the
passes read for that tile, even at weight 0, must lie in the footprint (or
off the image, in the zero padding), so the tile comes out bit-equal to the
warp of the whole image. Each footprint also fits the shared memory the
kernel sizes.
"""

import numpy as np
import torch

from vision_toolbox_tpu_torch.ops import trivial_augment as ta
from vision_toolbox_tpu_torch.ops import warp

GEOMETRIC = (ta.OP_SHEAR_X, ta.OP_SHEAR_Y, ta.OP_TRANSLATE_X, ta.OP_TRANSLATE_Y, ta.OP_ROTATE)
SIZES = (32, 64, 176)
FOOTPRINT_MAGS = sorted({s * m for m in (0.0, 1 / 30, 1 / 3, 0.5, 29 / 30, 1.0) for s in (1, -1)})


def program_rows(op, mags):
    program = warp.shear3_params(torch.full((len(mags),), op), torch.tensor(mags))
    return [(int(program[0][n]), *(float(t[n]) for t in program[1:])) for n in range(len(mags))]


def hold_footprint(op: int, size: int) -> None:
    """Every tile of a ``size`` px image under ``op`` at FOOTPRINT_MAGS."""
    x = torch.from_numpy(np.random.default_rng(size).random((1, size, size, 3),
                                                            dtype=np.float32)[..., :1])
    tiles = [(i0, j0) for i0 in range(0, size, warp.TILE) for j0 in range(0, size, warp.TILE)]
    for prog in program_rows(op, FOOTPRINT_MAGS):
        k90, *coef = prog
        program = tuple(torch.tensor([v]) for v in (k90, *coef))
        program = (program[0].int(), *program[1:])
        whole = warp.shear3_warp_plain(x, program)
        masked = x.repeat(len(tiles), 1, 1, 1).fill_(float("nan"))
        for n, (i0, j0) in enumerate(tiles):
            fp = warp.stage_footprint(prog, i0, j0, size, size)
            if fp is not None:
                assert fp.floats <= warp.STAGE_FLOATS, (prog, i0, j0, fp)
                (r0, r1), (c0, c1) = fp.rows, fp.cols
                r0, c0 = max(r0, 0), max(c0, 0)  # the image's part of it
                masked[n, r0:r1 + 1, c0:c1 + 1] = x[0, r0:r1 + 1, c0:c1 + 1]
        got = warp.shear3_warp_plain(masked, tuple(t.repeat(len(tiles)) for t in program))
        for n, (i0, j0) in enumerate(tiles):
            tile = (slice(i0, i0 + warp.TILE), slice(j0, j0 + warp.TILE))
            assert torch.equal(got[n][tile], whole[0][tile]), (prog, i0, j0)
