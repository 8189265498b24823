"""The `p4_solve` kernel's launch geometry, which the wrapper computes
(`kernels/p4_solve/ops.py p4_geometry`) and the launcher only checks:
the width bucket the kernel is instantiated at, warps a block (one
candidate each) and blocks. The kernel itself runs only on the card
(`tests/test_torch_cuda.py`)."""
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels.p4_solve import ops
from repro_torch.kernels.p4_solve.ops import (MAX_BLOCKS, MAX_N,
                                              WARPS_PER_BLOCK, p4_geometry)

SOURCE = Path(ops.__file__).parent / "csrc" / "p4_solve.cu"
COUNTS = (1, 2, 3, 4, 5, 9, 100, 300, 801)


@pytest.mark.parametrize("n", range(1, MAX_N + 1))
def test_geometry_covers_every_candidate_once(n):
    """For every n of 1..32: the bucket is n rounded up to a multiple of
    4, and candidate c = block * warps + warp of the grid covers every
    candidate exactly once, with no block that holds none."""
    for n_cand in COUNTS:
        bucket, warps, blocks = p4_geometry(n, n_cand)
        assert bucket % 4 == 0 and n <= bucket < n + 4 and bucket <= MAX_N
        assert warps == WARPS_PER_BLOCK
        c = (np.arange(blocks)[:, None] * warps
             + np.arange(warps)[None, :]).ravel()
        c = c[c < n_cand]
        assert np.array_equal(np.sort(c), np.arange(n_cand))
        assert (blocks - 1) * warps < n_cand


def test_geometry_refuses_more_blocks_than_a_grid_takes():
    """2^31 - 1 blocks are the most a grid takes: one candidate more is
    refused before anything runs, as is an n outside [1, 32]."""
    most = MAX_BLOCKS * WARPS_PER_BLOCK
    assert MAX_BLOCKS == 2 ** 31 - 1
    assert p4_geometry(11, most)[2] == MAX_BLOCKS
    with pytest.raises(ValueError, match="above the grid's"):
        p4_geometry(11, most + 1)
    for n in (0, MAX_N + 1):
        with pytest.raises(ValueError, match=r"\[1, 32\]"):
            p4_geometry(n, 1)


def test_every_bucket_has_an_instantiation():
    """The launcher instantiates the kernel at every bucket the geometry
    gives (the last as its default), takes no more warps a block than
    its launch bounds, and checks the geometry it is given."""
    src = SOURCE.read_text()
    cases = {int(b) for b in re.findall(r"case (\d+): err = launch<\1>", src)}
    default = {int(b) for b in re.findall(r"default: err = launch<(\d+)>",
                                          src)}
    assert cases | default == {p4_geometry(n, 1)[0]
                               for n in range(1, MAX_N + 1)}
    assert default == {MAX_N}
    max_warps = int(re.search(r"kMaxWarps = (\d+);", src).group(1))
    assert 1 <= WARPS_PER_BLOCK <= max_warps
    assert "blocks * warps < n_cand" in src and "bucket < pl.n" in src
