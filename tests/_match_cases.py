"""Edge cases of the streaming Hamming matcher (kernel B3), made with numpy
from a seed.  tests/test_torch_kernels.py holds the plain twin against the
Pallas kernel on them (interpret mode), tests/test_torch_cuda.py the CUDA
kernel against the twin.  Each case is (arrays, max_dist): frame words
[N, 8] uint32, pixels [N, 2], radii [N], valid [N]; map words [M, 8]
uint32, pixels [M, 2], visible [M].  M is a multiple of 128, so the Pallas
kernel runs with ``m_tile=128``."""

import numpy as np

SETTINGS = [dict(mutual=mutual, ratio=ratio)
            for mutual in (True, False) for ratio in (1.0, 0.8)]


def _words(rng, k):
    return rng.integers(0, 2**32, size=(k, 8), dtype=np.uint64).astype(np.uint32)


def _flip(rng, desc, bits):
    """``desc`` with ``bits`` distinct bits flipped."""
    out = desc.copy()
    for b in rng.choice(256, bits, replace=False):
        out[b // 32] ^= np.uint32(1 << (b % 32))
    return out


def _base(rng, n, m, r=np.inf):
    return [_words(rng, n),
            rng.uniform(0, (640.0, 480.0), (n, 2)).astype(np.float32),
            np.full(n, r, np.float32), rng.random(n) < 0.9, _words(rng, m),
            rng.uniform(0, (640.0, 480.0), (m, 2)).astype(np.float32),
            np.ones(m, bool)]


def sparse(rng):
    """The engine's call: only the lowest 150 of 1024 slots visible, holding
    copies of frame rows, so tiles 2-7 of 128 have no visible column; map
    pixels 0 and r = inf."""
    a = _base(rng, 64, 1024)
    rows = rng.permutation(64)[:48]
    for r, c in zip(rows, rng.choice(150, rows.size, replace=False)):
        a[4][c] = _flip(rng, a[0][r], int(rng.integers(0, 13)))
    a[5][:] = 0.0
    a[6][:] = False
    a[6][:150] = rng.random(150) < 0.95
    return a


def invisible(rng):
    """No visible column: every row unmatched."""
    a = _base(rng, 64, 512, r=30.0)
    a[4][:64] = a[0]
    a[5][:64] = a[1] + 3.0
    a[6][:] = False
    return a


def ties(rng):
    """Row 5 duplicates row 0, whose exact copy is column 40 (the lowest row
    wins the column); row 1's exact copy is columns 10, 20 (one tile) and
    300 (another), so best = second = 0 at column 10; row 2 lies 5 bits
    from columns 200 and 450 (two tiles), a tie at the lower column."""
    a = _base(rng, 64, 512)
    a[0][5] = a[0][0]
    a[3][[0, 1, 2, 5]] = True
    a[4][40] = a[0][0]
    a[4][[10, 20, 300]] = a[0][1]
    a[4][200] = _flip(rng, a[0][2], 5)
    a[4][450] = _flip(rng, a[0][2], 5)
    return a


def edges(rng):
    """N = 37 (no multiple of 16): row 0's only admissible column is its
    complement (distance 256, off the image); row 1 lies exactly 9 bits from
    column 100 and row 2 10 bits from column 101, both 3 px away."""
    a = _base(rng, 37, 256, r=40.0)
    a[3][:3] = True
    a[1][0] = (-100.0, -100.0)
    a[2][0] = 5.0
    a[4][7] = ~a[0][0]
    a[5][7] = (-99.0, -100.0)
    a[4][100] = _flip(rng, a[0][1], 9)
    a[5][100] = a[1][1] + 3.0
    a[4][101] = _flip(rng, a[0][2], 10)
    a[5][101] = a[1][2] + 3.0
    return a


# name -> (maker, max_dist): "edges" puts max_dist at row 1's exact
# distance, "complement" at 256.
CASES = {"sparse": (sparse, 64), "invisible": (invisible, 64),
         "ties": (ties, 64), "edges": (edges, 9), "complement": (edges, 256)}


def case(name, seed=0):
    make, max_dist = CASES[name]
    return make(np.random.default_rng(seed)), max_dist


def expect(name, idx, ok, dist, mutual, ratio):
    """What each case is built to show, on numpy outputs."""
    if name == "sparse":
        assert ok.sum() > 10 and np.all(idx[ok] < 150)
    elif name == "invisible":
        assert not ok.any() and np.all(idx == -1)
    elif name == "ties":
        assert idx[0] == 40 and idx[1] == 10 and dist[1] == 0
        assert idx[5] == (-1 if mutual else 40)
        assert idx[2] == (200 if ratio == 1.0 else -1) and dist[2] == 5
    elif name == "edges":
        assert dist[0] == 256 and idx[0] == -1
        assert idx[1] == 100 and dist[1] == 9 and idx[2] == -1
    elif name == "complement":
        assert idx[0] == 7 and dist[0] == 256
