"""The least time of kernel B3, relocalization's whole-map match
(``boslam_tpu_torch/ops/hamming_cuda.py``, ``csrc/fused_match.cu``: one
call, two launches, ``match_kernel`` then ``merge_kernel``), counted from
a call's shape.

The counts are a frozen copy of ``chip_smoke.py:match_bound`` at commit
37f0a60: the AND-popcount product over the visible columns, 2 x N x V x 256
operations at the card's dense int8 tensor-core rate, against the bytes
the call has to move: per frame row its descriptor words, pixel, radius
and flag in and its index, mask and distance out; every column's
visibility; the visible columns' words and pixels.  The bytes per second
are ``kernels.PEAKS``; the int8 rates are NVIDIA's data sheets (dense,
at the full power limit).  Nothing imports the port.
"""

from __future__ import annotations

import re

import kernels

INT8_PEAKS = (
    ("h100 pcie", 1513e12),
    ("h100 80gb hbm3", 1979e12),
    ("h100 sxm", 1979e12),
)
# The two launches' names in the device trace, with or without the
# anonymous namespace they are defined in.
LAUNCH = re.compile(r"(^|::)(match|merge)_kernel\(")
FIRST = re.compile(r"(^|::)match_kernel\(")


def counts(n: int, m: int, v: int):
    """(operations, bytes) of one call at N rows, M columns, V visible."""
    ops = 2.0 * n * v * 256
    nbytes = n * (32 + 8 + 4 + 1 + 4 + 1 + 4) + m + v * (32 + 8)
    return ops, float(nbytes)


def least_time_s(n: int, m: int, v: int, card: str):
    """The larger of the operations over the int8 rate and the bytes over
    the memory rate; None for a card not in the tables."""
    low = card.lower()
    peak = kernels.peaks(card)
    int8 = next((r for key, r in INT8_PEAKS if key in low), None)
    if peak is None or int8 is None:
        return None
    ops, nbytes = counts(n, m, v)
    return max(ops / int8, nbytes / peak[1])


def roofline_pct(run: dict):
    """B3's share of its roofline in the traced cold start: the least time
    of the probed call's shape over the mean device time of a traced call
    (both launches), in %; None where the run traced no call, probed none
    or the card is unknown."""
    prof, call = run.get("profile_cold"), run.get("match_call")
    if prof is None or call is None:
        return None
    least = least_time_s(call["n"], call["m"], call["v"], run.get("card", ""))
    hits = [(name, n, s) for name, (n, s) in prof["by_name"].items()
            if LAUNCH.search(name)]
    calls = sum(n for name, n, _ in hits if FIRST.search(name))
    seconds = sum(s for _, _, s in hits)
    if least is None or not calls or seconds <= 0:
        return None
    return 100.0 * least / (seconds / calls)
