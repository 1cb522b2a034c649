from boslam_tpu_torch.matching.hamming import (
    hamming_matrix,
    hamming_matrix_mxu,
    match_top2,
    pack_bits,
    unpack_bits,
)
from boslam_tpu_torch.matching.projection import project_points, search_by_projection

__all__ = [
    "hamming_matrix",
    "hamming_matrix_mxu",
    "match_top2",
    "pack_bits",
    "unpack_bits",
    "project_points",
    "search_by_projection",
]
