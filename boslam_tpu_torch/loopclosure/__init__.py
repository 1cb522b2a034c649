from boslam_tpu_torch.loopclosure.vocab import (
    LoopState, compute_bow, empty_loop_state, train_vocab,
)
from boslam_tpu_torch.loopclosure.detect import (
    LoopDetection, detect_loop, verify_loop, verify_loops_batch,
)

__all__ = [
    "LoopState", "empty_loop_state", "train_vocab", "compute_bow",
    "detect_loop", "verify_loop", "verify_loops_batch", "LoopDetection",
]
