"""Binary visual vocabulary + BoW database (``boslam_tpu.loopclosure.vocab``).

The vocabulary is a flat table of ``vocab_size`` 256-bit words trained
online by k-majority (binary k-means) on the map's own descriptors; word
assignment is one Hamming matrix product, a BoW vector a histogram, and
database scoring a dense ``[K, V] @ [V]`` product.  Word descriptors are
int32 tensors holding the reference's uint32 bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from boslam_tpu_torch.config import SlamConfig
from boslam_tpu_torch.matching import hamming
from boslam_tpu_torch.utils.tensor_ops import at, nonzero_static, set_at

# Parallel temporal-consistency groups (reference mvConsistentGroups).
N_STREAKS = 4


class LoopState(NamedTuple):
    vocab: torch.Tensor       # [V, 8] i32 word descriptors (uint32 bits)
    vocab_ready: torch.Tensor # scalar bool
    kf_bow: torch.Tensor      # [K, V] f32 L2-normalized tf-idf vectors
    idf: torch.Tensor         # [V] f32 (ones before training)
    streak_kf: torch.Tensor   # [N_STREAKS] i32 candidate group anchors (-1)
    streak_len: torch.Tensor  # [N_STREAKS] i32


def empty_loop_state(cfg: SlamConfig, device) -> LoopState:
    V = cfg.loop.vocab_size
    K = cfg.map.max_keyframes
    return LoopState(
        vocab=torch.zeros((V, 8), dtype=torch.int32, device=device),
        vocab_ready=torch.zeros((), dtype=torch.bool, device=device),
        kf_bow=torch.zeros((K, V), device=device),
        idf=torch.ones((V,), device=device),
        streak_kf=torch.full((N_STREAKS,), -1, dtype=torch.int32, device=device),
        streak_len=torch.zeros((N_STREAKS,), dtype=torch.int32, device=device),
    )


def _histograms(V: int, assign, valid):
    """Per-row word histograms: assign/valid [..., N] -> [..., V] f32 (the
    reference's ``segment_sum`` of ones with a dump segment V)."""
    seg = torch.where(valid, assign, V).long()
    hist = torch.zeros(seg.shape[:-1] + (V + 1,), device=seg.device)
    return hist.scatter_add(-1, seg, torch.ones(seg.shape, device=seg.device))[..., :V]


def _assign(vocab, desc):
    """[..., N] index of each descriptor's nearest word (first on a tie)."""
    return torch.argmin(hamming.hamming_matrix_mxu(desc, vocab), dim=-1)


def train_vocab(cfg: SlamConfig, loop: LoopState, map_state,
                iters: int = 3) -> LoopState:
    """k-majority vocabulary training on the map's keyframe descriptors.

    Init: a deterministic stride sample of valid descriptors.  Lloyd steps:
    assign every descriptor to its nearest word, recompute each word as the
    bitwise majority of its cluster.  Empty clusters keep their previous
    word.  Then recompute the idf and all keyframe BoW vectors.
    """
    V = cfg.loop.vocab_size
    K, N = map_state.kf_obs_pt.shape
    desc = map_state.kf_desc.reshape(K * N, 8)
    valid = (map_state.kf_kp_valid & map_state.kf_valid[:, None]).reshape(K * N)
    vidx = nonzero_static(valid, K * N, 0)
    n_valid = torch.clamp_min(torch.sum(valid), 1)
    take = (torch.arange(V, device=desc.device) * n_valid) // V
    words = desc[vidx[torch.clamp(take, 0, K * N - 1)]]

    bits = hamming.unpack_bits(desc)  # [KN, 256]
    wvalid = valid.to(torch.float32)
    for _ in range(iters):
        seg = torch.where(valid, _assign(words, desc), V)
        counts = torch.zeros((V + 1,), device=desc.device).index_add(
            0, seg, wvalid)[:V]
        sums = torch.zeros((V + 1, 256), device=desc.device).index_add(
            0, seg, bits * wvalid[:, None])[:V]
        maj = (sums * 2.0 > counts[:, None]).to(torch.float32)
        words = torch.where((counts > 0)[:, None], hamming.pack_bits(maj), words)

    ready = torch.ones((), dtype=torch.bool, device=desc.device)
    # Per-word idf over the current keyframe set: ln((1 + K) / (1 + df)),
    # df = number of keyframes containing the word.
    tf_all = _histograms(V, _assign(words, map_state.kf_desc),
                         map_state.kf_kp_valid & map_state.kf_valid[:, None])
    n_kf = torch.clamp_min(torch.sum(map_state.kf_valid), 1)
    df = torch.sum((tf_all > 0) & map_state.kf_valid[:, None], dim=0)
    idf = torch.log((1.0 + n_kf.to(torch.float32))
                    / (1.0 + df.to(torch.float32)))
    kf_bow = _normalize(tf_all * idf)
    return loop._replace(vocab=words, vocab_ready=ready, idf=idf, kf_bow=kf_bow)


def _tf_histogram(cfg: SlamConfig, vocab, desc, valid):
    return _histograms(cfg.loop.vocab_size, _assign(vocab, desc), valid)


def _normalize(v):
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                               1e-9)


def _bow_vector(cfg: SlamConfig, vocab, idf, desc, valid):
    return _normalize(_tf_histogram(cfg, vocab, desc, valid) * idf)


def word_ids(vocab, desc, valid):
    """[N] i32 vocabulary word per descriptor (-1 where not valid)."""
    return torch.where(valid, _assign(vocab, desc), -1).to(torch.int32)


def bow_vector(cfg: SlamConfig, vocab, desc, valid, idf=None):
    """L2-normalized BoW tf-idf vector of a descriptor set.

    ``idf=None`` falls back to uniform weights (pre-training callers)."""
    if idf is None:
        idf = torch.ones((cfg.loop.vocab_size,), device=desc.device)
    return _bow_vector(cfg, vocab, idf, desc, valid)


def compute_bow(cfg: SlamConfig, loop: LoopState, map_state, kf_id) -> LoopState:
    """Compute + store the BoW vector of one keyframe (on insertion)."""
    bow = _bow_vector(cfg, loop.vocab, loop.idf, at(map_state.kf_desc, kf_id),
                      at(map_state.kf_kp_valid, kf_id))
    bow = torch.where(loop.vocab_ready, bow, 0.0)
    return loop._replace(kf_bow=set_at(loop.kf_bow, kf_id, bow))
