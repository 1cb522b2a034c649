"""Resize variants against the reference's pyramid (ROADMAP C1).

The reference builds its pyramid with ``jax.image.resize(..., "linear")``,
one 3-operand einsum that XLA's CPU dot evaluates; the port replicates the
triangle weights and applies them as two matmuls
(``features.frontend.resize_linear``).  This tool measures how far each way
of summing the taps is from the reference, in differing pixels:

    JAX_PLATFORMS=cpu python tools/resize_variants.py [--levels 3]

prints one JSON line for frame 0 of ``orbit`` and frame 24 of ``loop``
(``tools/sequences.py``): the port's pyramid chained over the 8 levels;
the best elementwise variant chained; per level (each from the
reference's previous level, so errors do not chain) the four elementwise
variants, height or width first, with or without a fused multiply-add
(FMA: the f64 product plus the sum, rounded once to f32), and the height-
first FMA variant on the reference's own compiled weights; and how many
weight entries the port's replica and the reciprocal replica (the division
by the kernel scale as a product with its reciprocal, as XLA rewrites it)
differ from the compiled weights in.

    python tools/resize_variants.py --run [torch_sequence.py arguments]

installs the best elementwise variant (reciprocal weights, height first,
FMA) as the port's ``resize_linear`` and runs ``tools/torch_sequence.py``
with the given arguments (on the card unless ``--device cpu``), e.g.
``--run --sequence loop --loops``.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import numpy as np  # noqa: E402

import sequences  # noqa: E402

F32 = np.float32
FRAMES = (("orbit", 0), ("loop", 24))


def weights_reciprocal(m: int, n: int) -> np.ndarray:
    """The port's weight replica with ``|s - k| * (1 / kernel_scale)``."""
    inv = F32(1.0 / (n / m))
    ks = max(inv, F32(1.0))
    c = np.arange(n, dtype=F32) + F32(0.5)
    sample = (c.astype(np.float64) * np.float64(inv) - 0.5).astype(F32)
    x = np.abs(sample[None, :] - np.arange(m, dtype=F32)[:, None]) * (
        F32(1.0) / ks)
    w = np.maximum(F32(0.0), F32(1.0) - x)
    tot = w.sum(axis=0, keepdims=True, dtype=F32)
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(F32).eps,
                 w / np.where(tot != 0, tot, 1), 0).astype(F32)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, 0).astype(F32)


def contract(x: np.ndarray, W: np.ndarray, axis: int, fma: bool):
    """Resize ``x`` along ``axis`` by ``W`` [m, n], summing each output's
    non-zero taps in index order, with or without an FMA per step."""
    xx = np.moveaxis(x, axis, -1)
    out = np.zeros(xx.shape[:-1] + (W.shape[1],), F32)
    for j in range(W.shape[1]):
        acc = np.zeros(xx.shape[:-1], F32)
        for k in np.flatnonzero(W[:, j]):
            prod = xx[..., k].astype(np.float64) * np.float64(W[k, j])
            if fma:
                acc = (prod + acc.astype(np.float64)).astype(F32)
            else:
                acc = prod.astype(F32) + acc
        out[..., j] = acc
    return np.moveaxis(out, -1, axis)


def resize(x, Wh, Ww, height_first: bool, fma: bool):
    if height_first:
        return contract(contract(x, Wh, 0, fma), Ww, 1, fma)
    return contract(contract(x, Ww, 1, fma), Wh, 0, fma)


def n_diff(a, b) -> int:
    return int((np.asarray(a, F32).view(np.int32)
                != np.asarray(b, F32).view(np.int32)).sum())


def measure(n_levels: int) -> dict:
    import jax
    import jax.numpy as jnp
    from jax._src.image import scale as jscale

    jax.config.update("jax_platforms", "cpu")
    import torch

    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.features import frontend
    from boslam_tpu_torch.io import synthetic
    from boslam_tpu_torch.slam import to_gray_u8

    shapes = frontend.pyramid_shapes(480, 640, 8, 1.2)

    @jax.jit
    def reference(gray):
        levels = [gray]
        for hl, wl in shapes[1:]:
            levels.append(jax.image.resize(levels[-1], (hl, wl), "linear"))
        return levels

    def compiled(m, n):
        return np.asarray(jax.jit(lambda: jscale.compute_weight_mat(
            m, n, n / m, 0.0, jscale._fill_triangle_kernel, True))())

    dims = [(480, 640)] + shapes[1:]
    pairs = sorted({(a[i], b[i]) for a, b in zip(dims[:-1], dims[1:])
                    for i in (0, 1)})
    Wc = {p: compiled(*p) for p in pairs}
    out = {"weights_differ": {
        "port_replica": sum(int((frontend._resize_weights_np(*p)
                                 != Wc[p]).sum()) for p in pairs),
        "reciprocal_replica": sum(int((weights_reciprocal(*p)
                                       != Wc[p]).sum()) for p in pairs),
        "entries": sum(Wc[p].size for p in pairs), "matrices": len(pairs)}}
    for name, index in FRAMES:
        _, _, fr = sequences.build(name, SlamConfig, synthetic,
                                   n_frames=index + 1)
        gray = to_gray_u8(fr[index][1]).astype(F32)
        ref = [np.asarray(l) for l in reference(jnp.asarray(gray))]
        port = frontend.build_pyramid(torch.from_numpy(gray), SlamConfig())
        best, lvl = [], gray
        for hl, wl in shapes[1:]:
            h, w = lvl.shape
            lvl = resize(lvl, weights_reciprocal(h, hl),
                         weights_reciprocal(w, wl), True, True)
            best.append(lvl)
        rec = {"port_chained": [n_diff(a.numpy(), b)
                                for a, b in zip(port[1:], ref[1:])],
               "best_elementwise_chained": [n_diff(a, b) for a, b in
                                            zip(best, ref[1:])]}
        for height_first in (True, False):
            for fma in (False, True):
                key = (f"{'height' if height_first else 'width'}_first_"
                       f"{'fma' if fma else 'no_fma'}_per_level")
                rec[key] = []
                for l in range(1, n_levels + 1):
                    (h, w), (hl, wl) = ref[l - 1].shape, shapes[l]
                    rec[key].append(n_diff(resize(
                        ref[l - 1], frontend._resize_weights_np(h, hl),
                        frontend._resize_weights_np(w, wl), height_first,
                        fma), ref[l]))
        rec["reference_weights_height_first_fma_per_level"] = [
            n_diff(resize(ref[l - 1], Wc[(ref[l - 1].shape[0], shapes[l][0])],
                          Wc[(ref[l - 1].shape[1], shapes[l][1])], True, True),
                   ref[l]) for l in range(1, n_levels + 1)]
        rec["pixels_per_level"] = [int(np.prod(s)) for s in shapes[1:]]
        out[f"{name}_{index}"] = rec
    return out


def install() -> None:
    """The best elementwise variant as the port's ``resize_linear``."""
    import torch

    from boslam_tpu_torch.features import frontend

    def taps(m, n, device):
        W = weights_reciprocal(m, n)
        T = int((W != 0).sum(axis=0).max())
        idx = np.zeros((n, T), np.int64)
        wt = np.zeros((n, T), np.float64)
        for j in range(n):
            nz = np.flatnonzero(W[:, j])
            idx[j, :len(nz)], idx[j, len(nz):] = nz, nz[-1]
            wt[j, :len(nz)] = W[nz, j]
        return torch.from_numpy(idx).to(device), torch.from_numpy(wt).to(device)

    def rows(x, m_out):
        idx, wt = taps(x.shape[0], m_out, x.device)
        g = x.to(torch.float64)[idx]
        acc = torch.zeros((m_out, x.shape[1]), dtype=torch.float64,
                          device=x.device)
        for t in range(idx.shape[1]):
            acc = torch.addcmul(acc, g[:, t], wt[:, t, None]).float().double()
        return acc.float()

    def resize_linear(level, hl, wl):
        if tuple(level.shape) == (hl, wl):
            return level
        return rows(rows(level, hl).T, wl).T.contiguous()

    frontend.resize_linear = resize_linear


def main() -> None:
    if sys.argv[1:2] == ["--run"]:
        install()
        import torch_sequence

        sys.argv = ["torch_sequence.py", *sys.argv[2:]]
        torch_sequence.main()
        return
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--levels", type=int, default=3,
                    help="levels of the per-level variants")
    print(json.dumps(measure(ap.parse_args().levels)))


if __name__ == "__main__":
    main()
