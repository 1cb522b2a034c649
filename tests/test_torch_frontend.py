"""Frontend parity of the port against the JAX package.

* Given the JAX pyramid (rebuilt with ``jax.image.resize`` as the reference
  builds it), ``extract_features_from_levels`` gives identical valid /
  octave / has_depth / descriptor bits, with uv, angle and xyz within
  atol 1e-4 (summation order moves the moments by ~1e-7).
* On its own pyramid the port's resize differs from JAX's by float rounding
  only, so the whole ``extract_features`` is held by repeatability: >= 95%
  of JAX's valid keypoints found at the same octave within 0.05 px with an
  identical descriptor.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as tp
from boslam_tpu.features import extract_features as jax_extract
from boslam_tpu.features.frontend import orient_and_brief as jax_orient
from boslam_tpu_torch.features import frontend


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_levels(gray, cfg):
    shapes = frontend.pyramid_shapes(cfg.camera.height, cfg.camera.width,
                                     cfg.orb.n_levels, cfg.orb.scale_factor)
    levels = [gray]
    for hl, wl in shapes[1:]:
        levels.append(jax.image.resize(levels[-1], (hl, wl), "linear"))
    return levels


@pytest.fixture(scope="module")
def frames():
    cfg_j, cfg_t = tp.configs(tp.E2E)
    _, fr = tp.orbit_frames(cfg_t.camera, 6, depth_noise=0.01, seed=1)
    out = []
    for i in (0, 5):
        _, _, gray, depth = tp.wire(cfg_t, fr[i][1], fr[i][2])
        out.append((gray, depth))
    return cfg_j, cfg_t, out


def _valid(f):
    return np.asarray(f.valid)


def test_features_from_jax_levels_match(frames):
    cfg_j, cfg_t, data = frames
    for gray, depth in data:
        ref = jax_extract(jnp.asarray(gray), jnp.asarray(depth), cfg_j)
        levels = [torch.from_numpy(np.array(l))
                  for l in _jax_levels(jnp.asarray(gray), cfg_j)]
        got = frontend.extract_features_from_levels(
            levels, torch.from_numpy(depth), cfg_t)
        for k in ("valid", "octave", "has_depth"):
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(ref, k)), err_msg=k)
        v = _valid(ref)
        assert v.sum() > 200
        np.testing.assert_array_equal(got.desc.numpy().view(np.uint32)[v],
                                      np.asarray(ref.desc)[v])
        for k in ("uv", "angle", "xyz", "depth", "response"):
            np.testing.assert_allclose(getattr(got, k).numpy()[v],
                                       np.asarray(getattr(ref, k))[v],
                                       rtol=0, atol=1e-4, err_msg=k)


def test_frontend_takes_one_call_of_each_kernel_entry(frames, monkeypatch):
    """A frame goes through ``fast_rank_levels`` once (every level) and
    ``describe_patches`` once (every keypoint), and through no per-level
    entry."""
    from boslam_tpu_torch.ops import frontend_cuda as fc

    _, cfg_t, data = frames
    calls = []

    def counted(name):
        fn = getattr(fc, name)

        def wrapper(*a, **k):
            calls.append((name, len(a[0])))
            return fn(*a, **k)
        return wrapper

    def refuse(*a, **k):
        raise AssertionError("a per-level entry on the frame path")

    for name in ("fast_rank_levels", "describe_patches"):
        monkeypatch.setattr(fc, name, counted(name))
    for name in ("fast_rank", "extract_patches"):
        monkeypatch.setattr(fc, name, refuse)
    gray, depth = data[0]
    got = frontend.extract_features(torch.from_numpy(gray),
                                    torch.from_numpy(depth), cfg_t)
    n = cfg_t.orb.n_levels
    assert calls == [("fast_rank_levels", n), ("describe_patches", n)]
    assert got.desc.shape == (cfg_t.orb.n_features, 8)
    assert got.angle.shape == (cfg_t.orb.n_features,)


def test_extract_features_repeatability(frames):
    cfg_j, cfg_t, data = frames
    for gray, depth in data:
        ref = jax_extract(jnp.asarray(gray), jnp.asarray(depth), cfg_j)
        got = frontend.extract_features(torch.from_numpy(gray),
                                        torch.from_numpy(depth), cfg_t)
        rv, gv = _valid(ref), got.valid.numpy()
        r_uv, g_uv = np.asarray(ref.uv), got.uv.numpy()
        r_oct, g_oct = np.asarray(ref.octave), got.octave.numpy()
        r_desc, g_desc = np.asarray(ref.desc), got.desc.numpy().view(np.uint32)
        found = 0
        for i in np.flatnonzero(rv):
            cand = gv & (g_oct == r_oct[i]) & (
                np.linalg.norm(g_uv - r_uv[i], axis=1) <= 0.05)
            found += bool(np.any(np.all(g_desc[cand] == r_desc[i], axis=1)))
        assert found >= 0.95 * rv.sum(), (found, rv.sum())


def test_resize_replica_close_to_jax():
    """The port's antialiased resize repeats jax.image.resize's weights
    (including their fused multiply-add rounding); what is left is the
    matrix products' summation order."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (240, 320)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x: jax.image.resize(x, (200, 267), "linear"))(
        jnp.asarray(img)))
    got = frontend.resize_linear(torch.from_numpy(img), 200, 267).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


# Pixels of the port's pyramid that differ from the reference's, and the
# largest difference in ulps, at levels 0-7 of frame 0 of ``orbit`` and frame
# 24 of ``loop`` (tools/sequences.py).  The reference's XLA CPU dot splits its
# sums into blocks and kernels that no summation order of the port's
# reproduces, and its compiled weights round differently from any numpy
# replica tried, so the pyramids are not bit-equal (ROADMAP C1 lists the
# variants tried and their counts); these counts, the port's at the time,
# are the bound it must stay under.
PYRAMID_DIFF_BOUND = {
    ("orbit", 0): [(0, 0), (90888, 5), (85851, 6), (61334, 6), (44270, 43),
                   (33271, 51), (24407, 36), (17387, 24)],
    ("loop", 24): [(0, 0), (89896, 6), (85003, 6), (60379, 6), (43495, 46),
                   (32932, 48), (24159, 54), (17179, 41)],
}


@pytest.mark.parametrize("name,index", sorted(PYRAMID_DIFF_BOUND))
def test_pyramid_against_jax_image_resize(name, index):
    """``build_pyramid`` against the reference's pyramid (``jax.image.resize``
    compiled for the CPU) at all 8 levels of a full-width frame: the count of
    differing pixels and the largest ulp difference stay within the bound."""
    import sys

    sys.path.insert(0, str(tp.ROOT / "tools"))
    import sequences
    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.io import synthetic
    from boslam_tpu_torch.slam import to_gray_u8

    cfg, _, fr = sequences.build(name, SlamConfig, synthetic,
                                 n_frames=index + 1)
    gray = to_gray_u8(fr[index][1]).astype(np.float32)
    cfg_j, _ = tp.configs(sequences.SEQUENCES[name]["cfg"])
    ref = [np.asarray(l) for l in _jax_levels(jnp.asarray(gray), cfg_j)]
    got = frontend.build_pyramid(torch.from_numpy(gray), cfg)
    assert len(got) == len(ref) == 8
    counts = []
    for a, b in zip(got, ref):
        a = a.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        ulp = np.abs(a.view(np.int32).astype(np.int64)
                     - b.view(np.int32).astype(np.int64))
        counts.append((int((ulp > 0).sum()), int(ulp.max())))
    for lvl, ((n, u), (n_max, u_max)) in enumerate(
            zip(counts, PYRAMID_DIFF_BOUND[(name, index)])):
        assert n <= n_max and u <= u_max, (lvl, counts)


def test_orient_and_brief_matches_jax():
    """Descriptor sampling by gather equals the reference's one-hot einsums
    (exact selections); angles agree to float rounding."""
    rng = np.random.default_rng(1)
    patches = (rng.random((128, 32, 32), dtype=np.float32) * 255).round()
    a_ref, d_ref = jax_orient(jnp.asarray(patches))
    a, d = frontend.orient_and_brief(torch.from_numpy(patches))
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(d.numpy().view(np.uint32), np.asarray(d_ref))


def test_rgb_to_gray_matches_jax():
    from boslam_tpu.features.frontend import rgb_to_gray as jax_gray

    rgb = np.random.default_rng(4).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    got = frontend.rgb_to_gray(rgb)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_gray(rgb))


def test_grid_select_ties_match_jax():
    """Integer ranks tie everywhere; the stable-sort top-k must pick JAX's
    indices (torch.topk does not)."""
    from boslam_tpu.features.frontend import _grid_select as jax_grid

    rng = np.random.default_rng(2)
    rank = rng.integers(0, 4, (120, 160)).astype(np.float32) * 7.0
    ys_j, xs_j, top_j = jax_grid(jnp.asarray(rank), 50, 8, 8)
    ys, xs, top = frontend._grid_select(torch.from_numpy(rank), 50, 8, 8)
    np.testing.assert_array_equal(ys.numpy(), np.asarray(ys_j))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(xs_j))
    np.testing.assert_array_equal(top.numpy(), np.asarray(top_j))


def test_depth_lookup_with_wire_stride():
    """depth_wire_stride > 1: each keypoint reads its own block's sample."""
    import dataclasses

    cfg_j, cfg_t = tp.configs(dict(tp.E2E, camera=dict(tp.CAM, depth_wire_stride=4)))
    _, fr = tp.orbit_frames(cfg_t.camera, 1)
    _, _, gray, depth = tp.wire(cfg_t, fr[0][1], fr[0][2])
    assert depth.shape == cfg_t.camera.depth_wire_shape
    ref = jax_extract(jnp.asarray(gray), jnp.asarray(depth), cfg_j)
    levels = [torch.from_numpy(np.array(l))
              for l in _jax_levels(jnp.asarray(gray), cfg_j)]
    got = frontend.extract_features_from_levels(levels, torch.from_numpy(depth),
                                                cfg_t)
    np.testing.assert_array_equal(got.has_depth.numpy(), np.asarray(ref.has_depth))
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth), atol=1e-6)
    assert dataclasses.asdict(cfg_t.camera) == dataclasses.asdict(cfg_j.camera)
