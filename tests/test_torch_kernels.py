"""The port's kernels: their plain PyTorch twins against the JAX package's
golden twins and Pallas kernels (interpret mode), and the CPU dispatch of
the wrappers.  Each kernel against its twin on a CUDA card is in
tests/test_torch_cuda.py.

Tolerances: ``fast_rank`` raw/rank at rtol 1e-5 / atol 1e-3 with identical
corner support (the bar of tests/test_ops_pallas.py); ``extract_patches``
bit-exact; ``describe_patches`` descriptors exact and angles at atol 1e-5
(the moments' summation order); ``fused_match_top2`` indices and masks
exact, matched distances exact.  The host side of the one-launch kernels
(tile grid, view offsets, pattern table, bit packing) is tested here too."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import _match_cases
import _torch_parity  # noqa: F401  (thread cap, TF32 off)
from boslam_tpu.config import CameraConfig
from boslam_tpu.features.frontend import (
    _BOOST_HI, _extract_patches_jnp, _fast_rank_maps, rgb_to_gray,
)
from boslam_tpu.features.frontend import orient_and_brief as j_orient_and_brief
from boslam_tpu.io import synthetic
from boslam_tpu.ops.frontend_pallas import extract_patches_pallas, fast_rank_pallas
from boslam_tpu.ops.hamming_pallas import fused_match_top2 as j_fused_match
from boslam_tpu_torch.features import frontend as t_frontend
from boslam_tpu_torch.ops import frontend_cuda as fc
from boslam_tpu_torch.ops import hamming_cuda as hc

RTOL, ATOL = 1e-5, 1e-3


def _frame():
    cam = CameraConfig(width=320, height=240, fx=260.0, fy=260.0,
                       cx=160.0, cy=120.0)
    rgb, _ = synthetic.render_frame(cam, np.array([1.0, 0, 0, 0, 0.1, -0.1, 0.2]))
    return rgb_to_gray(rgb).astype(np.float32)


@pytest.mark.parametrize("rows", [240, 230])
def test_fast_rank_plain_matches_jax(rows):
    gray = _frame()[:rows]
    rank_j, raw_j = _fast_rank_maps(jnp.asarray(gray), 20.0, 7.0, 17)
    rank_p, raw_p = fast_rank_pallas(jnp.asarray(gray), 20.0, 7.0, _BOOST_HI, 17,
                                     interpret=True)
    rank, raw = fc.fast_rank(torch.from_numpy(gray), 20.0, 7.0, _BOOST_HI, 17)
    assert rank.shape == (rows, 320)
    for ref_rank, ref_raw in ((rank_j, raw_j), (rank_p, raw_p)):
        ref_rank, ref_raw = np.asarray(ref_rank), np.asarray(ref_raw)
        np.testing.assert_array_equal(rank.numpy() > 0, ref_rank > 0)
        np.testing.assert_allclose(raw.numpy(), ref_raw, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(rank.numpy(), ref_rank, rtol=RTOL, atol=ATOL)


def test_fast_rank_plain_on_random_levels():
    """Integer-valued and fractional levels (the pyramid's), odd shapes."""
    rng = np.random.default_rng(3)
    for shape, frac in (((97, 131), False), ((64, 70), True)):
        lvl = rng.integers(0, 256, shape).astype(np.float32)
        if frac:
            lvl = lvl + rng.random(shape, dtype=np.float32)
        rank_j, raw_j = _fast_rank_maps(jnp.asarray(lvl), 20.0, 7.0, 17)
        rank, raw = fc.fast_rank_plain(torch.from_numpy(lvl), 20.0, 7.0,
                                       _BOOST_HI, 17)
        np.testing.assert_array_equal(raw.numpy(), np.asarray(raw_j))
        np.testing.assert_array_equal(rank.numpy(), np.asarray(rank_j))


def _cpu_pyramid():
    """Three levels, the last two with odd shapes."""
    gray = _frame()
    return [gray, np.ascontiguousarray(gray[:200, :267]),
            np.ascontiguousarray(gray[:97, :131])]


def test_fast_rank_levels_matches_jax():
    levels = _cpu_pyramid()
    maps = fc.fast_rank_levels([torch.from_numpy(l) for l in levels], 20.0, 7.0,
                               _BOOST_HI, 17)
    assert len(maps) == 3
    for lvl, (rank, raw) in zip(levels, maps):
        rank_j, raw_j = _fast_rank_maps(jnp.asarray(lvl), 20.0, 7.0, 17)
        rank_p, raw_p = fast_rank_pallas(jnp.asarray(lvl), 20.0, 7.0, _BOOST_HI,
                                         17, interpret=True)
        assert rank.shape == lvl.shape
        for ref_rank, ref_raw in ((rank_j, raw_j), (rank_p, raw_p)):
            ref_rank, ref_raw = np.asarray(ref_rank), np.asarray(ref_raw)
            np.testing.assert_array_equal(rank.numpy() > 0, ref_rank > 0)
            np.testing.assert_allclose(raw.numpy(), ref_raw, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(rank.numpy(), ref_rank, rtol=RTOL, atol=ATOL)


def test_describe_patches_matches_jax():
    """All levels' keypoints through the port's entry against the
    reference's gather -> orient_and_brief, level after level."""
    levels = _cpu_pyramid()
    rng = np.random.default_rng(4)
    ys = [rng.integers(-3, l.shape[0] + 3, 40).astype(np.int32) for l in levels]
    xs = [rng.integers(-3, l.shape[1] + 3, 40).astype(np.int32) for l in levels]
    patches = jnp.concatenate([
        _extract_patches_jnp(jnp.asarray(l), jnp.asarray(y), jnp.asarray(x))
        for l, y, x in zip(levels, ys, xs)])
    a_ref, d_ref = j_orient_and_brief(patches)
    a, d = fc.describe_patches([torch.from_numpy(l) for l in levels],
                               [torch.from_numpy(y) for y in ys],
                               [torch.from_numpy(x) for x in xs])
    assert a.shape == (120,) and d.shape == (120, 8) and d.dtype == torch.int32
    np.testing.assert_array_equal(d.numpy().view(np.uint32), np.asarray(d_ref))
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), rtol=0, atol=1e-5)


FULL_SHAPES = [(480, 640), (400, 533), (333, 444), (278, 370), (231, 309),
               (193, 257), (161, 214), (134, 179)]


@pytest.mark.parametrize("shapes", [FULL_SHAPES, [(97, 131), (35, 35), (64, 70)],
                                    [(480, 640)], [(35, 61)] * 16])
def test_fast_tile_grid_covers_each_level_once(shapes):
    """The kernel's own arithmetic on the host's table: every tile index
    belongs to exactly one level and tile, and the tiles cover each level."""
    tiles, n_tiles = fc.fast_tiles(shapes)
    tw, th = fc.FAST_TILE
    covered = [np.zeros(s, np.int32) for s in shapes]
    for bid in range(n_tiles):
        l = 0
        while l + 1 < len(tiles) and bid >= tiles[l + 1][0]:
            l += 1
        tile0, tx, ty = tiles[l]
        t_idx = bid - tile0
        assert 0 <= t_idx < tx * ty
        y0, x0 = (t_idx // tx) * th, (t_idx % tx) * tw
        assert y0 < shapes[l][0] and x0 < shapes[l][1]
        covered[l][y0:y0 + th, x0:x0 + tw] += 1
    assert all((c == 1).all() for c in covered)
    if shapes is FULL_SHAPES:
        assert n_tiles == 1143


def test_host_and_kernel_agree_on_the_fast_tile():
    """The host lays the grid out for the tile the source is written for."""
    import re

    import pathlib

    src = (pathlib.Path(fc.__file__).parents[1] / "csrc"
           / fc.KERNELS["fast_rank"][0]).read_text()
    tile = tuple(int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
                 for n in ("OX", "OY"))
    assert tile == fc.FAST_TILE


def test_output_views_are_16_byte_aligned():
    sizes = [h * w for h, w in FULL_SHAPES] * 2 + [35 * 35, 1, 3]
    offs, total = fc.view_offsets(sizes)
    assert all(o % 4 == 0 for o in offs) and total % 4 == 0
    ends = [o + n for o, n in zip(offs, sizes)]
    assert all(e <= o for e, o in zip(ends, offs[1:])) and ends[-1] <= total
    assert total - sum(sizes) < 4 * len(sizes)
    assert fc.view_offsets([111, 93, 0, 31], align=1) == ([0, 111, 204, 204], 235)


def test_level_tables_as_the_c_entries_receive_them(monkeypatch):
    """The launch path up to the C call, with the entry points replaced by
    readers of the by-value tables: pointers, shapes, tile and keypoint
    offsets are what the views and inputs say."""
    import ctypes
    from unittest import mock

    seen = {}

    def fast_entry(table, *rest):
        t = ctypes.cast(table, ctypes.POINTER(fc._FastTable)).contents
        seen["fast"] = (t.n, t.n_tiles), [
            (v.img, v.rank, v.raw, v.h, v.w, v.tile0, v.tiles_x)
            for v in t.lv[:t.n]], rest[:4]
        return 0

    def patch_entry(table, brief, angle, desc, patches, stream):
        t = ctypes.cast(table, ctypes.POINTER(fc._PatchTable)).contents
        seen["patch"] = (t.n, t.n_kp), [
            (v.img, v.ys, v.xs, v.h, v.w, v.k0) for v in t.lv[:t.n]], patches
        return 0

    levels = [torch.zeros(97, 131), torch.zeros(35, 37)]
    before = dict(fc.LAUNCHES)
    monkeypatch.setattr(fc, "kernel_fn", lambda name: {
        "fast_rank": fast_entry, "extract_patches": patch_entry}[name])
    with mock.patch("torch.cuda.device"), mock.patch("torch.cuda.current_stream"):
        maps = fc._launch_fast_rank(levels, 20.0, 7.0, 2.0, 17)
        ys = [torch.zeros(5, dtype=torch.int32), torch.zeros(3, dtype=torch.int32)]
        angle, desc, patches = fc._launch_describe(levels, ys, ys, False)
    monkeypatch.setitem(fc.LAUNCHES, "fast_rank", before["fast_rank"])
    monkeypatch.setitem(fc.LAUNCHES, "extract_patches", before["extract_patches"])

    head, rows, scalars = seen["fast"]
    assert head == (2, 5 * 4 + 2 * 2) and scalars == (20.0, 7.0, 2.0, 17)
    for lvl, (rank, raw), row, tile0 in zip(levels, maps, rows, (0, 20)):
        assert row == (lvl.data_ptr(), rank.data_ptr(), raw.data_ptr(),
                       *lvl.shape, tile0, -(-lvl.shape[1] // 30))
        assert rank.shape == lvl.shape and rank.is_contiguous()
        assert rank.data_ptr() % 16 == 0 and raw.data_ptr() % 16 == 0
    head, rows, patches_ptr = seen["patch"]
    assert head == (2, 8) and patches_ptr is None and patches is None
    assert angle.shape == (8,) and desc.shape == (8, 8)
    for lvl, y, row, k0 in zip(levels, ys, rows, (0, 5)):
        assert row == (lvl.data_ptr(), y.data_ptr(), y.data_ptr(), *lvl.shape, k0)


def test_describe_report_holds_the_plain_twin_and_catches_a_flipped_bit():
    """The contract the card holds the fused kernel to, on the CPU: the
    plain twin meets it; a descriptor bit flipped at an equal bin, or an
    angle moved by a whole bin, does not."""
    levels = [torch.from_numpy(l) for l in _cpu_pyramid()]
    rng = np.random.default_rng(6)
    ys = [torch.from_numpy(rng.integers(0, l.shape[0], 30).astype(np.int32))
          for l in levels]
    xs = [torch.from_numpy(rng.integers(0, l.shape[1], 30).astype(np.int32))
          for l in levels]
    angle, desc = fc.describe_patches(levels, ys, xs)
    report = fc.describe_report(levels, ys, xs, angle, desc)
    assert report["keypoints"] == 90 and not report["violations"]
    assert report["max_angle_err"] == 0.0
    assert report["bins_differ_at_edge"] == report["bins_differ_ill_conditioned"] == 0
    flipped = desc.clone()
    flipped[7, 3] ^= 1
    assert fc.describe_report(levels, ys, xs, angle, flipped)["violations"]
    turned = angle.clone()
    turned[5] += 2.0 * np.pi / t_frontend.N_ANGLE_BINS
    assert len(fc.describe_report(levels, ys, xs, turned, desc)["violations"]) == 2


def test_brief_table_is_the_package_pattern_in_uint16():
    tab = fc.brief_table_np()
    assert tab.dtype == np.uint16 and tab.shape == (t_frontend.N_ANGLE_BINS, 512)
    assert tab.max() < fc.PATCH * fc.PATCH
    np.testing.assert_array_equal(tab.astype(np.int64),
                                  t_frontend._brief_index_np())
    on_device = fc._brief_table(torch.device("cpu"))
    assert on_device.dtype == torch.int16
    np.testing.assert_array_equal(on_device.numpy().view(np.uint16), tab)


def test_warp_ballot_packing_is_pack_words():
    """The kernel's packing: thread p makes bit p, a ballot per warp of 32
    puts lane i into bit i of word p // 32.  Emulated in numpy."""
    rng = np.random.default_rng(5)
    bits = rng.random((37, 256)) < 0.5
    bits[0], bits[1] = True, False
    lanes = np.uint64(1) << np.arange(32, dtype=np.uint64)
    ballot = (bits.reshape(-1, 8, 32) * lanes).sum(-1).astype(np.uint32)
    packed = t_frontend.pack_words(torch.from_numpy(bits))
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), ballot)


def test_extract_patches_plain_matches_jax():
    gray = _frame()
    rng = np.random.default_rng(0)
    # Include coordinates the clip moves: the border and beyond.
    ys = np.concatenate([rng.integers(17, 240 - 17, size=60), [0, 5, 239, 230]])
    xs = np.concatenate([rng.integers(17, 320 - 17, size=60), [319, 2, 0, 310]])
    ys, xs = ys.astype(np.int32), xs.astype(np.int32)
    ref = np.asarray(_extract_patches_jnp(jnp.asarray(gray), jnp.asarray(ys),
                                          jnp.asarray(xs)))
    pal = np.asarray(extract_patches_pallas(jnp.asarray(gray), jnp.asarray(ys),
                                            jnp.asarray(xs), interpret=True))
    out = fc.extract_patches(torch.from_numpy(gray), torch.from_numpy(ys),
                             torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, pal)


def test_cpu_tensors_take_the_plain_path():
    """A CPU tensor never reaches a kernel: the launch counters stay put."""
    before = dict(fc.LAUNCHES)
    gray = torch.from_numpy(_frame())
    fc.fast_rank(gray, 20.0, 7.0, _BOOST_HI, 17)
    idx = torch.full((4,), 40, dtype=torch.int32)
    fc.extract_patches(gray, idx, idx)
    fc.fast_rank_levels([gray, gray[:100]], 20.0, 7.0, _BOOST_HI, 17)
    fc.describe_patches([gray, gray], [idx, idx], [idx, idx])
    assert fc.LAUNCHES == before


def test_wrappers_reject_bad_inputs():
    gray = torch.from_numpy(_frame())
    with pytest.raises(ValueError):
        fc.fast_rank(gray.double(), 20.0, 7.0, _BOOST_HI, 17)
    with pytest.raises(ValueError):
        fc.fast_rank(gray.t(), 20.0, 7.0, _BOOST_HI, 17)  # not contiguous
    idx = torch.full((4,), 40, dtype=torch.int64)
    with pytest.raises(ValueError):
        fc.extract_patches(gray, idx, idx)
    small = torch.zeros((16, 16))
    idx32 = idx.to(torch.int32)
    with pytest.raises(ValueError):
        fc.extract_patches(small, idx32, idx32)


def test_level_entries_reject_bad_inputs():
    gray = torch.from_numpy(_frame())
    idx = torch.full((4,), 40, dtype=torch.int32)
    elsewhere = torch.empty_like(gray, device="meta")
    args = (20.0, 7.0, _BOOST_HI, 17)
    for levels in ([gray, elsewhere],            # mixed devices
                   [gray, gray.double()],        # wrong type
                   [gray, gray.t()],             # not contiguous
                   [gray] * (fc.MAX_LEVELS + 1),  # more than the table holds
                   [],
                   [gray, gray[:34]]):           # no pixel inside the border
        with pytest.raises(ValueError):
            fc.fast_rank_levels(levels, *args)
    n = fc.MAX_LEVELS + 1
    for imgs, ys, xs in (([gray, elsewhere], [idx, idx], [idx, idx]),
                         ([gray], [idx.to("meta")], [idx]),
                         ([gray.double()], [idx], [idx]),
                         ([gray], [idx.long()], [idx.long()]),
                         ([gray], [idx], [idx[:3]]),
                         ([gray, gray], [idx], [idx]),
                         ([gray[:20]], [idx], [idx]),
                         ([gray] * n, [idx] * n, [idx] * n)):
        with pytest.raises(ValueError):
            fc.describe_patches(imgs, ys, xs)


def _match_problem(rng, n=128, m=512, img=(640.0, 480.0)):
    """The random windowed problem of tests/test_ops_pallas.py: map
    descriptors a quarter of which are copies of frame descriptors placed
    3 px from their keypoints."""
    desc_a = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    desc_b = rng.integers(0, 2**32, size=(m, 8), dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(0, n, size=m // 4)
    desc_b[: m // 4] = desc_a[idx]
    uv_a = rng.uniform(0, img, size=(n, 2)).astype(np.float32)
    uv_b = rng.uniform(0, img, size=(m, 2)).astype(np.float32)
    uv_b[: m // 4] = uv_a[idx] + 3.0
    r_a = rng.uniform(8.0, 40.0, size=(n,)).astype(np.float32)
    return [desc_a, uv_a, r_a, rng.random(n) < 0.9, desc_b, uv_b, rng.random(m) < 0.8]


def _match_both(prob, **kw):
    ref = j_fused_match(*(jnp.asarray(a) for a in prob), m_tile=128,
                        interpret=True, **kw)
    got = hc.fused_match_top2(*(torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                                 else a) for a in prob), **kw)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize("ratio", [1.0, 0.9])
def test_fused_match_twin_matches_pallas(mutual, ratio):
    ref, got = _match_both(_match_problem(np.random.default_rng(0)),
                           max_dist=64, ratio=ratio, mutual=mutual)
    assert ref[1].sum() > 10
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[2][ref[1]], ref[2][ref[1]])


def test_fused_match_twin_infinite_radius():
    """r = inf, the relocalization call: a plain brute-force match."""
    prob = _match_problem(np.random.default_rng(1))
    prob[2] = np.full_like(prob[2], np.inf)
    ref, got = _match_both(prob, max_dist=80, ratio=0.95, mutual=True)
    assert ref[1].sum() > 10
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[0], ref[0])


@pytest.mark.parametrize("setting", _match_cases.SETTINGS,
                         ids=lambda s: f"mutual{int(s['mutual'])}-ratio{s['ratio']}")
@pytest.mark.parametrize("name", list(_match_cases.CASES))
def test_fused_match_twin_matches_pallas_on_edge_cases(name, setting):
    """A sparse map (whole tiles without a visible column), a map with none
    visible, ties within and across tiles and between frame rows, and edges
    (distance 256, max_dist at a distance's exact value, N = 37)."""
    prob, max_dist = _match_cases.case(name)
    ref, got = _match_both(prob, max_dist=max_dist, **setting)
    _match_cases.expect(name, *ref, **setting)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[2][ref[1]], ref[2][ref[1]])


def test_fused_match_cpu_takes_the_twin_and_checks_inputs():
    prob = [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
            for a in _match_problem(np.random.default_rng(2), n=16, m=64)]
    before = dict(fc.LAUNCHES)
    hc.fused_match_top2(*prob, max_dist=64)
    assert fc.LAUNCHES == before and hc.LAUNCHES is fc.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        hc.fused_match_top2(*(t.to("meta") for t in prob), max_dist=64)


@pytest.mark.parametrize("n,m", [(512, 65536), (37, 256), (1, 1), (513, 65459)])
def test_fused_match_workspace_layout(n, m):
    """One allocation holds the kernel's scratch and the three outputs:
    regions aligned, disjoint, of the sizes the kernel indexes."""
    layout, total = hc.workspace_layout(n, m)
    tiles, chunks = -(-m // hc.TILE), -(-n // hc.ROWS)
    assert {k: s for k, (_, s) in layout.items()} == {
        "rowpart": 8 * tiles * n, "colpart": 4 * chunks * m,
        "live": 4 * tiles, "idx": 4 * n, "dist": 4 * n, "ok": n}
    spans = sorted(layout.values())
    assert all(off % 16 == 0 for off, _ in spans)
    assert all(a + s <= b for (a, s), (b, _) in zip(spans, spans[1:]))
    assert spans[-1][0] + spans[-1][1] <= total < spans[-1][0] + spans[-1][1] + 16


def test_kernel_build_is_keyed_by_source():
    """Each source builds into its own library under build/, named by a
    hash of source and flags, so a stale build is never loaded."""
    paths = {name: fc._lib_path(name) for name in fc.KERNELS}
    assert len(set(paths.values())) == len(fc.KERNELS)
    for name, p in paths.items():
        assert p.parent == fc.BUILD_DIR and p.name.startswith(f"lib{name}.")
    assert "arch=compute_90a,code=sm_90a" in fc.NVCC_FLAGS
    sources = {name: src for name, (src, _, _) in fc.KERNELS.items()}
    assert sources == {"fast_rank": "fast_rank.cu",
                       "extract_patches": "describe_patches.cu",
                       "fused_match": "fused_match.cu",
                       "pose_gn": "pose_gn.cu"}
    # The empty kernel is not counted; local BA's graph replays and captures
    # are (``solvers.local_ba.SolveGraph``).
    assert set(fc.LAUNCHES) == set(fc.KERNELS) | {"local_ba_graph",
                                                  "local_ba_capture"}
