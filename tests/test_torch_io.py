"""The port's dataset IO against the JAX package's: the ICL-NUIM loader on
both layouts, groundtruth discovery, the native runtime (bit-equal decode,
prefetch order, size check), ``tum.sequence(native=...)``, the PNG header
read, and the CLI's ``--icl``, ``--config`` and ``--no-native-loader``."""

import json

import numpy as np
import pytest

import _torch_parity as tp
from boslam_tpu_torch.io import icl_nuim, tum
from boslam_tpu_torch.runtime import native

cv2 = pytest.importorskip("cv2")

W, H = 128, 96


def _assert_frames_equal(got, want):
    assert len(got) == len(want) > 0
    for (ts_a, img_a, d_a), (ts_b, img_b, d_b) in zip(got, want):
        assert ts_a == ts_b
        assert img_a.dtype == img_b.dtype
        np.testing.assert_array_equal(img_a, img_b)
        np.testing.assert_array_equal(d_a, d_b)


@pytest.fixture(scope="module")
def png_pairs(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    rgbs, deps = [], []
    for i in range(6):
        rgb = rng.integers(0, 256, (H, W, 3), np.uint8)
        dep = rng.integers(0, 30000, (H, W)).astype(np.uint16)
        rgbs.append(str(d / f"rgb{i}.png"))
        deps.append(str(d / f"d{i}.png"))
        cv2.imwrite(rgbs[-1], rgb[:, :, ::-1])
        cv2.imwrite(deps[-1], dep)
    return rgbs, deps


def test_native_decode_is_bit_equal_to_jax(png_pairs):
    from boslam_tpu.runtime import native as j_native

    assert native.available(), "native runtime failed to build"
    assert native.lib_path().parent == native.BUILD_DIR
    rgbs, deps = png_pairs
    for r, d in zip(rgbs, deps):
        got = native.decode_frame(r, d, W, H)
        want = j_native.decode_frame(r, d, W, H)
        for a, b in zip(got, want):
            assert a.dtype == np.float32 and a.shape == (H, W)
            np.testing.assert_array_equal(a, b)
    # Against cv2, as tests/test_native_runtime.py holds the JAX decoder.
    gray, depth = native.decode_frame(rgbs[0], deps[0], W, H)
    rgb = cv2.imread(rgbs[0], cv2.IMREAD_COLOR)[:, :, ::-1].astype(np.float32)
    np.testing.assert_allclose(
        gray, 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2],
        atol=0.51)
    np.testing.assert_allclose(
        depth, cv2.imread(deps[0], cv2.IMREAD_UNCHANGED) / np.float32(5000.0),
        atol=1e-6)


def test_native_prefetch_keeps_order(png_pairs):
    rgbs, deps = png_pairs
    loader = native.NativeLoader(rgbs, deps, W, H, n_threads=3, capacity=3)
    frames = list(loader)
    loader.close()
    assert len(frames) == 6
    for i, (gray, depth) in enumerate(frames):
        want = native.decode_frame(rgbs[i], deps[i], W, H)
        np.testing.assert_array_equal(gray, want[0])
        np.testing.assert_array_equal(depth, want[1])


def test_native_decode_rejects_wrong_size(png_pairs):
    rgbs, deps = png_pairs
    assert native.decode_frame(rgbs[0], deps[0], W + 2, H) is None
    assert native.decode_frame(rgbs[0], deps[0], W, H - 1) is None
    assert tum.png_size(rgbs[0]) == (W, H)
    with pytest.raises(ValueError, match="not a PNG"):
        tum.png_size(__file__)


def test_tum_sequence_native_matches_jax():
    """``native=True`` yields the JAX package's native frames (gray f32),
    ``native=False`` its cv2 frames (rgb u8), and ``None`` the native ones
    when the library loads."""
    from boslam_tpu.io import tum as j_tum

    root = str(tp.TUM_MINI)
    _assert_frames_equal(list(tum.sequence(root, native=True, limit=4)),
                         list(j_tum.sequence(root, native=True, limit=4)))
    _assert_frames_equal(list(tum.sequence(root, native=False)),
                         list(j_tum.sequence(root, native=False)))
    auto = list(tum.sequence(root, native=None, limit=2))
    assert auto[0][1].dtype == np.float32 and auto[0][1].ndim == 2


def test_native_required_raises_when_unavailable(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="unavailable"):
        next(tum.sequence(str(tp.TUM_MINI), native=True))
    # Auto falls back to cv2.
    ts, rgb, depth = next(tum.sequence(str(tp.TUM_MINI), native=None))
    assert rgb.dtype == np.uint8 and rgb.ndim == 3


def _icl_raw(root, frames):
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    for i, (_, rgb, depth) in enumerate(frames):
        cv2.imwrite(str(root / "rgb" / f"{i}.png"), rgb[:, :, ::-1])
        cv2.imwrite(str(root / "depth" / f"{i}.png"),
                    np.rint(depth * 5000.0).astype(np.uint16))


def _random_frames(rng, n):
    return [(0.0, rng.integers(0, 255, (48, 64, 3), dtype=np.uint8),
             rng.uniform(0.5, 3.0, (48, 64)).astype(np.float32))
            for _ in range(n)]


def test_icl_nuim_layouts_match_jax(tmp_path):
    """Both layouts give the JAX loader's frames, with either decoder; the
    groundtruth file is found as the JAX loader finds it."""
    from boslam_tpu.io import icl_nuim as j_icl

    rng = np.random.default_rng(0)
    raw = tmp_path / "icl_raw"
    _icl_raw(raw, _random_frames(rng, 3))
    for nat in (False, True):
        _assert_frames_equal(
            list(icl_nuim.sequence(str(raw), limit=2, native=nat)),
            list(j_icl.sequence(str(raw), limit=2, native=nat)))
    ts, rgb, depth = next(icl_nuim.sequence(str(raw)))
    assert rgb.shape == (48, 64, 3) and 0.4 < depth.mean() < 3.1

    (raw / "livingroom.gt.freiburg").write_text(
        "0 0.1 0.2 0.3 0 0 0 1\n1 0.2 0.2 0.3 0 0 0 1\n")
    assert icl_nuim.groundtruth_path(str(raw)) == j_icl.groundtruth_path(str(raw))
    for a, b in zip(icl_nuim.read_groundtruth(str(raw)),
                    j_icl.read_groundtruth(str(raw))):
        np.testing.assert_array_equal(a, b)
    assert icl_nuim.read_groundtruth(str(raw))[1][0][4] == 0.1

    flat = tmp_path / "icl_tum"
    (flat / "rgb").mkdir(parents=True)
    (flat / "depth").mkdir()
    with open(flat / "rgb.txt", "w") as fr, open(flat / "depth.txt", "w") as fd:
        for i, (_, rgb, depth) in enumerate(_random_frames(rng, 2)):
            cv2.imwrite(str(flat / "rgb" / f"{i}.png"), rgb)
            cv2.imwrite(str(flat / "depth" / f"{i}.png"),
                        (depth * 5000).astype(np.uint16))
            fr.write(f"{i * 0.05:.2f} rgb/{i}.png\n")
            fd.write(f"{i * 0.05:.2f} depth/{i}.png\n")
    for nat in (False, True):
        _assert_frames_equal(list(icl_nuim.sequence(str(flat), native=nat)),
                             list(j_icl.sequence(str(flat), native=nat)))
    with pytest.raises(OSError, match="neither"):
        list(icl_nuim.sequence(str(tmp_path)))


def test_cli_icl_with_config(tmp_path):
    """``--icl DIR --config cfg.yaml`` (the ICL preset with the camera
    section overridden to the fixture's 160x120) on a raw-layout sequence
    rendered from the orbit, with its ``.gt.freiburg``: six poses, no lost
    frame, ATE < 5 cm, with the native decoder and with
    ``--no-native-loader``."""
    from boslam_tpu_torch.config import SlamConfig
    from boslam_tpu_torch.io import synthetic

    cam = tp.TUM_MINI_CAM
    cfg = SlamConfig.from_dict({"camera": cam})
    traj = synthetic.orbit_trajectory(6, radius=0.3)
    root = tmp_path / "icl"
    _icl_raw(root, synthetic.render_sequence(cfg.camera, traj))
    with open(root / "office.gt.freiburg", "w") as f:
        for i, (qw, qx, qy, qz, tx, ty, tz) in enumerate(traj.poses_twc):
            f.write(f"{i / 30.0} {tx} {ty} {tz} {qx} {qy} {qz} {qw}\n")
    yml = tmp_path / "cfg.yaml"
    yml.write_text("camera:\n" + "".join(f"  {k}: {v}\n" for k, v in cam.items()))
    for extra in ((), ("--no-native-loader",)):
        res = tp.run_cli("--icl", root, "--config", yml, "--device", "cpu",
                         "--out", tmp_path / "t.txt", *extra)
        summary = json.loads(res.stdout.strip().splitlines()[-1])
        assert summary["frames"] == 6 and summary["lost"] == 0, extra
        assert summary["ate_rmse_m"] < 0.05, (extra, summary)
