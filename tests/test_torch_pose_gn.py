"""The ``pose_gn`` kernel's host side on the CPU: ``optimize_pose``'s
dispatch (the plain version for CPU tensors, exactly), the wrapper's
checks, the batch strides it hands the kernel, and the argument struct
against the kernel's source.  The kernel against the plain version on a
CUDA card is in tests/test_torch_cuda.py."""

import ctypes
import re

import pytest
import torch

import _pose_cases
from boslam_tpu_torch.ops import build
from boslam_tpu_torch.ops import pose_cuda as pc
from boslam_tpu_torch.solvers import pose_opt


@pytest.mark.parametrize("name", sorted(_pose_cases.CASES))
def test_optimize_pose_on_cpu_is_the_plain_version(name):
    cfg, args, kwargs = _pose_cases.problem(name, seed=3)
    before = dict(build.LAUNCHES)
    got = pose_opt.optimize_pose(cfg, *args, **kwargs)
    ref = pose_opt.optimize_pose_plain(cfg, *args, **kwargs)
    assert build.LAUNCHES == before
    for field in ref._fields:
        torch.testing.assert_close(getattr(got, field), getattr(ref, field),
                                   rtol=0, atol=0, equal_nan=True)
    lead = args[0].shape[:-1]
    assert got.pose.shape == lead + (7,) and got.chi2.shape == lead


def _bad(name):
    """A case's CPU inputs with one fault planted, and the message."""
    cfg, args, kw = _pose_cases.problem("reloc", seed=1)
    pose0, pts, uv, depth, hd, ok = args
    if name == "pts_float64":
        return cfg, (pose0, pts.double(), uv, depth, hd, ok), kw, "float32"
    if name == "mask_uint8":
        return cfg, (pose0, pts, uv, depth, hd, ok.to(torch.uint8)), kw, "bool"
    if name == "octave_int64":
        return cfg, args, dict(kw, octave=kw["octave"].long()), "int32"
    if name == "uv_width":
        return cfg, (pose0, pts, torch.zeros(uv.shape[:-1] + (3,)), depth, hd,
                     ok), kw, "end in"
    if name == "edge_count":
        return cfg, (pose0, pts, uv, depth[:-1], hd, ok), kw, "end in"
    if name == "batch":
        return cfg, (pose0[:3], pts, uv, depth, hd, ok), kw, "broadcast"
    if name == "too_many_edges":
        n = pc.MAX_EDGES + 1
        return cfg, (pose0[0], torch.zeros(n, 3), torch.zeros(n, 2),
                     torch.zeros(n), torch.zeros(n, dtype=torch.bool),
                     torch.zeros(n, dtype=torch.bool)), {}, "at most"
    if name == "mixed_devices":
        return cfg, (pose0, pts, uv.to("meta"), depth, hd, ok), kw, "is on"
    if name == "cpu":
        return cfg, args, kw, "needs CUDA"
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "pts_float64", "mask_uint8", "octave_int64", "uv_width", "edge_count",
    "batch", "too_many_edges", "mixed_devices", "cpu"])
def test_pose_gn_refuses_what_the_kernel_does_not_take(name):
    cfg, args, kwargs, message = _bad(name)
    before = dict(build.LAUNCHES)
    with pytest.raises(ValueError, match=message):
        pc.pose_gn(cfg, *args, **kwargs)
    assert build.LAUNCHES == before


def test_pose_gn_reads_broadcast_inputs_through_a_zero_stride():
    cfg, (pose0, pts, uv, depth, hd, ok), kw = _pose_cases.problem("reloc", 2)
    r, n = pts.shape[:2]
    batch = (r,)
    rows, stride = pc.operand(uv, (n, 2), batch)   # the frame's keypoints
    assert stride == 0 and rows.data_ptr() == uv.data_ptr()
    rows, stride = pc.operand(pts, (n, 3), batch)  # per candidate
    assert stride == n * 3 and rows.data_ptr() == pts.data_ptr()
    rows, stride = pc.operand(pose0[0], (7,), batch)
    assert stride == 0
    # Rows that are not dense are copied once; a column slice is not dense.
    wide = torch.randn(r, n, 4)
    rows, stride = pc.operand(wide[..., :3], (n, 3), batch)
    assert stride == n * 3 and torch.equal(rows, wide[..., :3])
    # Two leading dims flatten to one, row for row.
    rows, stride = pc.operand(pts.reshape(2, 2, n, 3), (n, 3), (2, 2))
    assert rows.shape == (r, n, 3) and torch.equal(rows, pts)
    assert pc.operand(ok[0], (n,), ())[1] == 0


def test_pose_gn_args_mirror_the_kernel_struct():
    """``_PoseGnArgs`` lists the C struct's fields in order, with the same
    types, and the edge limit is the kernel's threads times edges a
    thread."""
    src = (build._CSRC / build.KERNELS["pose_gn"][0]).read_text()
    body = re.search(r"struct PoseGnArgs \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    kinds = {"float*": ctypes.c_void_p, "uint8_t*": ctypes.c_void_p,
             "int*": ctypes.c_void_p, "long long": ctypes.c_longlong,
             "int": ctypes.c_int, "float": ctypes.c_float}
    fields = []
    for decl in body.split(";"):
        decl = " ".join(decl.replace("const ", "").split())
        if not decl:
            continue
        m = re.match(r"(float\*|uint8_t\*|int\*|long long|int|float) (.*)", decl)
        fields += [(name.strip(), kinds[m.group(1)])
                   for name in m.group(2).split(",")]
    assert fields == list(pc._PoseGnArgs._fields_)
    consts = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
              for k in ("THREADS", "MAX_EPT")}
    assert (consts["THREADS"], consts["MAX_EPT"]) == (pc.THREADS, pc.MAX_EPT)
    assert pc.MAX_EDGES == pc.THREADS * pc.MAX_EPT
