"""The PyTorch ray cast against the frozen numpy renderer, on the CPU."""

import numpy as np
import pytest
import torch

import render

CAM = render.Camera(fx=65.0, fy=65.0, cx=79.5, cy=59.5, width=160, height=120,
                    depth_factor=5000.0, depth_max=20.0, depth_wire_stride=2)


@pytest.mark.parametrize("path,i,room", [
    ({"path": "clover", "n_frames": 450, "n_petals": 3, "radius": 2.5,
      "yaw_amplitude": 0.4}, 0, 2.5),
    ({"path": "clover", "n_frames": 450, "n_petals": 3, "radius": 2.5,
      "yaw_amplitude": 0.4}, 333, 2.5),
    ({"path": "survey", "n_frames": 400, "span": 6.0}, 150, 3.0),
])
def test_torch_render_matches_numpy(path, i, room):
    pose = render.trajectory(path).poses_twc[i]
    rgb, depth = render.render_frame_np(CAM, pose, room)
    gray, depth_t = render.render_frame(CAM, pose, room, "cpu")
    assert np.array_equal((gray * 255).to(torch.uint8).numpy(), rgb[..., 0])
    # numpy rotates the rays by a matrix product, the card element by
    # element: the same sums in another order, one float32 rounding apart.
    np.testing.assert_allclose(depth_t.numpy(), depth, rtol=2.4e-7, atol=0)
    wire = render.depth_wire(depth_t, CAM).numpy().astype(np.uint16)
    assert np.array_equal(wire, render.depth_wire_np(depth, CAM))


def test_render_wire_is_fixed_by_the_seed():
    traj = render.trajectory({"path": "survey", "n_frames": 400, "span": 6.0})
    traj = render.Trajectory(traj.poses_twc[:2], traj.timestamps[:2])

    def frames(seed):
        return render.render_wire(CAM, traj, depth_noise=0.01, room_scale=3.0,
                                  generator=torch.Generator().manual_seed(seed),
                                  device="cpu")

    a, b, c = frames(2**31 + 5), frames(2**31 + 5), frames(7)
    assert all(np.array_equal(x[2], y[2]) for x, y in zip(a, b))
    assert not np.array_equal(a[1][2], c[1][2])
    assert a[0][1].dtype == np.uint8 and a[0][2].dtype == np.uint16
    assert a[0][2].shape == CAM.wire_shape
