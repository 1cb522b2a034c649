"""3D map / trajectory view (``boslam_tpu.viz.viewer``).

Renders a ``MapState`` (landmarks and keyframe positions) and trajectories
to a PNG with matplotlib's Agg backend, imported when it renders: the
package is optional.  Host-side only.
"""

from __future__ import annotations

import numpy as np

from boslam_tpu_torch.geometry import se3


def _set_axes_equal(ax) -> None:
    lims = np.array([ax.get_xlim3d(), ax.get_ylim3d(), ax.get_zlim3d()])
    center = lims.mean(axis=1)
    radius = 0.5 * float((lims[:, 1] - lims[:, 0]).max())
    for c, setter in zip(
        center, (ax.set_xlim3d, ax.set_ylim3d, ax.set_zlim3d)
    ):
        setter([c - radius, c + radius])


def render_map(map_state, trajectory=None, out_path: str = "map.png",
               groundtruth=None, title: str = "boslam_tpu_torch map",
               max_points: int = 20000) -> str:
    """Render landmarks, keyframe positions and trajectories to ``out_path``.

    Args:
      map_state: MapState on any device.
      trajectory: optional [T, 7] T_wc poses (qw qx qy qz tx ty tz).
      groundtruth: optional [T, 7] same layout, drawn dashed.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = map_state.pt_xyz.cpu().numpy()
    pv = map_state.pt_valid.cpu().numpy()
    kf_pose = map_state.kf_pose.cpu()
    kv = map_state.kf_valid.cpu()

    fig = plt.figure(figsize=(9, 7))
    ax = fig.add_subplot(111, projection="3d")
    p = pts[pv]
    if len(p) > max_points:
        p = p[:: len(p) // max_points + 1]
    if len(p):
        ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=2.0, c=p[:, 2],
                   cmap="viridis", alpha=0.85, linewidths=0,
                   label="map points")
    if bool(kv.any()):
        kf_twc = se3.pose_inv(kf_pose[kv]).numpy()
        ax.scatter(kf_twc[:, 4], kf_twc[:, 5], kf_twc[:, 6], s=25,
                   c="tab:red", marker="^", label="keyframes")
    if trajectory is not None:
        t = np.asarray(trajectory)
        ax.plot(t[:, 4], t[:, 5], t[:, 6], c="tab:blue", lw=1.5,
                label="estimate")
    if groundtruth is not None:
        g = np.asarray(groundtruth)
        ax.plot(g[:, 4], g[:, 5], g[:, 6], c="tab:gray", lw=1.0, ls="--",
                label="groundtruth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    ax.set_title(title)
    ax.legend(loc="upper right")
    _set_axes_equal(ax)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
