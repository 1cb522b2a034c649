"""The median host-clock time of the window's keyframe frames: tracking
plus the keyframe event (insert, fuse, cull and inline local BA)."""

import numpy as np


def read(run):
    if run.get("kind") != "frames":
        return None
    dts = run["frame_s"][run["keyframe"]]
    return float(np.median(dts)) * 1e3 if len(dts) else None
