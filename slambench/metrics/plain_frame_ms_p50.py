"""The median host-clock time of the window's frames that inserted no
keyframe: the frontend and tracking alone."""

import numpy as np


def read(run):
    if run.get("kind") != "frames":
        return None
    dts = run["frame_s"][~run["keyframe"]]
    return float(np.median(dts)) * 1e3 if len(dts) else None
