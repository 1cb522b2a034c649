"""The median host-clock time of the window's lost-branch frames that saw
the scene (relocalization attempts at positions with no blank): the
candidates' match, RANSAC PnP and the refine."""

import numpy as np


def read(run):
    dts = run.get("reloc_frame_s")
    return float(np.median(dts)) * 1e3 if dts else None
