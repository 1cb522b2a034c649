"""The median host time of the window's loop corrections (the engine's
``flush.close_loop`` spans): fusing the loop's points, the essential
graph's solve and moving the map."""

import numpy as np


def read(run):
    ms = [t for _, name, t in run.get("spans", ()) if name == "flush.close_loop"]
    return float(np.median(ms)) if ms else None
