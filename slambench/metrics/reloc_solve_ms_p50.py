"""The median host time of the window's ``reloc.solve`` spans: RANSAC PnP
over the candidates, the refine and the choice of the candidate."""

import numpy as np


def read(run):
    ms = [t for _, name, t in run.get("spans", ()) if name == "reloc.solve"]
    return float(np.median(ms)) if ms else None
