"""Device operations (kernels, copies, fills) per frame in the traced
frames after the window: the launch overhead the frame step pays."""


def read(run):
    prof = run.get("profile_frames")
    if prof is None:
        return None
    return prof["n_ops"] / prof["n_frames"]
