"""1 - device busy / wall over the traced frames after the window: the
share of a frame in which the card waits for the host."""


def read(run):
    prof = run.get("profile_frames")
    if prof is None:
        return None
    return 1.0 - prof["busy_s"] / prof["window_s"]
