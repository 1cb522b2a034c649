"""Host reads of a device value (``tracking.tracker.HostSync.count``) per
frame over the window's frames: each one stalls the host until the card
drains."""


def read(run):
    if run.get("kind") != "frames" or not run["n_frames"]:
        return None
    return run["host_syncs"] / run["n_frames"]
