"""1 - device busy / wall over one traced global-BA solve after the
window: what the CG loop's host reads cost the card."""


def read(run):
    prof = run.get("profile_solve")
    if prof is None:
        return None
    return 1.0 - prof["busy_s"] / prof["window_s"]
