"""CG iterations per LM iteration over the window's solves
(``GlobalBaStats.pcg_steps``): the solver's work per step."""


def read(run):
    if run.get("kind") != "gba" or not run["pcg_steps"]:
        return None
    return sum(run["pcg_steps"]) / len(run["pcg_steps"])
