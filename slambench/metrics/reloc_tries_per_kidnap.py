"""Relocalization attempts per cover over the window's engines: the
engines' ``n_reloc_tries`` over the covers they fed the start of.  Each
cover costs at least its blank frames after the first and one attempt
that succeeds; the rest are attempts on views the map cannot place."""


def read(run):
    rc = run.get("reloc_counts")
    if not rc or not rc["covers"]:
        return None
    return rc["tries"] / rc["covers"]
