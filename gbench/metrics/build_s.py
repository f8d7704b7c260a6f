"""build_s: host clock around the program's host build from the COO
(``from_coo``: symmetrize, sort, deduplicate, CSR)."""


def read(run):
    return run.spans["build_s"]
