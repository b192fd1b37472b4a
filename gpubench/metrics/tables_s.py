"""tables_s: seconds of set-up spent building the program's runners
(``api.get_runner``: the tables, their build and upload)."""


def read(run):
    return run.tables_s if run.tables_s > 0 else None
