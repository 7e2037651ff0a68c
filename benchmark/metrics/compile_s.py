"""compile_s (setup layer): host seconds of ``apt.compile`` (circuit, test
SRS, keys), synchronised."""


def read(run):
    return run.compile_s
