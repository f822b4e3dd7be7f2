"""setup_s: seconds from the process's start to the end of the warm-up
(imports, kernel libraries, weights, model build, warm-up), host clock."""


def read(run):
    return run.setup_s
