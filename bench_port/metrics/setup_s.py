"""setup_s: from the harness's first statement to the end of the warm-up
(imports, the first run's build, the operator, the AMG setup, the capture
of the loop's graphs), host clock."""


def read(run):
    return run.setup_s
