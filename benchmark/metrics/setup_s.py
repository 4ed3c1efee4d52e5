"""setup_s (end to end, every cell): seconds from the process's start to
the first timed request or step: imports, weights, inputs or corpus,
warm-up or capture."""


def read(run: dict):
    return run["setup_s"]
