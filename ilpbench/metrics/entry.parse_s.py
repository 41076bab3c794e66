"""The benchmark's span around ``make_problem`` (LP text to the raw problem)."""


def read(run):
    return run["parse_s"]
