"""Process start to the first timed wave or step."""


def read(run):
    return run.setup_s
