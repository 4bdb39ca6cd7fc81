"""Seconds of Medium.from_grids in set-up, between two synchronizes."""


def read(run):
    return run.spans.get("medium_build")
