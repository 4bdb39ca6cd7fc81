"""Device idle milliseconds a train step while the host was inside the
step's prb.record spans, averaged over the cards."""
from benchmark import spans


def read(run):
    return spans.phase_idle_ms(run, "record")
