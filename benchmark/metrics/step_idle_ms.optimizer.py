"""Device idle milliseconds a train step while the host was inside the
step's train.optimizer spans, averaged over the cards."""
from benchmark import spans


def read(run):
    return spans.phase_idle_ms(run, "optimizer")
