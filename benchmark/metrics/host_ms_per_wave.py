"""Host milliseconds a wave spends in the call into the program (its issue),
the benchmark's span around it, over all the window's waves."""


def read(run):
    if run.kind != "render" or not run.window.call_s:
        return None
    return 1e3 * sum(run.window.call_s) / len(run.window.call_s)
