"""The share of the traced window in which no operation ran on the
device (one minus the union of the operations' intervals), in percent."""


def read(run):
    if run.trace is None:
        return None
    return 100 * (1 - run.trace.busy_s / run.trace.window_s)
