"""The device's idle share of the traced window, in percent: one minus the
union of the card's kernel, copy and set intervals over the window."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.window_s)
