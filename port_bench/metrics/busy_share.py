"""Share of the traced window in which a kernel, a copy or a fill ran on
the device (the union over all streams), in percent."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * run.trace["busy_share"]
