"""Share of the traced window in which no operation ran on the device:
1 - the union of the device operations' intervals over the window."""


def read(run):
    return run.idle_share()
