"""Share of the profiled stretch with no operation running on the device:
one minus the union of the device operations' intervals over the span from
the first one's start to the last one's end."""


def read(run):
    busy = run.stretch.busy()
    return None if busy is None else 100.0 * (1.0 - busy[0] / busy[1])
