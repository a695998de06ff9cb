"""Share of the window the server process (the HTTP server, the app,
the runner, the batcher: one interpreter) spent paused in Python's
cyclic garbage collector, every generation, in percent: the pauses that
ended in the window, timed on the host clock by a ``gc.callbacks``
hook the benchmark installs once set-up is over."""

from beacon_bench.lib.readers import gc_pause_pct


def read(w):
    return gc_pause_pct(w)
