"""How much of a query job's wall time its worker thread ran on a CPU:
the thread-CPU seconds of the program's ``query_jobs.run`` spans over
their wall seconds, inside the window, in percent. A low share means
the worker waits: on the interpreter lock, the job table's lock, the
batcher or the collector."""

from beacon_bench.lib.program_spans import oncpu_pct


def read(w):
    return oncpu_pct(w, "query_jobs.run")
