"""Host CPU milliseconds the server process (the HTTP server, the app,
the runner, the batcher and every thread they run) spends on one
completed request: user + system time of this process over the window
(``resource.getrusage``), over the requests completed in it. The
client processes are not in it."""

from beacon_bench.lib.readers import server_cpu_ms_per_req


def read(w):
    return server_cpu_ms_per_req(w)
