"""The hand-off from the runner's worker to the handler thread that
waits on the job: each ``runner.await`` span's end less the matching
``runner.done`` instant (joined by ``query_id``; from the await's start
where the job was done before the wait began), inside the window, per
completed request, in ms."""

from beacon_bench.lib.program_spans import wake_ms_per_req


def read(w):
    return wake_ms_per_req(w)
