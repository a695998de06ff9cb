"""Launches of ``bisect_query`` (J3) per completed request over the
window: the program's launch counter (``telemetry.launch_counts()``)
differenced across the window, over the requests completed in it."""

from beacon_bench.lib.readers import launches_per_req


def read(w):
    return launches_per_req(w, "bisect_query")
