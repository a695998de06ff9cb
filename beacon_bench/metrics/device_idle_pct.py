"""Share of the traced window in which nothing ran on the card: 100 x (1
- the union of the kernel, copy and fill intervals of the
``torch.profiler`` trace over the capture's length)."""

from beacon_bench.lib.readers import device_idle_pct


def read(w):
    return device_idle_pct(w)
