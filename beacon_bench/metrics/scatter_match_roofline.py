"""Share of its roofline that ``scatter_match`` (J1) reaches in the traced
window: the mean bound of the window's launches (the larger of the
bytes their own inputs need at 3.35 TB/s and their integer operations
at 16.7e12/s, ``lib/bounds.py``, from inputs recorded by wrapping the
launch entry) over the kernel's mean device time in the
``torch.profiler`` trace, in percent. Returns (share, bound_by)."""

from beacon_bench.lib.readers import roofline_pct

KERNELS = ('scatter_match',)


def read(w):
    return roofline_pct(w, "scatter_match")
