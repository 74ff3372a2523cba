"""kernels.pass_roofline: the least time a pass's work could take on the
card (``bench/roofline.py``: the CSR read once a call and each answer
written once, over the published memory bandwidth) as a share of the
kernels' device time in a pass. None where no kernel ran or the card is not
in the table of peaks."""

from bench import roofline


def read(w):
    if w.trace is None or not w.trace.kernel_total_ns:
        return None
    least = roofline.least_seconds(w.num_vertices, w.directed_edges, w.calls,
                                   w.device_name)
    if least is None:
        return None
    return 100.0 * least / (w.trace.kernel_total_ns / 1e9 / w.passes)
