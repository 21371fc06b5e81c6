"""``device_idle_share`` (%): the share of the profiled slice in which
no kernel, copy or set ran on the card: one less the union of the
device intervals of ``torch.profiler``'s trace over the slice's length.
The executors of a cluster run in this process, so their work is in the
trace too."""

from qbench.trace import covered_ns


def read(run):
    p = run.profile
    if p is None or not p.device or p.end_ns <= p.start_ns:
        return None
    busy = covered_ns(p.device_intervals(), p.start_ns, p.end_ns)
    return 100.0 * (1.0 - busy / (p.end_ns - p.start_ns))
