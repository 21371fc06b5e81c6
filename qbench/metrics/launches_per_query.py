"""``launches_per_query`` (launches): CUDA runtime calls that launch
work or copy or set memory (names with ``Launch``, ``Memcpy`` or
``Memset``: kernel launches, graph launches, and the copies into a
graph's inputs) made inside the queries that the profiled slice holds
whole, divided by those queries."""

from qbench.trace import union

KINDS = ("Launch", "Memcpy", "Memset")


def read(run):
    p = run.profile
    if p is None:
        return None
    spans = [s for s in run.spans if "." not in s.name and s.session >= 0
             and p.start_ns <= s.start_ns and s.end_ns <= p.end_ns]
    if not spans:
        return None
    inside = union([(s.start_ns, s.end_ns) for s in spans])
    calls = 0
    for name, s, _ in p.runtime:
        if any(k in name for k in KINDS) and any(
                lo <= s <= hi for lo, hi in inside):
            calls += 1
    return calls / len(spans) if calls else None
