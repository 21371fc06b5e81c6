"""``query_p50_s`` (s): the median latency of every query completed in
the window, all query types together, on the host clock from the call
of ``ctx.sql`` to the rows on the host (``statistics.median``)."""

import statistics


def read(run):
    lat = [q.end - q.start for q in run.completed()]
    return statistics.median(lat) if lat else None
