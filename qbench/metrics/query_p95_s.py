"""``query_p95_s`` (s): the 95th percentile latency of every query
completed in the window, all query types together, on the host clock
(``statistics.quantiles(lat, n=20, method="inclusive")[18]``). Needs at
least 200 queries, so that ten or more lie beyond it."""

import statistics


def read(run):
    lat = [q.end - q.start for q in run.completed()]
    if len(lat) < 200:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
