"""``subquery_join_s_per_query`` (s): the seconds the window's queries
spent in decorrelated-join and scalar-subquery operators, per completed
query: the sum over the latency ledgers of their ``operators`` key (the
port's ``join.build`` and ``join.probe`` spans of semi, anti, outer and
decorrelated joins, and its ``subquery.scalar`` spans). A program whose
ledgers have no such key reads nothing."""


def read(run):
    done = run.completed()
    ops = [e["operators"] for e in run.ledgers if "operators" in e]
    if not done or not ops:
        return None
    return sum(float(v) for o in ops for v in o.values()) / len(done)
