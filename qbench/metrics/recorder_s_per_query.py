"""``recorder_s_per_query`` (s): per completed query, the collect thread's
exclusive host seconds in the port's ``recorder`` category
(``observability/hostclock.py``): the standalone recorder: its start,
and its finish (lanes, latency ledger, query history, metrics). The sum
over the window's latency ledgers of their ``host`` key's ``recorder``,
over the completed queries. A program whose ledgers have no ``host`` key
reads nothing."""


def read(run):
    done = run.completed()
    hosts = [e["host"] for e in run.ledgers if e.get("host")]
    if not done or not hosts:
        return None
    return sum(float(h["recorder"]) for h in hosts) / len(done)
