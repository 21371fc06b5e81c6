"""``unattributed_s_per_query`` (s): per completed query, the part of the
harness's query wall (``ctx.sql`` to rows, host clock) that no category
of the port's host clock (``observability/hostclock.py``) holds: the sum
of the completed queries' walls less the sum over the window's latency
ledgers of their ``host`` key's six categories, over the completed
queries. It is the harness's own spans, the calls between ``ctx.sql``
and the collect, and the collect's set-up and teardown outside any
category. A program whose ledgers have no ``host`` key reads nothing."""

CATEGORIES = ("frontend", "governor", "operators", "device_wait",
              "pool_wait", "recorder")


def read(run):
    done = run.completed()
    hosts = [e["host"] for e in run.ledgers if e.get("host")]
    if not done or not hosts:
        return None
    walls = sum(q.end - q.start for q in done)
    held = sum(float(h[c]) for h in hosts for c in CATEGORIES)
    return (walls - held) / len(done)
