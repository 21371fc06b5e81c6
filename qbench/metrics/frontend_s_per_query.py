"""``frontend_s_per_query`` (s): per completed query, the collect thread's
exclusive host seconds in the port's ``frontend`` category
(``observability/hostclock.py``): the query's ``ctx.sql`` (parse,
logical planning, the plan cache) and the collect's planning, optimizer,
fusion and adaptive rewrite. The sum over the window's latency ledgers
of their ``host`` key's ``frontend``, over the completed queries. A
program whose ledgers have no ``host`` key reads nothing."""


def read(run):
    done = run.completed()
    hosts = [e["host"] for e in run.ledgers if e.get("host")]
    if not done or not hosts:
        return None
    return sum(float(h["frontend"]) for h in hosts) / len(done)
