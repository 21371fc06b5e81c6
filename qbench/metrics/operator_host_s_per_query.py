"""``operator_host_s_per_query`` (s): per completed query, the collect
thread's exclusive host seconds in the port's ``operators`` category
(``observability/hostclock.py``): each operator's own host code, and the
collect's driving of the plan and its conversion of batches to the
client's rows. The sum over the window's latency ledgers of their
``host`` key's ``operators``, over the completed queries. A program
whose ledgers have no ``host`` key reads nothing."""


def read(run):
    done = run.completed()
    hosts = [e["host"] for e in run.ledgers if e.get("host")]
    if not done or not hosts:
        return None
    return sum(float(h["operators"]) for h in hosts) / len(done)
