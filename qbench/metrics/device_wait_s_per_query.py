"""``device_wait_s_per_query`` (s): per completed query, the collect
thread's exclusive host seconds in the port's ``device_wait`` category
(``observability/hostclock.py``): the thread blocked on the card, inside
the port's ``device.block`` spans. The sum over the window's latency
ledgers of their ``host`` key's ``device_wait``, over the completed
queries. A program whose ledgers have no ``host`` key reads nothing."""


def read(run):
    done = run.completed()
    hosts = [e["host"] for e in run.ledgers if e.get("host")]
    if not done or not hosts:
        return None
    return sum(float(h["device_wait"]) for h in hosts) / len(done)
