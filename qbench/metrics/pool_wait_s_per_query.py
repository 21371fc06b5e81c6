"""``pool_wait_s_per_query`` (s): per completed query, the collect thread's
exclusive host seconds in the port's ``pool_wait`` category
(``observability/hostclock.py``): the thread blocked on other host
threads: prefetch queues (partitions and primed scans),
``parallel_map``'s futures, a scan's reader threads. The sum over the
window's latency ledgers of their ``host`` key's ``pool_wait``, over the
completed queries. A program whose ledgers have no ``host`` key reads
nothing."""


def read(run):
    done = run.completed()
    hosts = [e["host"] for e in run.ledgers if e.get("host")]
    if not done or not hosts:
        return None
    return sum(float(h["pool_wait"]) for h in hosts) / len(done)
