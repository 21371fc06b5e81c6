"""``governor_host_s_per_query`` (s): per completed query, the collect
thread's exclusive host seconds in the port's ``governor`` category
(``observability/hostclock.py``): the governed programs' calls
(``GovernedFunction.call_with``): program lookup, input flattening,
copies in and out, the replay's launch, any capture. The sum over the
window's latency ledgers of their ``host`` key's ``governor``, over the
completed queries. A program whose ledgers have no ``host`` key reads
nothing."""


def read(run):
    done = run.completed()
    hosts = [e["host"] for e in run.ledgers if e.get("host")]
    if not done or not hosts:
        return None
    return sum(float(h["governor"]) for h in hosts) / len(done)
