"""``shuffle_write_s_per_query`` (s): the mean of the latency ledger's
``shuffle_write`` phase over the window's queries: the executors'
partition and shuffle writes (Arrow IPC files). The ledger sums the
phase over a query's tasks, which run side by side, so these are task
thread-seconds and can exceed the query's wall."""


def read(run):
    vals = [float(e["phases"].get("shuffle_write", 0.0)) for e in run.ledgers]
    return sum(vals) / len(vals) if vals else None
