"""``planning_ms`` (ms): the mean of the latency ledger's ``planning``
phase over the window's queries (logical and physical planning with
fusion; the port's own span, read from its ledgers)."""


def read(run):
    vals = [float(e["phases"].get("planning", 0.0)) for e in run.ledgers]
    return 1000.0 * sum(vals) / len(vals) if vals else None
