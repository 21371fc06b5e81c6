"""``unledgered_s_per_query`` (s): per query, the time that no phase of
the program's latency ledger accounts for, as means over the window:
the wall the session saw (host clock, ``ctx.sql`` to rows) less the
scheduler's wall of the job (``wall_seconds``), which is the client's
submission, polls and result fetch, plus the scheduler's own remainder
(``unattributed_seconds``), which is the executors' polls and the
dispatch of tasks between the phases.

A cluster ledger sums each phase over the job's tasks, which run side
by side, so the phases can add up to more than the wall; the ledger's
remainder is then 0 and this reads low, never below the client's part."""


def read(run):
    done = run.completed()
    if not done or not run.ledgers:
        return None
    n = len(run.ledgers)
    wall = sum(q.end - q.start for q in done) / len(done)
    job = sum(float(e["wall_seconds"]) for e in run.ledgers) / n
    rest = sum(float(e["unattributed_seconds"]) for e in run.ledgers) / n
    return wall - job + rest
