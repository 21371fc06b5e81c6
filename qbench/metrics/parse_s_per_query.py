"""``parse_s_per_query`` (s): host thread-seconds the scans spent
parsing ``.tbl`` text in the window (``ingest.phase_totals()["parse"]``
at the end less at the start), per completed query. Thread-seconds of
scans that overlap add up, so this can exceed a query's wall."""


def read(run):
    done = run.completed()
    parse = run.delta("ingest_parse_s")
    return parse / len(done) if done and parse > 0 else None
