"""``h2d_s_per_query`` (s): host thread-seconds the scans spent copying
parsed columns to the card in the window (``ingest.phase_totals()
["h2d"]`` delta), per completed query. Overlapping copies add up."""


def read(run):
    done = run.completed()
    h2d = run.delta("ingest_h2d_s")
    return h2d / len(done) if done and h2d > 0 else None
