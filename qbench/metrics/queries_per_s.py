"""``queries_per_s`` (queries/s): queries completed in the window over
the window's whole time, on the host clock. The window opens when the
sessions start and closes when the last query a session started before
the deadline has its rows on the host."""


def read(run):
    done = run.completed()
    if not done or run.window_s <= 0:
        return None
    return len(done) / run.window_s
