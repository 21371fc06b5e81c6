"""``captures_in_window`` (captures): CUDA graphs the governor captured
inside the window (``compile_stats()["graph_captures"]`` at the window's
end less at its start). Every capture in the window is a stall that the
warm-up should have taken."""


def read(run):
    return run.delta("graph_captures")
