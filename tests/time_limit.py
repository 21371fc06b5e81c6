"""A time limit on every test phase (setup, call, teardown).

A phase that runs past ``LIMIT_S`` gets every thread's stack dumped into
its captured output, then a ``pytest.fail`` raised in the main thread
through ``SIGALRM``: the test fails, and its ``finally`` blocks and
fixtures still run. A phase that has not returned ``GRACE_S`` after that
(a C call that never comes back to Python, or code that swallows the
failure) ends the process through ``faulthandler``, which dumps the
stacks once more; pytest-xdist then reports the one test as crashed and
starts a new worker. Either way a hang costs one test and at most
``LIMIT_S + GRACE_S`` of one worker, not the whole run.

Under ``--dist loadfile`` xdist hands a crashed test back to a new
worker with the rest of its file. So a phase that passes its limit is
noted in a record of the run, and the note is withdrawn when the phase
returns: what stays noted ended its worker, and a later worker fails it
at once instead of hanging on it again. A setup is noted by its file,
since a module or session fixture that hung there would hang again for
every later test of the file; a call or teardown by its test.

Only the standard library is used: pytest-timeout is not available.
"""

import faulthandler
import os
import signal
import sys
import tempfile
from contextlib import contextmanager

import pytest

# About 5x the slowest test phase of the tier (62 s, an SF0.2 q1 with its
# data generation), so no honest test on a slower machine reaches it.
LIMIT_S = 300
GRACE_S = 30


def _file_of(item):
    return item.nodeid.split("::")[0]


class PhaseTimeLimit:
    """The pytest plugin: register one instance per process."""

    def __init__(self, limit_s=LIMIT_S, grace_s=GRACE_S):
        self.limit_s = limit_s
        self.grace_s = grace_s
        self._stderr_fd = None
        self._record = None

    def pytest_configure(self, config):
        # A copy of the process's own stderr, taken while capture is
        # suspended: the last-resort dump must outlive the phase's capture.
        self._stderr_fd = os.dup(2)
        run = getattr(config, "workerinput", {}).get("testrunuid")
        if run:
            self._record = os.path.join(tempfile.gettempdir(),
                                        f"phase-time-limit-{run}.txt")

    def pytest_unconfigure(self, config):
        if self._stderr_fd is not None:
            os.close(self._stderr_fd)
            self._stderr_fd = None

    def _note(self, line):
        if self._record:
            with open(self._record, "a") as f:
                f.write(line + "\n")

    def _ended_a_worker(self, item):
        """The key of this test or its file if a phase of it passed its
        limit in a worker that was then ended, else None."""
        if self._record is None:
            return None
        try:
            with open(self._record) as f:
                lines = f.read().splitlines()
        except FileNotFoundError:
            return None
        held = set()
        for line in lines:
            (held.add if line[0] == "+" else held.discard)(line[1:])
        for key in (item.nodeid, _file_of(item)):
            if key in held:
                return key
        return None

    @contextmanager
    def _limited(self, item, phase):
        what = f"{item.nodeid} ({phase})"
        key = _file_of(item) if phase == "setup" else item.nodeid
        fired = []

        def on_alarm(signum, frame):
            fired.append(True)
            self._note("+" + key)
            sys.stderr.write(f"\n{what} passed its {self.limit_s} s limit; "
                             "every thread's stack:\n")
            sys.stderr.flush()
            try:
                out = sys.stderr.fileno()
            except (AttributeError, OSError, ValueError):  # capsys
                out = self._stderr_fd
            faulthandler.dump_traceback(file=out, all_threads=True)
            pytest.fail(f"{what} passed its {self.limit_s} s limit "
                        "(stacks in the captured stderr)")

        previous = signal.signal(signal.SIGALRM, on_alarm)
        signal.setitimer(signal.ITIMER_REAL, self.limit_s)
        faulthandler.dump_traceback_later(self.limit_s + self.grace_s,
                                          exit=True, file=self._stderr_fd)
        try:
            yield
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            faulthandler.cancel_dump_traceback_later()
            signal.signal(signal.SIGALRM, previous)
            if fired:  # the phase returned: its worker lives on
                self._note("-" + key)

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_setup(self, item):
        key = self._ended_a_worker(item)
        if key is not None:
            pytest.fail(f"{key} passed its {self.limit_s} s limit in a worker "
                        f"that was then ended; {item.nodeid} not run again")
        with self._limited(item, "setup"):
            return (yield)

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_call(self, item):
        with self._limited(item, "call"):
            return (yield)

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_teardown(self, item):
        with self._limited(item, "teardown"):
            return (yield)
