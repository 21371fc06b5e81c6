"""The per-phase time limit of ``tests/time_limit.py``, under the tier's
own flags (``-p xdist -n 2 --dist loadfile``).

Each test runs a child pytest over a temporary directory whose conftest
installs the same plugin with a limit of a few seconds, and reads the
child's JUnit XML. Without the plugin the child's hangs never end, and
the child runs into this test's outer bound.
"""

import os
import signal
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

import pytest

LIMIT_S = 2
GRACE_S = 2
MARGIN_S = 60
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))

CONFTEST = f"""
import sys
sys.path.insert(0, {TESTS_DIR!r})
from time_limit import PhaseTimeLimit


def pytest_configure(config):
    config.pluginmanager.register(
        PhaseTimeLimit(limit_s={LIMIT_S}, grace_s={GRACE_S}),
        "phase-time-limit")
"""

HANGS = """
import subprocess
import threading

import pytest


@pytest.fixture
def stuck_teardown():
    yield
    threading.Event().wait()


def test_waits_on_an_event():
    threading.Event().wait()


def test_fixture_teardown_waits(stuck_teardown):
    pass


def test_stuck_in_a_child_process():
    subprocess.run(["sleep", "100"])


def test_plain_one():
    assert sum(range(4)) == 6


def test_plain_two():
    assert "limit".upper() == "LIMIT"
"""

SWALLOWS = """
import threading


def test_swallows_the_failure():
    while True:
        try:
            threading.Event().wait()
        except BaseException:
            pass


def test_plain_after_the_crash():
    assert 2 * 3 == 6
"""

MODULE_SETUP = """
import threading

import pytest


@pytest.fixture(scope="module")
def stuck_setup():
    while True:
        try:
            threading.Event().wait()
        except BaseException:
            pass


def test_first_user(stuck_setup):
    pass


def test_second_user(stuck_setup):
    pass
"""


def _run_child(tmp_path, body, bound_s):
    """Run pytest over ``body`` in a child; return (seconds, output,
    {test name: (outcome, message, captured stderr)})."""
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    (tmp_path / "conftest.py").write_text(CONFTEST)
    (tmp_path / "test_hangs.py").write_text(body)
    xml = tmp_path / "out.xml"
    cmd = [sys.executable, "-m", "pytest", str(tmp_path), "-q",
           "-p", "no:cacheprovider", "-p", "xdist", "-n", "2",
           "--dist", "loadfile", "-p", "no:randomly",
           f"--junitxml={xml}", "-o", "junit_logging=system-err"]
    t0 = time.monotonic()
    # TMPDIR: the plugin's record of the run lands in the test's directory
    proc = subprocess.Popen(cmd, cwd=tmp_path, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, "TMPDIR": str(tmp_path)},
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=bound_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    seconds = time.monotonic() - t0
    cases = {}
    for case in ET.parse(xml).getroot().iter("testcase"):
        bad = case.find("failure")
        if bad is None:
            bad = case.find("error")
        err = case.find("system-err")
        cases[case.get("name")] = (
            "passed" if bad is None else bad.tag,
            "" if bad is None else (bad.get("message") or "") + (bad.text or ""),
            "" if err is None else err.text or "")
    return seconds, out, cases


def test_each_hanging_phase_fails_alone_with_every_stack(tmp_path):
    # loadfile sends the whole file to one worker: its three hangs run in turn
    bound = 3 * LIMIT_S + GRACE_S + MARGIN_S
    seconds, out, cases = _run_child(tmp_path, HANGS, bound)
    assert seconds < bound, out
    hanging = {"test_waits_on_an_event", "test_fixture_teardown_waits",
               "test_stuck_in_a_child_process"}
    failed = {n for n, (outcome, _, _) in cases.items()
              if outcome != "passed"}
    assert failed == hanging, out
    for name in hanging:
        _, message, stderr = cases[name]
        assert f"passed its {LIMIT_S} s limit" in message, (name, out)
        assert "Thread 0x" in stderr, (name, out)
    assert cases["test_plain_one"][0] == "passed", out
    assert cases["test_plain_two"][0] == "passed", out


@pytest.mark.parametrize("body, outcomes", [
    (SWALLOWS, {"test_swallows_the_failure": "not run again",
                "test_plain_after_the_crash": "passed"}),
    (MODULE_SETUP, {"test_first_user": "not run again",
                    "test_second_user": "not run again"}),
], ids=["call", "module-setup"])
def test_a_phase_that_swallows_the_failure_ends_its_worker(tmp_path, body,
                                                          outcomes):
    bound = LIMIT_S + GRACE_S + MARGIN_S
    seconds, out, cases = _run_child(tmp_path, body, bound)
    assert seconds < bound, out
    # ended once; the new worker that xdist hands the rest of the file to
    # neither hangs on the ended test nor builds the stuck fixture again
    assert out.count("crashed while running") == 1, out
    assert "Thread 0x" in out, out
    for name, want in outcomes.items():
        outcome, message, _ = cases[name]
        if want == "passed":
            assert outcome == "passed", (name, out)
        else:
            assert want in message, (name, out)
