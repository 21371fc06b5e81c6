"""The port's executor binary drains on a SIGTERM that the kernel hands
to a thread other than the main one.

``python -m ballista_tpu_torch.distributed.executor_main --local
--device cpu`` runs threads that started before ``main`` (numpy's BLAS
pool, torch's) and so never blocked SIGINT/SIGTERM. A process-directed
SIGTERM may be delivered to any of them. The JAX package's binary blocks
the signals in ``main`` and ``sigwait``s, so such a delivery kills it
with -15 before it drains; the port's installs handlers and waits on
them (``executor_main._wait_for_stop``). The test makes the delivery
deterministic with ``tgkill`` to one such thread (thread ids and their
blocked masks from ``/proc/<pid>/task``), and expects the drain and exit
code 0. It first pins that such a thread exists.
"""

import ctypes
import os
import signal
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
_SYS_TGKILL = {"x86_64": 234, "aarch64": 131}


def _blocks_sigterm(pid: int, tid: int) -> bool:
    with open(f"/proc/{pid}/task/{tid}/status") as fh:
        for line in fh:
            if line.startswith("SigBlk:"):
                return bool(int(line.split()[1], 16)
                            & (1 << (signal.SIGTERM - 1)))
    raise AssertionError("no SigBlk line")


@pytest.mark.skipif(os.uname().machine not in _SYS_TGKILL,
                    reason="tgkill's syscall number is known for x86_64 "
                           "and aarch64 only")
def test_sigterm_to_a_non_main_thread_drains():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ballista_tpu_torch.distributed.executor_main",
         "--local", "--device", "cpu", "--concurrent-tasks", "1",
         "--metrics-port", "-1"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines = []
    try:
        while True:
            line = proc.stdout.readline()
            lines.append(line)
            if not line or "polling" in line:
                break
        assert "polling" in lines[-1], "".join(lines)
        tids = sorted(int(t) for t in os.listdir(f"/proc/{proc.pid}/task"))
        others = [t for t in tids if t != proc.pid]
        # the threads the race needs: started before main, SIGTERM
        # unblocked
        unblocked = [t for t in others if not _blocks_sigterm(proc.pid, t)]
        assert unblocked, f"no non-main thread with SIGTERM unblocked: {tids}"
        libc = ctypes.CDLL(None, use_errno=True)
        rc = libc.syscall(_SYS_TGKILL[os.uname().machine], proc.pid,
                          unblocked[0], int(signal.SIGTERM))
        assert rc == 0, ctypes.get_errno()
        out, _ = proc.communicate(timeout=60)
        lines.append(out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    text = "".join(lines)
    assert "(graceful drain)" in text, text
    assert proc.returncode == 0, text
