"""One way for a test to run a group of processes: one deadline for the
whole group, and every member killed and reaped on a timeout or a failure.

Each member runs in a session of its own, and the group's end kills that
session's process group whether the member is still running or not, so
nothing a member started in it outlives the group.  Each member writes
its output to a temporary file, not a pipe, so that no member blocks on
a full pipe while the test waits on another.
"""

import contextlib
import os
import signal
import subprocess
import tempfile
import time


class GroupFailed(AssertionError):
    """A member exited non-zero, or the group outran its deadline.

    ``procs`` are the members (all exited by the time this is raised) and
    ``outputs`` what each wrote.
    """

    def __init__(self, message, procs, outputs):
        super().__init__(message)
        self.procs = procs
        self.outputs = outputs


def _kill(procs):
    """Kill every member's process group, also that of a member which has
    exited (its children may live on), and reap the members."""
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    for p in procs:
        p.wait()


def run_group(argvs, deadline, *, env=None, cwd=None):
    """Start one process per argument list and wait for all of them, for
    at most ``deadline`` seconds in all.

    Returns each member's output (stdout and stderr, decoded) in order,
    once every member has exited 0 and what they left running is killed.
    Raises :class:`GroupFailed`, after killing and reaping every member,
    as soon as one exits non-zero or when the deadline passes.
    """
    with contextlib.ExitStack() as files:
        logs = [files.enter_context(tempfile.TemporaryFile()) for _ in argvs]
        procs = []
        try:
            for argv, log in zip(argvs, logs):
                procs.append(subprocess.Popen(
                    argv, stdout=log, stderr=subprocess.STDOUT, env=env,
                    cwd=cwd, start_new_session=True))
            end = time.monotonic() + deadline
            failed = None
            while failed is None:
                codes = [p.poll() for p in procs]
                bad = [i for i, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = f"member {bad[0]} of {len(procs)} exited " \
                             f"with {codes[bad[0]]}"
                elif None not in codes:
                    break
                elif time.monotonic() > end:
                    failed = f"the group of {len(procs)} outran its " \
                             f"{deadline} s deadline"
                else:
                    time.sleep(0.05)
        finally:
            _kill(procs)
        outputs = []
        for log in logs:
            log.seek(0)
            outputs.append(log.read().decode(errors="replace"))
    if failed is not None:
        raise GroupFailed(failed + "".join(
            f"\n--- member {i} (rc {p.returncode}) ---\n{out}"
            for i, (p, out) in enumerate(zip(procs, outputs))),
            procs, outputs)
    return outputs
