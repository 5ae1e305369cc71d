"""tests/_spawn.py's group runner: outputs in order, and no member left
alive after a timeout or a failure."""

import os
import sys
import time

import pytest

from _spawn import GroupFailed, run_group

SLEEP = [sys.executable, "-c", "import time; time.sleep(60)"]


def test_outputs_in_order():
    argvs = [[sys.executable, "-c", f"print('rank {r}')"] for r in range(3)]
    outs = run_group(argvs, 60)
    assert [o.strip() for o in outs] == ["rank 0", "rank 1", "rank 2"]


def test_timeout_kills_every_member():
    """One member sleeps past a 5 s deadline: the group fails at the
    deadline and every member has exited."""
    t0 = time.monotonic()
    with pytest.raises(GroupFailed, match="deadline") as err:
        run_group([[sys.executable, "-c", "print('done')"], SLEEP], 5)
    assert 5 <= time.monotonic() - t0 < 30
    assert all(p.poll() is not None for p in err.value.procs)
    assert err.value.procs[0].returncode == 0
    assert err.value.procs[1].returncode < 0        # killed, not finished


def test_failure_kills_the_rest_at_once():
    """A member that exits non-zero ends the group before its deadline."""
    t0 = time.monotonic()
    with pytest.raises(GroupFailed, match="exited with 3") as err:
        run_group([SLEEP, [sys.executable, "-c",
                           "import sys; print('bad'); sys.exit(3)"]], 60)
    assert time.monotonic() - t0 < 30
    assert all(p.poll() is not None for p in err.value.procs)
    assert "bad" in err.value.outputs[1]


def _gone(pid):
    """``pid`` has exited: no such process, or a zombie not yet reaped."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def test_children_of_an_exited_member_are_killed():
    """A member that exits 0 leaves a sleeping child behind: the group
    still kills it when it ends."""
    spawner = [sys.executable, "-c",
               "import subprocess, sys; p = subprocess.Popen([sys.executable,"
               " '-c', 'import time; time.sleep(60)']); print(p.pid)"]
    t0 = time.monotonic()
    out, = run_group([spawner], 30)
    child = int(out.split()[-1])
    while not _gone(child) and time.monotonic() - t0 < 20:
        time.sleep(0.05)
    assert _gone(child)
