"""chip_smoke.py's deadline, on the CPU: a run that overruns stops itself
with a nonzero exit that names the phase in progress and prints no result
line.

The script is imported in a subprocess (as the phase rehearsals import
it), its deadline armed at 2 s over a phase that sleeps for 60 s; the
subprocess must end long before the sleep would, exit nonzero, name the
sleeping phase in the deadline's own line, dump the stacks and print no
``{"ok": true, ...}`` line.  A second case holds the main thread in a
call that keeps the GIL, so the Python timer cannot run and
faulthandler's backstop has to end the run.
"""
import pathlib
import subprocess
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = """
import sys, time
sys.path.insert(0, {root!r})
import chip_smoke as cs

cs.arm_deadline(2.0, backstop={backstop})


@cs.phase("99. a phase that sleeps")
def sleeper():
    {body}


sleeper()
print('{{"ok": true, "device": {{"platform": "gpu"}}}}', flush=True)
"""

#: the sleeping phase's body: a sleep the timer thread can interrupt, and
#: one that holds the GIL (a regular expression backtracking in C for
#: minutes) so that only the backstop can stop it
BODIES = {"timer": "time.sleep(60)",
          "backstop": "import re; re.match(r'(a*)*b', 'a' * 40)"}


@pytest.mark.parametrize("how", sorted(BODIES))
def test_deadline_names_the_phase_and_exits_nonzero(how, tmp_path):
    script = tmp_path / "overrun.py"
    script.write_text(SCRIPT.format(root=str(ROOT), body=BODIES[how],
                                    backstop=1.0))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=120, cwd=tmp_path)
    seconds = time.perf_counter() - t0
    out = proc.stdout
    assert proc.returncode != 0, out
    assert seconds < 60, f"the run took {seconds:.1f} s"
    assert '"ok": true' not in out
    if how == "timer":
        line = next(ln for ln in out.splitlines() if ln.startswith("DEADLINE"))
        assert "99. a phase that sleeps" in line, out
        assert "phase seconds so far" in out
        assert "sleeper" in out   # the main thread's stack
    else:
        # faulthandler's dump: the stack runs through the sleeping phase
        assert "Timeout" in out and "sleeper" in out, out
