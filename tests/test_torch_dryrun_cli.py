"""The dry run's command line and its no-allocation promise, each in a
subprocess of its own (the fake process group is the process's): the
reference test's contract (``--arch whisper-tiny --shape train_4k`` ->
``done: 1 ok, 0 skip, 0 fail``), and DeepSeek-V3 x ``train_4k`` raising
the process's resident memory by less than 2 GiB (its bf16 parameters
alone are 1.3 TB)."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=600):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=ROOT)


def test_cli_single_combo():
    r = _run(["-m", "repro_torch.launch.dryrun", "--arch", "whisper-tiny",
              "--shape", "train_4k"])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "1 ok, 0 skip, 0 fail" in r.stdout
    assert "OK   whisper-tiny x train_4k x 16x16" in r.stdout


def test_deepseek_train_allocates_nothing():
    code = (
        "import torch.distributed as dist\n"
        "def kib(key):\n"
        "    for line in open('/proc/self/status'):\n"
        "        if line.startswith(key):\n"
        "            return int(line.split()[1])\n"
        "from repro_torch.launch import dryrun as DR\n"
        "before = kib('VmRSS')\n"
        "r = DR.run_one('deepseek-v3-671b', 'train_4k', multi_pod=False)\n"
        "dist.destroy_process_group()\n"
        "print('STATUS', r['status'], r['arg_bytes'])\n"
        "print('GROWTH_KIB', kib('VmHWM') - before)\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    lines = dict(line.split(" ", 1) for line in r.stdout.splitlines()
                 if line.startswith(("STATUS", "GROWTH_KIB")))
    status, arg_bytes = lines["STATUS"].split()
    assert status == "OK" and int(arg_bytes) > 2 ** 30
    assert int(lines["GROWTH_KIB"]) < 2 * 2 ** 20
