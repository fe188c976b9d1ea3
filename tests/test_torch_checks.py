"""The port's check script and CI workflow, on the CPU.

``scripts/check_torch.sh`` runs the smokes of ``scripts/check.sh`` with
the same flags through the port's serve CLI (``--device`` added), and
its exit code is non-zero when any stage fails; every script and module
that ``.github/workflows/ci_torch.yml``'s ``run:`` steps name exists.
"""
import os
import re
import shlex
import subprocess

import yaml

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _commands(script: str, module: str) -> list:
    """The argument lists after ``python -m <module>`` in ``script``,
    line continuations joined."""
    with open(os.path.join(ROOT, script)) as f:
        text = f.read().replace("\\\n", " ")
    out = []
    for line in text.splitlines():
        m = re.search(rf"python -m {re.escape(module)}\s(.*)$", line)
        if m and not line.lstrip().startswith("#"):
            out.append(shlex.split(m.group(1)))
    return out


def _without_device(argv: list) -> list:
    out = list(argv)
    i = out.index("--device")
    del out[i:i + 2]
    return out


def test_check_torch_smokes_are_the_reference_smokes():
    ref = _commands("scripts/check.sh", "repro.launch.serve")
    port = _commands("scripts/check_torch.sh", "repro_torch.launch.serve")
    assert len(ref) == 6
    for argv in port:
        assert argv[argv.index("--device") + 1] == "${DEVICE}"
    assert [_without_device(a) for a in port] == ref
    quick = _commands("scripts/check_torch.sh",
                      "repro_torch.examples.quickstart")
    assert quick == [["--device", "${DEVICE}"]]


def test_check_torch_fails_when_a_stage_fails():
    """Every smoke refuses an unknown device at once: each stage fails,
    later stages still run, and the script exits 1 naming them all."""
    env = dict(os.environ, CHECK_DEVICE="no-such-device",
               CHECK_SKIP_SCALE="1", OMP_NUM_THREADS="1")
    proc = subprocess.run(["bash", "scripts/check_torch.sh", "--fast"],
                          cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 1, proc.stdout[-2000:]
    failed = re.findall(r"^-- (.*): FAILED \(exit 2", proc.stdout, re.M)
    assert len(failed) == 5, proc.stdout[-2000:]
    assert failed[-1] == "quickstart"
    assert proc.stdout.rstrip().endswith(failed[-1])
    assert "CHECKS FAILED: " in proc.stdout
    assert "ALL CHECKS PASSED" not in proc.stdout


def _run_steps(workflow: str) -> list:
    with open(os.path.join(ROOT, ".github", "workflows", workflow)) as f:
        doc = yaml.safe_load(f)
    return [step["run"] for job in doc["jobs"].values()
            for step in job["steps"] if "run" in step]


def test_ci_torch_names_only_what_exists():
    runs = _run_steps("ci_torch.yml")
    assert any("scripts/check_torch.sh" in r for r in runs)
    named = 0
    for run in runs:
        for path in re.findall(r"(?:scripts|tests|src)/[\w./-]+", run):
            assert os.path.exists(os.path.join(ROOT, path)), path
            named += 1
        for mod in re.findall(r"python -m ([\w.]+)", run):
            if mod.startswith("repro"):
                rel = os.path.join(ROOT, "src", *mod.split("."))
                assert os.path.exists(rel + ".py") or os.path.isdir(rel), mod
    assert named >= 1
    # the scripts that check_torch.sh itself names exist as well
    with open(os.path.join(ROOT, "scripts", "check_torch.sh")) as f:
        text = f.read()
    for mod in set(re.findall(r"python -m (repro_torch[\w.]+)", text)):
        assert os.path.exists(os.path.join(ROOT, "src",
                                           *mod.split(".")) + ".py"), mod
