"""The port's environment doctor (``protgram_directgcn_torch/doctor.py``):
``--cpu`` passes on this CPU-only machine, in a process of its own; without
``--cpu`` and without a card it exits 1 with a line naming CUDA (the gloo
subprocess check, which the ``--cpu`` run covers, stubbed there)."""

import os
import subprocess
import sys

from protgram_directgcn_torch import doctor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cpu_checks_pass():
    proc = subprocess.run([sys.executable, "-m", "protgram_directgcn_torch.doctor", "--cpu"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip().startswith("[")]
    assert len(lines) == 5 and all(ln.strip().startswith("[ok]") for ln in lines), proc.stdout
    assert "gloo all_to_all_single" in proc.stdout


def test_without_a_card_fails_naming_cuda(capsys, monkeypatch):
    monkeypatch.setattr(doctor, "_gloo", lambda: "stubbed")
    assert doctor.main([]) == 1
    out = capsys.readouterr().out
    assert any(ln.strip().startswith("[!!] card") and "CUDA" in ln for ln in out.splitlines())
    assert "some checks FAILED" in out
