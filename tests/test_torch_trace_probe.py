"""tools/trace_ops_probe.py, the port's op-trace probe, on the CPU.

It runs the headline graph (PSF(50, 30 deg), K = 0.01, the kernel route,
white balance on) at 128^2 under torch.profiler and prints device busy
("not measured": a CPU trace has no device rows), the phase table (the
host ms of each fphase_ range) and the op table. The probe imports
nothing of JAX: a subprocess runs it and reads sys.modules.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from fft_restoration_tpu_torch.tools import trace_ops_probe

torch.set_num_threads(1)  # small planes; parallel test workers would oversubscribe the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the phases the kernel route's single-frame restore opens (models/pipeline.py)
PHASES = {"fft_image", "spectral_fused", "ifft", "post_process"}


def test_probe_cpu_tables(capsys):
    assert trace_ops_probe.main(["--device", "cpu", "--size", "128"]) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0].startswith("graph: 128x128x3 uint8, PSF(50, 30 deg), K = 0.01")
    assert lines[1] == "device busy: not measured (the trace has no device rows)"
    i_ph = lines.index("phases (host ms/run):")
    i_op = lines.index("ops (host ms/run, inclusive):")
    phases = {ln.split()[1] for ln in lines[i_ph + 1:i_op]}
    assert phases == PHASES, phases
    ops = [ln.split(None, 1) for ln in lines[i_op + 1:]]
    assert ops and all(name.startswith("aten::") for _, name in ops)
    times = [float(ms) for ms, _ in ops]
    assert times == sorted(times, reverse=True) and times[0] > 0


def test_probe_result_and_refusals():
    res = trace_ops_probe.probe("cpu", 64)
    assert res["timeline"] == "host" and res["device_busy_ms"] is None
    assert set(res["phases_ms"]) == PHASES and all(v > 0 for v in res["phases_ms"].values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no card"):
            trace_ops_probe.probe("cuda", 64)
    with pytest.raises(SystemExit):
        trace_ops_probe.main(["--device", "cpu", "--size", "0"])


def test_probe_imports_no_jax():
    code = ("import json, sys\n"
            "from fft_restoration_tpu_torch.tools import trace_ops_probe as p\n"
            "p.main(['--device', 'cpu', '--size', '64'])\n"
            "mods = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "        or m == 'jaxlib' or m.startswith('jaxlib.')\n"
            "        or m == 'fft_restoration_tpu' or m.startswith('fft_restoration_tpu.')]\n"
            "print(json.dumps(mods))\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "phases (host ms/run):" in proc.stdout
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
