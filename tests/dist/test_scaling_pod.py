"""scaling_pod.py smoke test: the config-5 pod benchmark entry must run
end-to-end (sharded renders over a virtual mesh, timed frames, exact ray
counting, JSON summary) without hardware. Uses a subprocess so
the script's own env/virtual-device setup is exercised as shipped."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_scaling_pod_smoke():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "scaling_pod.py"),
         "--cpu-virtual", "4", "--scene", "cornell_spheres",
         "--width", "32", "--height", "32", "--depth", "2",
         "--budget", "2", "--single-chip-ref", "1000"],
        capture_output=True, text=True, timeout=600,
        cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("{")][-1]
    row = json.loads(line)
    assert row["unit"] == "rays/s"
    assert row["value"] > 0
    assert row["scaling_eff"] is not None
    assert row["device"]["platform"] == "cpu"
