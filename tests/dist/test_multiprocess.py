"""Multi-PROCESS distributed smoke test (SURVEY.md §4.5).

Spawns two local jax.distributed CPU processes that each render half the
image's pixel rows with the engine and psum a checksum — exercising
parallel/mesh.py:initialize_distributed and the cross-process collective
path that multi-host pod runs use (config 5). Skips (not fails) if the
local environment cannot form a process group within the timeout, since
that's an environment property, not a code defect.
"""

import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_WORKER = textwrap.dedent(
    """
    import os, sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pathtracer.parallel.mesh import initialize_distributed

    pid = int(sys.argv[1])
    initialize_distributed("127.0.0.1:%s", 2, pid)
    assert jax.process_count() == 2, jax.process_count()

    import numpy as np
    import jax.numpy as jnp
    from pathtracer.config import RenderConfig
    from pathtracer.engine.wavefront import trace_sample
    from pathtracer.scene.builder import build_scene

    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=1,
                       scene="cornell_spheres", use_bvh=False)
    scene = build_scene(cfg.scene)
    n = cfg.n_pixels // 2
    ids = jnp.arange(pid * n, (pid + 1) * n, dtype=jnp.uint32)
    rad = trace_sample(scene.geometry, scene.materials, scene.camera,
                       scene.lights, cfg, ids, jnp.uint32(0))
    # Cross-process reduction of the local radiance checksum (the same
    # collective path config-5 grad all-reduce uses across hosts).
    from jax.experimental import multihost_utils
    local = float(jnp.sum(rad))
    gathered = multihost_utils.process_allgather(jnp.float32(local))
    total = float(gathered.sum())
    print(f"proc{pid} local={local:.6f} total={total:.6f}", flush=True)
    """
)


@pytest.mark.timeout(180)
def test_two_process_psum(tmp_path):
    port = 12355
    script = tmp_path / "worker.py"
    script.write_text(_WORKER % port)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)  # no fake devices: 1 device per process
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=150)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("jax.distributed process group did not form in time")
    for rc, out, err in outs:
        if rc != 0 and "initialize" in err:
            pytest.skip(f"jax.distributed unavailable here: {err[-300:]}")
        assert rc == 0, err[-2000:]
    # Both processes agree on the global psum total.
    totals = [o.split("total=")[1].split()[0] for _, o, _ in outs]
    assert totals[0] == totals[1], totals
    locals_ = [float(o.split("local=")[1].split()[0]) for _, o, _ in outs]
    assert abs(sum(locals_) - float(totals[0])) < 1e-3
