"""CLI smoke tests (SURVEY.md T13)."""

import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ENV = dict(os.environ, JAX_PLATFORMS="cpu")


def _run(args):
    return subprocess.run(
        [sys.executable, "-m", "pathtracer.cli", *args],
        cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=420,
    )


def test_render_smoke(tmp_path):
    out = tmp_path / "out.png"
    r = _run(["render", "--width", "32", "--height", "32", "--spp", "1",
              "--depth", "1", "--scene", "cornell_spheres", "--no-bvh",
              "--out", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert out.exists()


def test_render_resume_roundtrip(tmp_path):
    out = tmp_path / "o.npy"
    ck = tmp_path / "ck.npz"
    r1 = _run(["render", "--width", "16", "--height", "16", "--spp", "4",
               "--depth", "1", "--scene", "cornell_spheres", "--no-bvh",
               "--checkpoint", str(ck), "--checkpoint-every", "2",
               "--out", str(out)])
    assert r1.returncode == 0, r1.stderr[-2000:]
    full = np.load(out)
    # Resume from the checkpoint (which holds all 4 spp) → identical image.
    out2 = tmp_path / "o2.npy"
    r2 = _run(["render", "--width", "16", "--height", "16", "--spp", "4",
               "--depth", "1", "--scene", "cornell_spheres", "--no-bvh",
               "--resume", str(ck), "--out", str(out2)])
    assert r2.returncode == 0, r2.stderr[-2000:]
    np.testing.assert_allclose(np.load(out2), full, atol=1e-6)


def test_render_progressive_preview(tmp_path):
    """--preview-every dumps a converging preview every N spp without
    perturbing the final image (spp-keyed chunked accumulation)."""
    out = tmp_path / "prog.npy"
    r = _run(["render", "--width", "16", "--height", "16", "--spp", "4",
              "--depth", "1", "--scene", "cornell_spheres", "--no-bvh",
              "--preview-every", "2", "--out", str(out)])
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.count("preview ") == 2, r.stdout  # at 2 and 4 spp
    preview = tmp_path / "prog.preview.npy"
    assert preview.exists()
    # The final preview (all 4 spp) IS the final image.
    np.testing.assert_allclose(np.load(preview), np.load(out), atol=1e-6)
    # And it matches a straight no-preview render exactly.
    out2 = tmp_path / "straight.npy"
    r2 = _run(["render", "--width", "16", "--height", "16", "--spp", "4",
               "--depth", "1", "--scene", "cornell_spheres", "--no-bvh",
               "--out", str(out2)])
    assert r2.returncode == 0, r2.stderr[-2000:]
    np.testing.assert_allclose(np.load(out2), np.load(out), atol=1e-6)


def test_configs_dir_matches_presets():
    """configs/*.json must equal config.py:PRESETS exactly (drifted
    on-disk presets would silently measure another path).
    Regenerate with scripts/regen_configs.py when PRESETS changes."""
    from pathtracer.config import PRESETS, RenderConfig

    cfg_dir = os.path.join(ROOT, "configs")
    on_disk = {
        f[:-5] for f in os.listdir(cfg_dir) if f.endswith(".json")
    }
    assert on_disk == set(PRESETS), (on_disk, set(PRESETS))
    for name, cfg in PRESETS.items():
        with open(os.path.join(cfg_dir, f"{name}.json")) as f:
            assert RenderConfig.from_json(f.read()) == cfg, name


def test_fit_smoke():
    r = _run(["fit", "--width", "16", "--height", "16", "--spp", "1",
              "--depth", "1", "--scene", "cornell_spheres", "--no-bvh",
              "--steps", "3", "--perturb"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "loss" in r.stdout
