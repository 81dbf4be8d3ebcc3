"""Golden-image regression tests (SURVEY.md §4.6).

Goldens are generated on the CPU backend by scripts/regen_goldens.py; the
suite also runs on CPU (conftest), so comparison is near-exact. A failure
means the renderer's semantics changed — regenerate deliberately, never
casually.
"""

import os

import numpy as np
import pytest

from pathtracer.engine import wavefront
from scripts.regen_goldens import GOLDENS, OUT


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden(name):
    path = os.path.join(OUT, f"{name}.npy")
    if not os.path.exists(path):
        pytest.skip(f"golden {name} not generated")
    mk, cfg = GOLDENS[name]
    golden = np.load(path)
    img = np.asarray(wavefront.render(mk(), cfg))
    np.testing.assert_allclose(img, golden, atol=1e-5, rtol=1e-5)
