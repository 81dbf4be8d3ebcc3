"""Regenerate configs/*.json from config.py:PRESETS — the single source
of truth for the five driver milestone configs + the bench preset.

On-disk presets that drift from the code presets make
`--config-json configs/bench.json` silently measure another path. This
script + the parity test
(tests/unit/test_cli.py::test_configs_dir_matches_presets) keep the two
surfaces identical forever.

Run: python scripts/regen_configs.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pathtracer.config import PRESETS  # noqa: E402


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg_dir = os.path.join(here, "configs")
    os.makedirs(cfg_dir, exist_ok=True)
    for name, cfg in PRESETS.items():
        path = os.path.join(cfg_dir, f"{name}.json")
        with open(path, "w") as f:
            f.write(cfg.to_json() + "\n")
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
