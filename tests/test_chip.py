"""On-card check: chip_smoke.py end to end on a GPU.

Run on a machine with a card: `python -m pytest -m chip tests/test_chip.py`.
The suite's own process stays on the CPU (conftest), so the smoke script
runs as the one process that uses the card. Whether a card exists is
decided inside the fixture, never at import time; without one the test
skips."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def gpu_env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.default_backend())"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    backend = (r.stdout.strip().splitlines() or ["none"])[-1]
    if backend != "gpu":
        pytest.skip(f"no GPU here (JAX backend {backend!r})")
    return env


@pytest.mark.chip
def test_chip_smoke_on_card(gpu_env):
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=gpu_env,
        capture_output=True, text=True, timeout=1500,
    )
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
