"""The GPU entry points refuse to measure anywhere else, the peak table
refuses unknown devices, and the compilation cache lands where it says.

chip_smoke.py and bench.py run on the card; here they must fail before
printing any result."""
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke
from icra20_hand_object_pose_tpu import benchmarks
from icra20_hand_object_pose_tpu.utils import jaxcache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("args", [["chip_smoke.py"],
                                  ["chip_smoke.py", "--four"],
                                  ["bench.py"]])
def test_entry_points_refuse_cpu(args):
    r = _run(args, ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"metric"' not in r.stdout, r.stdout
    assert "no GPU" in r.stderr, r.stderr[-2000:]


def test_chip_smoke_alone_fails(tmp_path):
    """Without the package beside it the script cannot pass."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        benchmarks.require_gpu()


def test_chip_peaks_unknown_device_raises():
    with pytest.raises(KeyError, match="no published peaks"):
        benchmarks.chip_peaks(jax.devices()[0].device_kind)
    with pytest.raises(KeyError):
        benchmarks.chip_peaks("NVIDIA H100 PCIe")


def test_chip_peaks_h100_row():
    p = benchmarks.chip_peaks("NVIDIA H100 80GB HBM3")
    assert p == {"bf16_flops": 989e12, "tf32_flops": 495e12,
                 "hbm_bytes": 3.35e12}


def test_device_info_names_the_backend():
    assert benchmarks.device_info() == {
        "platform": "cpu", "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices())}


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert jaxcache.cache_dir() == str(tmp_path)
    assert jaxcache.enable_compilation_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_dir_default_is_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jaxcache.cache_dir() == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_four_selects_only_its_phase():
    assert chip_smoke.select_phases(True) == ("device", "four")
    default = chip_smoke.select_phases(False)
    assert "four" not in default
    assert default == ("device", "parity", "tracking")


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_format(count):
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
           "count": count, "extra": "dropped"}
    line = chip_smoke.result_line(dev)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}
    assert line.startswith('{"ok": true, "device": {"platform": "gpu"')
    assert "\n" not in line
