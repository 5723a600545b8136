"""Test harness: run everything on a virtual 8-device CPU mesh.

SURVEY.md §5.5: multi-device behavior is tested without accelerators via
xla_force_host_platform_device_count. The platform is switched through
jax.config (and any already-initialized backend dropped), so the suite
runs on the CPU even on a machine with a GPU.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
try:
    from jax.extend.backend import clear_backends

    clear_backends()
except Exception:
    pass
jax.config.update("jax_threefry_partitionable", True)

# Persistent XLA:CPU AOT cache: the suite's cost is dominated by CPU
# compiles of the frame programs; the plain jax compilation cache stores
# nothing on CPU — the AOT result cache ("xla_caches") does, cutting
# repeat runs. The directory is JAX_COMPILATION_CACHE_DIR when set (JAX
# reads it itself), else the fixed in-checkout utils/jaxcache default.
from icra20_hand_object_pose_tpu.utils import jaxcache  # noqa: E402

jaxcache.enable_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
jax.config.update("jax_persistent_cache_enable_xla_caches", "all")

assert jax.devices()[0].platform == "cpu", jax.devices()
assert jax.device_count() == 8, jax.devices()
