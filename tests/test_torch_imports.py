"""The port stands alone: importing every module of
``water_sandbox_tpu_torch`` in a fresh interpreter loads neither ``jax``
nor the JAX package ``water_sandbox_tpu``."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json, pkgutil, sys
import water_sandbox_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names:
    __import__(name)
print(json.dumps({"modules": names, "loaded": sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "water_sandbox_tpu"))}))
"""


def test_no_module_of_the_port_imports_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["loaded"] == []
    for name in ("cli", "bench", "golden", "io.export", "runtime.keymap",
                 "runtime.profiling", "viz.raster", "viz.live", "viz.render",
                 "viz.server", "ops.cuda.sph_bucket", "ops.cuda.incremental",
                 "ops.cuda.rescue", "ops.cuda.graph", "parallel.domain",
                 "parallel.gspmd"):
        assert f"water_sandbox_tpu_torch.{name}" in got["modules"], name
