"""The port imports nothing of JAX and nothing of the JAX package: in a
fresh interpreter, importing every module of ``triforce_tpu_torch`` (the
multi-GPU ones included) leaves ``jax`` and ``triforce_tpu`` out of
``sys.modules``. The card's machine has no JAX, so an import there would
fail; this catches it here first."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import triforce_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "triforce_tpu") or m.startswith(("jax.",
                                                              "triforce_tpu.")))
print(len(names))
print(",".join(names))
print("BAD:" + ",".join(bad))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    count, names, bad = p.stdout.strip().splitlines()[-3:]
    assert bad == "BAD:", bad
    names = names.split(",")
    for want in ("triforce_tpu_torch.parallel.mesh",
                 "triforce_tpu_torch.parallel.sharding",
                 "triforce_tpu_torch.ops.sp_attention",
                 "triforce_tpu_torch.engine", "triforce_tpu_torch.cli"):
        assert want in names
    assert int(count) == len(names) >= 30
