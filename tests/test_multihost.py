"""Multi-host simulation: 2 OS processes x 4 virtual CPU devices each,
coordinated by jax.distributed — the closest CPU stand-in for the
multi-host story (SURVEY §2.3 distributed row; BASELINE >80% scaling
target's N>=2-hosts rung).

Each process holds its shard of the pixel domain, renders it with the
replicated scene, and the cross-process psum of the per-shard ray counts
plus the assembled image must match a single-process render exactly.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytestmark = [pytest.mark.heavy, pytest.mark.slow]

_WORKER = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1])
port = sys.argv[2]
jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid
)
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

sys.path.insert(0, "/root/repo")
from fermat_tpu.integrators.pt import PTOptions, render_pass
from fermat_tpu.scene.procedural import cornell_box, cornell_camera
from fermat_tpu.scene.view import SceneView

assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8  # 4 local x 2 processes

view = SceneView.build(cornell_box(), cornell_camera())
opts = PTOptions(max_path_length=2, rr=False)
RES = 16
n = RES * RES
mesh = Mesh(np.array(jax.devices()), ("tiles",))
pix_sh = NamedSharding(mesh, P("tiles"))
repl = NamedSharding(mesh, P())

# globally-sharded pixel ids: each process supplies its local shard
# (device ids are process-offset on multi-process CPU; use the global
# mesh ordinal instead)
ordinal = {d: i for i, d in enumerate(jax.devices())}
local_ids = np.arange(n, dtype=np.uint32).reshape(8, n // 8)[
    [ordinal[d] for d in jax.local_devices()]
]
arrs = [jax.device_put(local_ids[i], d)
        for i, d in enumerate(jax.local_devices())]
pix = jax.make_array_from_single_device_arrays((n,), pix_sh, arrs)
view_r = jax.device_put(view, repl)


@jax.jit
def f(v, p):
    out = render_pass(v, opts, RES, RES, jnp.uint32(0), pix=p)
    img = out.composited.stack()
    # reduce to fully-replicated scalars in-graph (every process can read
    # them without a host-side allgather)
    return jnp.sum(img), jnp.mean(img), out.rays


total, mean, rays = f(view_r, pix)
print("RESULT" + json.dumps({
    "pid": pid,
    "rays": float(rays),
    "mean": float(mean),
    "sum": float(total),
}), flush=True)
"""


def test_two_process_render_matches_single():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    workers = []
    env = dict(os.environ)
    for pid in range(2):
        workers.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(pid), port],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            cwd="/root/repo",
        ))
    results = {}
    logs = []
    for w in workers:
        out, err = w.communicate(timeout=900)
        logs.append((w.returncode, out.decode(), err.decode()[-2000:]))
        for line in out.decode().splitlines():
            if line.startswith("RESULT"):
                r = json.loads(line[len("RESULT"):])
                results[r["pid"]] = r
    assert all(w.returncode == 0 for w in workers), logs
    assert set(results) == {0, 1}, logs
    # both processes assembled the same global image
    assert results[0]["sum"] == results[1]["sum"]

    # single-process reference (8 virtual devices in THIS process is not
    # needed — plain single-device render is the ground truth)
    code = r"""
import json, os, sys
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, "/root/repo")
from fermat_tpu.integrators.pt import PTOptions, render_pass
from fermat_tpu.scene.procedural import cornell_box, cornell_camera
from fermat_tpu.scene.view import SceneView
view = SceneView.build(cornell_box(), cornell_camera())
out = render_pass(view, PTOptions(max_path_length=2, rr=False), 16, 16,
                  jnp.uint32(0))
img = np.asarray(out.composited.stack())
print("RESULT" + json.dumps({"sum": float(img.sum()),
                             "rays": float(out.rays)}))
"""
    ref = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         timeout=900, cwd="/root/repo")
    assert ref.returncode == 0, ref.stderr.decode()[-2000:]
    rline = [l for l in ref.stdout.decode().splitlines()
             if l.startswith("RESULT")][0]
    rref = json.loads(rline[len("RESULT"):])
    np.testing.assert_allclose(results[0]["sum"], rref["sum"], rtol=1e-5)
    assert results[0]["rays"] == rref["rays"]
