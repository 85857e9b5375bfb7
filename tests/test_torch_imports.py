"""tinaural_torch imports neither jax nor flax, and its CPU route never
reaches the kernel build."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PROBE = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import tinaural_torch
from tinaural_torch.models.renderer import _neighbours
from tinaural_torch.ops import assembly_mac as am
from tinaural_torch.ops import block_render as br
from tinaural_torch.ops import block_step as step
from tinaural_torch.ops import partitioned_conv as pc
assert not any(m == "jax" or m.startswith(("jax.", "flax", "tinaural."))
               or m == "tinaural" for m in sys.modules), "JAX package imported"
t = tinaural_torch.TorchTable.from_hrir_table(
    tinaural_torch.load_hrir_set("synthetic"), "cpu")
r = tinaural_torch.BinauralRenderer(t, tinaural_torch.RenderConfig(block_size=256))
y = r.render_trajectory(np.ones(1000, np.float32), np.zeros((4, 2), np.float32))
assert y.shape == (2, 1000 + 191) and bool(torch.isfinite(y).all())
s = tinaural_torch.Stream(t)
assert s.push(np.ones(256, np.float32), 30.0, 0.0).shape == (2, 256)
bs = tinaural_torch.BatchedStream(t, 2, tinaural_torch.RenderConfig(
    stream_update_rate=2))
assert bs.push_many(np.ones((3, 2, 256), np.float32), np.zeros(2),
                    np.zeros(2)).shape == (3, 2, 2, 256)
assert r.render_streamed(np.ones(1024, np.float32),
                         np.zeros((4, 2), np.float32)).shape == (2, 1024)
for n in (500, 2048):  # the direct route, then the block route
    assert tinaural_torch.render(t, np.ones(n, np.float32), 30.0, 0.0,
                                 r.config).shape == (2, n + 191)
assert r.render_batch(np.ones((2, 600), np.float32),
                      np.zeros((2, 2), np.float32)).shape == (2, 2, 600 + 191)
xs = np.ones((2, 600), np.float32)  # the mixdown route, static and moving
assert r.render_scene(xs, np.zeros((2, 2), np.float32)).shape == (2, 791)
assert r.render_scene(xs, np.zeros((2, 3, 2), np.float32)).shape == (2, 791)
r4 = tinaural_torch.BinauralRenderer(t, tinaural_torch.RenderConfig(
    block_size=2048))  # n_fft 4096: the natural-order route
assert r4.render_trajectory(np.ones(5000, np.float32),
                            np.zeros((3, 2), np.float32)).shape == (2, 5191)
assert "tinaural_torch.ops._build" not in sys.modules, "CPU route reached the build"
assert all(v == 0 for v in (*br.launches.values(), *step.launches.values(),
                            *pc.launches.values(), *am.launches.values()))
assert "jax" not in sys.modules and "flax" not in sys.modules
print("ok")
"""


def test_import_leaves_out_jax_and_build():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
