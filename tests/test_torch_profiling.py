"""tinaural_torch.utils.profiling on the CPU: the fence, the timers, the
chrome trace and the anomaly switch (`tinaural.utils.profiling`'s
counterparts). Times here are the CPU's and only checked to be positive
and finite."""

import glob
import json
import math

import numpy as np
import pytest
import torch

import tinaural_torch as tt
from tinaural_torch.utils import (enable_debug_checks, fence, marginal_cost,
                                  marginal_cost_ab, trace)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def render():
    """A small CPU trajectory render: 16 blocks of 256, moving."""
    t = tt.TorchTable.from_hrir_table(tt.load_hrir_set("synthetic"), "cpu")
    r = tt.BinauralRenderer(t, tt.RenderConfig(block_size=256))
    x = np.random.default_rng(0).standard_normal(16 * 256).astype(np.float32)
    dirs = np.stack([np.linspace(0, 300, 16), np.zeros(16)], 1)
    return lambda: r.render_trajectory(x, dirs)


def test_fence_reads_the_last_element():
    assert fence(torch.arange(6.0).reshape(2, 3)) == 5.0
    assert isinstance(fence(torch.arange(3)), float)


def test_fence_takes_the_real_part_of_a_complex_tensor():
    assert fence(torch.tensor([1 + 2j, 3 - 4j])) == 3.0


def test_fence_takes_the_last_tensor_leaf():
    st = tt.init_state(tt.TorchTable.from_hrir_table(
        tt.load_hrir_set("synthetic"), "cpu"), tt.RenderConfig())
    assert fence((torch.ones(2), {"a": torch.zeros(1), "b": torch.full(
        (3,), 7.0)}, "not a tensor")) == 7.0
    assert fence(st) == 0.0  # a NamedTuple state: `started`
    with pytest.raises(TypeError):
        fence(["no tensor"])


def test_timers_are_positive_and_finite(render):
    m = marginal_cost(render, k1=1, k2=3, reps=3)
    assert 0 < m < math.inf
    ab = marginal_cost_ab({"a": render, "b": lambda: render()[:, :10]},
                          k1=1, k2=3, reps=3)
    assert set(ab) == {"a", "b"}
    assert all(0 < v < math.inf for v in ab.values())


def test_trace_writes_a_chrome_trace_of_the_render(render, tmp_path):
    with trace(tmp_path / "tr") as d:
        render()
    assert d == tmp_path / "tr"
    files = glob.glob(str(d / "trace-*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("aten::fft_") for n in names), sorted(names)[:20]
    with trace(d):  # a second trace beside the first, not over it
        render()
    assert len(glob.glob(str(d / "trace-*.json"))) == 2


def test_enable_debug_checks_flags_a_nan_in_a_backward():
    def nan_grad():
        x = torch.zeros(1, requires_grad=True)
        (torch.sqrt(x) * 0).sum().backward()  # 0 · 1/(2√0): NaN
        return x.grad

    assert torch.isnan(nan_grad()).all()  # unchecked, the NaN passes
    enable_debug_checks()
    try:
        with pytest.raises(RuntimeError, match="nan"):
            nan_grad()
    finally:
        torch.autograd.set_detect_anomaly(False)
    assert not torch.is_anomaly_enabled()
