"""Each cell's run, driven on the CPU at a test size past the harness's
look for a card: sound, it comes out correct; with the timed path broken
underneath in each way the cell can break, or with the control in the
program's place, it does not."""

import numpy as np
import pytest
import torch

from benchmark.harness import spec
from benchmark.tools.readings import control
from benchmark.tests.bench_tiny import CPU, TINY, run, tiny
from tinaural_torch.models import renderer

CELLS = sorted(TINY)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = run(name)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in spec.metrics(name, False)}
    assert set(out["metrics"]) == names
    assert list(out)[-1] == "check"


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limit(name):
    got = control(tiny(name), 2**31 + 21, CPU)
    limits = spec.cell(name).limits
    assert any(got[k] > 3 * limits[k] for k in limits), got


def _altered(core):
    """An answer altered where it is produced: one block of the render's
    output lost."""
    def broken(*a, **k):
        y = core(*a, **k).clone()
        y[..., 2048:3072] = 0.0
        return y
    return broken


def _half_sources(core):
    """Half of the sources left out, the rest scaled to the whole."""
    def broken(table, xbs, dirs, config, render=None):
        S = xbs.shape[0] // 2
        return 2.0 * core(table, xbs[:S], dirs[:S], config, render)
    return broken


OFFLINE_FAULTS = {
    "kemar128.trajectory": [("_trajectory_core", _altered)],
    "kemar128.scene": [("_scene_core", _altered),
                       ("_scene_core", _half_sources)],
}


@pytest.mark.parametrize("name, core, fault", [
    (n, c, f) for n, fs in OFFLINE_FAULTS.items() for c, f in fs],
    ids=lambda v: getattr(v, "__name__", v))
def test_offline_fault_is_caught(monkeypatch, name, core, fault):
    monkeypatch.setattr(renderer, core, fault(getattr(renderer, core)))
    out = run(name)
    assert not out["correct"], out["check"]


@pytest.mark.gpu
def test_traced_run_on_the_card():
    """On a card: a tiny run with --trace 1 reads every per-layer metric
    of its cell, and its device busy time lies inside its window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark.harness import runner

    for name in CELLS:
        out = runner.run(tiny(name), 5, 0.5, True, torch.device("cuda", 0),
                         0.0, log=lambda line: None)
        assert out["correct"], out["check"]
        dev = out["device"]
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert np.isfinite(list(v["value"] for v in out["metrics"].values())).all()
