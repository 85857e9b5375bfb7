"""tinaural_torch.parallel against tinaural.parallel and golden.

The port runs over gloo: at world sizes 2 and 4 in ranks that
`tinaural_torch.parallel.launch.spawn` starts, once a world size in a
module fixture that runs every case (`torch_parallel_ranks.run`), and at
world size 1 in the test process's own group. The JAX package runs the
same cases on meshes of the same shape over the suite's 8 virtual CPU
devices (`conftest.py`). Bars: ≥ 90 dB against the JAX sharded function,
≥ 60 dB against golden, equal bits where the port's route is the same
(world size 1 against the unsharded entry points, checkpoint and resume,
a burst against single pushes); the fit's loss to rtol 1e-5 and every
gradient leaf to rtol 1e-4, atol 1e-3, against `jax.grad` of the JAX
sharded loss. 128-tap synthetic table, block 128 (n_fft 512: three
blocks a shard cover an overlap-add tail), stream block 128.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import tinaural
import tinaural_torch as tt
import torch_parallel_ranks
from tinaural import parallel as jpar
from tinaural.config import RenderConfig as JaxConfig
from tinaural.models import fit as jfit
from tinaural.reference import golden
from tinaural_torch.models import fit as tfit
from tinaural_torch.parallel import launch, make_mesh
from tinaural_torch.parallel.dryrun import dryrun_multichip

from conftest import snr_db

torch.set_num_threads(1)

B = 128


def _dirs(rng, *lead):
    return np.stack([rng.uniform(0, 360, lead), rng.uniform(-40, 90, lead)],
                    axis=-1).astype(np.float32)


def _scene_case(mesh, S, N, static, seed):
    rng = np.random.default_rng(seed)
    nb = -(-N // B)
    return {"kind": "scene", "mesh": mesh, "cfg": {"block_size": B},
            "xs": rng.standard_normal((S, N)).astype(np.float32),
            "dirs": _dirs(rng, S) if static else _dirs(rng, S, nb)}


def _long_case(mesh, N, seed, **cfg):
    rng = np.random.default_rng(seed)
    nb = -(-N // B)
    dirs = np.stack([np.linspace(0, 355, nb), np.linspace(-40, 90, nb)],
                    axis=1).astype(np.float32)
    return {"kind": "long", "mesh": mesh, "cfg": {"block_size": B, **cfg},
            "x": rng.standard_normal(N).astype(np.float32), "dirs": dirs}


def _stream_inputs(S, K, seed):
    rng = np.random.default_rng(seed)
    return {"blocks": rng.standard_normal((K, S, B)).astype(np.float32),
            "azs": ((np.linspace(0, 340, S)[None] + 7.0 * np.arange(K)[:, None])
                    % 360).astype(np.float32),
            "els": np.broadcast_to(np.linspace(-30, 60, S), (K, S))
            .astype(np.float32)}


def _fit_case(mesh, seed, S=5, nb=3):
    rng = np.random.default_rng(seed)
    params = {"ear_eq_log": rng.normal(0, 0.3, (2, 8)),
              "itd_scale_log": rng.normal(0, 0.2),
              "ild_scale_log": rng.normal(0, 0.2),
              "gain_log": rng.normal(0, 0.2)}
    return {"kind": "fit", "mesh": mesh, "cfg": {"block_size": B},
            "params": {k: np.asarray(v, np.float32) for k, v in params.items()},
            "xbs": rng.standard_normal((S, nb, B)).astype(np.float32),
            "dirs": _dirs(rng, S, nb),
            "target": 0.1 * rng.standard_normal((2, nb * B + 191))
            .astype(np.float32), "lr": 3e-2, "steps": 2}


# name → case, each run by the world size of its mesh; world size 4's
# first in each table, as its ranks finish first
SCENES = {"static, 5 sources on (4, 1)": _scene_case((4, 1), 5, 600, True, 2),
          "moving (2, 2)": _scene_case((2, 2), 6, 500, False, 3),
          "moving (2, 1)": _scene_case((2, 1), 4, 700, False, 1)}
LONGS = {"dir_rate 4 (1, 4)": _long_case((1, 4), 24 * B, 5, dir_rate=4,
                                         out_length="same"),
         "full (2, 2)": _long_case((2, 2), 9 * B + 30, 6),
         "ragged (1, 2)": _long_case((1, 2), 10 * B + 50, 4,
                                     out_length="same")}
STREAMS = {"(2, 1)": {"kind": "streams", "mesh": (2, 1), "pushes": 3,
                      "cfg": {"stream_block": B}, **_stream_inputs(4, 4, 7)},
           "update rate 4 (4, 1)": {"kind": "streams", "mesh": (4, 1),
                                    "burst": True,
                                    "cfg": {"stream_block": B,
                                            "stream_update_rate": 4},
                                    **_stream_inputs(8, 8, 8)}}
FITS = {"(2, 1)": _fit_case((2, 1), 9), "(4, 1)": _fit_case((4, 1), 10)}
WORLD_ONE = {"scene moving": _scene_case((1, 1), 3, 700, False, 11),
             "scene static": _scene_case((1, 1), 3, 700, True, 12),
             "long": _long_case((1, 1), 9 * B + 30, 13),
             "streams": {"kind": "streams", "mesh": (1, 1), "burst": True,
                         "cfg": {"stream_block": B}, **_stream_inputs(3, 4, 14)},
             "fit": _fit_case((1, 1), 15),
             "mesh_errors": {"kind": "mesh_errors", "mesh": (1, 1)}}


def _jcfg(c, key="cfg"):
    return JaxConfig(**c[key])


def _jmesh(shape):
    return jpar.make_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])


@pytest.fixture(scope="module")
def jtable():
    return tinaural.load_hrir_set("synthetic")


@pytest.fixture(scope="module")
def jax_streams(jtable):
    """The JAX package's sharded streams on each streams case: single
    pushes and the state after them, one more push, or one burst."""
    out = {}
    for name, c in STREAMS.items():
        svc = jpar.ShardedBatchedStream(jtable, c["blocks"].shape[1],
                                        _jmesh(c["mesh"]), _jcfg(c))
        if "pushes" in c:
            k = c["pushes"]
            ys = [np.asarray(svc.push(c["blocks"][i], c["azs"][i],
                                      c["els"][i])) for i in range(k)]
            state = {f: np.asarray(getattr(svc.state, f))
                     for f in svc.state._fields}
            nxt = np.asarray(svc.push(c["blocks"][k], c["azs"][k],
                                      c["els"][k]))
            out[name] = {"push": np.stack(ys), "state": state, "next": nxt}
        else:
            out[name] = {"burst": np.asarray(svc.push_many(
                c["blocks"], c["azs"], c["els"]))}
    return out


def _cases(world):
    cases = {**{f"scene {k}": v for k, v in SCENES.items()},
             **{f"long {k}": v for k, v in LONGS.items()},
             **{f"streams {k}": v for k, v in STREAMS.items()},
             **{f"fit {k}": v for k, v in FITS.items()},
             f"mesh_errors {world}": {"kind": "mesh_errors",
                                      "mesh": (world, 1)}}
    return {k: v for k, v in cases.items()
            if v["mesh"][0] * v["mesh"][1] == world}


@pytest.fixture(scope="module")
def ranks(request, tmp_path_factory):
    """→ result(name): a case's result from rank 0. World sizes 4 and 2
    (one spawn each) and the dry run run one after another on a thread
    while the tests compute the JAX side (world size 2's streams take the
    JAX state, computed while world size 4 runs); world size 1 runs at
    once in this process's own group."""
    where = {name: world for world in (2, 4) for name in _cases(world)}
    with ThreadPoolExecutor(1) as pool:
        futures = {}
        for world in (4, 2):
            cases = _cases(world)
            for name, c in cases.items():
                if c["kind"] == "streams" and "pushes" in c:
                    key = name.removeprefix("streams ")
                    jax_streams = request.getfixturevalue("jax_streams")
                    cases[name] = {**c, "jax_state": jax_streams[key]["state"]}
            futures[world] = pool.submit(
                launch.spawn, torch_parallel_ranks.run, world, "cpu", cases,
                workdir=tmp_path_factory.mktemp("rdv"))
        futures["dryrun"] = pool.submit(dryrun_multichip, 4, "cpu")
        d = tmp_path_factory.mktemp("rdv1")
        dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                                world_size=1, rank=0)
        try:
            one = torch_parallel_ranks.run(WORLD_ONE)
        finally:
            dist.destroy_process_group()

        def result(name):
            if name == "dryrun":
                return futures["dryrun"].result()
            if name.startswith("one "):
                return one[name.removeprefix("one ")]
            return futures[where[name]].result()[name]

        yield result


def _golden_scene(jtable, c):
    return golden.render_scene(jtable, c["xs"], c["dirs"], _jcfg(c))


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_sharded(ranks, jtable, name):
    c = SCENES[name]
    want = np.asarray(jpar.render_scene_sharded(
        jtable, c["xs"], c["dirs"], _jmesh(c["mesh"]), _jcfg(c)))
    ref = _golden_scene(jtable, c)
    got = ranks(f"scene {name}")
    assert got["y"].shape == want.shape == ref.shape
    assert got["same_everywhere"]
    assert snr_db(want, got["y"]) >= 90
    assert snr_db(ref, got["y"]) >= 60


@pytest.mark.parametrize("name", list(LONGS))
def test_long_sharded(ranks, jtable, name):
    c = LONGS[name]
    want = np.asarray(jpar.render_long_sharded(
        jtable, c["x"], c["dirs"], _jmesh(c["mesh"]), _jcfg(c)))
    # golden snaps the track itself (golden.snap_dirs) at dir_rate > 1
    ref = golden.render_trajectory(jtable, c["x"], c["dirs"], _jcfg(c))
    got = ranks(f"long {name}")
    assert got["y"].shape == want.shape == ref.shape
    assert got["same_everywhere"]
    assert snr_db(want, got["y"]) >= 90
    assert snr_db(ref, got["y"]) >= 60


def _golden_streams(jtable, c, n):
    """Each listener's golden stream over the first n blocks, on the
    case's update schedule → (n, S, 2, B)."""
    k = c["cfg"].get("stream_update_rate", 1)
    out = []
    for s in range(c["blocks"].shape[1]):
        g = golden.GoldenStream(jtable, JaxConfig(stream_block=B))
        out.append([g.push(c["blocks"][i, s].astype(np.float64),
                           c["azs"][i, s], c["els"][i, s]) if i % k == 0
                    else g.push_held(c["blocks"][i, s].astype(np.float64))
                    for i in range(n)])
    return np.asarray(out).transpose(1, 0, 2, 3)


def test_streams_push_across_shards(ranks, jtable, jax_streams):
    """Single pushes, every listener across the shard boundary, against
    the JAX sharded streams and each listener's golden stream."""
    c, got = STREAMS["(2, 1)"], ranks("streams (2, 1)")
    want = jax_streams["(2, 1)"]["push"]
    assert got["push"].shape == want.shape == (3, 4, 2, B)
    assert snr_db(want, got["push"]) >= 90
    ref = _golden_streams(jtable, c, 3)
    for s in range(4):
        assert snr_db(ref[:, s], got["push"][:, s]) >= 60, s


def test_streams_state_matches_jax(ranks, jax_streams):
    """The ranks' states after the pushes, rows in order, against the JAX
    sharded state: the same fields and shapes, ≥ 90 dB."""
    got = ranks("streams (2, 1)")["state"]
    want = jax_streams["(2, 1)"]["state"]
    assert set(got) == set(want)
    for f in want:
        assert got[f].shape == want[f].shape, f
        if np.any(want[f]):
            assert snr_db(want[f], got[f]) >= 90, f
        else:
            assert not np.any(got[f]), f


def test_streams_push_many_equals_pushes(ranks):
    assert ranks("streams (2, 1)")["many_equal"]


def test_streams_checkpoint_resume_equal_in_bits(ranks):
    assert ranks("streams (2, 1)")["resume_equal"]


def test_streams_carry_the_jax_state(ranks, jax_streams):
    """The JAX sharded state after three pushes, set on each rank (which
    keeps its rows), then one more push on both sides."""
    got = ranks("streams (2, 1)")["carried"]
    want = jax_streams["(2, 1)"]["next"]
    assert got.shape == want.shape == (4, 2, B)
    assert snr_db(want, got) >= 90


def test_streams_update_rate_4(ranks, jtable, jax_streams):
    c, got = STREAMS["update rate 4 (4, 1)"], ranks(
        "streams update rate 4 (4, 1)")
    want = jax_streams["update rate 4 (4, 1)"]["burst"]
    assert got["burst"].shape == want.shape == (8, 8, 2, B)
    assert snr_db(want, got["burst"]) >= 90
    ref = _golden_streams(jtable, c, 8)
    for s in (0, 1, 2, 7):  # the first two shards' edges and the last
        assert snr_db(ref[:, s], got["burst"][:, s]) >= 60, s


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_streams_refuse_indivisible_listeners(ranks, name):
    assert ranks(f"streams {name}")["refuses_indivisible"]


def _jax_fit(jtable, c, mesh_shape):
    """The JAX sharded loss and its jax.grad on the case's inputs."""
    p = jfit.FitParams(**{k: jnp.asarray(v) for k, v in c["params"].items()})
    args = (jax.device_put(jtable), jnp.asarray(c["xbs"]),
            jnp.asarray(c["dirs"]), jnp.asarray(c["target"]), _jcfg(c))
    if mesh_shape is None:
        return jax.value_and_grad(jfit.scene_loss)(p, *args)
    return jax.value_and_grad(jpar.scene_loss_sharded)(p, *args,
                                                       _jmesh(mesh_shape))


@pytest.mark.parametrize("name", list(FITS))
def test_fit_gradient_is_the_true_one(ranks, jtable, name):
    """The loss, and every gradient leaf on every rank, against jax.grad
    of the JAX sharded loss on the same mesh shape: no factor of the
    world size (an autograd all-reduce of the mixdown would give one)."""
    c = FITS[name]
    loss, grads = _jax_fit(jtable, c, c["mesh"])
    got = ranks(f"fit {name}")
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    assert got["same_grads"]
    for g, gj in zip(got["grads"], grads):
        np.testing.assert_allclose(g, np.asarray(gj), rtol=1e-4, atol=1e-3)
        assert np.any(g != 0)


@pytest.mark.parametrize("name", list(FITS))
def test_fit_steps_match_the_unsharded_steps(ranks, name):
    """Adam steps through `fit_step_sharded` keep the parameters equal on
    every rank and give the losses of `models.fit.train_step`."""
    c, got = FITS[name], ranks(f"fit {name}")
    t = tt.TorchTable.from_hrir_table(tt.load_hrir_set("synthetic"), "cpu")
    params = tfit.FitParams(*(torch.tensor(c["params"][f]).requires_grad_()
                              for f in tfit.FitParams._fields))
    opt = torch.optim.Adam(params, lr=c["lr"])
    xbs, dirs, target = (torch.from_numpy(c[k])
                         for k in ("xbs", "dirs", "target"))
    want = [float(tfit.train_step(params, opt, t, xbs, dirs, target,
                                  tt.RenderConfig(**c["cfg"])))
            for _ in range(c["steps"])]
    assert got["same_params"]
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_make_mesh_refuses_a_shape_off_the_world_size(ranks, world):
    got = ranks(f"mesh_errors {world}")
    assert "!=" in got["bad_shape"]
    assert "CUDA card" in got["cuda_without_card"]


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1, 1), "cpu")


@pytest.mark.parametrize("name", ["scene moving", "scene static"])
def test_world_one_scene_equals_render_scene(ranks, name):
    c, got = WORLD_ONE[name], ranks(f"one {name}")
    t = tt.TorchTable.from_hrir_table(tt.load_hrir_set("synthetic"), "cpu")
    want = tt.BinauralRenderer(t, tt.RenderConfig(**c["cfg"])).render_scene(
        c["xs"], c["dirs"])
    np.testing.assert_array_equal(got["y"], want.numpy())


def test_world_one_long_matches_render_trajectory(ranks, jtable):
    """One span with its leading silent block against the unsharded
    render, and against golden."""
    c, got = WORLD_ONE["long"], ranks("one long")
    t = tt.TorchTable.from_hrir_table(tt.load_hrir_set("synthetic"), "cpu")
    want = tt.BinauralRenderer(t, tt.RenderConfig(**c["cfg"])) \
        .render_trajectory(c["x"], c["dirs"]).numpy()
    assert got["y"].shape == want.shape
    assert snr_db(want, got["y"]) >= 100
    ref = golden.render_trajectory(jtable, c["x"], c["dirs"], _jcfg(c))
    assert snr_db(ref, got["y"]) >= 60


def test_world_one_streams_equal_batched_stream(ranks):
    c, got = WORLD_ONE["streams"], ranks("one streams")
    t = tt.TorchTable.from_hrir_table(tt.load_hrir_set("synthetic"), "cpu")
    bs = tt.BatchedStream(t, c["blocks"].shape[1], tt.RenderConfig(**c["cfg"]))
    want = bs.push_many(c["blocks"], c["azs"], c["els"])
    np.testing.assert_array_equal(got["burst"], want.numpy())


def test_world_one_fit_equals_scene_loss(ranks):
    c, got = WORLD_ONE["fit"], ranks("one fit")
    t = tt.TorchTable.from_hrir_table(tt.load_hrir_set("synthetic"), "cpu")
    params = tfit.FitParams(*(torch.tensor(c["params"][f]).requires_grad_()
                              for f in tfit.FitParams._fields))
    loss = tfit.scene_loss(params, t, *(torch.from_numpy(c[k]) for k in
                                        ("xbs", "dirs", "target")),
                           tt.RenderConfig(**c["cfg"]))
    loss.backward()
    np.testing.assert_allclose(got["loss"], loss.item(), rtol=1e-6)
    for g, p in zip(got["grads"], params):
        np.testing.assert_allclose(g, p.grad.numpy(), rtol=1e-5, atol=1e-7)


def test_world_one_mesh_errors(ranks):
    got = ranks("one mesh_errors")
    assert "!=" in got["bad_shape"]
    assert "CUDA card" in got["cuda_without_card"]


def test_dryrun_multichip_cpu(ranks):
    """Rank 0's shapes on the (2, 2) mesh: 8 sources of 384 samples and
    16 blocks of 128 at 64 taps (t_eff 128), 4 listeners over 2 shards."""
    out = ranks("dryrun")  # dryrun_multichip(4, "cpu")
    assert out["scene"] == (2, 384 + 127) and out["long"] == (2, 2048 + 127)
    assert np.isfinite(out["fit_loss"])
    assert out["push"] == (2, 2, 256) and out["push_many"] == (2, 2, 2, 256)
    assert out["push_many_rate_2"] == (4, 2, 2, 256)


def test_spawn_refuses_an_unknown_device_type():
    with pytest.raises(ValueError, match="device_type"):
        launch.spawn(os.getpid, 1, "tpu")
