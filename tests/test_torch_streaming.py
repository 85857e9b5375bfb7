"""tinaural_torch's streams (`Stream`, `BatchedStream`) against the JAX
package's (plain jnp route) and the float64 `GoldenStream`, and the state
bridge between the two packages."""

import jax
import numpy as np
import pytest
import torch

import tinaural
import tinaural_torch
from conftest import snr_db
from tinaural.models.streaming import BatchedStream as JaxBatchedStream
from tinaural.models.streaming import Stream as JaxStream
from tinaural.models.streaming import StreamState as JaxStreamState
from tinaural.reference import golden
from tinaural_torch import BatchedStream, Stream, StreamState
from tinaural_torch.data import TorchTable

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tables():
    arrays = tinaural.load_hrir_set("synthetic")
    return arrays, TorchTable.from_hrir_table(arrays, "cpu")


def _configs(**kw):
    return (tinaural_torch.RenderConfig(**kw),
            tinaural.RenderConfig(use_pallas=False, **kw))


def _check(ours, jax_out, gold):
    ours = ours.numpy()
    assert ours.shape == np.asarray(jax_out).shape == gold.shape
    assert np.isfinite(ours).all()
    assert snr_db(jax_out, ours) >= 90
    assert snr_db(gold, ours) >= 80


def _track(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 360, n).astype(np.float32),
            rng.uniform(-40, 90, n).astype(np.float32))


@pytest.mark.parametrize("B", [256, 128])
def test_push_chain(tables, B):
    """Chained single pushes, the first included, at block 256 and 128."""
    arrays, t = tables
    cfg, jcfg = _configs(stream_block=B)
    s, js = Stream(t, cfg), JaxStream(arrays, jcfg)
    gs = golden.GoldenStream(arrays, jcfg)
    x = np.random.default_rng(B).standard_normal((5, B)).astype(np.float32)
    azs, els = _track(5, B)
    ys, jys, gys = [], [], []
    for b in range(5):
        ys.append(s.push(x[b], azs[b], els[b]))
        jys.append(np.asarray(js.push(x[b], azs[b], els[b])))
        gys.append(gs.push(x[b].astype(np.float64), azs[b], els[b]))
    assert ys[0].shape == (2, B)
    _check(torch.cat(ys, -1), np.concatenate(jys, -1), np.concatenate(gys, -1))


@pytest.mark.parametrize("k", [1, 4])
def test_push_many(tables, k):
    """K = 6 chained batched pushes of S = 3 streams at update rate k: at
    k = 4, pushes 0 and 4 update and the rest hold (golden push_held);
    the directions move every push, so a held push that updated would
    show. A second burst restarts the schedule."""
    arrays, t = tables
    cfg, jcfg = _configs(stream_update_rate=k)
    S, K, B = 3, 6, cfg.stream_block
    bs, jbs = BatchedStream(t, S, cfg), JaxBatchedStream(arrays, S, jcfg)
    gss = [golden.GoldenStream(arrays, jcfg) for _ in range(S)]
    rng = np.random.default_rng(k)
    for burst in range(2):
        blocks = rng.standard_normal((K, S, B)).astype(np.float32)
        azs = rng.uniform(0, 360, (K, S)).astype(np.float32)
        els = rng.uniform(-40, 90, (K, S)).astype(np.float32)
        ys = bs.push_many(blocks, azs, els)
        assert ys.shape == (K, S, 2, B)
        gold = np.stack([np.stack([
            gss[s].push(blocks[i, s].astype(np.float64), azs[i, s], els[i, s])
            if i % k == 0 else gss[s].push_held(blocks[i, s].astype(np.float64))
            for s in range(S)]) for i in range(K)])
        _check(ys, jbs.push_many(blocks, azs, els), gold)
    # single pushes always update; a (S,) direction holds over the burst
    y1 = bs.push(blocks[0], azs[0], els[0])
    _check(y1, jbs.push(blocks[0], azs[0], els[0]),
           np.stack([gss[s].push(blocks[0, s].astype(np.float64), azs[0, s],
                                 els[0, s]) for s in range(S)]))
    _check(bs.push_many(blocks, azs[0], els[0]),
           jbs.push_many(blocks, azs[0], els[0]),
           np.stack([np.stack([
               gss[s].push(blocks[i, s].astype(np.float64), azs[0, s],
                           els[0, s])
               if i % k == 0 else
               gss[s].push_held(blocks[i, s].astype(np.float64))
               for s in range(S)]) for i in range(K)]))


@pytest.mark.parametrize("k", [1, 4])
def test_render_offline(tables, k):
    """Stream.render_offline on the update schedule, Stream.push_many
    equal to it (and a scalar direction held over the burst), and
    BatchedStream.render_offline equal to one Stream per signal (to
    float32 rounding: the batch changes the plain route's summation
    order)."""
    arrays, t = tables
    cfg, jcfg = _configs(stream_update_rate=k)
    B, nb = cfg.stream_block, 6
    x = np.random.default_rng(7).standard_normal(nb * B).astype(np.float32)
    dirs = np.stack(_track(nb, 8), -1)
    y = Stream(t, cfg).render_offline(x, dirs)
    gs = golden.GoldenStream(arrays, jcfg)
    gold = np.concatenate([
        gs.push(x[b * B:(b + 1) * B].astype(np.float64), *dirs[b])
        if b % k == 0 else gs.push_held(x[b * B:(b + 1) * B].astype(np.float64))
        for b in range(nb)], -1)
    _check(y, JaxStream(arrays, jcfg).render_offline(x, dirs), gold)
    xs = np.stack([x, x[::-1]])
    dd = np.stack([dirs, dirs[::-1]])
    ym = Stream(t, cfg).push_many(x.reshape(nb, B), dirs[:, 0], dirs[:, 1])
    assert torch.equal(ym.permute(1, 0, 2).reshape(2, -1), y)
    held = Stream(t, cfg).push_many(x.reshape(nb, B), dirs[0, 0], dirs[0, 1])
    assert torch.equal(held, Stream(t, cfg).push_many(
        x.reshape(nb, B), np.repeat(dirs[:1, 0], nb), np.repeat(dirs[:1, 1], nb)))
    yb = BatchedStream(t, 2, cfg).render_offline(xs, dd)
    assert yb.shape == (2, 2, nb * B)
    assert snr_db(y.numpy(), yb[0].numpy()) >= 120
    assert snr_db(Stream(t, cfg).render_offline(xs[1], dd[1]).numpy(),
                  yb[1].numpy()) >= 120


def test_int16_pcm_and_directions(tables):
    """int16 audio scales by 2^-15; int16 directions stay degrees."""
    arrays, t = tables
    cfg, jcfg = _configs()
    B = cfg.stream_block
    pcm = np.random.default_rng(9).integers(-20000, 20000, (2, B),
                                             dtype=np.int16)
    az, el = np.array([90, 250], np.int16), np.array([10, -20], np.int16)
    y = BatchedStream(t, 2, cfg).push(pcm, az, el)
    ref = BatchedStream(t, 2, cfg).push(pcm.astype(np.float32) * 2.0**-15,
                                        az.astype(np.float32),
                                        el.astype(np.float32))
    assert torch.equal(y, ref)
    jy = JaxBatchedStream(arrays, 2, jcfg).push(pcm, az, el)
    assert snr_db(jy, y.numpy()) >= 90
    assert float(y[0, 1].pow(2).sum()) > float(y[0, 0].pow(2).sum())  # az 90


def test_state_bridge(tables):
    """A JAX stream's state carries into the port and continues; the
    port's state carries back and the JAX stream continues; both agree
    with an uninterrupted run."""
    arrays, t = tables
    cfg, jcfg = _configs()
    B = cfg.stream_block
    x = np.random.default_rng(11).standard_normal((6, B)).astype(np.float32)
    azs, els = _track(6, 12)
    whole = JaxStream(arrays, jcfg)
    ref = [np.asarray(whole.push(x[b], azs[b], els[b])) for b in range(6)]

    js = JaxStream(arrays, jcfg)
    for b in range(2):
        js.push(x[b], azs[b], els[b])
    s = Stream(t, cfg)
    s.state = StreamState.from_numpy(js.state, "cpu")
    assert [tuple(f.shape) for f in s.state] == [
        tuple(np.shape(f)) for f in js.state]
    got = [s.push(x[b], azs[b], els[b]).numpy() for b in (2, 3)]
    js2 = JaxStream(arrays, jcfg)
    js2.state = JaxStreamState(*jax.device_put(s.state.to_numpy()))
    got += [np.asarray(js2.push(x[b], azs[b], els[b])) for b in (4, 5)]
    assert snr_db(np.concatenate(ref[2:], -1), np.concatenate(got, -1)) >= 90


def test_kernel_routes_get_contiguous_tensors(tables, monkeypatch):
    """The streams hand the kernel routes contiguous tensors only (the CUDA
    wrappers reject views): a transposed burst in
    BatchedStream.render_offline, a strided push_many burst, and a state
    set from strided views, which then resumes exactly."""
    from tinaural_torch.ops import partitioned_conv as pc

    _, t = tables
    conv = pc.stream_conv_reference

    def checked(*args, **kw):
        assert all(a.is_contiguous() for a in args)
        return conv(*args, **kw)

    monkeypatch.setattr(pc, "stream_conv_reference", checked)
    cfg = tinaural_torch.RenderConfig(stream_update_rate=2)
    B, S, nb = cfg.stream_block, 3, 4
    rng = np.random.default_rng(14)
    xs = rng.standard_normal((S, nb * B)).astype(np.float32)
    dirs = rng.uniform(0, 90, (S, nb, 2)).astype(np.float32)
    bs, bs2 = BatchedStream(t, S, cfg), BatchedStream(t, S, cfg)
    y = bs.render_offline(xs, dirs)
    view = torch.from_numpy(xs.reshape(S, nb, B)).transpose(0, 1)
    y2 = bs2.push_many(view, dirs[..., 0].T, dirs[..., 1].T)
    assert torch.equal(y, y2.permute(1, 2, 0, 3).reshape(S, 2, nb * B))
    bs2.state = StreamState(*(torch.stack([f, f], -1)[..., 0]
                              for f in bs.state))
    assert torch.equal(bs.push_many(view, dirs[:, 0, 0], dirs[:, 0, 1]),
                       bs2.push_many(view, dirs[:, 0, 0], dirs[:, 0, 1]))


def test_saved_state_resumes_bit_identically(tables):
    """A saved state survives later pushes (nothing is written in place)
    and resumes bit-identically, in a batched stream at k = 2."""
    _, t = tables
    cfg = tinaural_torch.RenderConfig(stream_update_rate=2)
    B, S = cfg.stream_block, 2
    rng = np.random.default_rng(13)
    blocks = torch.from_numpy(rng.standard_normal((3, S, B)).astype(np.float32))
    azs = torch.from_numpy(rng.uniform(0, 360, (3, S)).astype(np.float32))
    els = torch.zeros((3, S))
    bs = BatchedStream(t, S, cfg)
    bs.push_many(blocks, azs, els)
    saved = bs.state
    copy = StreamState(*(f.clone() for f in saved))
    first = bs.push_many(blocks, azs, els)
    bs.push_many(blocks.flip(0), azs, els)
    assert all(torch.equal(a, b) for a, b in zip(saved, copy))
    bs.state = saved
    assert torch.equal(bs.push_many(blocks, azs, els), first)
    bs.reset()
    assert not bool(bs.state.started.any())
    with pytest.raises(ValueError):
        bs.state = StreamState(*(f[:1] for f in saved))
