"""The choice of kernel, pinned: the renderer's route rule
(`models.renderer.route`) and the launch-mode rule of every kernel with a
`layout` call (`ops._layout.launch_mode` over each plan's body and shared
figure), each as a table of literals. A change to either rule that moves
any shape's route or mode fails here."""

import pytest

from tinaural_torch.models import renderer as rd
from tinaural_torch.ops import _layout
from tinaural_torch.ops.conv_plan import conv_launch, conv_plan, stream_launch
from tinaural_torch.ops.filters import n_parts
from tinaural_torch.ops.mac_plan import mac_plan
from tinaural_torch.ops.partitions_plan import launch, partitions_plan
from tinaural_torch.ops.render_plan import filters_plan, mix_groups, mix_plan
from tinaural_torch.ops.spectra_inverse import inverse_plan
from tinaural_torch.ops.step_plan import (mix_launch, pruned_plan,
                                          spectra_rows, step_plan)
from tinaural_torch.ops.step_plan import mix_groups as step_mix_groups

H100_SHARED_BYTES = 232_448  # one block's opt-in shared memory (227 KB)
SMS = 132  # the H100's

# (kind, S, nb, n_fft, SMs) → the route, at each side of each threshold;
# the first row of each kind is a cell's shape where the benchmark has one
ROUTES = [
    ("trajectory", 1, 8192, 2048, 132, "block_render"),
    ("trajectory", 1, 8192, 4096, 132, "assembly_mac_render"),
    ("trajectory", 1, 131, 2048, 132, "block_render"),
    ("trajectory", 1, 8, 2048, 0, "block_render"),
    ("trajectory", 1, 8, 4096, 0, "assembly_mac_render"),
    ("batch", 64, 128, 4096, 132, "assembly_mac_render"),
    ("batch", 64, 128, 2048, 132, "block_step_render"),
    ("batch", 1, 132, 2048, 0, "block_step_render"),
    ("batch", 2, 131, 4096, 0, "assembly_mac_render"),
    ("scene", 64, 128, 2048, 132, "scene_step_render"),
    ("scene", 64, 131, 2048, 132, "scene_step_render"),
    ("scene", 64, 132, 2048, 132, "block_render"),
    ("scene", 2, 131, 2048, 132, "scene_step_render"),
    ("scene", 1, 131, 2048, 132, "block_render"),
    ("scene", 64, 128, 4096, 132, "scene_step_render"),
    ("scene", 2, 132, 4096, 132, "block_render"),
    ("scene", 64, 128, 2048, 0, "block_render"),
    ("static_scene", 1, 131, 2048, 132, "scene_step_render"),
    ("static_scene", 64, 132, 4096, 132, "scene_step_render"),
    ("static_scene", 2, 8, 2048, 0, "scene_step_render"),
    ("static", 1, 8, 2048, 132, "block_step_render"),
    ("static", 1, 132, 4096, 0, "block_step_render"),
    ("streamed", 1, 132, 1024, 132, "partitioned_render"),
    ("streamed", 1, 8, 4096, 0, "partitioned_render"),
]


@pytest.mark.parametrize("kind,S,nb,n_fft,sms,want", ROUTES)
def test_route_rule(kind, S, nb, n_fft, sms, want):
    got = rd.route(kind, S, nb, n_fft, sms)
    assert got is getattr(rd, want), (got.__name__, want)


def test_route_rule_refuses_an_unknown_kind():
    with pytest.raises(ValueError):
        rd.route("mono", 1, 8, 2048, 0)


# The columns: n_fft 64 … 262144 (NS), or blocks 64 … 4096 (BLOCKS) for
# the partitioned kernels; the rows: taps, blocks, (S, nb) or n_fft.
NS = [1 << k for k in range(6, 19)]
TAPS = (64, 128, 512, 2048, 8128, 16000, 30000, 44100)
BLOCKS = (64, 128, 256, 512, 1024, 2048, 4096)
LETTER = {_layout.REGISTER: "R", _layout.CLUSTER: "C", _layout.PRUNED: "P",
          _layout.RADIX2: "2", _layout.SPLIT: "S", _layout.DIRECT: "D"}
FORCED_WORK = 256  # two passes take 65536 points: larger FFTs raise (X)


def _mode(body, shared_f2, largest_fft):
    try:
        mode, _ = _layout.launch_mode(body, shared_f2, largest_fft,
                                      H100_SHARED_BYTES)
    except ValueError:
        return "X"
    return LETTER[mode]


def _assembly(plan_of, taps, n):
    """assemble_filters or assembly_mac: the plan's own shared figure."""
    try:
        p = plan_of(taps, n)
    except ValueError:
        return "."  # n_fft below taps + DELAY_PAD
    return _mode(p.body, p.shared_f2, n)


def _mix_inverse(S, nb, n):
    if n < 128:
        return "."
    p = mix_plan(n)
    return _mode(p.body, mix_groups(S, nb, p, SMS) * p.group_f2, n)


def _spectra(B, n, mix, S=64, nb=128):
    """block_spectra over S·nb rows, or block_spectra_mix over S sources
    × nb blocks under crossfade, at blocks of B samples."""
    if n < B:
        return "."
    p = pruned_plan(n, mix, B)
    if p is not None:
        return _mode(p.body, p.shared_f2, n)
    p = step_plan(n, mix)
    if mix:
        chunk = mix_launch(S, nb, n, SMS, B, True)[0]
        per = step_mix_groups(p, chunk, -(-S // chunk) * nb, SMS)
    else:
        per = spectra_rows(p, S * nb, SMS)
    return _mode(p.body, p.shared_f2(per), n)


def _inverse(n):
    p = inverse_plan(n)
    return _mode(p.body, p.shared_f2, n)


def _partitions(taps, B, rows=1024):
    p = partitions_plan(taps, B, True)
    return _mode(p.body, launch(taps, B, rows, SMS, True)[2], max(p.L, 2 * B))


def _conv(taps, B, stream):
    """stream_conv over 64 streams, or partitioned_conv over 2048 blocks."""
    P = n_parts(taps, B)
    shared = (stream_launch(B, P, 64, SMS)[2] if stream
              else conv_launch(B, P, 2048, SMS)[1])
    return _mode(conv_plan(B, P).body, shared, 2 * B)


KERNELS = {
    "assemble_filters": (TAPS, NS, lambda t, n: _assembly(filters_plan, t, n)),
    "assembly_mac": (TAPS, NS, lambda t, n: _assembly(mac_plan, t, n)),
    "block_spectra_mix_inverse": (((1, 8192), (64, 128), (16, 1024), (64, 4)),
                                  NS, lambda m, n: _mix_inverse(*m, n)),
    "block_spectra": (BLOCKS, NS, lambda B, n: _spectra(B, n, False)),
    "block_spectra_mix": (BLOCKS, NS, lambda B, n: _spectra(B, n, True)),
    "spectra_inverse": (("n_fft",), NS, lambda _, n: _inverse(n)),
    "assemble_partitions": (TAPS, BLOCKS, _partitions),
    "stream_conv": (TAPS, BLOCKS, lambda t, B: _conv(t, B, True)),
    "partitioned_conv": (TAPS, BLOCKS, lambda t, B: _conv(t, B, False)),
}

# R register, C cluster, P pruned, 2 radix-2 in shared memory, S split,
# X raises, . no such launch
AT_THE_LIMIT = {
    "assemble_filters": {
        64: ".RRRRRRRRSSSS",
        128: "..RRRRRRRSSSS",
        512: "....RRRRRSSSS",
        2048: "......RRRSSSS",
        8128: ".......RRSSSS",
        16000: "........RSSSS",
        30000: ".........CSSS",
        44100: "..........CSS",
    },
    "assembly_mac": {
        64: ".RRRRRRRRSSSS",
        128: "..RRRRRRRSSSS",
        512: "....RRRRRSSSS",
        2048: "......RRRSSSS",
        8128: ".......RRSSSS",
        16000: "........RSSSS",
        30000: ".........CSSS",
        44100: "..........CSS",
    },
    "block_spectra_mix_inverse": {
        (1, 8192): ".RRRRRRRRCCCS",
        (64, 128): ".RRRRRRRRCCCS",
        (16, 1024): ".RRRRRRRRCCCS",
        (64, 4): ".RRRRRRRRCCCS",
    },
    "block_spectra": {
        64: "2RRRRRRRRPPPP",
        128: ".RRRRRRRRPPPP",
        256: "..RRRRRRRPPPP",
        512: "...RRRRRRPPPP",
        1024: "....RRRRRPPPP",
        2048: ".....RRRRPPPP",
        4096: "......RRRPPPP",
    },
    "block_spectra_mix": {
        64: "2RRRRRRRRPPPP",
        128: ".RRRRRRRRPPPP",
        256: "..RRRRRRRPPPP",
        512: "...RRRRRRPPPP",
        1024: "....RRRRRPPPP",
        2048: ".....RRRRPPPP",
        4096: "......RRRPPPP",
    },
    "spectra_inverse": {
        "n_fft": "RRRRRRRRRCCCS",
    },
    "assemble_partitions": {
        64: "RRRRRR2",
        128: "RRRRRR2",
        512: "RRRRRR2",
        2048: "RRRRRR2",
        8128: "RRRRRR2",
        16000: "CCCCCCS",
        30000: "CCCCCCS",
        44100: "CCCCCCS",
    },
    "stream_conv": {
        64: "RRRRRR2",
        128: "RRRRRR2",
        512: "RRRRRR2",
        2048: "RRRRRR2",
        8128: "RRRRRR2",
        16000: "RRRRRR2",
        30000: "RRRRRR2",
        44100: "RRRRRR2",
    },
    "partitioned_conv": {
        64: "RRRRRRS",
        128: "RRRRRRS",
        512: "RRRRRRS",
        2048: "RRRRRRS",
        8128: "RRRRRRS",
        16000: "RRRRRRS",
        30000: "RRRRRRS",
        44100: "RRRRRRS",
    },
}

FORCED = {
    "assemble_filters": {
        64: ".SSSSSSSSSSXX",
        128: "..SSSSSSSSSXX",
        512: "....SSSSSSSXX",
        2048: "......SSSSSXX",
        8128: ".......SSSSXX",
        16000: "........SSSXX",
        30000: ".........SSXX",
        44100: "..........SXX",
    },
    "assembly_mac": {
        64: ".SSSSSSSSSSXX",
        128: "..SSSSSSSSSXX",
        512: "....SSSSSSSXX",
        2048: "......SSSSSXX",
        8128: ".......SSSSXX",
        16000: "........SSSXX",
        30000: ".........SSXX",
        44100: "..........SXX",
    },
    "block_spectra_mix_inverse": {
        (1, 8192): ".SSSSSSSSSSXX",
        (64, 128): ".SSSSSSSSSSXX",
        (16, 1024): ".SSSSSSSSSSXX",
        (64, 4): ".SSSSSSSSSSXX",
    },
    "block_spectra": {
        64: "SSSSSSSSSSSXX",
        128: ".SSSSSSSSSSXX",
        256: "..SSSSSSSSSXX",
        512: "...SSSSSSSSXX",
        1024: "....SSSSSSSXX",
        2048: ".....SSSSSSXX",
        4096: "......SSSSSXX",
    },
    "block_spectra_mix": {
        64: "SSSSSSSSSSSXX",
        128: ".SSSSSSSSSSXX",
        256: "..SSSSSSSSSXX",
        512: "...SSSSSSSSXX",
        1024: "....SSSSSSSXX",
        2048: ".....SSSSSSXX",
        4096: "......SSSSSXX",
    },
    "spectra_inverse": {
        "n_fft": "SSSSSSSSSSSXX",
    },
    "assemble_partitions": {
        64: "SSSSSSS",
        128: "SSSSSSS",
        512: "SSSSSSS",
        2048: "SSSSSSS",
        8128: "SSSSSSS",
        16000: "SSSSSSS",
        30000: "SSSSSSS",
        44100: "SSSSSSS",
    },
    "stream_conv": {
        64: "SSSSSSS",
        128: "SSSSSSS",
        512: "SSSSSSS",
        2048: "SSSSSSS",
        8128: "SSSSSSS",
        16000: "SSSSSSS",
        30000: "SSSSSSS",
        44100: "SSSSSSS",
    },
    "partitioned_conv": {
        64: "SSSSSSS",
        128: "SSSSSSS",
        512: "SSSSSSS",
        2048: "SSSSSSS",
        8128: "SSSSSSS",
        16000: "SSSSSSS",
        30000: "SSSSSSS",
        44100: "SSSSSSS",
    },
}


@pytest.mark.parametrize("forced", [False, True], ids=["limit", "forced"])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_launch_mode_table(kernel, forced, monkeypatch):
    """Each kernel's launch mode at the H100's per-block limit, and with
    the split mode forced, over its shapes."""
    monkeypatch.setattr(_layout, "force_work", FORCED_WORK if forced else 0)
    rows, cols, mode_of = KERNELS[kernel]
    want = (FORCED if forced else AT_THE_LIMIT)[kernel]
    got = {row: "".join(mode_of(row, c) for c in cols) for row in rows}
    assert got == want


# `assemble_partitions` by its flags (the wrapper's rule: the rows need the
# chain where ITD or ILD applies): with neither, the direct body (D) at
# blocks 64 … 2048 at every L, up to L 131072 (100,000 taps) and beyond
# the cluster mode (200,000 taps, L 262144); forced, the split mode, which
# runs the chain, so L above two passes of FORCED_WORK raises (X); with
# either flag, the modes of the tables above.
DIRECT_TAPS = (*TAPS, 100000, 200000)
DIRECT_MODES = {
    "limit": {**{taps: "DDDDDD2" for taps in TAPS[:5]},
              **{taps: "DDDDDDS" for taps in DIRECT_TAPS[5:]}},
    "forced": {**{taps: "SSSSSSS" for taps in TAPS},
               100000: "XXXXXXX", 200000: "XXXXXXX"},
}
FLAG_PAIRS = [(False, False), (True, False), (False, True), (True, True)]


def _partitions_flags(taps, B, itd, ild, rows=1024):
    chain = itd or ild
    p = partitions_plan(taps, B, chain)
    return _mode(p.body, launch(taps, B, rows, SMS, chain)[2],
                 max(p.L, 2 * B))


@pytest.mark.parametrize("forced", [False, True], ids=["limit", "forced"])
@pytest.mark.parametrize("itd,ild", FLAG_PAIRS)
def test_assemble_partitions_direct_rule(itd, ild, forced, monkeypatch):
    """The direct body exactly where both flags are off and B is 64 …
    2048, at every L; with either flag on, each shape's mode is the one
    of the tables above and no plan is the direct body's."""
    monkeypatch.setattr(_layout, "force_work", FORCED_WORK if forced else 0)
    got = {taps: "".join(_partitions_flags(taps, B, itd, ild)
                         for B in BLOCKS) for taps in DIRECT_TAPS}
    if itd or ild:
        want = (FORCED if forced else AT_THE_LIMIT)["assemble_partitions"]
        assert {t: got[t] for t in TAPS} == want
        for taps in DIRECT_TAPS:
            for B in BLOCKS:
                assert partitions_plan(taps, B, True).body != _layout.DIRECT
    else:
        assert got == DIRECT_MODES["forced" if forced else "limit"]


@pytest.mark.parametrize("B,rows,want", [
    (512, 375, (1, 64, 1088)),  # room44k.streamed's chunk: P 87
    (128, 375, (4, 64, 4 * 272)),
    (64, 4106, (8, 64, 8 * 136)),
    (64, 1, (4, 32, 4 * 136)),  # one stream's push: 691 units, 132 SMs
    (2048, 375, (1, 256, 4352)),
])
def test_assemble_partitions_direct_launch(B, rows, want):
    """The direct body's launch at 44,100 taps: S units a block, the
    largest power of two up to 64/(2B/16), at least 1, that leaves every
    SM a block over rows × P, on S·2B/16 threads with S padded 2B-point
    exchange buffers."""
    plan = partitions_plan(44100, B, False)
    assert plan.body == _layout.DIRECT and plan.ranks == 0
    assert plan.radices_L == () and plan.parts == n_parts(44100, B)
    assert launch(44100, B, rows, SMS, False) == want
