"""tinaural_torch's CLI with --cpu against tinaural's CLI (JAX on the CPU):
the same WAVs in, and every WAV out within 1 int16 LSB of the JAX CLI's
and ≥ 90 dB from it; --cpu-golden equal in bytes to tinaural's."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import tinaural
import tinaural_torch
from tinaural.cli import main as jax_main
from tinaural_torch.cli import main
from tinaural_torch.data import read_wav, synthesize_hrirs, write_wav

from conftest import snr_db

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture()
def mono_wav(tmp_path):
    p = tmp_path / "in.wav"
    rng = np.random.default_rng(1234)
    write_wav(p, 44100, np.clip(rng.standard_normal(8000) * 0.2, -1, 1))
    return p


def _int16(path):
    sr, y = wavfile.read(path)
    assert y.dtype == np.int16
    return sr, y.astype(np.int64)


def _both(tmp_path, cmd, inp, rest, name, golden=False):
    """Run one subcommand through both CLIs (the port with --cpu, or both
    with --cpu-golden) → (port's int16 WAV, JAX's int16 WAV)."""
    a, b = tmp_path / f"{name}_torch.wav", tmp_path / f"{name}_jax.wav"
    flag = ["--cpu-golden"] if golden else ["--cpu"]
    assert main([cmd, str(inp), str(a), *rest, *flag]) == 0
    assert jax_main([cmd, str(inp), str(b), *rest,
                     *(["--cpu-golden"] if golden else [])]) == 0
    if golden:
        assert a.read_bytes() == b.read_bytes()
    sr_a, ya = _int16(a)
    sr_b, yb = _int16(b)
    assert sr_a == sr_b and ya.shape == yb.shape and ya.shape[1] == 2
    return ya, yb


def _close(ya, yb):
    assert np.abs(ya - yb).max() <= 1
    assert snr_db(yb, ya) >= 90


RENDERS = {
    "render_az90": ("render", ["--az", "90"]),
    "render_az33_el12": ("render", ["--az", "33", "--el", "12"]),
    "render_nearest_no_itd": ("render", ["--az", "250", "--interp", "nearest",
                                         "--no-itd", "--normalize"]),
    "sweep": ("sweep", ["--start", "270", "--end", "90", "--block", "512"]),
    "trajectory": ("trajectory", ["--waypoint", "0,0,0", "--waypoint",
                                  "0.2,180,40", "--block", "512"]),
    "trajectory_dir_rate_2": ("trajectory", ["--waypoint", "0,0,0",
                                             "--waypoint", "0.2,180,40",
                                             "--block", "256",
                                             "--dir-rate", "2"]),
    "stream": ("stream", ["--stream-block", "256", "--start-az", "300",
                          "--end-az", "60"]),
    "stream_update_rate_4": ("stream", ["--stream-block", "256", "--start-az",
                                        "300", "--end-az", "60",
                                        "--update-rate", "4"]),
}


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_render_subcommands_match_jax_cli(mono_wav, tmp_path, name):
    cmd, rest = RENDERS[name]
    ya, yb = _both(tmp_path, cmd, mono_wav, rest, name)
    _close(ya, yb)
    if name == "render_az90":  # az 90: the right ear louder
        e = np.sum(ya.astype(np.float64) ** 2, axis=0)
        assert e[1] > e[0]


def _scene_file(tmp_path, mono_wav):
    p2 = tmp_path / "in2.wav"
    write_wav(p2, 44100, np.clip(
        np.random.default_rng(5).standard_normal(5000) * 0.2, -1, 1))
    spec = [{"wav": str(mono_wav), "az": 10.0, "el": 0.0},
            {"wav": str(p2), "az": 200.0, "el": 30.0},
            {"wav": str(mono_wav), "az": 10.0, "el": 0.0}]  # deduped
    sf = tmp_path / "scene.json"
    sf.write_text(json.dumps(spec))
    return sf


@pytest.mark.parametrize("rest", [["--block", "512"],
                                  ["--block", "512", "--no-dedupe",
                                   "--no-normalize"]])
def test_scene_matches_jax_cli(mono_wav, tmp_path, rest):
    sf = _scene_file(tmp_path, mono_wav)
    ya, yb = _both(tmp_path, "scene", sf, rest, "scene")
    _close(ya, yb)
    assert ya.shape == (8000 + 191, 2)


@pytest.mark.parametrize("name", ["render_az33_el12", "sweep",
                                  "stream_update_rate_4"])
def test_cpu_golden_equals_jax_cpu_golden(mono_wav, tmp_path, name):
    cmd, rest = RENDERS[name]
    _both(tmp_path, cmd, mono_wav, rest, name, golden=True)


def test_scene_cpu_golden_equals_jax_cpu_golden(mono_wav, tmp_path):
    sf = _scene_file(tmp_path, mono_wav)
    _both(tmp_path, "scene", sf, ["--block", "512"], "scene", golden=True)


def test_port_close_to_its_golden(mono_wav, tmp_path):
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    for out, flag in ((a, "--cpu"), (b, "--cpu-golden")):
        assert main(["render", str(mono_wav), str(out), "--az", "33",
                     "--el", "12", flag]) == 0
    _, ya = read_wav(a)
    _, yb = read_wav(b)
    assert snr_db(yb, ya) >= 60


def test_hrir_sr_resamples_table(tmp_path):
    p_in = tmp_path / "in48.wav"
    write_wav(p_in, 48000, np.clip(
        np.random.default_rng(6).standard_normal(4096) * 0.2, -1, 1))
    ya, yb = _both(tmp_path, "render", p_in, ["--az", "45", "--hrir-sr",
                                              "48000"], "sr48")
    _close(ya, yb)
    assert wavfile.read(tmp_path / "sr48_torch.wav")[0] == 48000


def test_render_from_kemar_directory(mono_wav, tmp_path):
    """--hrir <compact KEMAR directory>: two rings on disk, front halves."""
    h, g = synthesize_hrirs(taps=128)
    root = tmp_path / "kemar"
    for e_deg in (0, 10):
        e_i = list(g.elevs).index(float(e_deg))
        d = root / f"elev{e_deg}"
        d.mkdir(parents=True)
        for a_i, az in enumerate(g.ring_azimuths(e_i)):
            if az <= 180.0:
                write_wav(d / f"H{e_deg}e{int(round(az)) % 360:03d}a.wav",
                          44100, h[e_i, a_i].T, dtype="float32")
    ya, yb = _both(tmp_path, "render", mono_wav,
                   ["--az", "130", "--el", "4", "--hrir", str(root)], "kemar")
    _close(ya, yb)


def test_wrong_rate_and_short_input_messages(tmp_path):
    p = tmp_path / "in22.wav"
    write_wav(p, 22050, np.zeros(1000))
    with pytest.raises(SystemExit, match="--hrir-sr 22050"):
        main(["render", str(p), str(tmp_path / "o.wav"), "--az", "0",
              "--cpu"])
    q = tmp_path / "short.wav"
    write_wav(q, 44100, np.zeros(0))
    with pytest.raises(SystemExit, match="shorter than one block"):
        main(["stream", str(q), str(tmp_path / "o.wav"), "--cpu"])


def test_fit_end_to_end(tmp_path):
    """fit: a 3 dB-hot target; the personalized table, saved as .npz,
    loads in both packages and renders closer to the target than the
    stock table."""
    sr = 44100
    x = np.clip(np.random.default_rng(8).standard_normal(1024) * 0.2, -1, 1)
    src = tmp_path / "src.wav"
    write_wav(src, sr, x, dtype="float32")
    cfg = tinaural_torch.RenderConfig(block_size=256)
    stock = tinaural_torch.TorchTable.from_hrir_table(
        tinaural_torch.load_hrir_set("synthetic"), "cpu")

    def render(table):
        return tinaural_torch.BinauralRenderer(table, cfg).render_scene(
            x[None, :], np.array([[75.0, 10.0]])).numpy()

    y = render(stock) * np.sqrt(2.0)
    tgt = tmp_path / "target.wav"
    write_wav(tgt, sr, y.T, dtype="float32")
    out = tmp_path / "fitted.npz"
    assert main(["fit", str(src), str(tgt), str(out), "--az", "75",
                 "--el", "10", "--steps", "40", "--block", "256",
                 "--cpu"]) == 0
    fitted = tinaural_torch.load_hrir_set(str(out))
    theirs = tinaural.load_hrir_set(str(out))
    for f in ("h", "delays", "gains", "elevs", "az_counts", "valid"):
        a, b = getattr(fitted, f), np.asarray(getattr(theirs, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert fitted.decomposed and fitted.gains.dtype == np.float32
    yf = render(tinaural_torch.TorchTable.from_hrir_table(fitted, "cpu"))
    y0 = render(stock)
    err_fit = np.sum((yf - y) ** 2)
    err_stock = np.sum((y0 - y) ** 2)
    assert err_fit < 0.2 * err_stock


def test_fit_rejects_mono_target(mono_wav, tmp_path):
    with pytest.raises(SystemExit, match="stereo"):
        main(["fit", str(mono_wav), str(mono_wav), str(tmp_path / "f.npz"),
              "--az", "0", "--steps", "1", "--cpu"])


@pytest.mark.parametrize("raw", [False, True])
def test_export_info_round_trip_across_packages(tmp_path, capsys, raw):
    ours, theirs = tmp_path / "ours.npz", tmp_path / "theirs.npz"
    flag = ["--raw"] if raw else []
    assert main(["export", str(ours), *flag]) == 0
    assert jax_main(["export", str(theirs), *flag]) == 0
    for p in (ours, theirs):
        a, b = tinaural_torch.load_hrir_set(str(p)), tinaural.load_hrir_set(str(p))
        for f in ("h", "delays", "gains", "elevs", "az_counts", "valid"):
            assert np.array_equal(getattr(a, f), np.asarray(getattr(b, f))), f
        assert a.decomposed == (not raw)
    capsys.readouterr()
    infos = []
    for fn, p in ((main, ours), (jax_main, theirs), (main, "synthetic"),
                  (jax_main, "synthetic")):
        assert fn(["info", "--hrir", str(p)]) == 0
        infos.append(capsys.readouterr().out.splitlines()[1:])  # past source
    assert infos[0] == infos[1] and infos[2] == infos[3]
    assert "710" in infos[0][0] and "decomposed" in infos[0][-1]


def test_bench_exits_2(capsys):
    assert main(["bench"]) == 2
    assert "no benchmark harness" in capsys.readouterr().err


def test_no_card_without_cpu_flag_exits_naming_the_card(mono_wav, tmp_path,
                                                        monkeypatch):
    """No entry point falls back to the CPU: without --cpu and with no
    card, every rendering subcommand exits non-zero naming the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "o.wav")
    for argv in (["render", str(mono_wav), out, "--az", "30"],
                 ["sweep", str(mono_wav), out],
                 ["stream", str(mono_wav), out],
                 ["fit", str(mono_wav), out, out, "--az", "0"]):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code not in (0, None)
        assert "no CUDA card" in str(e.value.code), argv
    assert not (tmp_path / "o.wav").exists()


@pytest.mark.parametrize("flag", ["--no-pallas", "--filter-path=matmul",
                                  "--fft-pack=both", "--fft-impl=xla",
                                  "--kernel-precision=tri",
                                  "--no-fuse-epilogue",
                                  "--part-assembly=kernel"])
def test_tpu_only_flags_are_argparse_errors(mono_wav, tmp_path, flag, capsys):
    with pytest.raises(SystemExit) as e:
        main(["render", str(mono_wav), str(tmp_path / "o.wav"), "--az", "0",
              "--cpu", flag])
    assert e.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_python_m_runs_the_cli(tmp_path):
    env = {"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-m", "tinaural_torch", "info"],
                          capture_output=True, text=True, cwd=tmp_path,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "directions:  710" in proc.stdout
