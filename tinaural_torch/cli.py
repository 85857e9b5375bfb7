"""Command-line interface: read a mono WAV, render, write a stereo WAV.

The subcommands, arguments, defaults, messages and exit codes of
`tinaural.cli`:

    python -m tinaural_torch render in.wav out.wav --az 60 --el 10
    python -m tinaural_torch sweep in.wav out.wav --start 270 --end 90
    python -m tinaural_torch trajectory in.wav out.wav --waypoint 0,0,0 \
        --waypoint 2,180,40
    python -m tinaural_torch scene scene.json out.wav
    python -m tinaural_torch stream in.wav out.wav --update-rate 4
    python -m tinaural_torch fit src.wav target.wav fitted.npz --az 75
    python -m tinaural_torch export table.npz
    python -m tinaural_torch info

Every subcommand that renders or fits runs on ``cuda:0`` unless ``--cpu``
is given; with no card and no ``--cpu`` it exits non-zero with a message
that names the missing card. ``--cpu-golden`` renders with the numpy
golden reference (`tinaural_torch.reference.golden`) instead. ``export``
and ``info`` read the table on the host only. The JAX package's TPU
knobs (``--no-pallas``, ``--filter-path``, ``--fft-pack``, ``--fft-impl``,
``--kernel-precision``, ``--no-fuse-epilogue``, ``--part-assembly``) have
no counterpart here: the tensors' device picks the route.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .config import RenderConfig
from .data import (HrirArrays, TorchTable, load_hrir_set, read_wav,
                   save_table, write_wav)
from .models import BinauralRenderer, Stream
from .models.fit import fit_hrtf, personalize_table
from .reference import golden
from .utils.paths import circular_sweep, waypoints_to_block_dirs


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--hrir", default="synthetic",
                   help="HRIR source: 'synthetic', a KEMAR directory, a .sofa "
                        "file or a .npz table")
    p.add_argument("--hrir-sr", type=int, default=None, metavar="RATE",
                   help="resample the HRIR table to this rate on load "
                        "(match it to your audio's sample rate)")
    p.add_argument("--interp", choices=["nearest", "bilinear"], default="bilinear")
    p.add_argument("--no-itd", action="store_true", help="skip fractional-delay ITD")
    p.add_argument("--no-ild", action="store_true", help="skip ILD gain")
    p.add_argument("--block", type=int, default=1024, help="block size (pow2)")
    p.add_argument("--cpu-golden", action="store_true",
                   help="render with the NumPy golden reference instead of "
                        "the torch renderers")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain torch route) instead of "
                        "the CUDA card")
    p.add_argument("--dir-rate", type=int, choices=[1, 2, 4, 8], default=1,
                   help="update the moving-source HRTF every Nth block "
                        "(directions snap to the group start; cuts the "
                        "per-block gather+assembly work by N)")


def _config(args) -> RenderConfig:
    return RenderConfig(
        interp=args.interp,
        apply_itd=not args.no_itd,
        apply_ild=not args.no_ild,
        block_size=args.block,
        dir_rate=args.dir_rate,
    )


def _device(args) -> torch.device:
    """cuda:0, or the CPU with ``--cpu``; no card without ``--cpu`` is an
    error, never a silent run on the CPU."""
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit(
            "tinaural-torch: no CUDA card (torch.cuda.is_available() is "
            "false); pass --cpu to run on the CPU")
    return torch.device("cuda", 0)


def _load_table(args, **kw) -> HrirArrays:
    return load_hrir_set(args.hrir,
                         target_sample_rate=getattr(args, "hrir_sr", None),
                         **kw)


def _load_mono(path: str, table=None):
    sr, x = read_wav(path)
    if x.ndim > 1:
        x = x.mean(axis=1)  # downmix to mono
    if table is not None and sr != table.sample_rate:
        raise SystemExit(
            f"{path}: sample rate {sr} != HRIR table rate "
            f"{table.sample_rate}; pass --hrir-sr {sr} to resample the "
            f"table on load, or resample the audio")
    return sr, x


def cmd_render(args) -> int:
    dev = None if args.cpu_golden else _device(args)
    table = _load_table(args)
    cfg = _config(args)
    sr, x = _load_mono(args.input, table)
    if args.cpu_golden:
        y = golden.render_static(table, x, args.az, args.el, cfg)
    else:
        y = BinauralRenderer(TorchTable.from_hrir_table(table, dev), cfg).render(
            x, args.az, args.el).cpu().numpy()
    write_wav(args.output, sr, y.T, normalize=args.normalize)
    print(f"wrote {args.output}: {y.shape[1]} samples at az={args.az} el={args.el}")
    return 0


def _render_trajectory(args, dirs_fn) -> int:
    dev = None if args.cpu_golden else _device(args)
    table = _load_table(args)
    cfg = _config(args)
    sr, x = _load_mono(args.input, table)
    nb = -(-len(x) // cfg.block_size)
    dirs = dirs_fn(nb, cfg, sr)
    if args.cpu_golden:
        y = golden.render_trajectory(table, x, np.asarray(dirs, np.float64), cfg)
    else:
        y = BinauralRenderer(TorchTable.from_hrir_table(table, dev),
                             cfg).render_trajectory(x, dirs).cpu().numpy()
    write_wav(args.output, sr, y.T, normalize=args.normalize)
    print(f"wrote {args.output}: {y.shape[1]} samples, {nb} blocks")
    return 0


def cmd_sweep(args) -> int:
    return _render_trajectory(
        args, lambda nb, cfg, sr: circular_sweep(nb, args.start, args.end, args.el))


def cmd_trajectory(args) -> int:
    wps = []
    for w in args.waypoint:
        t, az, el = (float(v) for v in w.split(","))
        wps.append((t, az, el))

    return _render_trajectory(
        args,
        lambda nb, cfg, sr: waypoints_to_block_dirs(wps, nb, cfg.block_size, sr))


def cmd_scene(args) -> int:
    """Scene file: JSON list of {"wav": path, "az": deg, "el": deg}."""
    dev = None if args.cpu_golden else _device(args)
    with open(args.scene) as f:
        spec = json.load(f)
    table = _load_table(args)
    cfg = _config(args)
    srs, sigs, dirs = set(), [], []
    for src in spec:
        sr, x = _load_mono(src["wav"])
        srs.add(sr)
        sigs.append(x)
        dirs.append([float(src["az"]), float(src["el"])])
    if len(srs) != 1:
        raise SystemExit(f"all sources must share one sample rate, got {srs}")
    sr = srs.pop()
    if sr != table.sample_rate:
        raise SystemExit(
            f"scene sample rate {sr} != HRIR table rate "
            f"{table.sample_rate}; pass --hrir-sr {sr}")
    n = max(len(x) for x in sigs)
    xs = np.zeros((len(sigs), n))
    for i, x in enumerate(sigs):
        xs[i, : len(x)] = x
    if args.cpu_golden:
        y = golden.render_scene(table, xs, np.asarray(dirs), cfg)
    else:
        y = BinauralRenderer(TorchTable.from_hrir_table(table, dev),
                             cfg).render_scene(
            xs, np.asarray(dirs), dedupe=not args.no_dedupe).cpu().numpy()
    write_wav(args.output, sr, y.T, normalize=not args.no_normalize)
    print(f"wrote {args.output}: {len(sigs)} sources, {y.shape[1]} samples")
    return 0


def cmd_stream(args) -> int:
    """Simulate the real-time streaming loop: push the WAV block by block
    through the streaming renderer while the head rotates."""
    dev = None if args.cpu_golden else _device(args)
    table = _load_table(args)
    cfg = _config(args).replace(stream_block=args.stream_block,
                                stream_update_rate=args.update_rate)
    sr, x = _load_mono(args.input, table)
    B = cfg.stream_block
    nb = -(-len(x) // B)  # zero-pad the tail like the trajectory path
    if nb == 0:
        raise SystemExit(f"input shorter than one block ({B} samples)")
    x = np.pad(x, (0, nb * B - len(x)))
    dirs = circular_sweep(nb, args.start_az, args.end_az, args.el)
    if args.cpu_golden:
        s = golden.GoldenStream(table, cfg)
        outs = [s.push(x[i * B : (i + 1) * B], float(dirs[i, 0]), args.el)
                if i % args.update_rate == 0
                else s.push_held(x[i * B : (i + 1) * B])
                for i in range(nb)]
        y = np.concatenate(outs, axis=1)
    else:
        s = Stream(TorchTable.from_hrir_table(table, dev), cfg)
        y = s.render_offline(x, dirs).cpu().numpy()
    write_wav(args.output, sr, y.T, normalize=args.normalize)
    print(f"wrote {args.output}: {nb} blocks of {B} "
          f"({B / sr * 1e3:.2f} ms latency each)")
    return 0


def cmd_export(args) -> int:
    """Preprocess an HRIR source into a .npz table (fast reload)."""
    table = _load_table(args, decompose=not args.raw)
    save_table(args.output, table)
    print(f"wrote {args.output}: {table.h.shape} taps={table.taps} "
          f"decomposed={table.decomposed}")
    return 0


def cmd_fit(args) -> int:
    """Fit listener-personalization parameters: given a mono source, its
    known direction and an observed binaural recording, recover EQ/ITD/
    ILD/gain and export the personalized table. The loss renders through
    the plain torch versions on the chosen device (`models.fit`)."""
    dev = _device(args)
    table = _load_table(args)
    cfg = _config(args)
    sr, x = _load_mono(args.input, table)
    sr_t, target = read_wav(args.target)
    if target.ndim != 2 or target.shape[1] != 2:
        raise SystemExit("target must be a stereo WAV")
    if sr_t != sr:
        raise SystemExit(f"sample-rate mismatch: {sr} vs {sr_t}")
    table_d = TorchTable.from_hrir_table(table, dev)
    params, losses = fit_hrtf(
        table_d, x[None, :], np.array([[args.az, args.el]]), target.T,
        steps=args.steps, config=cfg)
    with torch.no_grad():
        fitted = personalize_table(table_d, params).to_arrays()
    save_table(args.output, fitted)
    print(f"fit: loss {losses[0]:.3e} -> {losses[-1]:.3e} over {args.steps} "
          f"steps; wrote {args.output}")
    return 0


def cmd_info(args) -> int:
    table = _load_table(args)
    g = table.grid()
    print(f"source:      {args.hrir}")
    print(f"directions:  {g.n_directions} ({g.n_elevs} elevation rings, "
          f"max {g.a_max} azimuths)")
    print(f"elevations:  {g.elevs[0]:.0f}..{g.elevs[-1]:.0f} deg")
    print(f"taps:        {table.taps} @ {table.sample_rate} Hz")
    print(f"decomposed:  {table.decomposed} (ITD/ILD tracks "
          f"{'available' if table.decomposed else 'baked into HRIRs'})")
    return 0


def cmd_bench(args) -> int:
    print("tinaural-torch bench: this package has no benchmark harness yet; "
          "python3 chip_smoke.py in a source checkout drives and times the "
          "port on the card", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tinaural-torch",
        description="binaural audio synthesis in PyTorch on a CUDA card")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="static render at one direction")
    p.add_argument("input"); p.add_argument("output")
    p.add_argument("--az", type=float, required=True)
    p.add_argument("--el", type=float, default=0.0)
    p.add_argument("--normalize", action="store_true")
    _add_common(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("sweep", help="moving source: azimuth sweep")
    p.add_argument("input"); p.add_argument("output")
    p.add_argument("--start", type=float, default=0.0)
    p.add_argument("--end", type=float, default=360.0)
    p.add_argument("--el", type=float, default=0.0)
    p.add_argument("--normalize", action="store_true")
    _add_common(p)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("trajectory", help="moving source along waypoints")
    p.add_argument("input"); p.add_argument("output")
    p.add_argument("--waypoint", action="append", required=True,
                   metavar="T,AZ,EL", help="repeatable: time_sec,az_deg,el_deg")
    p.add_argument("--normalize", action="store_true")
    _add_common(p)
    p.set_defaults(fn=cmd_trajectory)

    p = sub.add_parser("scene", help="multi-source scene from a JSON spec")
    p.add_argument("scene"); p.add_argument("output")
    p.add_argument("--no-dedupe", action="store_true",
                   help="render duplicate-direction sources individually "
                        "instead of pre-mixing them (exact either way)")
    p.add_argument("--no-normalize", action="store_true",
                   help="keep absolute levels instead of peak-normalizing "
                        "the mixdown (which may then clip in int16)")
    _add_common(p)
    p.set_defaults(fn=cmd_scene)

    p = sub.add_parser("stream", help="simulated real-time streaming render")
    p.add_argument("input"); p.add_argument("output")
    p.add_argument("--stream-block", type=int, default=256)
    p.add_argument("--update-rate", type=int, default=1, choices=(1, 2, 4, 8),
                   help="reassemble the HRTF filter only every k-th block; "
                        "held blocks render under the carried filter "
                        "(RenderConfig.stream_update_rate)")
    p.add_argument("--start-az", type=float, default=0.0)
    p.add_argument("--end-az", type=float, default=360.0)
    p.add_argument("--el", type=float, default=0.0)
    p.add_argument("--normalize", action="store_true")
    _add_common(p)
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("fit", help="fit personalization params to a recording")
    p.add_argument("input", help="mono source WAV")
    p.add_argument("target", help="observed binaural (stereo) WAV")
    p.add_argument("output", help="output .npz personalized table")
    p.add_argument("--az", type=float, required=True)
    p.add_argument("--el", type=float, default=0.0)
    p.add_argument("--steps", type=int, default=100)
    _add_common(p)
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("export", help="preprocess an HRIR source into .npz")
    p.add_argument("output")
    p.add_argument("--raw", action="store_true", help="skip ITD/ILD decomposition")
    _add_common(p)
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("info", help="describe an HRIR set")
    _add_common(p)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("bench", help="run the benchmark harness (none yet: "
                                     "exits 2)")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
