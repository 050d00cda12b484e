"""Batch CLI of the PyTorch/CUDA port: ``raw2film-tpu-torch`` (or
``python -m raw2film_tpu_torch``).

The counterpart of ``raw2film_tpu/cli.py``, with the same flags, folder
sidecar settings (raw2film_settings.json) and merge order. It renders on
``--device``: by default the first CUDA device, and it raises without one;
``--device cpu`` runs the kernels' plain PyTorch versions.
``--num-processes``/``--process-id`` slice the file list, and
``--coordinator`` first joins the processes' gloo group
(``parallel/distributed.py::init_process``)."""

from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    from raw2film_tpu_torch.pipeline.params import ImageParams, ProfileParams

    p = argparse.ArgumentParser(
        prog="raw2film-tpu-torch",
        description="Analog film emulation on PyTorch and CUDA: RAW -> film look -> JPEG/TIFF",
    )
    p.add_argument("inputs", nargs="*", help="RAW files or folders")
    p.add_argument("-o", "--output", default="export", help="output directory")
    p.add_argument("--quality", type=int, default=95, help="JPEG quality")
    p.add_argument("--ext", default=".jpg", choices=[".jpg", ".png", ".tiff"])
    p.add_argument("--list-stocks", action="store_true", help="list film stocks and exit")
    from raw2film_tpu_torch._version import __version__

    p.add_argument(
        "--version", action="version", version=f"raw2film-tpu-torch {__version__}"
    )
    p.add_argument(
        "--device",
        default=None,
        help="torch device to render on (default: the first CUDA device, and an"
        " error without one; 'cpu' runs the kernels' plain PyTorch versions)",
    )
    p.add_argument(
        "--serve",
        action="store_true",
        help="start the local web viewer on the first input folder",
    )
    p.add_argument("--port", type=int, default=8171, help="viewer port")
    p.add_argument(
        "--import-lensfun",
        metavar="DIR",
        help="convert an installed lensfun XML database (e.g. /usr/share/lensfun)"
        " into ~/.raw2film_tpu/lenses.json and exit",
    )
    p.add_argument(
        "--import-sfl",
        nargs="?",
        const="",
        default=None,
        metavar="PATH",
        help="import measured film-stock sensitometry from an installed "
        "spectral_film_lut package (or a source checkout at PATH) into "
        "~/.raw2film_tpu/stocks_imported.json and exit; imported stocks "
        "override same-name parametric entries at startup",
    )
    p.add_argument(
        "--validate-raw",
        action="store_true",
        help="decode each input RAW and report a per-file verdict (format, "
        "dims, CFA, bit range) or WHICH guard refused it — no rendering. "
        "Use this to check camera files against the reconstructed codecs "
        "(docs/raw_formats.md) before a batch run",
    )
    p.add_argument("--organize-by-date", action="store_true")
    p.add_argument(
        "--archive-raw",
        choices=["none", "copy", "move"],
        default="none",
        help="copy/move the source RAW into <output>/RAW after export",
    )
    p.add_argument("--seed", type=int, default=0, help="grain seed")
    p.add_argument(
        "--display-profile",
        metavar="ICC",
        help="ICC profile to bake into the output (LUT-baked pre-quantization)",
    )
    p.add_argument(
        "--softproof-profile",
        metavar="ICC",
        help="ICC profile to soft-proof through (with --display-profile as target)",
    )
    p.add_argument("--full-res", action="store_true", help="disable half-size decode")
    p.add_argument(
        "--jobs", type=int, default=0,
        help="parallel host-decode workers feeding the device (0 = auto: "
        "min(4, cpu count))",
    )
    p.add_argument(
        "--num-processes", type=int, default=1,
        help="export-fleet size: this invocation handles files"
        " [process-id::num-processes] (run one per host)",
    )
    p.add_argument(
        "--process-id", type=int, default=0, help="this process's fleet index"
    )
    p.add_argument(
        "--coordinator", default=None,
        help="host:port of the process group's coordinator (rank 0): every"
        " process joins a torch.distributed gloo group before rendering;"
        " omit for independent hosts",
    )
    p.add_argument("--trace", action="store_true", help="print per-stage timings")
    p.add_argument(
        "--export-lut",
        metavar="FILE.cube",
        help="bake the configured film chain into a .cube 3D LUT "
        "(linear Rec709 in, display RGB out) and exit",
    )
    p.add_argument("--lut-size", type=int, default=33, help="3D LUT side length")
    p.add_argument(
        "--lens-correction",
        type=lambda s: s.lower() in ("1", "true", "yes", "on"),
        default=argparse.SUPPRESS,
        metavar="BOOL",
        help="enable/disable lens correction (default on)",
    )
    p.add_argument(
        "--lens",
        default=argparse.SUPPRESS,
        help="manual lens profile model name (overrides EXIF auto-detect)",
    )
    # Every ProfileParams/ImageParams field becomes a flag. Defaults are
    # SUPPRESSed so main() can tell explicit flags (which must override the
    # folder sidecar) from untouched ones (which must NOT — the reference's
    # merge order is defaults < profile < per-image < explicit overrides).
    for dc in (ProfileParams(), ImageParams()):
        for f in dataclasses.fields(dc):
            name = "--" + f.name.replace("_", "-")
            default = getattr(dc, f.name)
            if isinstance(default, bool):
                p.add_argument(
                    name,
                    type=lambda s: s.lower() in ("1", "true", "yes", "on"),
                    default=argparse.SUPPRESS,
                    metavar="BOOL",
                )
            elif default is None or isinstance(default, str):
                p.add_argument(name, type=str, default=argparse.SUPPRESS)
            elif isinstance(default, int) and not isinstance(default, bool):
                p.add_argument(name, type=int, default=argparse.SUPPRESS)
            else:
                p.add_argument(name, type=float, default=argparse.SUPPRESS)
    return p


def main(argv: list[str] | None = None) -> int:
    import dataclasses as _dc

    from raw2film_tpu_torch.pipeline.params import ImageParams, ProfileParams

    # Die quietly when stdout is a closed pipe (`raw2film-tpu --list-stocks
    # | head`) instead of tracebacking on BrokenPipeError.
    if hasattr(signal, "SIGPIPE"):
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)

    args = build_parser().parse_args(argv)
    # Split explicit schema flags (they override the sidecar) from
    # untouched ones (restored to defaults for direct args.X uses below).
    cli_over = {}
    for dc in (ProfileParams(), ImageParams()):
        for f in _dc.fields(dc):
            if hasattr(args, f.name):
                cli_over[f.name] = getattr(args, f.name)
            else:
                setattr(args, f.name, getattr(dc, f.name))
    for name, default in (("lens_correction", True), ("lens", None)):
        if hasattr(args, name):
            cli_over[name] = getattr(args, name)
        else:
            setattr(args, name, default)
    if "print_film" in cli_over:
        cli_over["print_film"] = (
            None if cli_over["print_film"] in (None, "", "None")
            else cli_over["print_film"]
        )

    if args.trace:
        os.environ["RAW2FILM_TRACE"] = "1"

    from raw2film_tpu_torch.film.loader import load_film_stocks
    from raw2film_tpu_torch.pipeline.batch import BatchRunner, export_path, scan_raw_files
    from raw2film_tpu_torch.pipeline.params import ImageParams, ProfileParams, merge_params
    from raw2film_tpu_torch.pipeline.processor import Processor
    from raw2film_tpu_torch.pipeline.settings import load_folder_settings
    from raw2film_tpu_torch.io.export import save_image

    if args.import_lensfun:
        from raw2film_tpu_torch.io.lensfun_convert import convert_lensfun_db

        dst = os.path.expanduser("~/.raw2film_tpu/lenses.json")
        profiles = convert_lensfun_db(args.import_lensfun, dst)
        print(f"imported {len(profiles)} lens profiles -> {dst}")
        return 0 if profiles else 1

    if args.import_sfl is not None:
        from raw2film_tpu_torch.film.import_sfl import import_sfl_stocks

        try:
            entries, info = import_sfl_stocks(args.import_sfl or None)
        except ValueError as e:
            print(f"import failed: {e}", file=sys.stderr)
            return 1
        for name, err in info["errors"].items():
            print(f"  skipped {name}: {err}", file=sys.stderr)
        worst = max(
            (max(r["hd_rms"]) for r in info["fits"].values()), default=0.0
        )
        print(
            f"imported {len(entries)} stocks -> {info['path']} "
            f"(worst H&D fit rms {worst:.4f} density)"
        )
        return 0 if entries else 1

    if args.validate_raw:
        import json as _json

        from raw2film_tpu_torch.io.dng import read_raw

        files = []
        for item in args.inputs or ["."]:
            files.extend(scan_raw_files(item) if os.path.isdir(item) else [item])
        if not files:
            print("no RAW files found", file=sys.stderr)
            return 2
        n_bad = 0
        for f in files:
            rec = {"file": f}
            try:
                raw = read_raw(f)
                d = raw.data
                rec.update(
                    ok=True,
                    shape=list(d.shape),
                    dtype=str(d.dtype),
                    cfa=getattr(raw, "cfa_pattern", None),
                    white_level=getattr(raw, "white_level", None),
                    value_range=[float(d.min()), float(d.max())],
                    model=(raw.metadata or {}).get("EXIF:Model"),
                )
            except NotImplementedError as e:
                # A guard refused the file: the message names the guard
                # (unsupported layout / reconstructed-constant mismatch)
                # and the DNG escape hatch.
                n_bad += 1
                rec.update(ok=False, guard="unsupported", error=str(e))
            except Exception as e:
                n_bad += 1
                rec.update(ok=False, guard=type(e).__name__, error=str(e))
            print(_json.dumps(rec))
        print(
            f"{len(files) - n_bad}/{len(files)} decode cleanly",
            file=sys.stderr,
        )
        return 0 if n_bad == 0 else 1

    if args.serve:
        from raw2film_tpu_torch.viewer import serve

        inputs = args.inputs or ["."]
        folder = next((i for i in inputs if os.path.isdir(i)), inputs[0])
        return serve(folder, port=args.port, device=args.device)

    stocks = load_film_stocks()
    if args.list_stocks:
        for name, s in sorted(stocks.items()):
            print(
                f"{name:32s} {s.stage:6s} {s.film_type:8s} ISO {s.iso:>5g}  {s.comment}"
            )
        return 0

    if args.export_lut:
        from raw2film_tpu_torch.io.cube import export_film_lut

        if args.negative_film not in stocks:
            print(f"unknown negative stock {args.negative_film!r}", file=sys.stderr)
            return 2
        prt_name = args.print_film
        prt = None if prt_name in (None, "", "None") else stocks.get(prt_name)
        if prt_name not in (None, "", "None") and prt is None:
            print(f"unknown print stock {prt_name!r}", file=sys.stderr)
            return 2
        export_film_lut(
            args.export_lut,
            stocks[args.negative_film],
            prt,
            size=args.lut_size,
            red_light=args.red_light,
            green_light=args.green_light,
            blue_light=args.blue_light,
            projector_kelvin=args.projector_kelvin,
            shadow_comp=args.shadow_comp,
            inversion_gamma=args.inversion_gamma,
            idealized_curve=args.idealized_curve,
            white_balance=args.white_balance,
            sat_adjust=args.sat_adjust,
            gamma_func=args.gamma_func,
            white_clip=args.white_clip,
        )
        print(f"wrote {args.export_lut} ({args.lut_size}^3)")
        return 0

    files: list[str] = []
    sidecar_images: dict = {}
    sidecar_profiles: dict = {}
    for inp in args.inputs:
        if os.path.isdir(inp):
            files.extend(scan_raw_files(inp))
            profs, imgs = load_folder_settings(inp)
            sidecar_profiles.update(profs)
            sidecar_images.update(imgs)
        else:
            files.append(inp)
    if not files:
        print("no RAW inputs found", file=sys.stderr)
        return 2

    if args.num_processes > 1 or args.coordinator:
        # Fleet export (docs/scaling.md Tier 2): slice the file list per
        # process — RAW bytes never cross hosts; join the process group
        # when a coordinator is given.
        from raw2film_tpu_torch.parallel.distributed import init_process, my_file_slice

        if args.coordinator:
            init_process(args.coordinator, args.num_processes, args.process_id)
        files = my_file_slice(files, args.process_id, args.num_processes)
        print(
            f"fleet process {args.process_id}/{args.num_processes}: "
            f"{len(files)} files"
        )
        if not files:
            return 0

    if args.negative_film not in stocks:
        print(f"unknown negative stock {args.negative_film!r}; see --list-stocks", file=sys.stderr)
        return 2
    if args.print_film not in (None, "", "None") and args.print_film not in stocks:
        print(f"unknown print stock {args.print_film!r}; see --list-stocks", file=sys.stderr)
        return 2

    icc_transform = None
    if args.softproof_profile or args.display_profile:
        from raw2film_tpu_torch.io import icc as icc_mod

        if args.softproof_profile:
            icc_transform = icc_mod.build_softproof_transform(
                args.softproof_profile, args.display_profile
            )
        else:
            icc_transform = icc_mod.build_transform(args.display_profile)
        if icc_transform is None:
            print(
                "warning: ICC support unavailable (PIL.ImageCms missing); "
                "profiles ignored",
                file=sys.stderr,
            )

    proc = Processor(device=args.device)
    meta_by_src: dict[str, dict] = {}

    def decode(src, **params):
        # Container parse + bitstream decode — the expensive host half —
        # runs in BatchRunner's worker pool ahead of the device.
        from raw2film_tpu_torch.io.dng import read_raw

        return (str(src), read_raw(str(src)))

    def process(payload, **params):
        src, raw = payload if isinstance(payload, tuple) else (payload, None)
        # Reference merge order (gui.py:2181-2195): schema defaults, the
        # image's sidecar profile, its per-image sidecar params, then ONLY
        # explicitly-passed CLI flags on top.
        img_sc = sidecar_images.get(os.path.basename(src)) or {}
        prof = sidecar_profiles.get(img_sc.get("profile", ""))
        merged = merge_params(prof, img_sc, **params)
        merged.pop("profile", None)
        from raw2film_tpu_torch.pipeline.params import apply_film_format

        apply_film_format(merged)
        # Dynamic non-schema keys (sidecar-stored by the viewer, or the
        # --lens / --lens-correction flags): same precedence as above.
        lens_kw = {
            k: params.get(k, img_sc.get(k))
            for k in ("lens_correction", "lens")
            if k in params or k in img_sc
        }
        if lens_kw.get("lens"):
            proc.register_lens(lens_kw["lens"])
        out = proc.process(
            raw if raw is not None else src,
            merged.pop("negative_film"),
            print_film=merged.pop("print_film"),
            half_size=not args.full_res,
            max_scale=None if args.full_res else 400.0,
            seed=args.seed,
            icc_transform=icc_transform,
            **lens_kw,
            **merged,
        )
        # Metadata comes back through the Processor (single decode).
        meta_by_src[str(src)] = getattr(proc, "last_metadata", {}) or {}
        return out

    def export(image, src):
        dst = export_path(
            src, args.output, args.organize_by_date, ext=args.ext
        )
        save_image(
            image,
            dst,
            quality=args.quality,
            metadata=meta_by_src.get(str(src), {}),
            exp_comp=args.exp_comp,
        )
        if args.archive_raw != "none":
            from raw2film_tpu_torch.pipeline.batch import archive_raw

            archive_raw(str(src), args.output, args.archive_raw)
        return dst

    jobs = args.jobs or min(4, os.cpu_count() or 1)
    runner = BatchRunner(process, export, decode_fn=decode, workers=jobs)
    t0 = time.perf_counter()
    results = runner.run(
        [(f, dict(cli_over)) for f in files],
        progress=lambda done, total: print(f"[{done}/{total}]", flush=True),
    )
    dt = time.perf_counter() - t0
    ok = sum(r.ok for r in results)
    for r in results:
        if not r.ok:
            print(f"FAILED {r.src}: {r.error}", file=sys.stderr)
    print(f"exported {ok}/{len(results)} images in {dt:.1f}s -> {args.output}")
    return 0 if ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
