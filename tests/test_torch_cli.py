"""The port's batch engine, settings persistence and CLI on the CPU: the
cases of tests/test_batch_cli.py on ``raw2film_tpu_torch`` (the CLI with
``--device cpu``), its PNG exports held within 1 code of the JAX CLI's on
the same fixture, and what the port's CLI does differently: ``--device``,
``--version``, ``--coordinator`` (two processes in a gloo group), the ICC flags
(baked into the render, within 1 code of the JAX CLI) and ``--trace``."""

import json
import os

import numpy as np
import pytest
from PIL import Image

import raw2film_tpu  # noqa: F401
from raw2film_tpu.cli import main as jax_main
from raw2film_tpu_torch.cli import main as port_cli
from raw2film_tpu_torch.pipeline.batch import BatchRunner, export_path, scan_raw_files
from raw2film_tpu_torch.pipeline.params import ImageParams, ProfileParams
from raw2film_tpu_torch.pipeline.settings import (
    load_folder_settings,
    load_settings,
    save_settings,
    sidecar_path,
)


def main(argv):
    """The port's CLI on the CPU."""
    return port_cli([*argv, "--device", "cpu"])


def _write_fixture_dng(path, h=64, w=96, seed=0):
    from raw2film_tpu_torch.data import REC709_TO_XYZ, XYZ_TO_REC709
    from raw2film_tpu_torch.io.dng import write_dng

    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([0.1 + 0.5 * xx / w, 0.1 + 0.4 * yy / h, 0.3 - 0.1 * yy / h], -1)
    cam = (rgb @ REC709_TO_XYZ.T) @ XYZ_TO_REC709.T
    mosaic = np.zeros((h, w))
    mosaic[0::2, 0::2] = cam[0::2, 0::2, 0]
    mosaic[0::2, 1::2] = cam[0::2, 1::2, 1]
    mosaic[1::2, 0::2] = cam[1::2, 0::2, 1]
    mosaic[1::2, 1::2] = cam[1::2, 1::2, 2]
    write_dng(str(path), np.clip(mosaic, 0, 1) * 60000, white_level=60000)


def _read(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im)


def _within_one_code_of_jax(port_png, jax_png) -> None:
    a, b = _read(port_png), _read(jax_png)
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(int) - b.astype(int))
    print(f"{os.path.basename(port_png)}: max {d.max()} code, {(d == 0).mean():.6f} of codes equal")
    assert d.max() <= 1


class TestBatchRunner:
    def test_overlapped_run_and_progress(self, tmp_path):
        def process(src, **params):
            return np.full((8, 8, 3), 128, np.uint8)

        def export(image, src):
            dst = str(tmp_path / (os.path.basename(src) + ".jpg"))
            Image.fromarray(image).save(dst)
            return dst

        progress = []
        results = BatchRunner(process, export).run(
            [(f"img{i}.dng", {}) for i in range(5)],
            progress=lambda d, t: progress.append((d, t)),
        )
        assert len(results) == 5 and all(r.ok for r in results)
        assert progress[-1] == (5, 5)

    def test_parallel_decode_workers_preserve_order(self):
        """workers > 1: decode runs concurrently but results stay in
        submission order, and a decode failure only skips its item."""
        import threading
        import time as _time

        seen_concurrent = []
        active = [0]
        lock = threading.Lock()

        def decode(src, **params):
            with lock:
                active[0] += 1
                seen_concurrent.append(active[0])
            _time.sleep(0.05 if src != "c" else 0.0)
            with lock:
                active[0] -= 1
            if src == "b":
                raise ValueError("bad file")
            return f"payload-{src}"

        order = []

        def process(payload, **params):
            order.append(payload)
            return payload

        runner = BatchRunner(process, lambda img, src: src, decode_fn=decode, workers=3)
        results = runner.run([(s, {}) for s in "abcd"])
        assert order == ["payload-a", "payload-c", "payload-d"]
        assert [r.ok for r in results] == [True, False, True, True]
        assert max(seen_concurrent) > 1

    def test_failure_isolated(self):
        def process(src, **params):
            if "bad" in src:
                raise RuntimeError("decode exploded")
            return np.zeros((4, 4, 3), np.uint8)

        results = BatchRunner(process, lambda image, src: "ok").run(
            [("a.dng", {}), ("bad.dng", {}), ("c.dng", {})]
        )
        assert [r.ok for r in results] == [True, False, True]
        assert "decode exploded" in results[1].error

    def test_cancel(self):
        runner = BatchRunner(lambda s, **p: np.zeros((2, 2, 3), np.uint8), lambda i, s: "x")
        runner.cancel()
        assert len(runner.run([("a.dng", {})] * 10)) < 10

    def test_scan_and_paths(self, tmp_path):
        for name in ("a.DNG", "b.arw", "c.txt"):
            (tmp_path / name).write_bytes(b"")
        assert len(scan_raw_files(str(tmp_path))) == 2
        p = export_path("/x/y/img.dng", "/out", True, "2024:06:01 10:00:00")
        assert p == os.path.join("/out", "2024", "2024-06-01", "img.jpg")


class TestSettings:
    def test_roundtrip(self, tmp_path):
        p = str(tmp_path / "settings.json")
        save_settings(
            p,
            profiles={"Default": ProfileParams(negative_film="Kodak Ektar 100")},
            images={"img.dng": ImageParams(exp_comp=1.5, rotation=2.0)},
        )
        profiles, images = load_settings(p)
        assert profiles["Default"]["negative_film"] == "Kodak Ektar 100"
        assert images["img.dng"]["exp_comp"] == 1.5

    def test_unknown_keys_ignored(self, tmp_path):
        p = str(tmp_path / "settings.json")
        doc = {"profiles": {"X": {"negative_film": "Kodak Gold 200", "mystery": 1}}, "images": {}}
        with open(p, "w") as f:
            json.dump(doc, f)
        profiles, _ = load_settings(p)
        assert profiles["X"]["negative_film"] == "Kodak Gold 200"
        assert "mystery" not in profiles["X"]

    def test_folder_sidecar(self, tmp_path):
        save_settings(sidecar_path(str(tmp_path)), images={"a.dng": ImageParams(tint=3.0)})
        _, images = load_folder_settings(str(tmp_path))
        assert images["a.dng"]["tint"] == 3.0
        assert load_folder_settings("/nonexistent") == ({}, {})


class TestCLI:
    def test_list_stocks(self, capsys):
        assert port_cli(["x.dng", "--list-stocks"]) == 0  # no device needed
        out = capsys.readouterr().out
        assert "Kodak Portra 400" in out and "print" in out

    def test_unknown_stock_errors(self, tmp_path, capsys):
        dng = tmp_path / "t.dng"
        _write_fixture_dng(dng)
        assert main([str(dng), "--negative-film", "Kodachrome 9000"]) == 2
        assert "unknown negative stock" in capsys.readouterr().err

    def test_validate_raw(self, tmp_path, capsys):
        """--validate-raw reports ok/guard per file as JSON lines, exit 1
        when any file is refused."""
        from raw_fixtures import write_cr3_raw

        m = np.random.default_rng(0).integers(0, 16000, (64, 96)).astype(np.uint16)
        write_cr3_raw(str(tmp_path / "good.cr3"), m, levels=2, tile_cols=2)
        write_cr3_raw(str(tmp_path / "bad.cr3"), m, levels=2, enc_type=1)
        assert port_cli([str(tmp_path), "--validate-raw"]) == 1
        lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
        by_name = {os.path.basename(r["file"]): r for r in lines}
        assert by_name["good.cr3"]["ok"] and by_name["good.cr3"]["shape"] == [64, 96]
        bad = by_name["bad.cr3"]
        assert not bad["ok"] and bad["guard"] == "unsupported"
        assert "encType" in bad["error"]

    def test_export_end_to_end(self, tmp_path):
        """The JPEG export, then the PNG export held to the JAX CLI's."""
        dng = tmp_path / "shot.dng"
        _write_fixture_dng(dng)
        args = [str(dng), "--grain", "0", "--print-film", "None"]
        assert main([*args, "-o", str(tmp_path / "out")]) == 0
        dst = tmp_path / "out" / "shot.jpg"
        with Image.open(dst) as img:
            assert img.size[0] > 0
        assert main([*args, "-o", str(tmp_path / "png"), "--ext", ".png"]) == 0
        assert jax_main([*args, "-o", str(tmp_path / "jax"), "--ext", ".png"]) == 0
        _within_one_code_of_jax(tmp_path / "png" / "shot.png", tmp_path / "jax" / "shot.png")

    def test_mixed_folder_isolates_unsupported(self, tmp_path, capsys):
        """A decodable DNG beside an unsupported-payload CR3: the DNG
        exports, the CR3 is reported, the exit code is non-zero."""
        import io as _io

        from raw_fixtures import write_cr3

        _write_fixture_dng(tmp_path / "good.dng")
        b = _io.BytesIO()
        Image.new("RGB", (16, 12), (90, 60, 30)).save(b, "JPEG")
        write_cr3(str(tmp_path / "bad.cr3"), b.getvalue())
        out_dir = str(tmp_path / "out")
        rc = main([str(tmp_path), "-o", out_dir, "--grain", "0", "--print-film", "None"])
        assert os.path.exists(os.path.join(out_dir, "good.jpg"))
        assert not os.path.exists(os.path.join(out_dir, "bad.jpg"))
        assert rc != 0
        err = capsys.readouterr()
        assert "CRX" in err.err + err.out or "CR3" in err.err + err.out

    def test_export_nef_and_arw(self, tmp_path):
        """Vendor TIFF dialects through the full CLI export, held to the JAX
        CLI's PNGs."""
        from raw_fixtures import write_arw, write_nef

        mosaic = np.random.default_rng(3).integers(600, 15000, (40, 64)).astype(np.uint16)
        write_nef(str(tmp_path / "a.nef"), mosaic)
        write_arw(str(tmp_path / "b.arw"), mosaic)
        args = [str(tmp_path / "a.nef"), str(tmp_path / "b.arw"), "--grain", "0", "--ext", ".png"]
        assert main([*args, "-o", str(tmp_path / "out_v")]) == 0
        assert jax_main([*args, "-o", str(tmp_path / "jax")]) == 0
        for name in ("a.png", "b.png"):
            _within_one_code_of_jax(tmp_path / "out_v" / name, tmp_path / "jax" / name)

    def test_folder_input_with_sidecar(self, tmp_path):
        folder = tmp_path / "roll"
        folder.mkdir()
        _write_fixture_dng(folder / "f1.dng")
        save_settings(sidecar_path(str(folder)), images={"f1.dng": ImageParams(exp_comp=1.0)})
        out_dir = str(tmp_path / "out2")
        assert main([str(folder), "-o", out_dir, "--grain", "0"]) == 0
        assert os.path.exists(os.path.join(out_dir, "f1.jpg"))


class TestExportLut:
    def test_fleet_slicing(self, tmp_path):
        """--num-processes/--process-id slice the file list round-robin:
        two invocations cover disjoint halves."""
        from raw2film_tpu_torch.io.dng import write_dng

        rng = np.random.default_rng(0)
        for i in range(4):
            write_dng(
                str(tmp_path / f"{i}.dng"),
                rng.integers(3000, 50000, (40, 64)).astype(np.uint16),
                white_level=60000,
            )
        out = str(tmp_path / "out")
        for pid in (0, 1):
            rc = main([str(tmp_path), "-o", out, "--grain", "0", "--num-processes", "2",
                       "--process-id", str(pid)])
            assert rc == 0
        assert sorted(os.listdir(out)) == ["0.jpg", "1.jpg", "2.jpg", "3.jpg"]

    def test_cli_exports_cube(self, tmp_path):
        from raw2film_tpu_torch.io.cube import read_cube

        dst = str(tmp_path / "portra.cube")
        rc = port_cli(["--export-lut", dst, "--lut-size", "9", "--negative-film", "Kodak Portra 400",
                       "--print-film", "Fuji Crystal Archive Maxima"])
        assert rc == 0
        lut, _, _ = read_cube(dst)
        assert lut.shape == (9, 9, 9, 3)
        assert np.all(np.isfinite(lut)) and lut.max() <= 1.0 and lut.min() >= 0.0
        diag = np.array([lut[i, i, i].mean() for i in range(9)])
        assert diag[-1] > diag[1]

    def test_cli_export_lut_bw_paper(self, tmp_path):
        from raw2film_tpu_torch.io.cube import read_cube

        dst = str(tmp_path / "trix.cube")
        rc = port_cli(["--export-lut", dst, "--lut-size", "7", "--negative-film", "Kodak Tri-X 400",
                       "--print-film", "Ilford Multigrade IV RC"])
        assert rc == 0
        lut, _, _ = read_cube(dst)
        assert np.abs(lut.max(axis=-1) - lut.min(axis=-1)).max() < 1e-5


class TestSidecarMergeOrder:
    """defaults < sidecar profile < sidecar image < explicit flags only."""

    @staticmethod
    def _roll(tmp_path):
        folder = tmp_path / "roll"
        folder.mkdir()
        _write_fixture_dng(folder / "f1.dng")
        return folder

    @staticmethod
    def _mean_diff(tmp_path) -> float:
        a, b = (_read(tmp_path / d / "f1.jpg").astype(np.float32) for d in ("a", "b"))
        return float(np.abs(a - b).mean())

    def test_sidecar_actually_changes_output(self, tmp_path):
        folder = self._roll(tmp_path)
        assert main([str(folder), "-o", str(tmp_path / "a"), "--grain", "0"]) == 0
        save_settings(sidecar_path(str(folder)), images={"f1.dng": {"exp_comp": 2.0}})
        assert main([str(folder), "-o", str(tmp_path / "b"), "--grain", "0"]) == 0
        assert self._mean_diff(tmp_path) > 2.0, "sidecar exp_comp had no effect"

    def test_explicit_flag_overrides_sidecar(self, tmp_path):
        folder = self._roll(tmp_path)
        save_settings(sidecar_path(str(folder)), images={"f1.dng": {"exp_comp": 2.0}})
        assert main([str(folder), "-o", str(tmp_path / "a"), "--grain", "0", "--exp-comp", "0"]) == 0
        os.remove(sidecar_path(str(folder)))
        assert main([str(folder), "-o", str(tmp_path / "b"), "--grain", "0"]) == 0
        assert self._mean_diff(tmp_path) < 0.5

    def test_sidecar_profile_layer_resolves(self, tmp_path):
        folder = self._roll(tmp_path)
        assert main([str(folder), "-o", str(tmp_path / "a"), "--grain", "0"]) == 0
        save_settings(
            sidecar_path(str(folder)),
            profiles={"Hot": {"push_pull": 2.0}},
            images={"f1.dng": {"profile": "Hot"}},
        )
        assert main([str(folder), "-o", str(tmp_path / "b"), "--grain", "0"]) == 0
        assert self._mean_diff(tmp_path) > 1.0, "sidecar profile had no effect"

    def test_dynamic_lens_keys_survive_roundtrip(self, tmp_path):
        p = str(tmp_path / "settings.json")
        save_settings(p, images={"a.dng": {"exp_comp": 1.0, "lens": "synthetic 50mm f/2",
                                           "lens_correction": False}})
        _, images = load_settings(p)
        assert images["a.dng"]["lens"] == "synthetic 50mm f/2"
        assert images["a.dng"]["lens_correction"] is False

    def test_register_lens(self):
        from raw2film_tpu_torch.pipeline.processor import Processor

        proc = Processor(device="cpu")
        assert proc.register_lens("synthetic 50mm f/2")
        assert "synthetic 50mm f/2" in proc.lenses
        assert not proc.register_lens("no such lens")
        assert not proc.register_lens("")


class TestPortFlags:
    def test_version_names_the_port(self, capsys):
        from raw2film_tpu_torch import __version__

        with pytest.raises(SystemExit) as e:
            port_cli(["--version"])
        assert e.value.code == 0
        assert capsys.readouterr().out.strip() == f"raw2film-tpu-torch {__version__}"

    def test_coordinator_is_not_ported(self, tmp_path):
        """``--coordinator`` joins the processes' gloo group (it was refused
        until ``parallel/distributed.py`` was ported; the test keeps its
        name): two CLI processes on a free localhost port, each exporting its
        slice of the two files, equal to one process's export."""
        import socket
        import subprocess
        import sys

        for i, name in enumerate(("a.dng", "b.dng")):
            _write_fixture_dng(tmp_path / name, seed=i)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p))
        args = [str(tmp_path / "a.dng"), str(tmp_path / "b.dng"), "-o", str(tmp_path / "fleet"),
                "--grain", "0", "--device", "cpu", "--ext", ".png"]
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "raw2film_tpu_torch", *args, "--coordinator", f"127.0.0.1:{port}",
                 "--num-processes", "2", "--process-id", str(pid)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=root,
            )
            for pid in (0, 1)
        ]
        logs = [p.communicate(timeout=300)[0].decode(errors="replace") for p in procs]
        for pid, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, log[-2000:]
            assert f"fleet process {pid}/2: 1 files" in log
        assert main([*args[:2], "-o", str(tmp_path / "one"), "--grain", "0", "--ext", ".png"]) == 0
        assert sorted(os.listdir(tmp_path / "fleet")) == sorted(os.listdir(tmp_path / "one")) == ["a.png", "b.png"]
        for name in ("a.png", "b.png"):
            with Image.open(tmp_path / "fleet" / name) as f, Image.open(tmp_path / "one" / name) as o:
                np.testing.assert_array_equal(np.asarray(f), np.asarray(o))

    def test_device_is_handed_to_the_processor(self, tmp_path, monkeypatch):
        from raw2film_tpu_torch.pipeline import processor as tproc

        seen = []
        orig = tproc.Processor.__init__
        monkeypatch.setattr(tproc.Processor, "__init__",
                            lambda self, *a, **k: seen.append(k.get("device")) or orig(self, *a, **k))
        dng = tmp_path / "t.dng"
        _write_fixture_dng(dng)
        assert main([str(dng), "-o", str(tmp_path / "out"), "--grain", "0"]) == 0
        assert seen == ["cpu"]

    def test_softproof_profile_matches_jax(self, tmp_path):
        """--softproof-profile and --display-profile (PIL's built-in sRGB
        profile, written to a file): the transform is baked into the
        render before the rounding, within 1 code of the JAX CLI."""
        ImageCms = pytest.importorskip("PIL.ImageCms")
        prof = str(tmp_path / "srgb.icc")
        with open(prof, "wb") as f:
            f.write(ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes())
        dng = tmp_path / "shot.dng"
        _write_fixture_dng(dng)
        for flag in ("--softproof-profile", "--display-profile"):
            args = [str(dng), "--grain", "0", "--ext", ".png", flag, prof]
            assert main([*args, "-o", str(tmp_path / flag / "port")]) == 0
            assert jax_main([*args, "-o", str(tmp_path / flag / "jax")]) == 0
            _within_one_code_of_jax(tmp_path / flag / "port" / "shot.png",
                                    tmp_path / flag / "jax" / "shot.png")

    def test_trace_prints_stage_timings(self, tmp_path, capsys, monkeypatch):
        from raw2film_tpu_torch.utils import trace

        monkeypatch.setenv("RAW2FILM_TRACE", "0")  # restored after the test
        trace.reset_stats()
        dng = tmp_path / "t.dng"
        _write_fixture_dng(dng)
        assert main([str(dng), "-o", str(tmp_path / "out"), "--grain", "0", "--trace"]) == 0
        out = capsys.readouterr().out
        assert "[trace] batch.render:" in out and "[trace] batch.export:" in out
        stats = trace.stage_stats()
        assert stats["batch.render"]["count"] == 1 and stats["batch.export"]["count"] == 1
