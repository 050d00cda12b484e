"""The port's web viewer on the CPU: the cases of tests/test_viewer.py on
``raw2film_tpu_torch.viewer`` (its ViewerState over a CPU Processor), plus
what the port answers differently: ``/api/about`` reports torch and the
Processor's device, the page names the port, a soft-proofed frame is held
within 1 code of the JAX viewer's frame, and a ViewerState without a
processor builds one on the device it is given."""

import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from raw2film_tpu_torch.io.dng import write_dng
from raw2film_tpu_torch.viewer import ViewerState, make_handler


@pytest.fixture
def server(tmp_path):
    rng = np.random.default_rng(0)
    for name in ("a.dng", "b.dng"):
        write_dng(
            str(tmp_path / name),
            rng.integers(2000, 40000, (40, 64)).astype(np.uint16),
            white_level=60000,
        )
    state = ViewerState(str(tmp_path), device="cpu")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    yield base, state, str(tmp_path)
    httpd.shutdown()
    state.close()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.headers.get_content_type(), r.read()


def _post(url, doc):
    req = urllib.request.Request(
        url, data=json.dumps(doc).encode(), method="POST"
    )
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


class TestViewer:
    def test_page_and_images(self, server):
        base, _, _ = server
        code, ctype, body = _get(base + "/")
        assert code == 200 and ctype == "text/html" and b"raw2film-tpu-torch" in body
        code, _, body = _get(base + "/api/images")
        doc = json.loads(body)
        assert doc["files"] == ["a.dng", "b.dng"]
        assert "Kodak Portra 400" in doc["negatives"]
        assert doc["prints"]

    def test_multi_select_group_edit(self, server):
        """norender param store: multi-select editing persists the edit on
        the other selected images without rendering each (the reference's
        image-bar multi-select, docs/2_usage.md)."""
        base, state, _ = server
        _post(base + "/api/params", {"i": 1, "params": {"exp_comp": 1.5}, "norender": True})
        code, _, body = _get(base + "/api/params?i=1")
        assert json.loads(body)["exp_comp"] == 1.5
        # The client propagates only the CHANGED fields and resets its
        # baseline on navigation (a full-params propagation would clobber
        # the other selected images' settings; review finding, Aug 18).
        _, _, page = _get(base + "/")
        assert b"delta[k]=p[k]" in page and b"lastP=null" in page

    def test_about_and_theme(self, server):
        """/api/about (the reference GUI kit's AboutDialog role,
        gui.py:64-76) and the css_theme-role light/dark variables."""
        base, _, _ = server
        code, _, body = _get(base + "/api/about")
        doc = json.loads(body)
        assert code == 200 and doc["stocks"] >= 38 and doc["lenses"] >= 50
        assert doc["version"] and doc["backend"] == "cpu" and doc["device"] == "cpu"
        import torch

        assert doc["torch"] == torch.__version__
        _, _, page = _get(base + "/")
        assert b"body.light" in page and b"themebtn" in page

    def test_thumbnail(self, server):
        base, _, _ = server
        code, ctype, body = _get(base + "/api/thumb/0")
        assert code == 200 and ctype == "image/jpeg" and body[:2] == b"\xff\xd8"

    def test_params_to_frame_round_trip(self, server):
        base, state, folder = server
        out = _post(
            base + "/api/params",
            {"i": 0, "params": {"exp_comp": 0.5, "grain": 0}, "full": False},
        )
        assert out["ok"]
        code, _, body = _get(base + "/api/wait?since=0")
        doc = json.loads(body)
        assert doc["seq"] >= 1 and not doc.get("error"), doc
        code, ctype, jpg = _get(base + f"/api/frame.jpg?seq={doc['seq']}")
        assert code == 200 and jpg[:2] == b"\xff\xd8"
        code, ctype, png = _get(base + f"/api/hist.png?seq={doc['seq']}")
        assert code == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"
        # Settings persisted to the folder sidecar, keyed by basename.
        sidecar = os.path.join(folder, "raw2film_settings.json")
        assert os.path.exists(sidecar)
        saved = json.load(open(sidecar))
        assert saved["images"]["a.dng"]["exp_comp"] == 0.5

    def test_profile_save_resolve_round_trip(self, server):
        base, state, folder = server
        out = _post(
            base + "/api/profile",
            {"name": "Warm", "params": {"push_pull": 1.0, "sat_adjust": 1.2,
                                        "exp_comp": 0.7, "negative_film": "Kodak Gold 200"}},
        )
        assert out["ok"] and "Warm" in out["profiles"]
        # exp_comp is an ImageParams field — must NOT land in the profile.
        assert "exp_comp" not in out["profiles"]["Warm"]
        assert out["profiles"]["Warm"]["push_pull"] == 1.0
        # Assign the profile to an image; resolution layers profile under image.
        _post(base + "/api/params", {"i": 1, "params": {"profile": "Warm", "exp_comp": -0.5}})
        code, _, body = _get(base + "/api/params?i=1")
        doc = json.loads(body)
        assert doc["push_pull"] == 1.0 and doc["exp_comp"] == -0.5
        assert doc["negative_film"] == "Kodak Gold 200"
        # Persisted in the sidecar.
        saved = json.load(open(os.path.join(folder, "raw2film_settings.json")))
        assert saved["profiles"]["Warm"]["sat_adjust"] == 1.2

    def test_export_endpoint(self, server):
        base, state, folder = server
        out = _post(base + "/api/export", {"i": 0})
        assert out["ok"]
        state._export_thread.join(timeout=120)
        assert not state._export_thread.is_alive()
        assert state.last_error is None, state.last_error
        assert os.path.exists(out["dst"]) and open(out["dst"], "rb").read(2) == b"\xff\xd8"
        assert "exported" in (state.note or "")

    def test_params_endpoint_returns_full_defaults(self, server):
        """Switching images must reset untouched controls: GET /api/params
        includes schema defaults for every key, so image B doesn't inherit
        image A's slider state in the UI."""
        base, state, _ = server
        _post(base + "/api/params", {"i": 0, "params": {"exp_comp": 2.0}})
        code, _, body = _get(base + "/api/params?i=1")
        doc = json.loads(body)
        assert doc["exp_comp"] == 0.0  # default, not image 0's value
        for key in ("push_pull", "canvas_mode", "halation_intensity", "zoom"):
            assert key in doc, key

    def test_copy_settings_to_all(self, server):
        base, state, folder = server
        _post(base + "/api/params", {"i": 0, "params": {"exp_comp": 1.25, "tint": 5}})
        out = _post(base + "/api/copy_settings", {"i": 0})
        assert out["ok"]
        assert state.image_params["b.dng"]["exp_comp"] == 1.25
        saved = json.load(open(os.path.join(folder, "raw2film_settings.json")))
        assert saved["images"]["b.dng"]["tint"] == 5

    def test_canvas_modes_listed(self, server):
        base, _, _ = server
        _, _, body = _get(base + "/api/images")
        doc = json.loads(body)
        assert "Uniform white" in doc["canvas_modes"]
        assert "xpan" in doc["film_formats"]

    def test_film_format_changes_aspect(self, server):
        """film_format=xpan (65x24) crops the preview to a panoramic frame."""
        import io as _io

        from PIL import Image

        base, state, _ = server
        _post(base + "/api/params", {"i": 0, "params": {"film_format": "xpan"}})
        _get(base + "/api/wait?since=0")
        _, _, jpg = _get(base + "/api/frame.jpg")
        w, h = Image.open(_io.BytesIO(jpg)).size
        assert w / h > 2.2, (w, h)  # 65/24 = 2.71 target aspect

    def test_stock_browser_endpoints(self, server):
        base, _, _ = server
        _, _, body = _get(base + "/api/stocks")
        rows = json.loads(body)["stocks"]
        assert len(rows) >= 38
        by_name = {r["name"]: r for r in rows}
        portra = by_name["Kodak Portra 400"]
        assert portra["manufacturer"] == "Kodak" and portra["stage"] == "camera"
        for key in ("year", "iso", "film_type", "medium", "resolution"):
            assert key in portra
        assert any(r["stage"] == "print" for r in rows)
        # Color-checker swatch renders as a PNG for camera AND print stocks.
        import urllib.parse

        for name in ("Kodak Portra 400", "Fuji Crystal Archive Maxima"):
            code, ctype, png = _get(
                base + "/api/swatch?name=" + urllib.parse.quote(name)
            )
            assert code == 200 and png[:8] == b"\x89PNG\r\n\x1a\n", name

    def test_icc_softproof_round_trip(self, server, tmp_path):
        base, state, _ = server
        pytest.importorskip("PIL.ImageCms")
        from PIL import ImageCms

        # A real ICC file to proof through: PIL's built-in sRGB profile.
        prof = str(tmp_path / "proof.icc")
        with open(prof, "wb") as f:
            f.write(ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes())

        doc = _post(base + "/api/icc", {"softproof": prof})
        assert doc["active"] and doc["softproof"] == prof
        # The render kwargs now carry the transform; a frame renders with it.
        assert "icc_transform" in state._render_kwargs("a.dng")
        out = _post(base + "/api/params", {"i": 0, "params": {"grain": 0}})
        assert out["ok"]
        _, _, body = _get(base + "/api/wait?since=0")
        assert json.loads(body)["seq"] >= 1 and not json.loads(body).get("error")
        # Viewer-only: the export path strips the proof transform.
        kw = state._render_kwargs("a.dng")
        assert "icc_transform" in kw  # preview keeps it ...
        # ... and switching off clears it.
        doc = _post(base + "/api/icc", {})
        assert not doc["active"]
        assert "icc_transform" not in state._render_kwargs("a.dng")

    def test_icc_bad_path_is_an_error_not_fatal(self, server):
        base, _, _ = server
        import urllib.error

        try:
            doc = _post(base + "/api/icc", {"softproof": "/nonexistent/p.icc"})
        except urllib.error.HTTPError as e:
            doc = json.loads(e.read())
        assert "error" in doc
        code, _, _ = _get(base + "/api/images")
        assert code == 200

    def test_export_all(self, server):
        """Batch export queues every image, writes JPEGs, reports progress
        notes, and finishes."""
        import time

        base, state, folder = server
        doc = _post(base + "/api/export_all", {"quality": 90})
        assert doc["ok"] and doc["queued"] == 2
        deadline = time.time() + 120
        while time.time() < deadline:
            _, _, body = _get(base + "/api/wait?since=0")
            note = json.loads(body).get("note") or ""
            if "batch export finished" in note:
                break
            time.sleep(0.2)
        else:
            raise AssertionError("batch export did not finish")
        assert "(2/2)" in note
        out = sorted(os.listdir(os.path.join(folder, "export")))
        assert out == ["a.jpg", "b.jpg"]

    def test_bad_settings_reported_not_fatal(self, server):
        base, state, _ = server
        _post(
            base + "/api/params",
            {"i": 0, "params": {"exp_kelvin": -5.0}, "full": False},
        )
        _, _, body = _get(base + "/api/wait?since=0")
        doc = json.loads(body)
        assert doc["seq"] >= 1
        # Either the engine rejected it (error string) or rendered anyway;
        # the server must stay up either way.
        code, _, body = _get(base + "/api/images")
        assert code == 200

    def test_export_selected(self, server):
        """/api/export_all with indices exports ONLY those images (the
        reference's save_selected_images, gui.py:383-385)."""
        import time

        base, state, folder = server
        doc = _post(base + "/api/export_all", {"indices": [1]})
        assert doc["ok"] and doc["queued"] == 1
        deadline = time.time() + 120
        while time.time() < deadline:
            _, _, body = _get(base + "/api/wait?since=0")
            note = json.loads(body).get("note") or ""
            if "batch export finished" in note:
                break
            time.sleep(0.2)
        else:
            raise AssertionError("selected export did not finish")
        assert sorted(os.listdir(os.path.join(folder, "export"))) == ["b.jpg"]

    def test_reset_image_and_all(self, server):
        """/api/reset drops stored per-image params (one image or all) and
        persists the removal to the sidecar."""
        base, state, folder = server
        _post(base + "/api/params", {"i": 0, "params": {"exp_comp": 1.5}})
        _post(base + "/api/params", {"i": 1, "params": {"exp_comp": -1.0}})
        assert state.image_params["a.dng"]["exp_comp"] == 1.5
        out = _post(base + "/api/reset", {"i": 0})
        assert out["ok"] and "a.dng" not in state.image_params
        # Resolved params fall back to the schema default.
        _, _, body = _get(base + "/api/params?i=0")
        assert json.loads(body)["exp_comp"] == 0.0
        assert state.image_params["b.dng"]["exp_comp"] == -1.0
        out = _post(base + "/api/reset", {"all": True})
        assert out["ok"] and state.image_params == {}
        saved = json.load(
            open(os.path.join(folder, "raw2film_settings.json"))
        )
        assert saved["images"] == {}

    def test_delete_profile(self, server):
        """Profile deletion removes it from state + sidecar; the Default
        profile is protected."""
        base, state, folder = server
        _post(base + "/api/profile", {"name": "Punchy", "params": {"push_pull": 1.0}})
        assert "Punchy" in state.profiles
        out = _post(base + "/api/profile", {"name": "Punchy", "delete": True})
        assert out["ok"] and "Punchy" not in out["profiles"]
        saved = json.load(
            open(os.path.join(folder, "raw2film_settings.json"))
        )
        assert "Punchy" not in saved.get("profiles", {})
        import urllib.error

        try:
            out = _post(base + "/api/profile", {"name": "Default", "delete": True})
        except urllib.error.HTTPError as e:
            out = json.loads(e.read())
        assert "error" in out
        # The guard must not have crashed the server.
        code, _, _ = _get(base + "/api/images")
        assert code == 200

    def test_half_res_preview(self, server):
        """The half flag halves the preview scale cap handed to the engine
        (the tiny test fixture is source-limited, so assert on the request,
        not the rendered frame size)."""
        from raw2film_tpu_torch.viewer import PREVIEW_MAX_SCALE

        base, state, _ = server
        seen = []
        orig = state.engine.request
        state.engine.request = lambda src, **kw: seen.append(kw["max_scale"])
        try:
            _post(base + "/api/params", {"i": 0, "params": {}, "half": False})
            _post(base + "/api/params", {"i": 0, "params": {}, "half": True})
        finally:
            state.engine.request = orig
        assert seen == [PREVIEW_MAX_SCALE, PREVIEW_MAX_SCALE * 0.5]

    def test_lens_toggle_and_override(self, server):
        """Per-image lens_correction toggle + manual lens profile override
        flow through to the render kwargs (the reference's dynamic
        image-param keys, gui.py:1410-1455)."""
        base, state, _ = server
        # Defaults exposed so the UI can reset the controls.
        _, _, body = _get(base + "/api/params?i=0")
        doc = json.loads(body)
        assert doc["lens_correction"] is True and doc["lens"] == ""
        # The lens DB names are listed for the datalist.
        _, _, body = _get(base + "/api/images")
        lenses = json.loads(body)["lenses"]
        assert "synthetic 50mm f/2" in lenses
        # Store an override; the render kwargs carry it and the profile is
        # registered in the processor's lookup.
        _post(base + "/api/params", {"i": 0, "params": {
            "lens_correction": False, "lens": "synthetic 50mm f/2"}})
        kw = state._render_kwargs("a.dng")
        assert kw["lens_correction"] is False
        assert kw["lens"] == "synthetic 50mm f/2"
        assert "synthetic 50mm f/2" in state.proc.lenses

    def test_close_selected(self, server):
        """/api/close drops images from the session list without touching
        the files on disk (the reference's "Close selected images")."""
        base, state, folder = server
        out = _post(base + "/api/close", {"indices": [0]})
        assert out["ok"] and out["removed"] == 1
        _, _, body = _get(base + "/api/images")
        assert json.loads(body)["files"] == ["b.dng"]
        assert os.path.exists(os.path.join(folder, "a.dng"))  # file untouched
        # Thumb index 0 now serves the remaining image.
        code, _, _ = _get(base + "/api/thumb/0")
        assert code == 200

    def test_delete_selected_files(self, server):
        """/api/delete PERMANENTLY removes the selected files from disk and
        drops their stored params (the reference's Delete-selected-images
        Shift+Del action, gui.py:394-396, 1738-1754)."""
        base, state, folder = server
        _post(base + "/api/params", {"i": 0, "params": {"exp_comp": 1.0}, "norender": True})
        out = _post(base + "/api/delete", {"indices": [0], "confirm": "delete"})
        assert out["ok"] and out["deleted"] == 1
        assert not os.path.exists(os.path.join(folder, "a.dng"))
        assert os.path.exists(os.path.join(folder, "b.dng"))
        _, _, body = _get(base + "/api/images")
        assert json.loads(body)["files"] == ["b.dng"]
        assert "a.dng" not in state.image_params  # sidecar entry dropped

    def test_delete_requires_confirmation_token(self, server):
        """The destructive route refuses without the client's explicit
        confirm token (the HTTP analog of the reference's QMessageBox)."""
        base, state, folder = server
        with pytest.raises(urllib.error.HTTPError):
            _post(base + "/api/delete", {"indices": [0]})
        assert os.path.exists(os.path.join(folder, "a.dng"))

    def test_icc_intent_round_trip(self, server, tmp_path):
        """The rendering-intent selection persists through /api/icc (the
        reference's per-transform intent menus, gui.py:437-480)."""
        base, state, _ = server
        pytest.importorskip("PIL.ImageCms")
        from PIL import ImageCms

        prof = str(tmp_path / "p.icc")
        with open(prof, "wb") as f:
            f.write(ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes())
        out = _post(base + "/api/icc", {"softproof": prof, "intent": 3})
        assert out["active"] and out["intent"] == 3
        _, _, body = _get(base + "/api/icc")
        assert json.loads(body)["intent"] == 3
        # Page carries the intent selector.
        _, _, page = _get(base + "/")
        assert b"icc_intent" in page

    def test_advanced_controls(self, server):
        """The advanced section exposes every remaining ProfileParams/
        ImageParams control; posted values flow into the render kwargs."""
        base, state, _ = server
        _, _, page = _get(base + "/")
        for ctl in (b"halation_size", b"projector_kelvin", b"grain_mode",
                    b"gamma_func", b"rot90", b"color_masking", b"burn_scale",
                    b"white_clip", b"idealized_curve", b"flip"):
            assert ctl in page, ctl
        _, _, body = _get(base + "/api/images")
        assert "ARRI LogC3" in json.loads(body)["gamma_funcs"]
        _post(base + "/api/params", {"i": 0, "params": {
            "grain": 0, "gamma_func": "Rec709", "rotate_times": 1,
            "halation": False, "shadow_comp": 0.5, "flip": True}})
        kw = state._render_kwargs("a.dng")
        assert kw["grain"] == 0 and kw["gamma_func"] == "Rec709"
        assert kw["rotate_times"] == 1 and kw["halation"] is False
        assert kw["shadow_comp"] == 0.5 and kw["flip"] is True

    def test_preview_latency_regression(self, server):
        """Steady-state slider->frame cycles stay under a GENEROUS bound
        (the interactive contract benchmarks/preview_latency.py measures
        precisely on the chip; this pins the wiring never regresses to
        e.g. a full re-decode or a recompile per slider change). Warm
        cycles on the 40x64 CPU fixture run in tens of ms; 5 s leaves two
        orders of magnitude for CI noise."""
        import time as _time

        base, _, _ = server
        seq = 0

        def cycle(i):
            t0 = _time.perf_counter()
            _post(base + "/api/params",
                  {"i": 0, "params": {"exp_comp": 0.01 * i}})
            nonlocal seq
            _, _, body = _get(base + f"/api/wait?since={seq}")
            doc = json.loads(body)
            assert not doc.get("error"), doc
            seq = doc["seq"]
            code, _, jpg = _get(base + f"/api/frame.jpg?seq={seq}")
            assert code == 200 and jpg[:2] == b"\xff\xd8"
            return _time.perf_counter() - t0

        cycle(0)  # compile + decode-cache warm (not asserted)
        lat = sorted(cycle(i) for i in range(1, 6))
        assert lat[len(lat) // 2] < 5.0, lat

    def test_lens_confidence_badging(self, server):
        """/api/images exposes per-model provenance so the UI can badge
        class-derived (approximate) corrections; the page carries the badge
        element + rendering logic."""
        base, state, _ = server
        _, _, body = _get(base + "/api/images")
        conf = json.loads(body)["lens_conf"]
        assert conf, "lens_conf empty"
        tiers = set(conf.values())
        assert "heuristic" in tiers and "curated" in tiers, tiers
        _, _, page = _get(base + "/")
        assert b"lens_badge" in page and b"class-derived (approximate)" in page

    def test_mtf_fidelity_toggle(self, server):
        """The mtf_fidelity checkbox (VERDICT r4 weak #3: the flag existed
        but was viewer-invisible) ships with its tradeoff explanation, flows
        into the render kwargs, and persists via the folder sidecar."""
        base, state, folder = server
        _, _, page = _get(base + "/")
        assert b"mtf_fidelity" in page
        assert b"Datasheet-true MTF" in page  # the one-line explanation
        _post(base + "/api/params",
              {"i": 0, "params": {"mtf_fidelity": True}, "norender": True})
        assert state._render_kwargs("a.dng")["mtf_fidelity"] is True
        saved = json.load(open(os.path.join(folder, "raw2film_settings.json")))
        assert saved["images"]["a.dng"]["mtf_fidelity"] is True
        # GET round-trips it back to the UI; default for other images stays off.
        _, _, body = _get(base + "/api/params?i=0")
        assert json.loads(body)["mtf_fidelity"] is True
        _, _, body = _get(base + "/api/params?i=1")
        assert json.loads(body)["mtf_fidelity"] is False

    def test_advanced_params_render_a_frame(self, server):
        """A full-preview request carrying advanced params (grain BW,
        Rec709 encoding, halation off, rotate 90) renders end-to-end."""
        base, state, _ = server
        out = _post(base + "/api/params", {"i": 0, "full": True, "params": {
            "grain": 1, "gamma_func": "Rec709", "halation": False,
            "rotate_times": 1, "color_masking": 0.5, "shadow_comp": 0.3}})
        assert out["ok"]
        _, _, body = _get(base + "/api/wait?since=0")
        doc = json.loads(body)
        assert doc["seq"] >= 1 and not doc.get("error"), doc
        code, _, jpg = _get(base + "/api/frame.jpg")
        assert code == 200 and jpg[:2] == b"\xff\xd8"
        # rotate_times=1 swaps the frame aspect (64x40 source -> taller
        # than wide after the 90-degree rotation + 3:2 frame crop).
        import io as _io

        from PIL import Image

        w, h = Image.open(_io.BytesIO(jpg)).size
        assert h > w, (w, h)


def test_js_endpoints_have_routes():
    """Every /api/ path the embedded JS fetches must have a server route
    (guards UI/server drift — the JS is not executed by these tests)."""
    import re

    import raw2film_tpu_torch.viewer as v

    src = open(v.__file__).read()
    js = {p.rstrip(".") for p in re.findall(r'["\'(]/(api/[a-z_./]+)', src)}
    routes = set(re.findall(r'u\.path(?:\.startswith\()? ?==? ?"/(api/[a-z_./]+)"', src))
    routes |= set(re.findall(r'u\.path\.startswith\("/(api/[a-z_./]+)', src))
    missing = {
        j
        for j in js
        if not any(j.startswith(r.rstrip("/")) or r.startswith(j) for r in routes)
    }
    assert not missing, missing


def test_softproof_frame_matches_jax(server, tmp_path, monkeypatch):
    """The frame the port's engine renders with a soft proof set (the array
    before its JPEG encode) is within 1 code of the JAX viewer's frame for
    the same request, and differs from no proof by at most the uint8
    tabulation of the sRGB-to-sRGB proof (1 code)."""
    ImageCms = pytest.importorskip("PIL.ImageCms")
    import raw2film_tpu.viewer as jviewer
    import raw2film_tpu_torch.viewer as tviewer

    base, state, folder = server
    prof = str(tmp_path / "proof.icc")
    with open(prof, "wb") as f:
        f.write(ImageCms.ImageCmsProfile(ImageCms.createProfile("sRGB")).tobytes())
    frames = {"port": [], "jax": []}
    for key, mod in (("port", tviewer), ("jax", jviewer)):
        orig = mod._jpeg_bytes
        monkeypatch.setattr(
            mod, "_jpeg_bytes", lambda a, quality=88, k=key, o=orig: frames[k].append(a) or o(a, quality)
        )
    jstate = jviewer.ViewerState(folder)
    try:
        for st in (state, jstate):
            seq = st.seq
            st.set_icc(softproof=prof)
            st.request(0, {"exp_comp": 0.3}, False)
            assert st.wait(seq, timeout=120) > seq and st.last_error is None, st.last_error
        seq = state.seq
        state.set_icc()
        state.request(0, {"exp_comp": 0.3}, False)
        assert state.wait(seq, timeout=120) > seq
    finally:
        jstate.close()
    proofed, unproofed = frames["port"]
    (want,) = frames["jax"]
    assert proofed.shape == want.shape and proofed.dtype == want.dtype == np.uint8
    assert np.abs(proofed.astype(int) - want.astype(int)).max() <= 1
    assert np.abs(proofed.astype(int) - unproofed.astype(int)).max() <= 1


def test_viewer_state_builds_its_processor_on_the_device(tmp_path):
    from raw2film_tpu_torch.viewer import ViewerState as PortState

    state = PortState(str(tmp_path), device="cpu")
    try:
        assert str(state.proc.device) == "cpu" and state.engine.processor is state.proc
    finally:
        state.close()
