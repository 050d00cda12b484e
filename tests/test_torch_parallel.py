"""The port's device mesh and sharded batch render (raw2film_tpu_torch/
parallel/) on the CPU, against its own unsharded render and against the
JAX package's ``parallel/mesh.py`` on its virtual 8-device CPU mesh.

- The counterparts of tests/test_parallel.py, each with that file's gate,
  on a mesh of repeated CPU devices (``make_mesh(devices=["cpu"] * n)``):
  batch-sharded bit-equal to unsharded, space-sharded within 1 code on
  every row, an interior seam with burn 0.3 within 3 codes, grain within 1
  code beyond 12 rows of the frame edges, the multi-hop case (halo > 2 *
  h_loc) within 1 code beyond 12 rows, the burn grid aligned at seams
  within 1 code, the mesh shapes.
- The port's sharded render within 1 code of JAX's (halo, 4 x 2 mesh, with
  halation, MTF, grain 2 and burn), ``space_halo_rows`` equal to JAX's, and
  the halo gather equal to JAX's, including a halo longer than the frame.
- The row-aligned burn (``ops/burn.py``) against JAX's ``burn_smallmap``
  and ``burn`` within 1e-5, and their None guards.
- A render by two processes in a gloo group (this file runs itself as the
  worker) equal to one process's, and within 1 code of JAX's.

Grain seeds: a JAX key k maps to the port's seed k[0] ^ k[1].
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import raw2film_tpu  # noqa: F401
from raw2film_tpu.film import chain as jfchain
from raw2film_tpu.film.loader import load_film_stocks
from raw2film_tpu.ops import burn as jburn
from raw2film_tpu.parallel import mesh as jmesh
from raw2film_tpu.pipeline.params import ImageParams, ProfileParams, merge_params
from raw2film_tpu.pipeline.render import build_render_config, make_film_bundle
from raw2film_tpu_torch.convert import bundle_from_numpy, config_from_jax
from raw2film_tpu_torch.ops import burn as tburn
from raw2film_tpu_torch.parallel import mesh as tmesh

STOCKS = load_film_stocks()


def _setup(h=64, w=96, **over):
    """(JAX bundle, JAX cfg, port bundle, port cfg), as tests/test_parallel.py
    builds them."""
    neg = STOCKS["Kodak Portra 400"]
    prt = STOCKS["Fuji Crystal Archive Maxima"]
    neg_p = jfchain.build_negative_params(neg)
    prt_p = jfchain.build_print_params(neg, prt, neg_params=neg_p)
    out_p = jfchain.build_output_params(neg, prt, prt_p, neg_p)
    jb = make_film_bundle(neg_p, prt_p, out_p)
    merged = merge_params(ProfileParams(), ImageParams())
    merged.update({"halation": False, "grain": 0, "sharpness": False, **over})
    jcfg = build_render_config(neg, prt, "print", max(h, w) / 36.0, merged)
    nb = {k: tuple(np.asarray(a) for a in v) if isinstance(v, tuple) else np.asarray(v) for k, v in jb.items()}
    return jb, jcfg, bundle_from_numpy(nb), config_from_jax(jcfg)


def _inputs(b, h, w, seed, mean=0.25, sd=0.1):
    xyz = np.abs(np.random.default_rng(seed).normal(mean, sd, (b, 3, h, w))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), b)
    seeds = [int(k) for k in np.asarray(keys[:, 0] ^ keys[:, 1])]
    return xyz, keys, seeds


def _cpu_mesh(batch, space):
    return tmesh.make_mesh(batch * space, batch=batch, space=space, devices=["cpu"] * (batch * space))


def _single_and_sharded(cfg, bundle, xyz, seeds, batch, space):
    x = torch.from_numpy(xyz)
    single = tmesh.batch_render_fn(cfg)(x, bundle, seeds).numpy()
    sharded = tmesh.sharded_batch_render(_cpu_mesh(batch, space), cfg)(x, bundle, seeds).numpy()
    assert sharded.dtype == np.uint8 and sharded.shape == xyz.shape
    return np.abs(single.astype(int) - sharded.astype(int))


# ------------------------------------------------------------ tests/test_parallel.py's gates


def test_batch_sharded_matches_single():
    *_, bundle, cfg = _setup()
    xyz, _, seeds = _inputs(8, 64, 96, 0, 0.2)
    assert _single_and_sharded(cfg, bundle, xyz, seeds, 8, 1).max() == 0


def test_space_sharding_with_convs_matches():
    """Halation and MTF, 4 x 2 mesh: within 1 code on every row, frame
    edges included (edge shards reflect-101-fill the rows beyond the frame,
    the convention of every conv in the chain)."""
    *_, bundle, cfg = _setup(halation=True, sharpness=True)
    xyz, _, seeds = _inputs(4, 64, 96, 1, 0.2)
    assert _single_and_sharded(cfg, bundle, xyz, seeds, 4, 2).max() <= 1


def test_halo_path_interior_seam_exact_at_larger_halo():
    *_, bundle, cfg = _setup(96, 96, halation=True, sharpness=True, highlight_burn=0.3)
    xyz, _, seeds = _inputs(4, 96, 96, 3)
    dh = _single_and_sharded(cfg, bundle, xyz, seeds, 4, 2)
    assert dh[:, :, 48 - 8 : 48 + 8].max() <= 3


def test_halo_path_grain_exact_across_seams():
    *_, bundle, cfg = _setup(96, 96, halation=True, sharpness=True, grain=2)
    xyz, _, seeds = _inputs(4, 96, 96, 5)
    dh = _single_and_sharded(cfg, bundle, xyz, seeds, 4, 2)
    assert dh[:, :, 12:-12].max() <= 1
    assert dh[:, :, 48 - 6 : 48 + 6].max() <= 1


def test_halo_multi_hop_when_overlap_exceeds_shard():
    *_, bundle, cfg = _setup(
        64, 96, halation=True, sharpness=True, halation_size=24.0, highlight_burn=0.3
    )
    h_loc = 64 // 4
    assert tmesh.space_halo_rows(cfg, 64, 96) > 2 * h_loc
    xyz, _, seeds = _inputs(2, 64, 96, 7)
    dh = _single_and_sharded(cfg, bundle, xyz, seeds, 2, 4)
    assert dh[:, :, 12:-12].max() <= 1


@pytest.mark.parametrize("burn_scale", [50.0, 10.0], ids=["staged-f2", "smallmap-f10"])
def test_halo_burn_grid_aligned_at_seams(burn_scale):
    """The burn's cells lie on the frame's grid in every shard: seam rows
    within 1 code. At burn_scale 10 the factor is 10, so each shard takes
    the small-map path (its glow upsampled in the print tail, K3) with the
    row matrix built for its row offset, and the halo exceeds the frame."""
    *_, bundle, cfg = _setup(
        96, 96, halation=True, sharpness=True, highlight_burn=0.6, burn_scale=burn_scale
    )
    xyz, _, seeds = _inputs(4, 96, 96, 9, 0.3, 0.15)
    dh = _single_and_sharded(cfg, bundle, xyz, seeds, 4, 2)
    assert dh[:, :, 48 - 8 : 48 + 8].max() <= 1


def test_mesh_shapes():
    mesh = tmesh.make_mesh(8, devices=["cpu"] * 8)
    assert mesh.shape == {"batch": 8, "space": 1}
    mesh = tmesh.make_mesh(8, space=4, devices=["cpu"] * 8)
    assert mesh.shape == {"batch": 2, "space": 4}
    assert mesh.devices[1][3] == torch.device("cpu")
    assert tmesh.make_mesh(devices=["cpu"] * 6, batch=3).shape == {"batch": 3, "space": 2}


def test_mesh_errors():
    with pytest.raises(ValueError, match="9 devices requested but only 8"):
        tmesh.make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="must equal n devices"):
        tmesh.make_mesh(8, batch=3, space=2, devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="devices requested"):
            tmesh.make_mesh()
    *_, bundle, cfg = _setup()
    with pytest.raises(ValueError, match="Not to port"):
        tmesh.sharded_batch_render(_cpu_mesh(1, 2), cfg, space_mode="spmd")
    with pytest.raises(ValueError, match="not a multiple of space"):
        tmesh.sharded_batch_render(_cpu_mesh(1, 3), cfg)(torch.zeros(1, 3, 64, 96), bundle, [0])


# ------------------------------------------------------------ against JAX


def test_sharded_render_matches_jax():
    """The port's halo path against JAX's sharded_batch_render on a 4 x 2
    mesh of its virtual CPU devices: halation, MTF, grain 2 and burn 0.3."""
    jb, jcfg, bundle, cfg = _setup(
        96, 96, halation=True, sharpness=True, grain=2, highlight_burn=0.3
    )
    xyz, keys, seeds = _inputs(4, 96, 96, 11)
    mesh = jmesh.make_mesh(8, batch=4, space=2)
    with mesh:
        want = np.asarray(jmesh.sharded_batch_render(mesh, jcfg)(jnp.asarray(xyz), jb, keys))
    got = tmesh.sharded_batch_render(_cpu_mesh(4, 2), cfg)(torch.from_numpy(xyz), bundle, seeds).numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    print(f"port vs JAX sharded: max {diff.max()} code, {(diff == 0).mean():.6f} of codes equal")
    assert diff.max() <= 1


def test_space_halo_rows_match_jax():
    for over in (
        {}, dict(halation=True), dict(halation=True, halation_size=3.0),
        dict(sharpness=True), dict(sharpness=True, sharpening_sigma=2.5),
        dict(chroma_nr=3), dict(highlight_burn=0.3), dict(highlight_burn=0.3, burn_scale=10.0),
        dict(halation=True, sharpness=True, chroma_nr=2, highlight_burn=0.3, halation_size=24.0),
    ):
        for h, w in ((64, 96), (96, 96), (5472, 8208), (8208, 5472), (3, 700)):
            _, jcfg, _, cfg = _setup(h, w, **over)
            assert tmesh.space_halo_rows(cfg, h, w) == jmesh.space_halo_rows(jcfg, h, w), (over, h, w)


def _jax_gather(monkeypatch, h, space, halo):
    """The frame rows each shard of JAX's halo path renders: its
    sharded_batch_render over a frame whose rows hold their own index, with
    the halo patched to ``halo`` and the render patched to write the rows
    of its padded slab into the part of its output that is kept."""
    w = 96
    h_loc = h // space
    monkeypatch.setattr(jmesh, "space_halo_rows", lambda cfg, hh, ww: halo)

    def fn_of(cfg):
        def fn(padded, bundle, keys, row_offset=0, ref_hw=None):
            rows = padded[:, 0, :, 0]  # (B, h_loc + 2 * halo) frame rows
            n = rows.shape[1]
            flat = jnp.zeros((rows.shape[0], h_loc * w), rows.dtype).at[:, :n].set(rows)
            kept = flat.reshape(rows.shape[0], 1, h_loc, w)
            out = jnp.zeros_like(padded)
            return out.at[:, :1, halo : halo + h_loc, :].set(kept)

        return fn

    monkeypatch.setattr(jmesh, "batch_render_fn", fn_of)
    _, jcfg, _, _ = _setup()
    frame = np.broadcast_to(np.arange(h, dtype=np.float32)[None, None, :, None], (1, 3, h, w)).copy()
    mesh = jmesh.make_mesh(space, batch=1, space=space)
    with mesh:
        out = np.asarray(jmesh.sharded_batch_render(mesh, jcfg)(jnp.asarray(frame), {}, jax.random.split(jax.random.PRNGKey(0), 1)))
    n = h_loc + 2 * halo
    return [out[0, 0, s * h_loc : (s + 1) * h_loc].reshape(-1)[:n].astype(np.int64) for s in range(space)]


@pytest.mark.parametrize(
    "h,space,halo",
    [(64, 2, 8), (64, 4, 40), (64, 4, 64), (64, 4, 72), (64, 8, 136)],
    ids=["one-hop", "multi-hop", "halo=H", "halo>H", "deep"],
)
def test_halo_rows_match_jax_gather(monkeypatch, h, space, halo):
    """The port's row gather (reflect-101 once, then clip: not
    ``ops/conv.py::reflect_index``, which repeats the reflection) against
    the rows JAX's ppermute hops and gather hand each shard."""
    want = _jax_gather(monkeypatch, h, space, halo)
    h_loc = h // space
    for s in range(space):
        lo = s * h_loc - halo
        got = tmesh.halo_rows(h, lo, lo + h_loc + 2 * halo, "cpu").numpy()
        np.testing.assert_array_equal(got, want[s])


# ------------------------------------------------------------ the row-aligned burn


def _density(h, w, seed):
    return np.abs(np.random.default_rng(seed).normal(1.2, 0.4, (3, h, w))).astype(np.float32)


@pytest.mark.parametrize("row_offset", [-57, 0, 13, 45, None], ids=lambda r: f"offset{r}")
def test_burn_smallmap_matches_jax(row_offset):
    """f = ceil(min(1000, 1500) / 50) = 20 from the frame's size; a shard
    of 230 rows at frame row ``row_offset`` (negative: a top shard's halo;
    13: not a multiple of f; 45: more than f; None: the static path with
    the frame's factor)."""
    d = _density(230, 300, 1)
    want = jburn.burn_smallmap(jnp.asarray(d), 1.0, 50.0, ref_hw=(1000, 1500), row_offset=row_offset)
    got = tburn.burn_smallmap(torch.from_numpy(d), 1.0, 50.0, ref_hw=(1000, 1500), row_offset=row_offset)
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


@pytest.mark.parametrize(
    "shape,ref_hw,row_offset",
    [((230, 300), (300, 400), 13), ((18, 300), (1000, 1500), 5), ((230, 15), (1000, 1500), 0),
     ((230, 300), None, 3), ((230, 300), None, None)],
    ids=["factor<=8", "hs<=0", "ws==0", "own-frame", "own-frame-static"],
)
def test_burn_smallmap_guards_match_jax(shape, ref_hw, row_offset):
    d = _density(*shape, 2)
    want = jburn.burn_smallmap(jnp.asarray(d), 1.0, 50.0, ref_hw=ref_hw, row_offset=row_offset)
    got = tburn.burn_smallmap(torch.from_numpy(d), 1.0, 50.0, ref_hw=ref_hw, row_offset=row_offset)
    assert (got is None) == (want is None)


@pytest.mark.parametrize("row_offset", [-9, 0, 4, 17, None], ids=lambda r: f"offset{r}")
def test_staged_burn_matches_jax(row_offset):
    """f = ceil(min(300, 400) / 50) = 6 <= 8: the staged burn, its aligned
    cells upsampled by two exact float32 products."""
    d = _density(70, 90, 3)
    want = np.asarray(jburn.burn(jnp.asarray(d), 1.0, 0.4, 50.0, ref_hw=(300, 400), row_offset=row_offset))
    got = tburn.burn(torch.from_numpy(d), 1.0, 0.4, 50.0, ref_hw=(300, 400), row_offset=row_offset).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ------------------------------------------------------------ two processes


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker(pid: int, nproc: int, port: str, folder: str) -> None:
    """One process of the group: its slice of the global batch (process
    major), over a mesh of two CPU devices."""
    from raw2film_tpu_torch.parallel.distributed import distributed_batch_render, init_process

    init_process(f"127.0.0.1:{port}", nproc, pid)
    _, _, bundle, cfg = _setup(halation=True, sharpness=True)
    xyz = np.load(os.path.join(folder, "xyz.npy"))
    seeds = np.load(os.path.join(folder, "seeds.npy"))
    b = xyz.shape[0] // nproc
    mesh = tmesh.make_mesh(devices=["cpu"] * 2)
    out = distributed_batch_render(mesh, cfg, xyz[pid * b : (pid + 1) * b], bundle, seeds[pid * b : (pid + 1) * b])
    np.save(os.path.join(folder, f"out_{pid}.npy"), out)


def test_two_process_group_matches_single(tmp_path):
    jb, jcfg, bundle, cfg = _setup(halation=True, sharpness=True)
    xyz, keys, seeds = _inputs(4, 64, 96, 0, 0.2)
    np.save(tmp_path / "xyz.npy", xyz)
    np.save(tmp_path / "seeds.npy", np.asarray(seeds, np.uint32))
    port = str(_free_port())
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        p for p in (os.path.dirname(os.path.dirname(os.path.abspath(__file__))), os.environ.get("PYTHONPATH")) if p
    ))
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(pid), "2", port, str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        )
        for pid in (0, 1)
    ]
    logs = [p.communicate(timeout=300)[0].decode(errors="replace") for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-2000:]
    got = np.concatenate([np.load(tmp_path / f"out_{pid}.npy") for pid in (0, 1)])
    assert got.shape == (4, 3, 64, 96) and got.dtype == np.uint8
    single = tmesh.batch_render_fn(cfg)(torch.from_numpy(xyz), bundle, seeds).numpy()
    np.testing.assert_array_equal(got, single)
    want = np.asarray(jax.jit(jmesh.batch_render_fn(jcfg))(jnp.asarray(xyz), jb, keys))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
