"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip without them
(as on a CPU-only test machine). ``python3 chip_smoke.py`` runs the same
checks, and more, at the 45 MP main path's shapes."""

import numpy as np
import pytest
import torch

from raw2film_tpu_torch.kernels import build as kb
from raw2film_tpu_torch.ops import demosaic as dm
from raw2film_tpu_torch.ops import develop as dev_ops
from raw2film_tpu_torch.ops import grain as grain_ops
from raw2film_tpu_torch.ops import halation as hal_ops
from raw2film_tpu_torch.ops import print_encode as pe
from raw2film_tpu_torch.ops import pyramid
from raw2film_tpu_torch.ops import sep_rank
from raw2film_tpu_torch.pipeline import render

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on an NVIDIA GPU")
    return torch.device("cuda", 0)


def _plain(fn, *args):
    with kb.plain_reference():
        return fn(*args)


def _launched(name, fn, *args):
    before = kb.launches[name]
    out = fn(*args)
    assert kb.launches[name] == before + 1
    return out


def test_demosaic_kernel(cuda):
    codes = torch.randint(0, 16000, (45, 67), dtype=torch.int32, device=cuda).to(torch.uint16)
    mat = np.array([[0.9, 0.2, -0.1], [0.1, 1.1, -0.2], [-0.05, 0.15, 0.95]], np.float32)
    norm = (256.0, 1.0 / 15000.0)
    before = kb.launches["demosaic"]
    got = dm.demosaic_exposure(codes, "GRBG", mat, norm)
    assert kb.launches["demosaic"] == before + 1
    ref = _plain(dm.demosaic_exposure, codes, "GRBG", mat, norm)
    assert (got - ref).abs().max().item() <= 2e-6


_MAT = np.array([[0.9, 0.2, -0.1], [0.1, 1.1, -0.2], [-0.05, 0.15, 0.95]], np.float32)


def _mosaic(kind, shape, cuda, seed=0, offset=0):
    """(mosaic, norm): uint16 sensor codes with their normalize, small
    uint16 codes without it (0-3: the interpolants stay exact), or float32
    in [0, 1] (or codes, with the normalize); laid ``offset`` elements into
    its storage."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    n = shape[0] * shape[1]
    if kind == "u16":
        flat, norm = torch.randint(0, 4, (n + offset,), generator=g, device=cuda).to(torch.uint16), None
    elif kind == "u16-norm":
        flat = torch.randint(0, 16000, (n + offset,), generator=g, device=cuda).to(torch.uint16)
        norm = (256.0, 1.0 / 15000.0)
    elif kind == "f32":
        flat, norm = torch.rand(n + offset, generator=g, device=cuda), None
    else:
        flat, norm = torch.rand(n + offset, generator=g, device=cuda) * 16000.0, (256.0, 1.0 / 15000.0)
    return flat[offset:].view(shape), norm


def _demosaic_case(x, pattern, norm, mat):
    if mat is None:
        got = _launched("demosaic", dm.demosaic_mhc, x, pattern, norm)
        ref = _plain(dm.demosaic_mhc, x, pattern, norm)
    else:
        got = _launched("demosaic", dm.demosaic_exposure, x, pattern, mat, norm)
        ref = _plain(dm.demosaic_exposure, x, pattern, mat, norm)
    assert tuple(got.shape) == (3, *x.shape)
    assert (got - ref).abs().max().item() <= 2e-6


@pytest.mark.parametrize("with_mat", [False, True], ids=["rgb", "mat"])
@pytest.mark.parametrize("kind", ["u16", "u16-norm", "f32", "f32-norm"])
@pytest.mark.parametrize("pattern", list(dm.PATTERNS))
def test_demosaic_kernel_phases(cuda, pattern, kind, with_mat):
    """K1's four phase instances, uint16 and float32, with and without the
    normalize and the matrix, on a 49 x 392 frame: its 16-byte path, with
    interior tiles (16-byte staging) beside the edge ones."""
    x, norm = _mosaic(kind, (49, 392), cuda, seed=len(kind))
    out = torch.empty((3, 49, 392), device=cuda)
    assert dm.vec_path(392, x.dtype, x.data_ptr(), out.data_ptr())
    _demosaic_case(x, pattern, norm, _MAT if with_mat else None)


@pytest.mark.parametrize("kind", ["u16-norm", "f32"])
@pytest.mark.parametrize("w", [67, 66, 64, 392, 8207])
def test_demosaic_kernel_widths(cuda, w, kind):
    """Widths on the 16-byte path (64 and 392; 66 for neither dtype) and on
    the general one (67, 66, 8207)."""
    x, norm = _mosaic(kind, (45, w), cuda, seed=w)
    assert dm.vec_path(w, x.dtype, x.data_ptr(), x.data_ptr()) == (w in (64, 392))
    _demosaic_case(x, "GRBG", norm, _MAT)


@pytest.mark.parametrize("kind,offset", [("u16-norm", 1), ("u16-norm", 2), ("u16-norm", 8), ("f32", 1), ("f32", 4)])
def test_demosaic_kernel_unaligned(cuda, kind, offset):
    """A contiguous mosaic view that starts 1, 2, 4 or 8 values into its
    storage: the general path unless 16-byte aligned (u16 offset 8, f32
    offset 4)."""
    x, norm = _mosaic(kind, (49, 392), cuda, seed=offset, offset=offset)
    assert x.is_contiguous()
    assert dm.vec_path(392, x.dtype, x.data_ptr(), 0) == (x.data_ptr() % 16 == 0)
    _demosaic_case(x, "RGGB", norm, _MAT)


@pytest.mark.parametrize("kind", ["u16-norm", "f32"])
@pytest.mark.parametrize("hw", [(2, 2), (2, 5), (3, 3), (4, 5), (5, 2), (5, 5)], ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_demosaic_kernel_small_frames(cuda, hw, kind):
    """Frames of 2-5 pixels a side: the 5 x 5 stencil reflects more than
    once (numpy's repeated reflect-101)."""
    x, norm = _mosaic(kind, hw, cuda, seed=hw[0] * 10 + hw[1])
    _demosaic_case(x, "BGGR", norm, None)
    _demosaic_case(x, "GBRG", norm, _MAT)


@pytest.mark.parametrize("hw", [(15, 127), (17, 129), (31, 255), (33, 257), (17, 136), (33, 264), (16, 128), (32, 256)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_demosaic_kernel_tile_edges(cuda, hw):
    """H and W one off the 16 x 128 tile (and 8 columns off, on the 16-byte
    path), and on it."""
    x, norm = _mosaic("u16-norm", hw, cuda, seed=hw[1])
    _demosaic_case(x, "RGGB", norm, _MAT)


def test_sep_rank_grain_kernel(cuda):
    rng = np.random.default_rng(0)
    u = rng.normal(size=(3, 4, 23)).astype(np.float32) * 0.05
    v = rng.normal(size=(3, 4, 23)).astype(np.float32) * 0.05
    d = torch.rand((3, 70, 130), device=cuda) * 3.0
    grain = ((12345, 7), torch.tensor([0.02, 0.15, 0.3, 2.4, 0.1, 0.3], device=cuda), (0.2, 0.9, 0.2))
    got = sep_rank.fused_sep_rank(d, u, v, grain)
    ref = _plain(sep_rank.fused_sep_rank, d, u, v, grain)
    assert (got - ref).abs().max().item() <= 1e-5


@pytest.mark.parametrize("grain", [False, True], ids=["ranks", "grain"])
@pytest.mark.parametrize("per_channel", [False, True], ids=["shared", "per-channel"])
@pytest.mark.parametrize("k", [3, 9, 23, 41, 73])
def test_sep_rank_chunked_lengths(cuda, k, per_channel, grain):
    """The chunked rank stage at short and long taps (1 to 10 chunks of 8),
    shared and per channel, on a frame one row and three columns past the
    32 x 128 tile, with and without the grain epilogue (13 taps: 4 chunks
    of 4)."""
    rng = np.random.default_rng(k)
    shape = (3, 3, k) if per_channel else (3, k)
    u = rng.normal(size=shape).astype(np.float32) * 0.1
    v = rng.normal(size=shape).astype(np.float32) * 0.1
    d = torch.rand((3, 161, 643), device=cuda) * 3.0
    assert not sep_rank.tpu_declines(161, 643, k // 2)
    g = ((99, 5), torch.tensor([0.02, 0.15, 0.3, 2.4, 0.1, 0.3], device=cuda),
         grain_ops.grain_corr_taps(2.3)) if grain else None
    got = _launched("sep_rank", sep_rank.fused_sep_rank, d, u, v, g)
    assert (got - _plain(sep_rank.fused_sep_rank, d, u, v, g)).abs().max().item() <= 1e-5


def test_sep_rank_ragged_ranks(cuda):
    """Shared ranks of 15, 27 and 5 taps (the /4 small blur's and a short
    one), each at its own chunk count, on a frame smaller than one tile."""
    from raw2film_tpu_torch.ops.conv import gaussian_kernel1d

    u = [gaussian_kernel1d(2.0, 3.5), gaussian_kernel1d(4.0, 3.3), gaussian_kernel1d(0.7, 3.0)]
    assert [len(t) for t in u] == [15, 27, 5]
    d = torch.rand((3, 29, 100), device=cuda)
    got = _launched("sep_rank_narrow", sep_rank.fused_sep_rank, d, u, u)
    assert (got - _plain(sep_rank.fused_sep_rank, d, u, u)).abs().max().item() <= 1e-5


def test_hash_words_kernel(cuda):
    a, b = sep_rank.hash_words_kernel(16, 40, 8190, 5460, 2, 0xFFFFFFF0, 2**31, cuda)
    pa, pb = grain_ops.hash_words(16, 40, 8190, 5460, 2, 0xFFFFFFF0, 2**31, device=cuda)
    assert torch.equal(a, pa) and torch.equal(b, pb)


@pytest.mark.parametrize("quantize", [True, False])
def test_print_encode_kernel(cuda, quantize):
    d = torch.rand((3, 33, 150), device=cuda) * 3.0
    pvec = torch.rand(61, device=cuda) * 0.5 + 0.25
    small = torch.rand((4, 6), device=cuda)
    rowmat = torch.rand((33, 4), device=cuda) / 4
    colmat = torch.rand((6, 150), device=cuda) / 6
    args = (d, pvec, "print", True, False, "Rec709", quantize, (small, rowmat, colmat))
    got, ref = pe.print_encode(*args), _plain(pe.print_encode, *args)
    assert (got.double() - ref.double()).abs().max().item() <= (1.0 if quantize else 1e-4)


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("width", [2000, 300, 301], ids=["2000-wide", "vec", "scalar"])
def test_print_encode_burn_band(cuda, width, quantize):
    """The burn band T (16 rows x ws) and the sums share the block's shared
    memory: a 2000-wide small map needs 128 KB (above 48 KB); W = 300 takes
    the 16-byte path, W = 301 the scalar one; 37 rows leave a short band."""
    g = torch.Generator(device=cuda).manual_seed(width)
    d = torch.rand((3, 37, width), generator=g, device=cuda) * 3.5
    pvec = torch.rand(61, generator=g, device=cuda) * 0.5 + 0.25
    ws = 2000 if width == 2000 else 7
    burn = (torch.rand((3, ws), generator=g, device=cuda), torch.rand((37, 3), generator=g, device=cuda) / 3,
            torch.rand((ws, width), generator=g, device=cuda) / ws)
    assert pe.vector_path(width, d.data_ptr(), d.data_ptr(), burn[2].data_ptr()) == (width % 4 == 0)
    args = (d, pvec, "print", True, False, "Gamma 2.2", quantize, burn)
    got = _launched("print_encode", pe.print_encode, *args)
    assert (got.double() - _plain(pe.print_encode, *args).double()).abs().max().item() <= (1.0 if quantize else 1e-4)


@pytest.mark.parametrize("gamma", ["sRGB", "Rec709", "Gamma 2.2", "Gamma 2.4", "ARRI LogC3", "Linear"])
@pytest.mark.parametrize("mode", ["print", "inversion"])
def test_print_encode_tail_on_the_sfu(cuda, mode, gamma):
    """The tail's exp2/log2 on the SFU, without the burn: every transfer
    and mode within 1e-4 of the plain version (float) and 1 code (uint8)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    d = torch.rand((3, 50, 260), generator=g, device=cuda) * 3.5
    pvec = torch.rand(61, generator=g, device=cuda) * 0.5 + 0.25
    for quantize, tol in ((False, 1e-4), (True, 1.0)):
        args = (d, pvec, mode, mode == "print", gamma == "Linear", gamma, quantize)
        got = _launched("print_encode", pe.print_encode, *args)
        assert (got.double() - _plain(pe.print_encode, *args).double()).abs().max().item() <= tol


@pytest.mark.parametrize(
    "shape,f",
    [((3, 38, 55), 4), ((2, 37, 53), 3), ((3, 38, 260), 4), ((3, 37, 252), 4), ((2, 45, 136), 8),
     ((1, 50, 96), 12)],
)
def test_box_downsample_kernel(cuda, shape, f):
    """The one-thread-per-output kernel (W % 4 != 0, f = 3 or 12) and the
    16-byte path (f = 4, 8 with W % 4 == 0; an odd count of outputs per
    row)."""
    x = torch.rand(shape, device=cuda) * 3.0
    assert pyramid.box_vec_path(f, shape[2], x.data_ptr()) == (f in (4, 8) and shape[2] % 4 == 0)
    got = _launched("pyramid_down", pyramid.box_downsample_pyramid, x, f)
    assert (got - _plain(pyramid.box_downsample_pyramid, x, f)).abs().max().item() <= 1e-6


@pytest.mark.parametrize("offset", [1, 4])
def test_box_downsample_unaligned(cuda, offset):
    """A contiguous view that starts 4 or 16 bytes into its storage: the
    one-thread-per-output kernel where it is not 16-byte aligned."""
    base = torch.rand(3 * 40 * 64 + 8, device=cuda) * 3.0
    x = base[offset: offset + 3 * 40 * 64].view(3, 40, 64)
    assert x.is_contiguous() and pyramid.box_vec_path(4, 64, x.data_ptr()) == (offset % 4 == 0)
    got = _launched("pyramid_down", pyramid.box_downsample_pyramid, x, 4)
    assert (got - _plain(pyramid.box_downsample_pyramid, x, 4)).abs().max().item() <= 1e-6


@pytest.mark.parametrize("f,oh", [(4, 41), (4, None), (3, 20)])
def test_upsample_rows_kernel(cuda, f, oh):
    x = torch.rand((3, 11, 29), device=cuda) * 3.0
    got = _launched("pyramid_up_rows", pyramid.bilinear_upsample_rows, x, f, oh)
    assert (got - _plain(pyramid.bilinear_upsample_rows, x, f, oh)).abs().max().item() <= 2e-6


@pytest.mark.parametrize(
    "shape,f,oh",
    [((3, 11, 32), 4, 41), ((3, 40, 2052), 4, None), ((2, 9, 30), 3, 25), ((1, 7, 64), 8, 53), ((2, 13, 37), 8, None),
     ((3, 20, 100), 3, 58)],
)
def test_upsample_rows_kernel_paths(cuda, shape, f, oh):
    """K12's 16-byte path (w % 4 == 0) and its scalar one, oh not a
    multiple of f, f = 3 and 8; runs of 8 rows across the row pairs."""
    x = torch.rand(shape, device=cuda) * 3.0
    assert pyramid.rows_vec_path(shape[2], x.data_ptr(), x.data_ptr()) == (shape[2] % 4 == 0)
    got = _launched("pyramid_up_rows", pyramid.bilinear_upsample_rows, x, f, oh)
    assert (got - _plain(pyramid.bilinear_upsample_rows, x, f, oh)).abs().max().item() <= 2e-6


@pytest.mark.parametrize("offset", [1, 2, 4])
def test_upsample_rows_unaligned(cuda, offset):
    """A contiguous view 1, 2 or 4 floats into its storage: the scalar path
    unless 16-byte aligned."""
    base = torch.rand(3 * 11 * 32 + 4, device=cuda) * 3.0
    x = base[offset: offset + 3 * 11 * 32].view(3, 11, 32)
    assert pyramid.rows_vec_path(32, x.data_ptr(), 0) == (offset % 4 == 0)
    got = _launched("pyramid_up_rows", pyramid.bilinear_upsample_rows, x, 4, 41)
    assert (got - _plain(pyramid.bilinear_upsample_rows, x, 4, 41)).abs().max().item() <= 2e-6


@pytest.mark.parametrize("develop", [False, True], ids=["exposure", "density"])
def test_halation_kernel(cuda, develop):
    """The 45 MP config's ranks (4 x 27 taps) on a frame whose W is not a
    multiple of 4 (the lerp's edge clamp on a short last column)."""
    us, vs, _ = hal_ops._full_res_ranks(57.0)
    img = torch.rand((3, 45, 70), device=cuda) * 2.0
    rows_up = torch.rand((3, 45, 18), device=cuda) * 0.5
    fac = torch.tensor([1.0, 0.3, 0.0], device=cuda)
    dv = None
    if develop:
        dv = torch.tensor(
            [0.01, 0.2, 0.25, 0.3, 0.6, 0.62, 0.58, -2.0, -2.1, -1.9, 1.0, 1.1, 0.9,
             0.3, 0.32, 0.28, 0.5, 0.45, 0.55], device=cuda,
        )
    args = (img, us, vs, rows_up, fac, dv)
    got = _launched("halation", hal_ops.halation_mega, *args)
    tol = 2e-5 if develop else 1e-5
    assert (got - _plain(hal_ops.halation_mega, *args)).abs().max().item() <= tol


_DEVELOP = [0.01, 0.2, 0.25, 0.3, 0.6, 0.62, 0.58, -2.0, -2.1, -1.9, 1.0, 1.1, 0.9, 0.3, 0.32, 0.28, 0.5, 0.45, 0.55]


@pytest.mark.parametrize("develop", [False, True], ids=["exposure", "density"])
@pytest.mark.parametrize("bw", [False, True], ids=["colour", "bw"])
@pytest.mark.parametrize(
    "size,hw",
    [(57.0, (33, 259)), (41.7, (67, 129)), (112.0, (35, 131)), (50.0, (65, 387))],
    ids=["27-taps", "43-taps", "5x49-taps", "4x49-taps"],
)
def test_halation_kernel_tile_edges(cuda, size, hw, bw, develop):
    """The 32 x 128 tile's edges: H and W one or three past a tile multiple
    (W not a multiple of 4), with the 45 MP stack (27 taps), the 24 MP one
    (43) and the longest ones (49 taps; 5 ranks: 490 floats)."""
    us, vs, _ = hal_ops._full_res_ranks(size)
    assert len(us[0]) == {57.0: 27, 41.7: 43, 112.0: 49, 50.0: 49}[size]
    g = torch.Generator(device=cuda).manual_seed(int(size * 10))
    img = torch.rand((3, *hw), generator=g, device=cuda) * 2.0
    rows_up = torch.rand((3, hw[0], -(-hw[1] // 4)), generator=g, device=cuda) * 0.5
    fac = torch.tensor([0.4, 0.4, 0.4] if bw else [1.0, 0.3, 0.0], device=cuda)
    dv = torch.tensor(_DEVELOP, device=cuda) if develop else None
    args = (img, us, vs, rows_up, fac, dv)
    got = _launched("halation", hal_ops.halation_mega, *args)
    assert (got - _plain(hal_ops.halation_mega, *args)).abs().max().item() <= (2e-5 if develop else 1e-5)


def _film(cuda, negative="Kodak Portra 400", masking=1.0):
    bundle, _ = render.load_film_bundle(negative, device=cuda, halation=False, color_masking=masking)
    return bundle


def _exposure(shape, cuda, seed=0):
    """Exposures over the curve's whole range, with zeros and negatives (the
    1e-6 clamp) in every plane."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    ep = torch.rand(shape, generator=g, device=cuda) ** 3 * 20.0 - 0.05
    ep.view(-1)[:: 7] = 0.0
    return ep


def _develop_case(ep, bundle):
    got = _launched("develop", render._develop, ep, bundle)
    want = _plain(render._develop, ep, bundle)
    assert got.shape == ep.shape and got.is_contiguous()
    assert (got - want).abs().max().item() <= 2e-5


# K16 within 2e-5 of the plain development (chip_smoke.py's TOL["develop"]: K14's SFU chain)
@pytest.mark.parametrize(
    "hw", [(5472, 8208), (7, 1), (7, 3), (7, 5), (5, 8207), (1, 8208), (1, 5), (1, 1), (45, 70)],
    ids=lambda hw: f"{hw[0]}x{hw[1]}",
)
def test_develop_kernel(cuda, hw):
    """The full 45 MP frame (16-byte path), W = 1, 3, 5 and 8207, H = 1."""
    ep = _exposure((3, *hw), cuda, seed=hw[1])
    assert ep.data_ptr() % 16 == 0  # the 16-byte path where H * W % 4 == 0
    _develop_case(ep, _film(cuda))


@pytest.mark.parametrize("negative,masking", [("Kodak Portra 400", 0.5), ("Kodak Tri-X 400", 1.0)],
                         ids=["colour-masking-0.5", "black-and-white"])
def test_develop_kernel_films(cuda, negative, masking):
    """A mask that is not the identity, and a black-and-white negative."""
    _develop_case(_exposure((3, 37, 388), cuda, seed=3), _film(cuda, negative, masking))


@pytest.mark.parametrize("offset", [0, 1, 4])
def test_develop_kernel_views(cuda, offset):
    """A crop's contiguous copy (the 16-byte path), and contiguous views 1
    and 4 floats into their storage (unaligned: the 4-byte path; aligned)."""
    bundle = _film(cuda)
    if offset == 0:
        ep = _exposure((3, 64, 96), cuda, seed=5)[:, 3:40, 5:81].contiguous()
    else:
        ep = _exposure((3 * 37 * 76 + offset,), cuda, seed=6)[offset:].view(3, 37, 76)
    assert (ep.data_ptr() % 16 == 0) == (offset != 1)  # 37 * 76 % 4 == 0: the 16-byte path where aligned
    _develop_case(ep, bundle)


def test_develop_kernel_refuses(cuda):
    """A strided, float64 or host exposure raises; one call is one launch."""
    host = _film(cuda)["develop_host"]
    ep = _exposure((3, 8, 16), cuda)
    with pytest.raises(ValueError, match="not contiguous"):
        dev_ops.develop(ep[:, :, ::2], host)
    with pytest.raises(TypeError, match="dtype"):
        dev_ops.develop(ep.double(), host)
    with pytest.raises(ValueError, match="CUDA"):
        dev_ops.develop(ep.cpu(), host)
    before = kb.launches["develop"]
    for _ in range(3):
        dev_ops.develop(ep, host)
    assert kb.launches["develop"] == before + 3


@pytest.mark.parametrize("pattern", ["RGGB", "GBRG"])
@pytest.mark.parametrize("dtype", ["u16", "f32"])
def test_half_size_kernel(cuda, pattern, dtype):
    """Odd H and W: the last row and column are dropped; bit-equal."""
    codes = torch.randint(0, 16000, (45, 67), dtype=torch.int32, device=cuda)
    x = codes.to(torch.uint16) if dtype == "u16" else codes.to(torch.float32) / 16000.0
    norm = (256.0, 1.0 / 15000.0) if dtype == "u16" else None
    got = _launched("half_size", dm.half_size_decode, x, pattern, norm)
    assert tuple(got.shape) == (3, 22, 33)
    assert torch.equal(got, _plain(dm.half_size_decode, x, pattern, norm))


# K15's cases: the 45 MP frame (16-byte path), small odd and even frames,
# and an unaligned view of a frame whose width takes the 16-byte path
# (the general path, by the wrapper's vec_path).
EXPOSURE_CASES = [((5472, 8208), 0), ((41, 67), 0), ((42, 66), 0), ((37, 80), 0), ((2, 2), 0), ((40, 64), 1)]


@pytest.mark.parametrize("dtype", ["u16", "f32"])
@pytest.mark.parametrize("pattern", list(dm.PATTERNS))
def test_exposure_sample_kernel(cuda, pattern, dtype):
    """K15 against the host estimate (its plain version): the power mean
    within 2e-6 relative, one launch a call; the cam matrix's Y row and a
    power of 1 / 5.47 (ISO 100, 1/125 s, f/4)."""
    cam = np.array([[0.41, 0.36, 0.18], [0.21, 0.72, 0.07], [0.02, 0.12, 0.95]], np.float32)
    norm = (512.0, 1.0 / 23488.0)
    factor = float(np.sqrt(4.0**2 / 100 / (1 / 125)) + 1.0)
    g = torch.Generator(device=cuda).manual_seed(15)
    for (h, w), offset in EXPOSURE_CASES:
        # codes from below black to above white: clipped sites at both ends
        codes = torch.rand((h * w + offset,), generator=g, device=cuda) * 26000.0 + 200.0
        x = (codes.to(torch.int32).to(torch.uint16) if dtype == "u16" else codes)[offset:].view(h, w)
        got = _launched("exposure_sample", dm.exposure_power_mean, x, pattern, cam, norm, factor)
        want = _plain(dm.exposure_power_mean, x, pattern, cam, norm, factor)
        assert abs(got / want - 1.0) <= 2e-6, ((h, w), offset, got, want)


@pytest.mark.parametrize("f,out_hw", [(4, (41, 115)), (8, (80, 96)), (3, None)])
def test_upsample_kernel(cuda, f, out_hw):
    x = torch.rand((3, 11, 29), device=cuda) * 3.0
    got = _launched("pyramid_up", pyramid.bilinear_upsample, x, f, out_hw)
    assert (got - _plain(pyramid.bilinear_upsample, x, f, out_hw)).abs().max().item() <= 2e-6


@pytest.mark.parametrize("bw", [False, True], ids=["colour", "bw"])
@pytest.mark.parametrize("sigma", [0.547, 2.3])
def test_grain_apply_kernel(cuda, bw, sigma):
    """3 and 13 correlation taps on a ragged frame; a negative row offset."""
    d = torch.rand((3, 70, 130), device=cuda) * 3.0
    prm = torch.tensor([0.02, 0.15, 0.3, 2.4, 0.1, 0.3], device=cuda)
    args = (d, (12345, (-7) & 0xFFFFFFFF), sigma, prm, bw)
    got = _launched("grain_apply_bw" if bw else "grain_apply", grain_ops.grain_apply, *args)
    assert (got - _plain(grain_ops.grain_apply, *args)).abs().max().item() <= 1e-5


def test_sep_rank_narrow_kernel(cuda):
    """K4: the K2 kernel, without grain, on a frame the TPU's K2 declines
    (at most 512 px wide); counted as ``sep_rank_narrow``."""
    rng = np.random.default_rng(1)
    u = rng.normal(size=(3, 2, 3)).astype(np.float32) * 0.3
    v = rng.normal(size=(3, 2, 3)).astype(np.float32) * 0.3
    d = torch.rand((3, 540, 360), device=cuda) * 3.0
    got = _launched("sep_rank_narrow", sep_rank.fused_sep_rank, d, u, v)
    assert (got - _plain(sep_rank.fused_sep_rank, d, u, v)).abs().max().item() <= 1e-5


def _k4_stacks():
    """K4's stacks: the preview's per-channel MTF (540 x 360 portrait at
    15 px/mm), the burn's Gaussian on its 1 x 49 x 74 small map, and 9
    shared ranks of 121 taps, above what the launch carries by value."""
    from raw2film_tpu_torch.ops import mtf as mtf_ops
    from raw2film_tpu_torch.ops.conv import gaussian_kernel1d
    from raw2film_tpu_torch import load_film_bundle

    _, cfg15 = load_film_bundle(h=540, w=360, device="cpu", grain=2, sharpness=True)
    u3, v3 = mtf_ops.mtf_taps(cfg15.mtf_key, cfg15.scale)
    k = gaussian_kernel1d(3.0, truncate=2.0)[None]
    rng = np.random.default_rng(9)
    big = (rng.normal(size=(2, 9, 121)) * 0.02).astype(np.float32)
    return {
        "preview-mtf": (u3, v3, (3, 540, 360)),
        "burn": (k, k, (1, 49, 74)),
        "above-capacity": (big[0], big[1], (3, 300, 200)),
    }


@pytest.mark.parametrize("name", ["preview-mtf", "burn", "above-capacity"])
def test_sep_rank_narrow_stacks(cuda, name):
    u, v, shape = _k4_stacks()[name]
    assert sep_rank.pack(u, v, *shape).by_value == (name != "above-capacity")
    d = torch.rand(shape, device=cuda) * 3.0
    for _ in range(2):  # the second launch finds the packed stack (and buffer) cached
        got = _launched("sep_rank_narrow", sep_rank.fused_sep_rank, d, u, v)
        assert (got - _plain(sep_rank.fused_sep_rank, d, u, v)).abs().max().item() <= 1e-5


@pytest.mark.parametrize("shape", [(3, 540, 360), (3, 300, 200)], ids=["by-value", "buffer"])
def test_sep_rank_stacks_of_one_shape_differ(cuda, shape):
    """Two stacks of the same shape launched in a row give their own
    results: the packed-stack cache is keyed by the taps' contents."""
    rng = np.random.default_rng(2)
    r, k = (2, 3) if shape[1] == 540 else (9, 121)
    u = (rng.normal(size=(2, r, k)) * 0.05).astype(np.float32)
    v = (rng.normal(size=(2, r, k)) * 0.05).astype(np.float32)
    d = torch.rand(shape, device=cuda) * 3.0
    a = sep_rank.fused_sep_rank(d, u[0], v[0])
    b = sep_rank.fused_sep_rank(d, u[1].copy(), v[0].copy())
    assert (a - _plain(sep_rank.fused_sep_rank, d, u[0], v[0])).abs().max().item() <= 1e-5
    assert (b - _plain(sep_rank.fused_sep_rank, d, u[1], v[0])).abs().max().item() <= 1e-5
    assert (a - b).abs().max().item() > 1e-3


@pytest.mark.parametrize(
    "shape,f,out_hw",
    [((3, 40, 70), 8, (301, 557)), ((3, 40, 70), 8, None), ((2, 45, 71), 3, (118, 209)),
     ((3, 37, 53), 4, None), ((1, 30, 41), 4, (117, 163))],
)
def test_upsample_kernel_runs(cuda, shape, f, out_hw):
    """K13 over several row and column blocks: a crop whose width is not a
    multiple of 4 (scalar stores), whole frames (16-byte stores), f = 3."""
    x = torch.rand(shape, device=cuda) * 3.0
    got = _launched("pyramid_up", pyramid.bilinear_upsample, x, f, out_hw)
    assert (got - _plain(pyramid.bilinear_upsample, x, f, out_hw)).abs().max().item() <= 2e-6


# (shape, taps, storage offset in floats): the shapes of the CPU model
# tests (tests/test_torch_sep_conv.py::MODEL_CASES): n in {1, 3, 9, 23, 31},
# n above the by-value cap, n > H and > W, H below a run, W % 4 != 0, C = 1,
# an unaligned view (the scalar path on W % 4 == 0)
CONV1D_CASES = [
    ((2, 90, 130), 1, 0), ((2, 90, 130), 9, 0), ((2, 90, 130), 31, 0), ((3, 21, 45), 3, 0),
    ((1, 37, 36), 9, 0), ((3, 40, 300), 23, 0), ((2, 29, 261), 23, 0), ((2, 5, 14), 31, 0),
    ((1, 3, 40), 9, 0), ((1, 1, 1), 3, 0), ((1, 9, 300), 301, 0), ((1, 7, 263), 259, 0),
    ((3, 70, 264), 23, 1),
]


@pytest.mark.parametrize("name", ["conv_w", "conv_h"])
@pytest.mark.parametrize("shape,n,offset", CONV1D_CASES)
def test_conv1d_kernel(cuda, name, shape, n, offset):
    """K5 / K6 on each path (16-byte and scalar, tail runs and tiles, 1 tap,
    above the by-value cap): bit-equal to the plain version (the same
    multiplies and adds in the same order)."""
    from raw2film_tpu_torch.ops import sep_conv

    t = np.random.default_rng(n).uniform(-0.2, 1.0, n).astype(np.float32)
    base = torch.rand(int(np.prod(shape)) + offset, device=cuda)
    x = base[offset:].view(shape)
    for _ in range(2):  # the second launch finds the packed taps (and buffer) cached
        got = _launched(name, getattr(sep_conv, name), x, t)
        assert torch.equal(got, _plain(getattr(sep_conv, name), x, t))


@pytest.mark.parametrize("bw", [False, True], ids=["colour", "bw"])
def test_grain_field_kernel(cuda, bw):
    """K7 on a ragged frame with 13 taps and a negative row offset."""
    args = ((12345, (-7) & 0xFFFFFFFF), (70, 130), 2.3)
    before = kb.launches["grain_field"]
    got = grain_ops.grain_field(*args, bw=bw, device=cuda)
    assert kb.launches["grain_field"] == before + 1
    with kb.plain_reference():
        ref = grain_ops.grain_field(*args, bw=bw, device=cuda)
    assert tuple(got.shape) == (3, 70, 130)
    assert (got - ref).abs().max().item() <= 1e-5


# a correlation sigma for each K7 / K8 path: white noise, the compiled 3 and
# 5 taps, the general path (13 taps)
_GRAIN_SIGMA = {1: 0.2, 3: 0.547, 5: 0.8, 13: 2.3}


@pytest.mark.parametrize(
    "shape,offset",
    [((3, 70, 130), 0), ((3, 70, 132), 0), ((3, 70, 132), 1), ((3, 5, 7), 0), ((3, 129, 260), 0), ((3, 65, 257), 0)],
    ids=["ragged-scalar", "ragged-vec", "unaligned", "tiny", "two-tiles-vec", "two-tiles-scalar"],
)
@pytest.mark.parametrize("n", [1, 3, 5, 13])
def test_grain_apply_paths(cuda, n, shape, offset):
    """K8 on every path (grain_path) and on both its 16-byte and its
    value-by-value stores, at ragged and unaligned shapes, within 1e-5."""
    sigma = _GRAIN_SIGMA[n]
    assert len(grain_ops.grain_corr_taps(sigma)) == n
    base = torch.rand(int(np.prod(shape)) + offset, generator=torch.Generator(device=cuda).manual_seed(n),
                      device=cuda) * 3.0
    d = base[offset:].view(shape)
    prm = torch.tensor([0.02, 0.15, 0.3, 2.4, 0.1, 0.3], device=cuda)
    args = (d, (12345, (-7) & 0xFFFFFFFF), sigma, prm, False)
    got = _launched("grain_apply", grain_ops.grain_apply, *args)
    assert (got - _plain(grain_ops.grain_apply, *args)).abs().max().item() <= 1e-5


@pytest.mark.parametrize("bw", [False, True], ids=["colour", "bw"])
@pytest.mark.parametrize("hw", [(70, 130), (70, 132), (5, 7), (129, 260)], ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("n", [1, 3, 5, 13])
def test_grain_field_paths(cuda, n, hw, bw):
    """K7 on every path and both store forms (W % 4), within 1e-5."""
    args = ((0xDEADBEEF, (-7) & 0xFFFFFFFF), hw, _GRAIN_SIGMA[n])
    before = kb.launches["grain_field"]
    got = grain_ops.grain_field(*args, bw=bw, device=cuda)
    assert kb.launches["grain_field"] == before + 1
    with kb.plain_reference():
        ref = grain_ops.grain_field(*args, bw=bw, device=cuda)
    assert (got - ref).abs().max().item() <= 1e-5
