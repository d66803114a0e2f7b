"""The host side of the flash-attention and InCRS kernels, without a card:
the flash wrapper's routing rule by type and its refusals, checked on
tensor metadata alone (CPU and meta tensors); the launch geometry the
wrappers compute and hand to their C launchers (query tiles, panels,
clusters, rings, shared memory); the build's hash of the headers a source
includes; and the per-row error the bf16 flash kernel is held to, against
a planted fault and against the JAX Pallas kernel in interpret mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp                                   # noqa: E402

from repro.kernels import flash_attention as jflash       # noqa: E402
from repro_torch.configs.paper_spmm import WORKLOADS      # noqa: E402
from repro_torch.core.incrs import InCRS                  # noqa: E402
from repro_torch.data import datasets                     # noqa: E402
from repro_torch.kernels import flash_attention as F      # noqa: E402
from repro_torch.kernels import incrs_spmm as K           # noqa: E402
from repro_torch.kernels import ops                       # noqa: E402

# An H100: 132 SMs, 64 resident warps, 2,048 threads, 32 blocks and
# 228 KB of shared memory (227 KB for one block, 1 KB reserved for each)
# on each.
SMS, SM_THREADS, SM_BLOCKS, SM_SMEM = 132, 2048, 32, 233_472
CTA_RESERVED = 1024


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _qkv(b, s, kv, g, hd, dtype=torch.bfloat16, sk=None):
    sk = s if sk is None else sk
    return (_meta(b, s, kv, g, hd, dtype=dtype),
            _meta(b, sk, kv, hd, dtype=dtype), _meta(b, sk, kv, hd,
                                                     dtype=dtype))


# ----------------------------------------------------------------------
# Flash attention: the route and what each kernel takes.
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "bf16_wgmma"),
                                         (torch.float32, "f32_fma")])
@pytest.mark.parametrize("hd", [16, 24, 64, 128, 200, 256])
def test_flash_routes_by_type(dtype, route, hd):
    launch = F.plan(*_qkv(2, 130, 2, 3, hd, dtype))
    assert launch.route == route
    assert launch.n_qt == -(-130 // F.Q_TILE[route])
    assert launch.smem == F.smem_bytes(hd, route) <= F.SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_flash_refuses_other_types(dtype):
    with pytest.raises(TypeError, match="f32 or bf16"):
        F.plan(*_qkv(1, 16, 1, 2, 64, dtype))


def test_flash_refuses_mixed_types_and_bad_shapes():
    q, k, v = _qkv(1, 16, 1, 2, 64)
    with pytest.raises(TypeError, match="one type"):
        F.plan(q, k.float(), v)
    for hd in (20, 264):
        with pytest.raises(ValueError, match="multiple of 8 up to 256"):
            F.plan(*_qkv(1, 16, 1, 2, hd))
    with pytest.raises(ValueError, match="match q"):
        F.plan(q, _meta(1, 16, 2, 64), _meta(1, 16, 2, 64))
    with pytest.raises(ValueError, match="contiguous in its head dim"):
        F.plan(q, k.transpose(1, 3).contiguous().transpose(1, 3), v)


def test_flash_bf16_needs_what_tma_reads():
    """TMA needs 16-byte strides and addresses; the f32 kernel reads any
    stride, so the same views pass there."""
    base = torch.zeros(1, 16, 1, 2, 68, dtype=torch.bfloat16)
    q = base[..., :64]                        # rows 68 elements apart
    k = torch.zeros(1, 16, 1, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8 elements"):
        F.plan(q, k, k)
    assert F.plan(q.float(), k.float(), k.float()).route == "f32_fma"
    flat = torch.zeros(16 * 64 + 4, dtype=torch.bfloat16)
    shifted = flat[4:].view(1, 16, 1, 64)     # 8 bytes off the allocation
    with pytest.raises(ValueError, match="16-byte aligned"):
        F.plan(q.contiguous(), shifted, k)
    # a dim of one element reads no stride: any is taken
    odd = torch.zeros(1, 16, 3, 64, dtype=torch.bfloat16)[:, :, 1:2]
    assert F.plan(q.contiguous(), odd, odd).route == "bf16_wgmma"


def test_flash_reads_a_fused_projection_through_strides():
    fused = torch.zeros(2, 90, 6, 64, dtype=torch.bfloat16)
    q = fused[:, :, :4].unflatten(2, (1, 4))
    launch = F.plan(q, fused[:, :, 4:5], fused[:, :, 5:6])
    assert launch.route == "bf16_wgmma"
    assert launch.strides[:4] == (90 * 384, 384, 64, 64)


def test_flash_shared_memory_per_route():
    # bf16: Q plus a two-stage K/V ring of bf16 tiles, 64 columns a region
    assert F.smem_bytes(128, "bf16_wgmma") == 6 * 128 * 128 + 1024 + 24
    assert 2 * F.smem_bytes(128, "bf16_wgmma") <= SM_SMEM   # 2 CTAs an SM
    assert F.smem_bytes(24, "bf16_wgmma") == F.smem_bytes(64, "bf16_wgmma")
    # f32: the transposed f32 tiles of the FMA kernel
    assert F.smem_bytes(128, "f32_fma") == 102_400
    assert F.smem_bytes(256, "f32_fma") == 204_800
    for hd in range(8, F.HD_MAX + 1, 8):
        for route in F.ROUTES.values():
            assert F.smem_bytes(hd, route) <= F.SMEM_LIMIT


def test_flash_plan_at_granite_wave():
    launch = F.plan(*_qkv(2, 8192, 1, 48, 128))
    assert launch.route == "bf16_wgmma"
    assert launch.n_qt == 64                     # 128-row query tiles
    assert launch.smem == 99_352                 # two CTAs an SM


def _attend(q, k, v, keep):
    """Attention of q (L, S, hd) over k, v (L, S, hd) with the boolean
    mask ``keep`` (S, S), in float64: the plain arithmetic with any mask."""
    s = torch.einsum("lqd,lkd->lqk", q, k) / q.shape[-1] ** 0.5
    s = s.masked_fill(~keep, float("-inf"))
    return torch.softmax(s, -1) @ v


def _lanes(hd, s=256, lanes=6, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(lanes, s, hd))).bfloat16()
            .double() for _ in range(3)]


@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("tile", ["first", "diagonal"])
def test_row_error_rejects_a_key_tile_dropped_from_the_long_rows(hd, tile):
    """A kernel that skipped one 64-key tile for the second half of the
    rows: the per-row error rejects it, and never reads less than the
    whole output's error relative to its max."""
    q, k, v = _lanes(hd)
    s = q.shape[1]
    causal = torch.ones(s, s, dtype=torch.bool).tril()
    want = _attend(q, k, v, causal)
    faulty = causal.clone()
    cols = slice(0, 64) if tile == "first" else slice(192, 256)
    faulty[s // 2:, cols] = False
    faulty[torch.arange(s), torch.arange(s)] = True   # no row left empty
    out = _attend(q, k, v, faulty).bfloat16()
    row = F.worst_row_error(out, want)
    whole = float((out.double() - want).abs().max() / want.abs().max())
    assert row > 1e-2 and row >= whole


@pytest.mark.parametrize("hd", [16, 64, 128])
def test_row_error_of_a_sound_bf16_output_is_its_rounding(hd):
    q, k, v = _lanes(hd, seed=1)
    s = q.shape[1]
    want = _attend(q, k, v, torch.ones(s, s, dtype=torch.bool).tril())
    assert F.worst_row_error(want, want) == 0.0
    assert 0.0 < F.worst_row_error(want.bfloat16(), want) <= 2.0 ** -8


def test_row_error_of_rows_with_no_keys():
    """A row of zeros (a query with no visible key) must come out zero."""
    want = torch.zeros(2, 3, 8)
    want[0, 0] = 1.0
    assert F.worst_row_error(want.clone(), want) == 0.0
    out = want.clone()
    out[1, 2, 5] = 1e-6
    assert F.worst_row_error(out, want) == float("inf")
    assert F.worst_row_error(torch.zeros(0, 8), torch.zeros(0, 8)) == 0.0


@pytest.mark.parametrize("window", [None, 40])
def test_row_error_against_the_pallas_kernel(window):
    """The JAX Pallas kernel in interpret mode on bf16-valued inputs, its
    output rounded to bf16, held to the port's plain version by the
    per-row error the bf16 kernel is held to."""
    hd, s = 64, 192
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(1, s, hd)).astype(np.float32) for _ in
               range(3))
    q, k, v = (torch.from_numpy(t).bfloat16().float().numpy()
               for t in (q, k, v))
    got = np.array(jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), g=1, window=window,
        interpret=True, bq=64, bk=64))
    want = F.plain(*(torch.from_numpy(t)[:, :, None, None] if i == 0 else
                     torch.from_numpy(t)[:, :, None] for i, t in
                     enumerate((q, k, v))), window=window)
    out = torch.from_numpy(got)[:, :, None, None].bfloat16()
    assert F.worst_row_error(out, want) <= 1e-2


# ----------------------------------------------------------------------
# InCRS reuse: the panel geometry and shared memory.
@pytest.mark.parametrize("n", [1, 8, 128, 129, 160, 256, 257, 384, 512, 640,
                               1200, 65536])
def test_reuse_geometry_covers_every_column(n):
    tpr, rows, panel = K.reuse_geometry(n)
    assert tpr in (32, 64, 128) and tpr * rows == K.REUSE_THREADS
    assert panel == K.REUSE_COLS_PER_THREAD * tpr <= 512
    n_panels = -(-n // panel)
    assert (n_panels - 1) * panel < n <= n_panels * panel
    if n <= 512:                 # one panel, and the narrowest that holds N
        assert n_panels == 1 and (panel == 128 or panel // 2 < n)


@pytest.mark.parametrize("smax", [1, 33, 256])
def test_reuse_shared_memory_no_longer_grows_with_n(smax):
    at_512 = K.reuse_smem_bytes(512, smax)
    assert K.reuse_smem_bytes(65536, smax) == at_512
    # two rows at N >= 512: raw rows of smax rounded up to 4, plus 4,
    # compacted rows of smax rounded up to 2, 16 bytes of counts
    assert at_512 == K.stripe_bytes(2, smax) == \
        2 * 16 * (-(-smax // 4) * 4 + 4 + -(-smax // 2) * 2 + 1)
    # wide N is taken: (threads per row, shared memory) for the launcher
    assert K.launch_geometry("incrs_spmm_reuse", 65536, smax, 256) == \
        (128, at_512)
    with pytest.raises(ValueError, match="shared memory"):
        K.launch_geometry("incrs_spmm_reuse", 128, 1000, 256)


def test_launch_geometry_of_the_other_orders():
    # expand: 8 warps, one row each, each with its own stripes
    expand = K.launch_geometry("incrs_spmm", 512, 33, 256)
    assert expand == (8, 8 * K.stripe_bytes(1, 33)) == (8, 9600)
    # pipelined at incrs-docword: 24 rows x two 64-column blocks a CTA,
    # clusters of 2, a ring of 3 (256, 64) f32 stages and their barriers
    pipe = K.launch_geometry("incrs_spmm_pipelined", 512, 33, 256, m=768)
    assert pipe == K.PipeGeometry(cols_per_lane=2, warps=24, cluster=2,
                                  stages=3, box_rows=128, boxes=1,
                                  row_tiles=32, col_tiles=4, smem=225584)
    assert pipe.smem == 128 + 3 * (256 * 64 * 4 + 16) + \
        K.stripe_bytes(24, 33)
    with pytest.raises(ValueError, match="shared memory"):
        K.launch_geometry("incrs_spmm_pipelined", 512, 33, 1024, m=768)
    with pytest.raises(ValueError, match="shared memory"):
        K.launch_geometry("incrs_spmm", 512, 10_000, 256)


def _docword_stripes():
    wl = WORKLOADS["incrs-docword"]
    inc = InCRS.from_crs(datasets.synthesize(wl.dataset, seed=0),
                         wl.section, wl.block)
    mp, _, smax = ops.prepare_incrs(inc, device="cpu").idx.shape
    assert (mp, smax) == (768, 33)
    return mp, smax


def _resident(threads, smem, blocks):
    """CTAs of ``threads`` threads and ``smem`` bytes resident on the card
    at once, of ``blocks`` launched."""
    per_sm = min(SM_THREADS // threads, SM_BLOCKS,
                 SM_SMEM // (smem + CTA_RESERVED))
    return min(blocks, per_sm * SMS)


def test_pipelined_fills_the_card_at_docword():
    """incrs-docword at N = 512: the whole grid is resident at once (one
    CTA an SM: the ring of 64-column blocks takes most of its shared
    memory) on all but 4 of the 132 SMs, 24 consumer warps each, and
    every cluster fits."""
    mp, smax = _docword_stripes()
    g = K.launch_geometry("incrs_spmm_pipelined", 512, smax, 256, m=mp)
    ctas = g.row_tiles * g.col_tiles
    assert g.row_tiles % g.cluster == 0 and g.row_tiles * g.warps >= mp
    assert _resident((g.warps + 1) * 32, g.smem, ctas) == ctas
    assert SMS - 4 <= ctas <= SMS and g.warps >= 16
    # a 23-row tile would need 136 CTAs: a second wave
    fewer = K.pipelined_geometry(mp, 512, smax, 256, warps=g.warps - 1)
    assert fewer.row_tiles * fewer.col_tiles > SMS


def test_expand_fills_the_card_at_docword():
    """incrs-docword at N = 512: at least 16 warps resident on each SM."""
    mp, smax = _docword_stripes()
    rows, smem = K.launch_geometry("incrs_spmm", 512, smax, 256)
    ctas = -(-mp // rows) * -(-512 // K.EXPAND_COLS)
    assert _resident(rows * 32, smem, ctas) * rows / SMS >= 16


_TABLE2 = ("incrs-docword", "incrs-amazon", "incrs-belcastro",
           "incrs-norris", "incrs-mks")


@pytest.mark.parametrize("name", _TABLE2)
def test_geometry_of_every_order_on_table2(name):
    """What each wrapper hands its launcher on the Table II operands:
    shared memory within the card's, an instance the kernel has, a cluster
    that divides the padded row tiles, a ring stage that covers the
    section in TMA boxes of at most 256 rows."""
    wl = WORKLOADS[name]
    inc = InCRS.from_crs(datasets.synthesize(wl.dataset, seed=0),
                         wl.section, wl.block)
    prep = ops.prepare_incrs(inc, device="cpu")
    mp, _, smax = prep.idx.shape
    for n in (128, 512, 640):
        rows, smem = K.launch_geometry("incrs_spmm", n, smax, prep.section)
        assert rows in K.EXPAND_ROWS and smem <= K.SMEM_LIMIT
        tpr, smem = K.launch_geometry("incrs_spmm_reuse", n, smax,
                                      prep.section)
        assert tpr in K.REUSE_TPR and smem <= K.SMEM_LIMIT
        g = K.launch_geometry("incrs_spmm_pipelined", n, smax, prep.section,
                              m=mp)
        assert g.cols_per_lane in K.PIPE_CPL
        assert 1 <= g.warps <= K.PIPE_MAX_WARPS and g.smem <= K.SMEM_LIMIT
        assert g.row_tiles % g.cluster == 0 and g.row_tiles * g.warps >= mp
        assert g.col_tiles * K.PIPE_BLOCKS * K.PIPE_COLS * \
            g.cols_per_lane >= n
        assert g.box_rows <= K.TMA_BOX_MAX
        assert g.cluster * g.boxes * g.box_rows >= prep.section


@pytest.mark.parametrize("section", [1, 2, 3, 100, 256, 300, 512, 600])
def test_pipelined_ring_covers_any_section(section):
    """Sections over 256 rows take several boxes per CTA; the cluster
    always divides the section, so no box starts past it."""
    g = K.pipelined_geometry(40, 128, 8, section)
    assert section % g.cluster == 0
    assert g.box_rows <= K.TMA_BOX_MAX
    assert g.cluster * g.boxes * g.box_rows >= section
    assert (g.cluster - 1) * g.boxes * g.box_rows < section


def test_library_path_follows_the_headers_a_source_includes(tmp_path,
                                                           monkeypatch):
    """A header edit rebuilds every source that includes it, and only
    those."""
    from repro_torch.kernels import _build
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// other\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.lib_path("k")
    (tmp_path / "other.cuh").write_text("// other, edited\n")
    assert _build.lib_path("k") == before
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert _build.lib_path("k") != before
    monkeypatch.undo()
    for name in ("incrs_spmm", "flash_attention"):
        assert _build._headers(_build.CSRC / f"{name}.cu") == \
            [_build.CSRC / "hopper.cuh"]
        assert "-lcuda" in _build._flags(name)


def test_reuse_fills_the_card_at_docword():
    """incrs-docword at N = 512: at least 16 warps resident on each SM
    (the L2 latency of the B gathers needs them)."""
    mp, smax = _docword_stripes()
    _, rows, panel = K.reuse_geometry(512)
    blocks = -(-mp // rows) * -(-512 // panel)
    smem = K.reuse_smem_bytes(512, smax)
    per_sm = min(SM_THREADS // K.REUSE_THREADS, SM_BLOCKS, SM_SMEM // smem)
    resident = min(blocks, per_sm * SMS)
    warps_per_sm = resident * K.REUSE_THREADS // 32 / SMS
    assert warps_per_sm >= 16
