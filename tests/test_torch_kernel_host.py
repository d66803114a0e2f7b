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
from _threads import one_thread                          # noqa: F401

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


# ----------------------------------------------------------------------
# Dense and BSR: the instance each wrapper launches, its K splits and its
# shared memory (``gemm_geometry``), and the C dispatch it names.
from repro_torch.kernels import _gemm                      # noqa: E402
from repro_torch.kernels import bsr_spmm as KB             # noqa: E402
from repro_torch.kernels import dense_mm as KD             # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16
# (M, K, N): granite-34b's W_up^T at N = 512, docword's operand, an
# engine wave of 128 columns, and ragged edges.
DENSE_SHAPES = [(24576, 6144, 512), (700, 12000, 512), (700, 12000, 128),
                (1, 1, 1), (127, 129, 300), (300, 7, 129), (33, 1000, 5),
                (127, 136, 264), (256, 512, 384)]


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", DENSE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_dense_geometry_picks_the_instance_by_type_and_shape(dtype, shape):
    m, k, n = shape
    g = KD.gemm_geometry(m, n, k, dtype)
    vec = 4 if dtype == F32 else 8
    fast = k % vec == 0 and n % vec == 0
    assert g.instance == (_gemm.FAST if fast else _gemm.GENERAL)[dtype]
    assert g.instance in KD.INSTANCES and g.smem <= _gemm.SMEM_LIMIT
    assert g.row_tiles * g.tile_m >= m and g.col_tiles * g.tile_n >= n
    assert g.tiles * g.splits <= _gemm.GRID_X_MAX * _gemm.GRID_Y_MAX
    if fast:
        steps = -(-k // g.tile_k)
        assert g.splits * _gemm.MIN_SPLIT_STEPS <= max(steps,
                                                       _gemm.MIN_SPLIT_STEPS)
    else:
        assert g.splits == 1
    # an operand off 16 bytes takes the general kernel of its type
    assert KD.gemm_geometry(m, n, k, dtype, aligned=False).instance == \
        _gemm.GENERAL[dtype]


@pytest.mark.parametrize("dtype,splits,ctas", [(F32, 11, 264),
                                               (BF16, 5, 120)],
                         ids=["f32", "bf16"])
def test_split_k_fills_the_card_at_docword(dtype, splits, ctas):
    """docword's dense operand (700 x 12000) at N = 512 has 24 tiles of
    128 x 128; split-K fills the card's resident slots (two f32 CTAs an
    SM, one bf16 CTA) in one wave. granite's 768 tiles need no split, and
    its bf16 tiles widen to 128 x 256 (384 of them still fill the card)."""
    g = KD.gemm_geometry(700, 512, 12000, dtype)
    slots = SMS * _gemm.CTAS_PER_SM[g.instance]
    assert (g.tiles, g.splits, g.tile_n) == (24, splits, 128)
    assert g.tiles * g.splits == ctas <= slots < g.tiles * (g.splits + 1)
    wide = KD.gemm_geometry(24576, 512, 6144, dtype)
    assert wide.splits == 1
    assert (wide.tile_n, wide.tiles) == ((256, 384) if dtype == BF16
                                         else (128, 768))
    assert KB.gemm_geometry(192, 128, 128, 512, dtype,
                            nnz=2304).tile_n == wide.tile_n
    # an engine wave of 128 columns keeps the 128-wide tile
    assert KD.gemm_geometry(24576, 128, 6144, dtype).tile_n == 128


# (n_block_rows, bm, bk, N, nnz): granite's W_up^T as BSR (block 128,
# density 0.25), the Table II blocks (50, 10, 60), 64 x 64, 32 x 64, bm
# over 128, and a short operand that split-K fills.
BSR_SHAPES = [(192, 128, 128, 512, 2304), (14, 50, 50, 512, 1000),
              (120, 10, 10, 512, 9000), (4, 60, 60, 1, 9),
              (10, 64, 64, 512, 48), (8, 32, 64, 320, 20),
              (2, 200, 100, 33, 4), (8, 128, 128, 128, 77),
              (6, 64, 16, 96, 30)]


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", BSR_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_bsr_geometry_picks_the_instance_by_type_and_shape(dtype, shape):
    nbr, bm, bk, n, nnz = shape
    g = KB.gemm_geometry(nbr, bm, bk, n, dtype, nnz=nnz)
    tk = 16 if dtype == F32 else 64
    fast = bm % 64 == 0 and bk % tk == 0 and n % (4 if dtype == F32
                                                  else 8) == 0
    assert g.instance == (_gemm.FAST if fast else _gemm.GENERAL)[dtype]
    assert g.smem <= _gemm.SMEM_LIMIT
    if fast:
        assert g.row_tiles == nbr * -(-bm // 128) and g.layout == ()
        steps = nnz * (bk // tk) / nbr
        slots = SMS * _gemm.CTAS_PER_SM[g.instance]
        assert g.splits == 1 or (g.tiles * g.splits <= slots and
                                 g.splits * _gemm.MIN_SPLIT_STEPS <= steps)
    else:
        tm, row_threads, col_threads, rows_alloc, bn, n_sub = g.layout
        assert tm in KB.GENERAL_TM and g.splits == 1
        assert rows_alloc == row_threads * tm >= min(bm, 128)
        assert row_threads * col_threads <= 256 and bn == 4 * col_threads
        assert (g.row_tiles, g.col_tiles) == (nbr * n_sub, -(-n // bn))
        assert g.smem == 16 * (rows_alloc + 1 + bn) * 4
    assert KB.gemm_geometry(nbr, bm, bk, n, dtype, nnz=nnz,
                            aligned=False).instance == _gemm.GENERAL[dtype]


def test_bsr_grid_limit_follows_the_column_tile():
    """The general instance tiles N by its own column tile (not by 64):
    N fits while its column tiles fit the grid's y."""
    for bm in (10, 50, 60, 200):
        bn = KB.general_layout(bm)[4]
        n_max = _gemm.GRID_Y_MAX * bn
        assert KB.gemm_geometry(4, bm, bm, n_max, F32,
                                nnz=4).col_tiles == _gemm.GRID_Y_MAX
        with pytest.raises(ValueError, match="column tiles"):
            KB.gemm_geometry(4, bm, bm, n_max + 1, F32, nnz=4)


@pytest.mark.parametrize("instance", ["f32_fma", "bf16_wgmma"])
def test_fast_shared_memory_and_stages(instance):
    lo, hi = _gemm.STAGES_RANGE[instance]
    for stages in range(lo, hi + 1):
        assert _gemm.smem_bytes(instance, stages, 256) <= _gemm.SMEM_LIMIT
    assert _gemm.smem_bytes("f32_fma", 4) == 49_152
    assert _gemm.smem_bytes("bf16_wgmma", 4) == 132_160
    assert _gemm.smem_bytes("bf16_wgmma", 4, 256) == 197_696
    with pytest.raises(ValueError, match="stages"):
        _gemm.fast_geometry(instance, 1, 1, 10, stages=hi + 1)
    with pytest.raises(ValueError, match="stages"):
        _gemm.fast_geometry(instance, 1, 1, 10, stages=1)


@pytest.mark.parametrize("source", ["dense_mm", "bsr_spmm"])
def test_every_instance_is_in_the_dispatch(source):
    """Each instance the host function can return has its id in the
    source's enum and a case in its launcher's switch; both sources
    include the shared core and link libcuda for its tensor maps."""
    from repro_torch.kernels import _build
    import re
    text = (_build.CSRC / f"{source}.cu").read_text()
    enum = dict((name, int(i)) for name, i in re.findall(
        r"\b([A-Z0-9_]+) = (\d+)", text.split("enum Instance")[1]
        .split("};")[0]))
    assert enum == {name.upper(): i for i, name in enumerate(_gemm.INSTANCES)}
    for name in _gemm.INSTANCES:
        assert f"case {name.upper()}:" in text
    if source == "bsr_spmm":
        for tm in KB.GENERAL_TM:
            assert f"case {tm}:" in text and f"bsr_kernel<{tm}, T>" in text
    assert _build._headers(_build.CSRC / f"{source}.cu") == \
        [_build.CSRC / "gemm_sm90.cuh", _build.CSRC / "hopper.cuh"]
    assert "-lcuda" in _build._flags(source)


@pytest.mark.parametrize("a,b,want", [
    (F32, F32, F32), (BF16, BF16, BF16), (BF16, F32, F32),
    (F32, BF16, F32), (torch.float16, torch.float16, None),
    (torch.float64, F32, None), (BF16, torch.float16, F32)])
def test_operands_promote_as_the_plain_versions_do(a, b, want):
    if want is None:
        with pytest.raises(TypeError, match="f32 or bf16"):
            _gemm.compute_dtype(a, b, "dense_mm")
    else:
        assert _gemm.compute_dtype(a, b, "dense_mm") == want


# ----------------------------------------------------------------------
# Index matching and condense: ``match_geometry``, the one source of their
# launch (instance, rows per warp, ring depth, entry bytes a stage, shared
# memory, persistent grid, condense's items a CTA), on the Table IV
# operands as ``prep_rounds`` pads them, and the C dispatch it names.
from functools import lru_cache                           # noqa: E402

from repro_torch.kernels import index_match_spmm as IM    # noqa: E402

TABLE4 = ("mesh-amazon4", "mesh-docword4", "mesh-mks4", "mesh-norris4",
          "mesh-arenas", "mesh-bates", "mesh-gleich", "mesh-sch")
MATCH_KERNELS = ("index_match_spmm", "spgemm_condense")


@lru_cache(maxsize=None)
def _table4_prep(name, rounds):
    """(M padded to 128, n_rounds, rmax) of ``prep_rounds`` on the operand,
    from its round groups (no prep)."""
    crs = datasets.synthesize(WORKLOADS[name].dataset, seed=0)
    counts = ops.round_groups(crs, rounds)[1]
    return (-(-crs.shape[0] // 128) * 128, counts.shape[1],
            max(1, int(counts.max(initial=0))))


def _table4_cases():
    return [(n, 128) for n in TABLE4] + [("mesh-docword4", 32)]


def test_match_instances_are_the_dispatch():
    """INSTANCES are the ids of index_match.cu's enum Instance, and the C
    side's ring constants are the ones the geometry computes with."""
    from repro_torch.kernels import _build
    import re
    text = (_build.CSRC / "index_match.cu").read_text()
    enum = dict((name, int(i)) for name, i in re.findall(
        r"\b([A-Z]+) = (\d+)", text.split("enum Instance")[1]
        .split("};")[0]))
    assert enum == {name.upper(): i for i, name in enumerate(IM.INSTANCES)}
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert int(const["kRingWarps"]) == IM.RING_WARPS
    assert (int(const["kRingWarps"]) + 2) * 32 == IM.RING_THREADS
    assert int(const["kRingCols"]) == IM.RING_COLS
    assert int(const["kMaxRowsPerWarp"]) == IM.RING_MAX_ROWS_PER_WARP
    assert 1 << int(const["kRowShift"]) == IM.RING_MAX_ROUNDS
    assert _build._headers(_build.CSRC / "index_match.cu") == \
        [_build.CSRC / "hopper.cuh"]


@pytest.mark.parametrize("kernel", MATCH_KERNELS)
@pytest.mark.parametrize("case", _table4_cases(),
                         ids=lambda c: f"{c[0]}-R{c[1]}")
def test_match_geometry_on_table4(case, kernel):
    """The ring takes every Table IV operand: its shared memory fits one
    block, and its persistent grid is one wave of one CTA an SM that walks
    every tile (fused) or every (tile, round) item (condense)."""
    name, rounds = case
    m, n_rounds, rmax = _table4_prep(name, rounds)
    g = IM.match_geometry(m, m, n_rounds, rmax, rmax, rounds, kernel)
    assert g.instance == "ring" and g.instance in IM.INSTANCES
    assert g.smem <= 232_448 and g.stripes == (kernel == MATCH_KERNELS[1])
    assert g.smem == IM.ring_smem(rounds, g.tile_m, g.stages, g.cap)
    assert g.cap >= IM.RING_MIN_CAP and g.cap % 16 == 0
    assert g.tile_m == IM.RING_WARPS * g.rows_per_warp
    assert g.row_tiles * g.tile_m >= m and g.col_tiles * 128 >= m
    assert g.grid <= SMS * IM.CTAS_PER_SM["ring"]
    if g.stripes:
        items = g.tiles * n_rounds
        assert g.grid * g.chunk >= items > (g.grid - 1) * g.chunk
    else:
        assert g.grid == min(g.tiles, SMS)
    # the general instance is at hand for the same operand
    old = IM.match_geometry(m, m, n_rounds, rmax, rmax, rounds, kernel,
                            instance="general")
    assert old.instance == "general" and old.smem <= 232_448


def test_match_geometry_fills_the_card_at_docword():
    """mesh-docword4 at R = 128, (1536, 94, 45): index matching takes 10
    rows a warp, tiles of 140 x 128, 11 x 12 = 132 of them, one a CTA and
    an SM (today's 64 x 128 tiles needed 288 CTAs, a second wave at two
    an SM); condense takes the tallest tile and spreads the 7,896 (tile,
    round) items 60 a CTA over 132 CTAs."""
    m, n_rounds, rmax = _table4_prep("mesh-docword4", 128)
    assert (m, n_rounds, rmax) == (1536, 94, 45)
    f = IM.match_geometry(m, m, n_rounds, rmax, rmax, 128)
    assert (f.instance, f.rows_per_warp, f.tile_m) == ("ring", 10, 140)
    assert (f.row_tiles, f.col_tiles, f.grid) == (11, 12, 132)
    g = IM.match_geometry(m, m, n_rounds, rmax, rmax, 128,
                          "spgemm_condense")
    assert (g.tile_m, g.tiles, g.grid, g.chunk) == (224, 84, 132, 60)
    old = IM.match_geometry(m, m, n_rounds, rmax, rmax, 128,
                            instance="general")
    assert old.grid == 288 > SMS * IM.CTAS_PER_SM["general"]


@pytest.mark.parametrize("rounds", [32, 64, 128, 160, 192])
@pytest.mark.parametrize("stages", [None, 4, 8, 12])
def test_ring_shared_memory_fits(rounds, stages):
    """Two windows of R x 128 f32 and the ring fit one block at every rows
    per warp; the entry bytes a stage shrink as R grows."""
    for rpw in range(1, IM.RING_MAX_ROWS_PER_WARP + 1):
        try:
            g = IM.match_geometry(4096, 4096, 50, 40, 40, rounds,
                                  instance="ring", rows_per_warp=rpw,
                                  stages=stages)
        except ValueError:
            assert stages is not None and \
                IM.ring_cap(rounds, 14 * rpw, stages) < IM.RING_MIN_CAP
            continue
        assert g.smem <= 232_448
        assert g.stages == (stages or IM.RING_STAGES)
        assert g.cap == IM.ring_cap(rounds, g.tile_m, g.stages)


def test_general_instance_where_the_ring_does_not_fit():
    """R = 256: the ring's two windows alone are 256 KB; B rows past
    2**23 do not fit an entry's row bits: both take the general kernel,
    and asking for the ring there raises. The general kernel's own limits
    (a window of R | 1 rows of 128 f32 within 227 KB; M within its grid)
    still raise."""
    g = IM.match_geometry(2048, 2048, 40, 30, 30, 256)
    assert g.instance == "general" and g.smem == 128 * 257 * 4
    with pytest.raises(ValueError, match="ring instance"):
        IM.match_geometry(2048, 2048, 40, 30, 30, 256, instance="ring")
    big = IM.match_geometry(256, 2 ** 23, 40, 1, 1, 128)
    assert big.instance == "general"
    with pytest.raises(ValueError, match="grid"):
        IM.match_geometry(2 ** 23, 256, 40, 1, 1, 128)
    with pytest.raises(ValueError, match="shared memory"):
        IM.match_geometry(2048, 2048, 40, 30, 30, 1024)
    with pytest.raises(ValueError, match="stages"):
        IM.match_geometry(2048, 2048, 40, 30, 30, 128, stages=3)
    with pytest.raises(ValueError, match="rows_per_warp"):
        IM.match_geometry(2048, 2048, 40, 30, 30, 128, rows_per_warp=17)


# The two stream kernels' launches: the gather's tile instance
# (gather_geometry) on the Table IV operands' section stripes, and merge's
# ring (merge_geometry) on their (n_rounds, M, N) stripes at R = 128 and
# 32, and the C dispatch each names.
from repro_torch.kernels import incrs_gather as G         # noqa: E402
from repro_torch.spgemm import kernels as SK              # noqa: E402


def _dispatch(source):
    """``{name: id}`` of ``enum Instance`` and the ``constexpr int`` values
    (plain numbers) of ``csrc/<source>.cu``."""
    from repro_torch.kernels import _build
    import re
    text = (_build.CSRC / f"{source}.cu").read_text()
    enum = dict((name.lower(), int(i)) for name, i in re.findall(
        r"\b([A-Z]+) = (\d+)", text.split("enum Instance")[1]
        .split("};")[0]))
    const = {k: int(v) for k, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    return enum, const


def test_gather_and_merge_instances_are_the_dispatch():
    """INSTANCES are the ids of the .cu files' enum Instance, and the C
    side's constants are the ones the geometries compute with."""
    enum, const = _dispatch("incrs_gather")
    assert enum == {name: i for i, name in enumerate(G.INSTANCES)}
    assert const["kTileWarps"] * 32 == G.TILE_THREADS
    assert const["kTileWarps"] == G.TILE_WARPS
    assert const["kTileMinCtas"] == G.TILE_MAX_CTAS
    assert const["kBatchChunks"] * 32 == G.TILE_BATCH
    assert const["kThreads"] == G.GENERAL_THREADS
    enum, const = _dispatch("index_match")
    assert enum == {name: i for i, name in enumerate(SK.MERGE_INSTANCES)}
    assert const["kMergeWarps"] == SK.MERGE_WARPS
    assert const["kMergeThreads"] == SK.MERGE_GENERAL_THREADS
    assert const["kMergeVec"] * 4 * SK.MERGE_WARPS * 32 == \
        SK.MERGE_MAX_CHUNK


@lru_cache(maxsize=None)
def _table4_stripes(name):
    """(M padded to 8, n_sections, smax) of the gather's section stripes of
    the operand (``ops.prepare_incrs``, section 256), as the densify
    engine preps it."""
    crs = datasets.synthesize(WORKLOADS[name].dataset, seed=0)
    prep = ops.prepare_incrs(InCRS.from_crs(crs), pad_rows_to=8,
                             device="cpu")
    return tuple(prep.idx.shape) + (prep.section,)


def _gather_cover(g, m, n_sec):
    """How often each (row, section) of the output is written: warp w of
    the grid takes items w, w + warps, ..., item i is row i // groups,
    sections from (i % groups) * g.sections, up to g.sections of them."""
    warps = g.grid * G.TILE_WARPS
    groups = -(-n_sec // g.sections)
    assert g.items == m * groups
    count = np.zeros((m, n_sec), np.int64)
    for w in range(min(warps, g.items)):
        items = np.arange(w, g.items, warps)
        row, grp = items // groups, items % groups
        for d in range(g.sections):
            sec = grp * g.sections + d
            keep = sec < n_sec
            np.add.at(count, (row[keep], sec[keep]), 1)
    return count


@pytest.mark.parametrize("name", TABLE4)
def test_gather_geometry_on_table4(name):
    """The tile instance takes every Table IV operand's stripes: a CTA's
    8 tiles fit its shared memory, the persistent grid is one wave of the
    CTAs an SM holds, and every (row, section) of the output is written by
    exactly one warp's item."""
    m, n_sec, smax, section = _table4_stripes(name)
    g = G.gather_geometry(m, n_sec, smax, section)
    enum, _ = _dispatch("incrs_gather")
    assert g.instance == "tile" and g.instance in enum
    assert g.smem <= 232_448
    assert g.smem == G.TILE_WARPS * g.tile * 4
    assert g.tile >= g.sections * section and g.tile % 4 == 0
    assert g.sections * smax <= G.TILE_BATCH or g.sections == 1
    per_sm = min(SM_THREADS // g.threads, SM_BLOCKS,
                 SM_SMEM // (g.smem + CTA_RESERVED), G.TILE_MAX_CTAS)
    assert g.ctas_per_sm == per_sm >= 1
    assert g.grid <= SMS * g.ctas_per_sm
    assert _resident(g.threads, g.smem, g.grid) == g.grid
    assert (_gather_cover(g, m, n_sec) == 1).all()
    old = G.gather_geometry(m, n_sec, smax, section, instance="general")
    assert old.instance == "general" and old.grid == m


def test_gather_geometry_at_docword():
    """mesh-docword4's stripes (1504, 47, 77): 2 sections an item (154
    slots, one batch; 2 KB tiles), 24 items a row, 36,096 items over 528
    CTAs of 8 warps, 4 CTAs an SM: one wave."""
    m, n_sec, smax, section = _table4_stripes("mesh-docword4")
    assert (m, n_sec, smax, section) == (1504, 47, 77, 256)
    g = G.gather_geometry(m, n_sec, smax, section)
    assert (g.sections, g.tile, g.smem) == (2, 512, 16_384)
    assert (g.items, g.grid, g.ctas_per_sm) == (36_096, 528, 4)


def test_gather_geometry_overrides_and_the_general_instance():
    """``sections`` overrides the rule; a section whose 8 tiles do not fit
    one SM, and stripes with no slot, take the general instance, where
    asking for the tile instance raises."""
    g = G.gather_geometry(64, 10, 7, 256, sections=1)
    assert (g.instance, g.sections, g.smem) == ("tile", 1, 8 * 1024)
    assert (_gather_cover(g, 64, 10) == 1).all()
    g = G.gather_geometry(64, 10, 7, 37, sections=3)
    assert g.tile == 112 and (_gather_cover(g, 64, 10) == 1).all()
    with pytest.raises(ValueError, match="sections"):
        G.gather_geometry(64, 10, 7, 256, sections=11)
    with pytest.raises(ValueError, match="shared memory"):
        G.gather_geometry(64, 10, 7, 4096, sections=10)
    wide = G.gather_geometry(64, 3, 7, 8192)
    assert wide.instance == "general" and wide.grid == 64
    with pytest.raises(ValueError, match="tile instance"):
        G.gather_geometry(64, 3, 7, 8192, instance="tile")
    assert G.gather_geometry(64, 3, 0, 256).instance == "general"
    with pytest.raises(ValueError, match="range"):
        G.gather_geometry(64, 2 ** 16, 2 ** 15, 256)


def _merge_cases():
    return [(n, r) for n in TABLE4 for r in (128, 32)]


@pytest.mark.parametrize("case", _merge_cases(),
                         ids=lambda c: f"{c[0]}-R{c[1]}")
def test_merge_geometry_on_table4(case):
    """The ring takes every Table IV operand's stripes at R = 128 and 32:
    its stages fit one block, its grid is one wave of two CTAs an SM, its
    chunks sit on 4 KB, the items cover the plane exactly once, and the
    CTAs' shares differ by at most one item."""
    name, rounds = case
    m, n_rounds, _ = _table4_prep(name, rounds)
    plane = m * m
    g = SK.merge_geometry(plane, n_rounds)
    enum, _ = _dispatch("index_match")
    assert g.instance == "ring" and g.instance in enum
    assert g.smem <= 232_448 and g.smem == SK.merge_smem(g.chunk, g.stages)
    assert g.chunk in SK.MERGE_CHUNKS and g.chunk % 1024 == 0
    assert g.items * g.chunk >= plane > (g.items - 1) * g.chunk
    assert g.grid <= SMS * SK.MERGE_CTAS_PER_SM
    assert _resident(g.threads, g.smem, g.grid) == g.grid
    share = np.bincount(np.arange(g.items) % g.grid, minlength=g.grid)
    assert share.min() >= 1 and share.max() - share.min() <= 1
    starts = np.arange(g.items) * g.chunk
    ends = np.minimum(starts + g.chunk, plane)
    assert starts[0] == 0 and ends[-1] == plane
    assert (starts[1:] == ends[:-1]).all()
    old = SK.merge_geometry(plane, n_rounds, instance="general")
    assert old.instance == "general"
    assert old.grid * SK.MERGE_GENERAL_THREADS * 4 >= plane or \
        old.grid == SK.MERGE_GENERAL_MAX_GRID


def test_merge_geometry_at_docword():
    """mesh-docword4 at R = 128: the 1536 x 1536 plane in 768 chunks of
    3,072 floats, at most 3 a CTA on 264 CTAs (4,096 would give 3 of
    4,096, 6,144 2 of 6,144), 4 stages (48 KB)."""
    g = SK.merge_geometry(1536 * 1536, 94)
    assert (g.chunk, g.items, g.grid, g.stages) == (3072, 768, 264, 4)
    assert g.smem == 4 * (3072 * 4 + 16)


def test_merge_geometry_overrides_and_the_general_instance():
    """A plane that is not a multiple of 4, stripes off 16 bytes, and no
    round take the general instance, where asking for the ring raises;
    chunk and stages override the rule within their limits."""
    for plane, rounds, aligned in ((4098, 3, True), (4096, 3, False),
                                   (4096, 0, True)):
        g = SK.merge_geometry(plane, rounds, aligned)
        assert g.instance == "general"
        with pytest.raises(ValueError, match="ring instance"):
            SK.merge_geometry(plane, rounds, aligned, instance="ring")
    g = SK.merge_geometry(4096 * 32, 7, chunk=2048, stages=8)
    assert (g.chunk, g.stages, g.items, g.grid) == (2048, 8, 64, 64)
    with pytest.raises(ValueError, match="chunk"):
        SK.merge_geometry(4096, 3, chunk=6)
    with pytest.raises(ValueError, match="chunk"):
        SK.merge_geometry(4096, 3, chunk=SK.MERGE_MAX_CHUNK + 4)
    with pytest.raises(ValueError, match="stages"):
        SK.merge_geometry(4096, 3, stages=1)
    with pytest.raises(ValueError, match="shared memory"):
        SK.merge_geometry(2 ** 20, 3, chunk=SK.MERGE_MAX_CHUNK, stages=12)
