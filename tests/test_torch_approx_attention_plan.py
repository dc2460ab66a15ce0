"""The approximate attention kernels' masked-block rule and launch plan, on the CPU.

``csrc/approx_attention.cu`` skips a (query tile, key block) pair when no
row of the tile may attend a slot of the block and every row of the tile
has an allowed slot somewhere.  That is exact only because every table
the kernels accept has a zero first row and column (``LUT[0, .] =
LUT[., 0] = 0``, ``U[0] = V[0] = 0``): a masked block then adds p_int = 0
times a zero row.  These tests check the tables, then run the plain
version's loop with the pairs that ``approx_tile_plan`` skips left out
and hold its (o, lse) bit-identical to ``approx_attention_plain``'s; then the kernels' shared memory and launch
plans, which the card tests hold equal to the built library's.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import approx_attention as jax_approx
from repro_torch.engine import artifacts
from repro_torch.kernels import approx_attention as aa
from repro_torch.kernels.build import SMEM_PER_BLOCK
from repro_torch.kernels.flash_attention import HEAD_DIMS

CPU = torch.device("cpu")
SMS = 132  # the H100's SMs, for the hand-worked plans


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _skipping(q, k, v, q_pos, k_pos, *, rows: int, **kw):
    """``approx_attention_plain`` with the (tile, block) pairs that
    ``approx_tile_plan`` skips for query tiles of ``rows`` rows left out, as
    the kernels leave them out: the plain loop, told which blocks each row
    keeps."""
    kw = dict(dict(mode="lowrank", n=8, t=4, fix_to_1=True, rank=8, causal=True, window=None,
                   softcap=None, scale=1.0, bk=None, with_lse=False), **kw)
    bk = min(kw["bk"] or aa.attn_tiles(kw["mode"])[1], k.shape[1])
    live = aa.approx_tile_plan(q_pos, k_pos, bk=bk, rows=rows, causal=kw["causal"],
                               window=kw["window"])
    keep = live.repeat_interleave(rows, dim=1)[:, :q.shape[1]]  # (B, S, key blocks) per row
    return aa._blockwise(q, k, v, q_pos, k_pos, _keep=keep, **kw)


# ------------------------------------------------------------------ tables
@pytest.mark.parametrize("n", range(1, 9))
def test_every_accepted_table_has_a_zero_first_row_and_column(n):
    """Every t at this n, fix_to_1 both ways: the product table's row and
    column 0, and U[0], V[0] of the rank 1, 4 and 8 factors, are zero."""
    for t in range(1, max(2, n)):
        for fix in (True, False):
            lut = artifacts.product_lut_u16(n, t, fix, CPU).to(torch.int64) & 0xFFFF
            lut = lut.reshape(1 << n, 1 << n)
            assert not lut[0].any() and not lut[:, 0].any(), (n, t, fix)
            for rank in (1, 4, 8):
                u, v, _ = artifacts.svd_factors(n, t, rank, fix, CPU)
                assert not u[0].any() and not v[0].any(), (n, t, fix, rank)


# ------------------------------------------------------------- skip rule
def _inputs(case: str, seed: int):
    """(q, k, v, q_pos, k_pos, window, softcap) of one layout, float32, from numpy."""
    rng = np.random.default_rng(seed)
    b, h, kv, hd = 2, 4, 2, 16
    s, t = {"causal": (256, 256)}.get(case, (24, 64))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd)))
    jj = np.tile(np.arange(t), (b, 1))
    window = softcap = None
    if case == "causal":
        q_pos, k_pos = jj[:, :s].copy(), jj.copy()
    elif case == "left-pad":  # row 1 padded by 7: its first 7 queries see no slot
        q_pos = np.tile(np.arange(s), (b, 1))
        q_pos[1] -= 7
        k_pos = np.where((jj >= np.array([[0], [7]])) & (jj < s), jj - np.array([[0], [7]]), -1)
    elif case == "masked-tail":  # a prompt of s over a cache of t, the tail unwritten
        q_pos = np.tile(np.arange(s), (b, 1))
        k_pos = np.where(jj < s, jj, -1)
    elif case == "window+softcap":
        q_pos = np.tile(np.arange(s) + (t - s), (b, 1))
        k_pos = jj.copy()
        window, softcap = 12, 20.0
    else:  # "masked-first-block": test_torch_attention's layout, row 1's first slots masked
        q_pos = np.tile(np.arange(s) + (t - s), (b, 1))
        k_pos = jj.copy()
        k_pos[1, :8] = -1
        k_pos[1, 8:] -= 8
        q_pos[1] -= 8
        q_pos[1, :3] = -1
        window, softcap = 12, 20.0
    pos = [torch.from_numpy(x.astype(np.int32)) for x in (q_pos, k_pos)]
    return q, k, v, *pos, window, softcap


CASES = ["left-pad", "masked-tail", "window+softcap", "masked-first-block", "causal"]


@pytest.mark.parametrize("bk", [8, 16, 64, 128])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", aa.ATTN_MODES)
def test_skipped_pairs_leave_o_and_lse_bit_identical(mode, case, bk):
    """The plain version without the pairs the kernels skip gives the same
    (o, lse), bit for bit, at the query tiles of every plan (1 to 32 rows)
    and at 8 rows."""
    q, k, v, qp, kp, window, softcap = _inputs(case, seed=bk)
    kw = dict(mode=mode, n=8, t=4, rank=4, causal=True, window=window, softcap=softcap,
              scale=0.25, bk=bk, with_lse=True)
    want_o, want_lse = aa.approx_attention_plain(q, k, v, qp, kp, **kw)
    assert bool(torch.isfinite(want_o).all())
    b, s, h, hd = q.shape
    t, kvh = k.shape[1:3]
    rows = {aa.launch_plan(mode, b, s, t, h, kvh, hd, 8, 4, sms).rows for sms in (1, 8, SMS)}
    skipped = 0
    for r in sorted(rows | {8}):
        live = aa.approx_tile_plan(qp, kp, bk=min(bk, t), rows=r, causal=True, window=window)
        skipped += int((~live).sum())
        o, lse = _skipping(q, k, v, qp, kp, rows=r, **kw)
        assert _same_bits(o, want_o), (r, (o - want_o).abs().max().item())
        assert _same_bits(lse, want_lse), r
    if case == "causal" and bk < t:
        assert skipped > 0  # causal blocks above the diagonal go


def test_skipping_matches_the_reference():
    """The skipping plain version against the JAX package's blockwise
    reference (the tolerance of ``tests/test_torch_attention.py``)."""
    q, k, v, qp, kp, window, softcap = _inputs("masked-first-block", seed=3)
    kw = dict(mode="bitexact", n=8, t=4, causal=True, window=window, softcap=softcap,
              scale=0.25, bk=8)
    want = np.asarray(jax_approx.approx_attention_reference(
        *(jnp.asarray(x.numpy()) for x in (q, k, v, qp, kp)), **kw))
    got = _skipping(q, k, v, qp, kp, rows=8, **kw).numpy()
    quantum = np.abs(v.numpy()).max() / 255
    np.testing.assert_allclose(got, want, rtol=0, atol=quantum)
    assert (np.abs(got - want) <= 1e-5).mean() >= 0.99


def _serve_positions(b=4, s=32, t=48):
    """chip_smoke's serve prefill: row 1 left-padded by 5, a masked tail."""
    jj = np.tile(np.arange(t), (b, 1))
    pad = np.zeros((b, 1), dtype=np.int64)
    pad[1] = 5
    q_pos = np.tile(np.arange(s), (b, 1)) - pad
    k_pos = np.where((jj >= pad) & (jj < s), jj - pad, -1)
    return torch.from_numpy(q_pos), torch.from_numpy(k_pos)


@pytest.mark.parametrize("mode,shape,bk", [
    ("bitexact", "serve", 16), ("lowrank", "serve", 16), ("bitexact", "train", 64),
    ("bitexact", "long", 64), ("lowrank", "long", 128),
])
def test_plan_skips_at_the_chip_smoke_shapes(mode, shape, bk):
    """At chip_smoke's serve, train and long shapes, with the rows of the
    launch plan on an H100, the kernels skip some pairs: the masked cache
    tail at serve (not in the left-padded row's first tile), the causal
    upper triangle at train and long."""
    if shape == "serve":
        qp, kp = _serve_positions()
        b, s, t = 4, 32, 48
    else:
        b, s = (8, 128) if shape == "train" else (1, 1024)
        t = s
        qp = torch.arange(s).expand(b, s).clone()
        kp = qp.clone()
    plan = aa.launch_plan(mode, b, s, t, 16, 8, 128, 8, 8, SMS)
    live = aa.approx_tile_plan(qp, kp, bk=bk, rows=plan.rows, causal=True, window=None)
    assert live.shape == (b, -(-s // plan.rows), -(-t // bk))
    assert 0 < int((~live).sum()) < live.numel()
    if shape == "serve":
        # row 1's first tile holds pad queries with no slot: it walks every block
        assert bool(live[1, 0].all()) and not bool(live[0, 0].all())


# ------------------------------------------------------------ launch plan
def test_shared_memory_fits_every_accepted_width():
    """Every (mode, n <= 8, hd <= 128, rank <= 24) fits a block's shared
    memory, in whole 16-byte words (bitexact at each row-tile factor); head
    width 256, where lowrank takes ranks up to 8 and bitexact TM up to 2 at
    n = 8: ``test_head_width_256_plans_fit_the_card``."""
    for n in range(1, 9):
        for hd in (w for w in HEAD_DIMS if w <= 128):
            for tm in (1, 2, 4):
                nbytes = aa.smem_bytes("bitexact", n, hd, 8, tm)
                assert nbytes <= SMEM_PER_BLOCK and nbytes % 16 == 0, (n, hd, tm)
            for rank in range(1, 25):
                nbytes = aa.smem_bytes("lowrank", n, hd, rank)
                assert nbytes <= SMEM_PER_BLOCK and nbytes % 16 == 0, (n, hd, rank)
    assert aa.smem_bytes("bitexact", 8, 128, 8) == 131072 + 4 * 128 * 64 + 2 * 64 * 128 \
        + 4 * 64 * 128 + 4 * (4 * 64 + 132) == 214_544
    assert aa.smem_bytes("lowrank", 8, 128, 8) == 16 * 257 * 8 + 18_432 + 68_608 + 16_384 \
        + 5_120 + 1_040 == 142_480
    # kernel_operands accepts the widest (n 8, hd 128, rank 24) and refuses what does not fit
    x = torch.randn((1, 4, 2, 128), generator=torch.Generator().manual_seed(0))
    ops = aa.kernel_operands(x, x[:, :, :1], x[:, :, :1], mode="lowrank", n=8, t=4,
                             fix_to_1=True, rank=24)
    assert ops.table.shape == (2, 256, 24) and [a.dtype for a in ops.args] == \
        [torch.uint8, torch.int8] * 3
    with pytest.raises(ValueError, match="shared memory"):
        aa.kernel_operands(x, x[:, :, :1], x[:, :, :1], mode="lowrank", n=8, t=4,
                           fix_to_1=True, rank=64)


@pytest.mark.parametrize("mode,args,want", [
    # serve prefill, bitexact: 32 items of 64 row-heads, 64 of 32; 128 of 16 (8 rows x 2 heads)
    ("bitexact", (4, 32, 48, 16, 8, 128), ((128, 1, 1), 512, 164_624, 8, 2)),
    # train (b) and S = T = 1024: 256 items of 64 row-heads fill the 132 SMs
    ("bitexact", (8, 128, 128, 16, 8, 128), ((132, 1, 1), 512, 214_544, 32, 2)),
    ("bitexact", (1, 1024, 1024, 16, 8, 128), ((132, 1, 1), 512, 214_544, 32, 2)),
    # hd 16: 32 TM row-heads; 4, 8 and 12 items at TM 4, 2, 1: TM 1, 16 rows x 2 heads
    ("bitexact", (2, 40, 256, 4, 2, 16), ((12, 1, 1), 512, 131_072 + 2_048 + 2_048 + 16_384
                                          + 4 * (4 * 32 + 132), 16, 2)),
    # g = 3: 16 row-heads hold 5 rows of 3 heads
    ("bitexact", (1, 10, 10, 6, 2, 64), ((4, 1, 1), 512, 131_072 + 4_096 + 8_192 + 8_192
                                         + 4 * (4 * 16 + 132), 5, 3)),
    # lowrank: 32 row-heads, 16 rows x 2 heads
    ("lowrank", (4, 32, 48, 16, 8, 128), ((64, 1, 1), 256, 142_480, 16, 2)),
    ("lowrank", (1, 1024, 1024, 16, 8, 128), ((132, 1, 1), 256, 142_480, 16, 2)),
    # g = 64 > 32: two head chunks of 32, one row each: 2 x 1 x 2 x 3 items
    ("lowrank", (2, 3, 7, 64, 1, 64), ((12, 1, 1), 256, None, 1, 32)),
])
def test_launch_plan_against_hand_worked_grids(mode, args, want):
    plan = aa.launch_plan(mode, *args, 8, 8, SMS)
    grid, threads, smem, rows, heads = want
    assert (plan.grid, plan.threads, plan.rows, plan.heads) == (grid, threads, rows, heads)
    assert plan.smem == (smem if smem is not None else aa.smem_bytes(mode, 8, args[-1], 8))
    with pytest.raises(ValueError, match="head_dim"):
        aa.launch_plan(mode, *args[:-1], 48, 8, 8, SMS)


# ------------------------------------------------------- head width 256
@pytest.mark.parametrize("g", [1, 2, 8, 10])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_head_width_256_plans_fit_the_card(dtype, g):
    """gemma's head width: bitexact's row tile is capped by the shared
    memory (TM = 4 needs 263,696 bytes at n = 8, so it is never chosen
    there), lowrank at the configs' rank 8 fits (226,448 bytes), and rank 24
    (292,240) is refused by the plan and by ``kernel_operands``, whatever
    the input dtype."""
    h, kv = (10, 1) if g == 10 else (16, 16 // g)  # g = 10: recurrentgemma-2b's MQA
    wide = aa.smem_bytes("bitexact", 8, 256, 8, 4)
    assert wide == 131_072 + 4 * 256 * 64 + 2 * 64 * 256 + 4 * 64 * 128 + 4 * (4 * 64 + 132) \
        == 263_696 > SMEM_PER_BLOCK
    assert aa.smem_bytes("lowrank", 8, 256, 8) == 226_448 <= SMEM_PER_BLOCK
    assert aa.smem_bytes("lowrank", 8, 256, 24) == 292_240 > SMEM_PER_BLOCK
    for b, s, t in ((4, 32, 48), (1, 1024, 1024), (8, 128, 128), (1, 5, 9)):
        for sms in (SMS, 1, 4096):
            plan = aa.launch_plan("bitexact", b, s, t, h, kv, 256, 8, 8, sms)
            assert plan.smem <= SMEM_PER_BLOCK and plan.smem != wide
            assert plan.smem in (aa.smem_bytes("bitexact", 8, 256, 8, tm) for tm in (2, 1))
            plan = aa.launch_plan("lowrank", b, s, t, h, kv, 256, 8, 8, sms)
            assert plan.smem == 226_448
            with pytest.raises(ValueError, match="shared memory"):
                aa.launch_plan("lowrank", b, s, t, h, kv, 256, 8, 24, sms)
    # at n = 7 the table is a quarter as large, and TM = 4 fits again
    assert aa.launch_plan("bitexact", 1, 1024, 1024, h, kv, 256, 7, 8, SMS).smem == \
        aa.smem_bytes("bitexact", 7, 256, 8, 4)
    x = torch.randn((1, 4, h, 256), generator=torch.Generator().manual_seed(0)).to(dtype)
    kx = x[:, :, :kv].contiguous()
    ops = aa.kernel_operands(x, kx, kx, mode="lowrank", n=8, t=4, fix_to_1=True, rank=8)
    assert ops.table.shape == (2, 256, 8)
    aa.kernel_operands(x, kx, kx, mode="bitexact", n=8, t=4, fix_to_1=True, rank=8)
    with pytest.raises(ValueError, match="shared memory"):
        aa.kernel_operands(x, kx, kx, mode="lowrank", n=8, t=4, fix_to_1=True, rank=24)


@pytest.mark.parametrize("mode", ["bitexact", "lowrank"])
def test_head_width_256_plain_version_matches_reference(mode):
    """``approx_attention_plain`` at head width 256 against the JAX
    package's blockwise reference, with window, softcap, a masked key block
    and left pads, within one probability quantum and 1e-5 for 99% of the
    outputs (``tests/test_torch_attention.py`` says why)."""
    rng = np.random.default_rng(257)
    b, s, t, h, kv, hd = 2, 16, 32, 4, 2, 256
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd)))
    qp = np.tile(np.arange(s, dtype=np.int32) + (t - s), (b, 1))
    kp = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    kp[1, :8] = -1
    kp[1, 8:] -= 8
    qp[1] -= 8
    qp[1, :3] = -1
    kw = dict(mode=mode, n=8, t=4, rank=8, causal=True, window=12, softcap=50.0,
              scale=hd**-0.5, bk=8)
    want = np.asarray(jax_approx.approx_attention_reference(
        *map(jnp.asarray, (q, k, v, qp, kp)), bq=8, **kw))
    got = aa.approx_attention_plain(*(torch.from_numpy(x) for x in (q, k, v, qp, kp)),
                                    **kw).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=np.abs(v).max() / 255)
    assert (np.abs(got - want) <= 1e-5).mean() >= 0.99
