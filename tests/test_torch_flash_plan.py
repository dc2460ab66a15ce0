"""The exact flash kernels' masked-block rule, decode split and launch plans, on the CPU.

``csrc/flash_attention.cu``'s forward skips a (query tile, key tile) pair
when no row of the tile may attend a slot of the key tile and every row
of the tile has an allowed slot somewhere; its decode cuts the cache into
chunks, skips the chunks with no allowed slot, and adds the chunks'
partial softmaxes in chunk order.  These tests run an online-softmax loop
with the pairs that ``fwd_tile_plan`` skips left out and hold its (o,
lse) bit-identical to the loop that keeps every pair (the plain version's
blockwise arithmetic) and within 2e-5 of ``flash_attention_plain`` and
of the JAX package's forward; they hold ``approx_tile_plan`` to the same
rule, worked out slot by slot; they model the decode's split and
combine in PyTorch against ``flash_decode_plain``; and they check the
launch plans that the card tests hold equal to the built library's.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro_torch.kernels import approx_attention as aa
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.build import SMEM_PER_BLOCK

SMS = 132  # the H100's SMs, for the hand-worked plans
TOL = dict(rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ the rule
def _online(q, k, v, q_pos, k_pos, *, rows, keys, causal, window, softcap, scale, keep=None):
    """The online softmax over query tiles of ``rows`` rows and key tiles of
    ``keys`` slots (the last ones may be shorter), every head at once, with
    the arithmetic of the plain version's blockwise loop
    (``flash_attention._attend_flash``).  ``keep`` (B, query tiles, key
    tiles) bool: where it is False the key tile leaves the rows of that
    query tile as they were, as the kernel leaves out a skipped pair.
    Returns (o (B, S, H, hd), lse (B, H, S))."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    outs, lses = [], []
    for qi, q0 in enumerate(range(0, s, rows)):
        qb, qpb = q[:, q0:q0 + rows], q_pos[:, q0:q0 + rows]
        n = qb.shape[1]
        m = torch.full((b, h, n), fa.NEG_INF, dtype=torch.float32)
        l = torch.zeros((b, h, n), dtype=torch.float32)
        acc = torch.zeros((b, h, n, hd), dtype=torch.float32)
        for ki, k0 in enumerate(range(0, t, keys)):
            kb, vb = k[:, k0:k0 + keys], v[:, k0:k0 + keys]
            logits = fa._scores(qb, kb, softcap, scale)
            allow = fa.allow_mask(qpb, k_pos[:, k0:k0 + keys], causal=causal, window=window)
            logits = torch.where(allow[:, None, :, :], logits, fa.NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            state = (m_new, l * corr + p.sum(dim=-1), acc * corr[..., None] + fa._weighted_values(p, vb))
            if keep is None:
                m, l, acc = state
            else:
                kept = keep[:, qi, ki][:, None, None]  # (B, 1, 1)
                m, l = (torch.where(kept, new, old) for new, old in zip(state, (m, l)))
                acc = torch.where(kept[..., None], state[2], acc)
        l = torch.clamp(l, min=1e-30)
        outs.append((acc / l[..., None]).transpose(1, 2))
        lses.append(m + torch.log(l))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=-1)


def _layout(case: str, seed: int, dtype):
    """(q, k, v, q_pos, k_pos, window, softcap) of one layout, from numpy."""
    rng = np.random.default_rng(seed)
    b, h, kv, hd = 2, 4, 2, 16
    s, t = {"causal": (256, 256)}.get(case, (40, 100))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
               for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd)))
    jj = np.tile(np.arange(t), (b, 1))
    window = softcap = None
    if case == "causal":
        q_pos, k_pos = jj[:, :s].copy(), jj.copy()
    elif case == "left-pad":  # row 1 padded by 7: its first 7 queries see no slot
        pad = np.array([[0], [7]])
        q_pos = np.tile(np.arange(s), (b, 1)) - pad
        k_pos = np.where((jj >= pad) & (jj < s), jj - pad, -1)
    elif case == "masked-tail":  # a prompt of s over a cache of t, the tail unwritten
        q_pos = np.tile(np.arange(s), (b, 1))
        k_pos = np.where(jj < s, jj, -1)
    elif case == "window+softcap":
        q_pos = np.tile(np.arange(s) + (t - s), (b, 1))
        k_pos = jj.copy()
        window, softcap = 12, 20.0
    else:  # "masked-first-tile": row 1's first 24 slots unwritten, its first queries padded
        q_pos = np.tile(np.arange(s) + (t - s), (b, 1))
        k_pos = jj.copy()
        k_pos[1, :24] = -1
        k_pos[1, 24:] -= 24
        q_pos[1] -= 24
        q_pos[1, :3] = -1
        window, softcap = 40, 20.0
    pos = [torch.from_numpy(x.astype(np.int32)) for x in (q_pos, k_pos)]
    return q, k, v, *pos, window, softcap


CASES = ["left-pad", "masked-tail", "window+softcap", "masked-first-tile", "causal"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,keys", [(8, 16), (32, 64), (64, 32)])
@pytest.mark.parametrize("case", CASES)
def test_skipped_pairs_leave_o_and_lse_bit_identical(case, rows, keys, dtype):
    """The loop without the pairs ``fwd_tile_plan`` skips gives the same (o,
    lse), bit for bit, as the loop that keeps every pair, and both are
    within 2e-5 of ``flash_attention_plain`` (its direct softmax) and of
    its lse; rows with no allowed slot keep lse = NEG_INF."""
    q, k, v, qp, kp, window, softcap = _layout(case, seed=rows + keys, dtype=dtype)
    kw = dict(rows=rows, keys=keys, causal=True, window=window, softcap=softcap, scale=0.25)
    live = fa.fwd_tile_plan(qp, kp, rows=rows, keys=keys, causal=True, window=window)
    assert live.shape == (q.shape[0], -(-q.shape[1] // rows), -(-k.shape[1] // keys))
    o, lse = _online(q, k, v, qp, kp, keep=live, **kw)
    want_o, want_lse = _online(q, k, v, qp, kp, **kw)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    plain, plain_lse = fa.attend(q, k, v, qp, kp, causal=True, window=window, softcap=softcap,
                                 scale=0.25, with_lse=True)
    torch.testing.assert_close(o, plain, **TOL)
    torch.testing.assert_close(lse, plain_lse, **TOL)
    assert torch.equal(lse == fa.NEG_INF, plain_lse == fa.NEG_INF)
    if case == "causal" or (case == "window+softcap" and keys == 16):
        assert not bool(live.all())  # causal tiles above the diagonal, slots out of the window


@pytest.mark.parametrize("rows,keys", [(32, 32), (64, 64)])
def test_skipping_loop_is_the_plain_blockwise_loop_and_matches_the_reference(rows, keys):
    """Where the tiles divide S and T, the loop is the plain version's own
    blockwise path bit for bit (``_attend_flash``, which ``attend`` takes
    past its chunk sizes), with or without the skipped pairs, and it agrees
    with the JAX package's flash forward (interpret mode) at the same
    tiles within 2e-5."""
    q, k, v, qp, kp, window, softcap = _layout("causal", seed=5, dtype=torch.float32)
    kw = dict(causal=True, window=window, softcap=softcap, scale=0.25)
    live = fa.fwd_tile_plan(qp, kp, rows=rows, keys=keys, causal=True, window=window)
    o, lse = _online(q, k, v, qp, kp, rows=rows, keys=keys, keep=live, **kw)
    want_o, want_lse = fa._attend_flash(q, k, v, qp, kp, q_chunk=rows, k_chunk=keys,
                                        with_lse=True, **kw)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    ref = jax_flash_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v, qp, kp)), True, None,
                              None, 0.25, rows, keys, True)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("rows,keys", [(24, 40), (16, 48), (48, 24)])
@pytest.mark.parametrize("case", CASES)
def test_blockwise_path_takes_lengths_the_chunks_do_not_divide(case, rows, keys):
    """The plain blockwise path at lengths that are not multiples of its
    chunks (a prompt of 4,096 over a cache of 4,104, say): the short last
    tiles' missing rows and slots add nothing, so (o, lse) stay within 2e-5
    of the direct softmax and of the loop over short tiles, and a row with
    no allowed slot averages its T real slots (lse NEG_INF)."""
    q, k, v, qp, kp, window, softcap = _layout(case, seed=rows + keys + 1, dtype=torch.float32)
    assert q.shape[1] % rows or k.shape[1] % keys
    kw = dict(causal=True, window=window, softcap=softcap, scale=0.25)
    o, lse = fa._attend_flash(q, k, v, qp, kp, q_chunk=rows, k_chunk=keys, with_lse=True, **kw)
    assert o.shape == q.shape and lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    want_o, want_lse = fa._attend_direct(q, k, v, qp, kp, with_lse=True, **kw)
    torch.testing.assert_close(o, want_o, **TOL)
    torch.testing.assert_close(lse, want_lse, **TOL)
    assert torch.equal(lse == fa.NEG_INF, want_lse == fa.NEG_INF)
    loop_o, loop_lse = _online(q, k, v, qp, kp, rows=rows, keys=keys, **kw)
    torch.testing.assert_close(o, loop_o, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse, loop_lse, rtol=1e-6, atol=1e-6)


def _rule_by_slot(q_pos, k_pos, *, rows, keys, causal, window):
    """The masked-block rule worked out pair by pair in plain Python: a
    (query tile, key tile) pair is live when some slot of the key tile is
    written and within the tile's least and greatest position (causal,
    window), or when some row of the tile has no allowed slot in T."""
    b, s = q_pos.shape
    t = k_pos.shape[1]
    qp, kp = q_pos.tolist(), k_pos.tolist()

    def allowed(x, y):
        return y >= 0 and (not causal or x >= y) and (window is None or x - y < window)

    live = torch.zeros((b, -(-s // rows), -(-t // keys)), dtype=torch.bool)
    for bi in range(b):
        for qi in range(live.shape[1]):
            tile = qp[bi][qi * rows:(qi + 1) * rows]
            lo, hi = min(tile), max(tile)
            lone = any(not any(allowed(x, y) for y in kp[bi]) for x in tile)
            for ki in range(live.shape[2]):
                slots = kp[bi][ki * keys:(ki + 1) * keys]
                may = any(y >= 0 and (not causal or y <= hi) and (window is None or lo - y < window)
                          for y in slots)
                live[bi, qi, ki] = may or lone
    return live


@pytest.mark.parametrize("case", CASES)
def test_fwd_tile_plan_is_the_rule_and_approx_tile_plan_follows_it(case):
    """``fwd_tile_plan`` equals the rule worked out slot by slot, and
    ``approx_tile_plan`` (which calls it) gives the same pairs at its key
    blocks, on the approximate kernels' layouts at every block size."""
    q, k, v, qp, kp, window, _ = _layout(case, seed=1, dtype=torch.float32)
    for rows, keys in ((8, 16), (32, 64), (64, 8), (1, 128)):
        want = _rule_by_slot(qp, kp, rows=rows, keys=keys, causal=True, window=window)
        got = fa.fwd_tile_plan(qp, kp, rows=rows, keys=keys, causal=True, window=window)
        assert torch.equal(got, want), (rows, keys)
        assert torch.equal(aa.approx_tile_plan(qp, kp, bk=keys, rows=rows, causal=True,
                                               window=window), want)
    # bidirectional: only written slots and the window count
    got = fa.fwd_tile_plan(qp, kp, rows=16, keys=16, causal=False, window=window)
    assert torch.equal(got, _rule_by_slot(qp, kp, rows=16, keys=16, causal=False, window=window))


def _serve_positions(b=4, s=32, t=48):
    """chip_smoke's serve prefill: row 1 left-padded by 5, a masked tail."""
    jj = np.tile(np.arange(t), (b, 1))
    pad = np.zeros((b, 1), dtype=np.int64)
    pad[1] = 5
    q_pos = np.tile(np.arange(s), (b, 1)) - pad
    k_pos = np.where((jj >= pad) & (jj < s), jj - pad, -1)
    return torch.from_numpy(q_pos), torch.from_numpy(k_pos)


def _decode_positions(b, t):
    """chip_smoke's decode: row i has written t - 16 + 4i slots."""
    written = t - 16 + 4 * np.arange(b)[:, None]
    k_pos = np.where(np.arange(t)[None] < written, np.arange(t)[None], -1)
    return torch.from_numpy(written[:, 0] - 1), torch.from_numpy(k_pos)


@pytest.mark.parametrize("shape", ["serve", "train", "long"])
def test_plan_skips_at_the_chip_smoke_shapes(shape):
    """At chip_smoke's shapes (16 query and 8 KV heads of 128) on an H100:
    the forward skips the causal upper triangle at the train and long
    shapes (at serve the 48 slots are one key tile, which stays); the
    decode skips row 0's unwritten last chunk at serve (all but the one
    chunk the window of 16 reaches, with it) and nothing over 4,096 nearly
    full slots (all but the last chunk, with the window)."""
    if shape == "serve":
        qp, kp = _serve_positions()
        b, s, t = 4, 32, 48
    else:
        b, s = (8, 128) if shape == "train" else (1, 1024)
        t = s
        qp = torch.arange(s).expand(b, s).clone()
        kp = qp.clone()
    plan = fa.launch_plan("fwd", b, s, t, 16, 8, 128, torch.bfloat16, sms=SMS)
    assert (plan.rows, plan.heads, plan.keys) == (32, 2, 64)
    live = fa.fwd_tile_plan(qp, kp, rows=plan.rows, keys=plan.keys, causal=True, window=None)
    skipped = int((~live).sum()) * 8
    assert skipped == {"serve": 0, "train": 8 * 2 * 8, "long": 1920}[shape]
    dec_b, dec_t = (4, 48) if shape == "serve" else (4, 4096)
    dqp, dkp = _decode_positions(dec_b, dec_t)
    dplan = fa.launch_plan("decode", dec_b, 1, dec_t, 16, 8, 128, torch.bfloat16, sms=SMS)
    dlive = fa.decode_chunk_plan(dqp, dkp, chunk=dplan.keys, window=None)
    assert dlive.shape == (dec_b, dplan.grid[1])
    assert int((~dlive).sum()) * 8 == (8 if shape == "serve" else 0)
    dlive = fa.decode_chunk_plan(dqp, dkp, chunk=dplan.keys, window=16)
    assert int((~dlive).sum()) * 8 == (40 if shape == "serve" else 8 * 4 * 15)


# ------------------------------------------------------------ the decode
def _decode_split_model(q, k, v, q_pos, k_pos, *, chunk, window, softcap, scale):
    """The decode kernel's arithmetic in PyTorch: each chunk of ``chunk``
    slots with an allowed slot gives a partial (m, l, acc) by the online
    softmax over tiles of 32 slots; a chunk without one gives only the flag
    l = 0; the chunks' partials are added in order 0, 1, 2, ...; a row
    with no live chunk gets the uniform average of all T slots, summed
    slot by slot in order."""
    b, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    live = fa.decode_chunk_plan(q_pos, k_pos, chunk=chunk, window=window)
    out = torch.empty((b, h, hd), dtype=torch.float32)
    for bi in range(b):
        parts = []
        for ci, c0 in enumerate(range(0, t, chunk)):
            if not live[bi, ci]:
                parts.append(None)
                continue
            m = torch.full((h,), fa.NEG_INF)
            l = torch.zeros(h)
            acc = torch.zeros((h, hd))
            for k0 in range(c0, min(t, c0 + chunk), 32):
                k1 = min(t, c0 + chunk, k0 + 32)
                kb = k[bi, k0:k1].float().repeat_interleave(g, dim=1)  # (n, h, hd)
                vb = v[bi, k0:k1].float().repeat_interleave(g, dim=1)
                s = torch.einsum("hd,nhd->hn", q[bi].float(), kb) * scale
                if softcap:
                    s = torch.tanh(s / softcap) * softcap
                allow = fa.allow_mask(q_pos[bi:bi + 1, None], k_pos[bi:bi + 1, k0:k1],
                                      causal=True, window=window)[0, 0]
                s = torch.where(allow[None], s, fa.NEG_INF)
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.exp(s - m_new[:, None])
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1)
                acc = acc * corr[:, None] + torch.einsum("hn,nhd->hd", p, vb)
                m = m_new
            parts.append((m, l, acc))
        kept = [p for p in parts if p is not None]
        if not kept:
            total = torch.zeros((kv, hd))
            for j in range(t):
                total = total + v[bi, j].float()
            out[bi] = (total / t).repeat_interleave(g, dim=0)
            continue
        m_all = torch.stack([m for m, _, _ in kept]).amax(0)
        l_all, a_all = torch.zeros(h), torch.zeros((h, hd))
        for m, l, acc in kept:
            w = torch.exp(m - m_all)
            l_all = l_all + l * w
            a_all = a_all + acc * w[:, None]
        out[bi] = a_all / torch.clamp(l_all, min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("t,h,kv,window,softcap", [
    (48, 16, 8, None, None), (48, 16, 8, 16, 30.0), (4096, 16, 8, None, None),
    (200, 16, 1, 40, None), (300, 4, 4, None, 30.0),
])
def test_decode_split_model_matches_plain_version(t, h, kv, window, softcap, dtype):
    """The split and the fixed-order combine, at the chunks of the H100's
    plan, agree with ``flash_decode_plain`` within 2e-5; a row whose
    position allows no slot (row 2) gets exactly the uniform average of all
    T slots, and no chunk of it is live."""
    b, hd = 4, 128 if t == 4096 else 32
    rng = np.random.default_rng(t + h)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
               for shape in ((b, h, hd), (b, t, kv, hd), (b, t, kv, hd)))
    q_pos, k_pos = _decode_positions(b, t)
    q_pos[2] = -1
    chunk = fa.launch_plan("decode", b, 1, t, h, kv, hd, dtype, sms=SMS).keys
    kw = dict(window=window, softcap=softcap, scale=hd**-0.5)
    got = _decode_split_model(q, k, v, q_pos, k_pos, chunk=chunk, **kw)
    want = fa.flash_decode_plain(q, k, v, q_pos, k_pos, **kw)
    torch.testing.assert_close(got, want, **TOL)
    assert not bool(fa.decode_chunk_plan(q_pos, k_pos, chunk=chunk, window=window)[2].any())
    total = torch.zeros((kv, hd))
    for j in range(t):
        total = total + v[2, j].float()
    assert torch.equal(got[2], (total / t).repeat_interleave(h // kv, dim=0))


def test_decode_split_fills_the_card():
    """The decode's chunks: whole multiples of 16 slots, none empty, about
    four blocks per SM (132) over the batch x KV-head pairs at chip_smoke's
    serve and long shapes, at most 32, and no split where the pairs fill
    the card."""
    assert fa.decode_split(4, 48, 8, SMS) == (3, 16)
    assert fa.decode_split(4, 4096, 8, SMS) == (16, 256)
    assert fa.decode_split(1, 4096, 8, SMS) == (32, 128)  # at most 32 chunks
    assert fa.decode_split(64, 4096, 8, SMS) == (1, 4096)
    for b, t, kv in ((1, 1, 1), (3, 100, 1), (2, 300, 4), (4, 4095, 8), (7, 5000, 2)):
        chunks, chunk = fa.decode_split(b, t, kv, SMS)
        assert chunk % 16 == 0 and (chunks - 1) * chunk < t <= chunks * chunk
        assert b * kv * chunks <= max(4 * SMS, b * kv) and chunks <= 32


def test_decode_workspace_is_kept_and_grown():
    """The decode's partials go to one float32 buffer per device, reused by
    every launch and grown when one needs more (``launch_decode`` asks for
    room for the most chunks the split makes, 32)."""
    from repro_torch.kernels import build

    dev = torch.device("cpu")
    buf = build.float_scratch(dev, 10)
    assert buf.dtype == torch.float32 and buf.numel() >= 1 << 16
    assert build.float_scratch(dev, 1 << 16) is buf
    grown = build.float_scratch(dev, (1 << 16) + 1)
    assert grown.numel() == (1 << 16) + 1 and build.float_scratch(dev, 10) is grown


# ---------------------------------------------------------- launch plans
def test_shared_memory_fits_every_accepted_width():
    """The forward and the decode fit a block's shared memory at every head
    width, both dtypes, any group up to 16 (the decode) and T up to
    32,768 (the forward's live-tile mask, in whole 16-byte words)."""
    for dtype in (torch.float32, torch.bfloat16):
        for hd in fa.HEAD_DIMS:
            for t in (1, 48, 1024, 32768):
                nbytes = fa.smem_bytes("fwd", hd, dtype, 1024, t, 2)
                assert nbytes <= SMEM_PER_BLOCK and nbytes % 16 == 0, (dtype, hd, t)
            for g in (1, 2, 16):
                nbytes = fa.smem_bytes("decode", hd, dtype, 1, 4096, g)
                assert nbytes <= SMEM_PER_BLOCK, (dtype, hd, g)
    # hand-worked: per item, a q plane 64 x 136 bf16, two stages of k, v planes (64 x
    # 136) and 64 positions, the mask in 16 bytes, two items to a block (float32: three
    # planes each, one stage, one item); the decode's q 16 x 128 f32, two stages of k, v
    # tiles (32 x 272 bytes) and 32 positions, 16 x 32 scores and three stats per row
    assert fa.smem_bytes("fwd", 128, torch.bfloat16, 1024, 1024, 2) == \
        2 * (17_408 + 2 * (2 * 17_408 + 256) + 16) == 175_136
    assert fa.smem_bytes("fwd", 128, torch.float32, 1024, 1024, 2) == \
        3 * 17_408 + 2 * 3 * 17_408 + 256 + 16 == 156_944
    assert fa.smem_bytes("decode", 128, torch.bfloat16, 1, 4096, 2) == \
        1_024 + 2 * (2 * 8_704 + 128) + 2 * 32 * 4 + 2 * 3 * 4 == 36_376


def test_launch_plans_against_hand_worked_grids():
    """The forward's items (64 row-heads: the group's heads over 64 / g
    rows, longest first; two to a bf16 block where they are more than one
    but at most two per SM) and the decode's (KV head, chunk, batch) grid."""
    bf = torch.bfloat16
    assert fa.launch_plan("fwd", 1, 1024, 1024, 16, 8, 128, bf, sms=SMS) == fa.FwdPlan(
        (8 * 32 // 2, 1, 1), 256, 175_136, 32, 2, 64)
    assert fa.launch_plan("fwd", 1, 1024, 1024, 16, 8, 128, torch.float32, sms=SMS)[:3] == (
        (8 * 32, 1, 1), 128, 156_944)
    assert fa.launch_plan("fwd", 8, 128, 128, 16, 8, 128, bf, sms=SMS).grid == (128, 1, 1)
    # one item a block: fewer items than SMs, or more than two per SM
    assert fa.launch_plan("fwd", 4, 32, 48, 16, 8, 128, bf, sms=SMS)[:3] == (
        (32, 1, 1), 128, 87_568)
    assert fa.launch_plan("fwd", 1, 4096, 4096, 16, 8, 128, bf, sms=SMS)[:3] == (
        (1024, 1, 1), 128, 87_568)
    # 16 heads on one KV head: 4 rows an item; 100 heads: chunks of 64 heads, one row;
    # an odd count of items (3 on 2 SMs): the last block holds one
    assert fa.launch_plan("fwd", 2, 40, 72, 16, 1, 64, bf, sms=SMS)[3:] == (4, 16, 64)
    assert fa.launch_plan("fwd", 1, 5, 9, 100, 1, 64, bf, sms=SMS).grid == (2 * 5, 1, 1)
    assert fa.launch_plan("fwd", 1, 5, 9, 100, 1, 64, bf, sms=8).grid == (5, 1, 1)
    assert fa.launch_plan("fwd", 3, 1, 9, 2, 1, 64, bf, sms=2).grid == (2, 1, 1)
    assert fa.launch_plan("decode", 4, 1, 4096, 16, 8, 128, bf, sms=SMS) == fa.FwdPlan(
        (8, 16, 4), 128, 36_376, 1, 2, 256)
    assert fa.launch_plan("decode", 4, 1, 48, 16, 8, 128, bf, sms=SMS).grid == (8, 3, 4)
    for kernel in ("fwd", "decode"):
        with pytest.raises(ValueError):
            fa.launch_plan(kernel, 4, 1, 48, 16, 8, 128, bf)  # no SM count
    with pytest.raises(ValueError):
        fa.launch_plan("decode", 4, 1, 48, 64, 1, 128, bf, sms=SMS)  # a group over 16
    with pytest.raises(ValueError):
        fa.launch_plan("fwd", 1, 8, 8, 2, 1, 48, bf, sms=SMS)  # not a built width


# ------------------------------------------------------- head width 256
WIDE_SHAPES = {  # (B, S, T): the serve prefill over its cache, S = T = 1024, train, decode
    "serve": (4, 32, 48), "long": (1, 1024, 1024), "train": (8, 128, 128), "decode": (4, 1, 8192),
}


@pytest.mark.parametrize("shape", sorted(WIDE_SHAPES))
@pytest.mark.parametrize("g", [1, 2, 8, 10])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_head_width_256_plans_fit_the_card(dtype, g, shape):
    """gemma's head width: the forward takes one item a block (eight warps,
    two to each 16 row-heads), float32 key tiles of 32, and every plan's
    shared memory fits a block at any SM count (two items a block would
    not: 338,976 bytes for bf16); the decode fits; so do the backward
    pair's (dq four warps, dk/dv one group of eight warps, two to each 16
    slots), and the CPU backward at 256 is the plain version."""
    b, s, t = WIDE_SHAPES[shape]
    h, kv = (10, 1) if g == 10 else (16, 16 // g)  # g = 10: recurrentgemma-2b's MQA
    for sms in (SMS, 1, b * kv * 64):  # one wave, many, and items within (sms, 2 sms]
        plan = fa.launch_plan("fwd", b, s, t, h, kv, 256, dtype, sms=sms)
        items = b * kv * -(-s // (64 // min(g, 64)))
        assert plan.grid == (items, 1, 1) and plan.threads == 256
        assert plan.keys == (64 if dtype == torch.bfloat16 else 32)
        assert plan.smem == fa.smem_bytes("fwd", 256, dtype, s, t, g, items, sms)
        assert plan.smem <= SMEM_PER_BLOCK and plan.smem % 16 == 0
        dec = fa.launch_plan("decode", b, 1, t, h, kv, 256, dtype, sms=sms)
        assert dec.smem == fa.smem_bytes("decode", 256, dtype, 1, t, g) <= SMEM_PER_BLOCK
    dq = fa.launch_plan("dq", b, s, t, h, kv, 256, dtype)
    assert dq == fa.BwdPlan((-(-s // 64), h, b), 128, fa.smem_bytes("dq", 256, dtype, s, t, g))
    dkv = fa.launch_plan("dkv", b, s, t, h, kv, 256, dtype)
    assert dkv == fa.BwdPlan((-(-t // 64), kv, b), 256, fa.smem_bytes("dkv", 256, dtype, s, t, g))
    for plan in (dq, dkv):
        assert plan.smem <= SMEM_PER_BLOCK and plan.smem % 4 == 0
    q = torch.zeros((b, s, h, 256), dtype=dtype)
    k = torch.zeros((b, t, kv, 256), dtype=dtype)
    pos = torch.arange(s, dtype=torch.int32).expand(b, s) + (t - s)
    kpos = torch.arange(t, dtype=torch.int32).expand(b, t)
    o, lse = fa.flash_attention_fwd(q, k, k, pos, kpos, with_lse=True)
    got = fa.flash_attention_bwd(q, k, k, pos, kpos, o, lse, o)
    assert [tuple(x.shape) for x in got] == [(b, s, h, 256), (b, t, kv, 256), (b, t, kv, 256)]
    assert all(x.dtype == torch.float32 and not bool(x.any()) for x in got)


def test_head_width_256_hand_worked_shared_memory():
    """bf16: one item of a q plane 64 x 264 and two stages of k, v planes
    (64 x 264) and 64 positions, the mask in 16 bytes; float32: three planes
    of q, one stage of three k and three v planes of 32 slots."""
    assert fa.smem_bytes("fwd", 256, torch.bfloat16, 1024, 1024, 2) == \
        33_792 + 2 * (2 * 33_792 + 256) + 16 == 169_488
    assert fa.smem_bytes("fwd", 256, torch.float32, 1024, 1024, 2) == \
        3 * 33_792 + 2 * 3 * 16_896 + 128 + 16 == 202_896
    assert fa.launch_plan("fwd", 1, 1024, 1024, 16, 8, 256, torch.bfloat16, sms=SMS) == \
        fa.FwdPlan((8 * 32, 1, 1), 256, 169_488, 32, 2, 64)


def test_head_width_256_backward_hand_worked_shared_memory():
    """The backward pair at 256, planes of rows of 264 bf16 (528 bytes), the
    live-tile mask in whole words.  dq, bf16: q (one plane of 64 rows), do
    (two), two ring stages of k and v (32 rows each) and 32 slot positions;
    float32: q and do two planes each, k and v split straight into two
    planes each, one step's 32 positions, no ring.  dk/dv, bf16: k and v
    (64 rows), one group's two ring stages of q (a plane of 32 rows), raw
    do (32 x 256 float32) and 3 x 32 stats, and the split do (two planes);
    float32: k and v two planes each, then split q and do (two planes
    each) and the 3 x 32 stats of one step."""
    row, bf, f32 = 528, torch.bfloat16, torch.float32
    assert fa.smem_bytes("dq", 256, bf, 128, 128, 2) == \
        64 * row + 2 * 64 * row + 2 * (2 * 32 * row + 128) + 4 == 169_220
    assert fa.smem_bytes("dq", 256, f32, 128, 128, 2) == \
        2 * 64 * row + 2 * 64 * row + 2 * 2 * 32 * row + 128 + 4 == 202_884
    assert fa.smem_bytes("dkv", 256, bf, 128, 128, 2) == \
        2 * 64 * row + 2 * (32 * row + 32 * 1024 + 384) + 2 * 32 * row + 4 == 201_476
    assert fa.smem_bytes("dkv", 256, f32, 128, 128, 2) == \
        2 * 2 * 64 * row + (2 + 2) * 32 * row + 384 + 4 == 203_140
    # S = T = 1024: 32 key tiles (dq), 2 heads x 32 query tiles (dk/dv) in the mask
    assert fa.smem_bytes("dq", 256, bf, 1024, 1024, 2) == 169_216 + 4
    assert fa.smem_bytes("dkv", 256, bf, 1024, 1024, 2) == 201_472 + 8
    assert fa.launch_plan("dkv", 8, 128, 128, 16, 8, 256, bf) == \
        fa.BwdPlan((2, 8, 8), 256, 201_476)
    assert fa.launch_plan("dq", 8, 128, 128, 16, 8, 256, f32) == \
        fa.BwdPlan((2, 16, 8), 128, 202_884)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_head_width_256_plain_forward_and_decode_match_reference(dtype):
    """``flash_attention_plain`` and ``flash_decode_plain`` at head width
    256 (gemma2-9b's 16 query and 8 KV heads cut to 4 and 2), window and
    softcap, against the JAX kernels in interpret mode."""
    from repro.kernels.flash_attention import flash_decode as jax_flash_decode

    rng = np.random.default_rng(256)
    b, s, t, h, kv, hd = 2, 16, 32, 4, 2, 256
    q, k, v = ((rng.standard_normal(shape) * 0.5).astype(np.float32)
               for shape in ((b, s, h, hd), (b, t, kv, hd), (b, t, kv, hd)))
    if dtype == torch.bfloat16:  # the same bf16 values on both sides
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16)).astype(np.float32)
                   for x in (q, k, v))
    qp = np.tile(np.arange(s, dtype=np.int32) + (t - s), (b, 1))
    kp = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    kw = dict(causal=True, window=8, softcap=50.0, scale=hd**-0.5)
    want = jax_flash_attention(*map(jnp.asarray, (q, k, v, qp, kp)), kw["causal"], kw["window"],
                               kw["softcap"], kw["scale"], 16, 16, True)
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    got = fa.flash_attention_plain(tq, tk, tv, torch.from_numpy(qp), torch.from_numpy(kp), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jax_flash_decode(*map(jnp.asarray, (q[:, -1], k, v, qp[:, -1], kp)),
                            window=kw["window"], softcap=kw["softcap"], scale=kw["scale"], bk=16,
                            interpret=True)
    got = fa.flash_decode_plain(tq[:, -1], tk, tv, torch.from_numpy(qp[:, -1]),
                                torch.from_numpy(kp), window=kw["window"],
                                softcap=kw["softcap"], scale=kw["scale"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
