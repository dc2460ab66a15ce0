"""The Hopper designs of ``seqmul_matmul`` and ``lut_matmul``, on the CPU.

``csrc/seqmul_matmul.cu`` runs the split-word recurrence bit-sliced over
K: 32 values of k in the 32 bits of a word, one word per bit position.
:func:`sliced_products` below is a PyTorch model of that form (planes as
int64 words of 32 lanes), kept here because it is a test model.  It is
held bit-equal (tolerance 0) to the recurrence of the port
(``repro_torch.engine.recurrence``) and of the JAX package
(``repro.engine.recurrence``), and its signed popcount sums to
``seqmul_matmul_plain``.  Then the launch plans of both kernels: the
splits fill at most one wave and leave no slice empty, the shared memory
fits a Hopper block at every n and row tile, and the partials of the
plan's slices, summed in slice order, give the plain result.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.engine import recurrence as jax_recurrence
from repro_torch.engine import artifacts, recurrence
from repro_torch.kernels import build
from repro_torch.kernels import lut_matmul as lm
from repro_torch.kernels import seqmul_matmul as sm

LANES = 32
_SHIFTS = torch.arange(LANES, dtype=torch.int64)
_COMBOS = ((True, True), (True, False), (False, False))  # (approx, fix_to_1)


def _splits(n: int) -> range:
    return range(1, max(1, n - 1) + 1)


# ------------------------------------------------------ the sliced model
def to_planes(x: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., K) non-negative ints -> (..., ceil(K / 32), bits) int64 words:
    bit l of word w, plane i is bit i of element 32 w + l; pad lanes 0."""
    k = x.shape[-1]
    words = -(-k // LANES)
    x = torch.nn.functional.pad(x.to(torch.int64), (0, words * LANES - k))
    x = x.reshape(*x.shape[:-1], words, LANES)
    return torch.stack([(((x >> i) & 1) << _SHIFTS).sum(-1) for i in range(bits)], -1)


def sign_planes(sign: torch.Tensor) -> torch.Tensor:
    """int8 signs in {-1, 0, 1} -> (..., words, 2): the nonzero plane (bit
    0 of the sign byte) and the negative plane (bit 7)."""
    byte = sign.to(torch.int64) & 0xFF
    return torch.cat([to_planes(byte & 1, 1), to_planes(byte >> 7, 1)], -1)


def sliced_products(a: torch.Tensor, b: torch.Tensor, *, n: int, t: int, approx: bool,
                    fix_to_1: bool) -> torch.Tensor:
    """The kernel's recurrence on planes: a, b (..., n) magnitude planes ->
    (..., 2n) product planes (lo's n - 1, then W's n + 1)."""
    zero = torch.zeros_like(a[..., 0])
    w = [zero] * (n + 1)  # W = s_lsp + 2^t s_msp
    lo, deferred = [], zero
    for j in range(n):
        nxt, carry = [zero] * (n + 1), zero
        for i in range(n):
            if i == t:  # the split: a renaming
                carry, deferred = (deferred if approx else carry), carry
            aug, m = w[i + 1], a[..., i] & b[..., j]
            nxt[i] = aug ^ m ^ carry  # LOP3 0x96
            carry = (aug & m) | (carry & (aug ^ m))  # LOP3 0xE8
        if t == n:  # n = 1
            carry, deferred = (deferred if approx else carry), carry
        nxt[n] = carry
        w = nxt
        if j < n - 1:
            lo.append(w[0])
    c = deferred if approx and fix_to_1 else zero
    planes = [p | c for p in lo] + [w[p] | c if p <= t else w[p] for p in range(n + 1)]
    return torch.stack(planes, -1)


def lane_values(planes: torch.Tensor) -> torch.Tensor:
    """(..., words, bits) planes -> (..., words * 32) values."""
    bits = (planes[..., None] >> _SHIFTS) & 1  # (..., words, bits, lanes)
    weights = 1 << torch.arange(planes.shape[-1], dtype=torch.int64)
    values = (bits * weights[:, None]).sum(-2)
    return values.reshape(*planes.shape[:-2], -1)


def popc(x: torch.Tensor) -> torch.Tensor:
    return ((x[..., None] >> _SHIFTS) & 1).sum(-1)


def sliced_matmul(mag_a, sign_a, mag_b, sign_b, *, n: int, t: int, approx: bool = True,
                  fix_to_1: bool = True) -> torch.Tensor:
    """The kernel's sums: sum over K words of sum_i 2^i (popc(P_i & pos) -
    popc(P_i & neg)), exact int64 (M, N)."""
    pa = torch.cat([to_planes(mag_a, n), sign_planes(sign_a)], -1)[:, None]  # (M, 1, W, n+2)
    pb = torch.cat([to_planes(mag_b.T, n), sign_planes(sign_b.T)], -1)[None]  # (1, N, W, n+2)
    prod = sliced_products(pa[..., :n], pb[..., :n], n=n, t=t, approx=approx,
                           fix_to_1=fix_to_1)
    differ = pa[..., n + 1] ^ pb[..., n + 1]
    both = pa[..., n] & pb[..., n]
    pos, neg = both & ~differ, both & differ
    weights = 1 << torch.arange(2 * n, dtype=torch.int64)
    counts = popc(prod & pos[..., None]) - popc(prod & neg[..., None])  # (M, N, W, 2n)
    return (counts * weights).sum((-1, -2))


# ------------------------------------------- (a) the sliced recurrence
def _pairs(n: int) -> tuple[np.ndarray, np.ndarray]:
    if n <= 6:  # every (a, b)
        v = np.arange(1 << n, dtype=np.uint32)
        return np.repeat(v, 1 << n), np.tile(v, 1 << n)
    rng = np.random.default_rng(n)
    return rng.integers(0, 1 << n, (2, 4099), dtype=np.uint32)  # a ragged last word


@pytest.mark.parametrize("n", range(1, 13))
def test_sliced_recurrence_bitmatches_both_recurrences(n):
    """Every t and (approx, fix_to_1): the sliced products equal the port's
    and the JAX package's ``seqmul_recurrence`` + ``pack_u32``, exhaustively
    at n <= 6 and on seeded random pairs at n = 7..12."""
    a, b = _pairs(n)
    ta, tb = torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64))
    pa, pb = to_planes(ta, n), to_planes(tb, n)
    for t in _splits(n):
        for approx, fix in _COMBOS:
            where = f"n={n} t={t} approx={approx} fix_to_1={fix}"
            got = lane_values(sliced_products(pa, pb, n=n, t=t, approx=approx,
                                              fix_to_1=fix))[: a.size].numpy()
            words = recurrence.seqmul_recurrence(ta, tb, n=n, t=t, approx=approx, fix_to_1=fix)
            port = recurrence.pack_u32(*words[:3], n=n, t=t).numpy()
            jax_words = jax_recurrence.seqmul_recurrence(
                jnp.asarray(a), jnp.asarray(b), n=n, t=t, approx=approx, fix_to_1=fix)
            reference = np.asarray(jax_recurrence.pack_u32(*jax_words[:3], n=n, t=t), np.int64)
            np.testing.assert_array_equal(got, port, err_msg=f"port, {where}")
            np.testing.assert_array_equal(got, reference, err_msg=f"JAX, {where}")


# ------------------------------------- (b) the signed popcount sum over K
def _seqmul_operands(m, k, n_cols, n, seed):
    """Random magnitudes and signs with zero magnitudes under both signs
    and nonzero magnitudes under sign 0."""
    rng = np.random.default_rng(seed)
    qmax = (1 << n) - 1
    mag_a = rng.integers(0, qmax + 1, (m, k))
    mag_b = rng.integers(0, qmax + 1, (k, n_cols))
    mag_a[rng.random((m, k)) < 0.15] = 0
    mag_b[rng.random((k, n_cols)) < 0.15] = 0
    sign_a = rng.choice([-1, 0, 1], (m, k), p=[0.45, 0.1, 0.45])
    sign_b = rng.choice([-1, 0, 1], (k, n_cols), p=[0.45, 0.1, 0.45])
    return (torch.from_numpy(mag_a).to(torch.int16), torch.from_numpy(sign_a).to(torch.int8),
            torch.from_numpy(mag_b).to(torch.int16), torch.from_numpy(sign_b).to(torch.int8))


@pytest.mark.parametrize("n,t,approx,fix_to_1,k", [
    (1, 1, True, True, 45), (4, 2, True, True, 77), (8, 4, True, True, 100),
    (8, 7, True, False, 33), (8, 1, False, False, 64), (12, 6, True, True, 95),
])
def test_sliced_signed_sum_bitmatches_plain_version(n, t, approx, fix_to_1, k):
    """K not a multiple of 32 (pad lanes are magnitude 0, sign 0) and
    zero magnitudes under both signs: the sliced sums equal
    ``seqmul_matmul_plain`` exactly."""
    args = _seqmul_operands(3, k, 5, n, seed=n * 100 + k)
    got = sliced_matmul(*args, n=n, t=t, approx=approx, fix_to_1=fix_to_1)
    want = sm.seqmul_matmul_plain(*args, n=n, t=t, approx=approx, fix_to_1=fix_to_1)
    assert torch.equal(got.to(torch.float32), want)


# ------------------------------------------------------ (c) launch plans
SHAPES = [(1, 1024, 3072), (4, 1024, 3072), (4, 3072, 1024), (32, 1024, 2048),
          (33, 301, 70), (128, 1024, 3072), (1024, 1024, 3072), (4, 0, 64)]


def _slices_cover_k(splits: int, chunk: int, k: int, step: int) -> None:
    assert chunk % step == 0 and chunk >= step
    if k == 0:
        assert splits == 1
    else:
        assert (splits - 1) * chunk < k <= splits * chunk  # no slice empty


@pytest.mark.parametrize("m,k,n_cols", SHAPES)
def test_seqmul_plan_fills_one_wave_and_no_slice_is_empty(m, k, n_cols):
    for sms in (132, 8):
        plan = sm.launch_plan(m, k, n_cols, 8, sms)
        bm, bn = sm.tile(m)
        tiles = -(-m // bm) * -(-n_cols // bn)
        assert (plan.bm, plan.bn) == (bm, bn)
        assert plan.grid == (-(-n_cols // bn), -(-m // bm), plan.splits)
        assert tiles * plan.splits <= max(tiles, build.SPLIT_BLOCKS_PER_SM * sms)
        _slices_cover_k(plan.splits, plan.k_chunk, k, sm.STAGE_K)
        assert plan.workspace == (0 if plan.splits == 1 else plan.splits * m * n_cols * 4)
    assert sm.launch_plan(4, 1024, 3072, 8).splits > 1  # decode fills the card
    plan = sm.launch_plan(32, 1024, 3072, 8)
    assert plan.grid[1] * plan.bm == 32  # M = 32 computes 32 rows, not 64
    assert sm.launch_plan(4, 3072, 1024, 12).workspace == (
        sm.launch_plan(4, 3072, 1024, 12).splits * 4 * 1024 * 8)  # int64 partials at n = 12


@pytest.mark.parametrize("m,k,n_cols", SHAPES)
def test_lut_plan_is_one_block_per_sm_and_no_slice_is_empty(m, k, n_cols):
    for sms in (132, 8):
        plan = lm.launch_plan(m, k, n_cols, 8, sms)
        bm, bn = lm.tile(m)
        tiles = -(-m // bm) * -(-n_cols // bn)
        assert plan.bm == bm and plan.items == tiles * plan.splits
        assert plan.grid == (min(plan.items, sms), 1, 1)  # persistent: the table once per SM
        if tiles <= sms:
            assert plan.items <= sms
        else:  # no more rounds of work per tile's worth than without a split
            assert plan.splits <= lm.MAX_ROUND_SPLITS
            assert -(-plan.items // sms) / plan.splits <= -(-tiles // sms)
        _slices_cover_k(plan.splits, plan.k_chunk, k, lm.STAGE_K)
    # M = 4 fills the SMs; M = 1024 copies the table once per SM, not per
    # tile, and cuts K in two: three rounds of half items, not two whole
    assert lm.launch_plan(4, 1024, 3072, 8).items >= 64
    big = lm.launch_plan(1024, 1024, 3072, 8)
    assert big.grid[0] == 132 < big.items == 2 * 192 and big.splits == 2


def test_shared_memory_fits_a_block_at_every_n_and_tile():
    for n in range(1, sm.MAX_N + 1):
        for bm, bn in sm.TILES:
            assert sm.smem_bytes(n, bm, bn) <= build.SMEM_PER_BLOCK
            assert sm.smem_bytes(n, bm, bn) % 16 == 0
    for n in range(1, 9):
        for bm, _ in lm.TILES:
            assert lm.smem_bytes(n, bm) <= build.SMEM_PER_BLOCK
            assert lm.smem_bytes(n, bm) % 16 == 0
    assert lm.smem_bytes(8, 32) == 131072 + 4 * 32 * (512 + 32) == 200_704
    assert lm.smem_bytes(1, 4) == 16 + 4 * 32 * (512 + 4)  # the table's 8 bytes, padded


def _lut_int(lut, mag_a, sign_a, mag_b, sign_b, n):
    table = lut.view(torch.int16).to(torch.int64) & 0xFFFF
    qmax = (1 << n) - 1
    ia = torch.clamp(mag_a.to(torch.int64), max=qmax) << n
    mb = torch.clamp(mag_b.to(torch.int64), max=qmax)
    prod = table[ia[:, :, None] + mb[None]]
    return (prod * sign_a.to(torch.int64)[:, :, None] * sign_b.to(torch.int64)[None]).sum(1)


@pytest.mark.parametrize("kernel", ["seqmul_matmul", "lut_matmul"])
def test_partials_of_the_plan_summed_in_slice_order_give_the_plain_result(kernel):
    """The slices the plan cuts (a few SMs force several), each summed as
    an exact integer the way a block does, then added in slice order:
    equal to the plain version on the whole K."""
    m, k, n_cols, n, t = 5, 700, 9, 8, 4
    mag_a, sign_a, mag_b, sign_b = _seqmul_operands(m, k, n_cols, n, seed=7)
    if kernel == "seqmul_matmul":
        plan = sm.launch_plan(m, k, n_cols, n, sms=2)
        part = lambda s: sliced_matmul(mag_a[:, s], sign_a[:, s], mag_b[s], sign_b[s], n=n, t=t)
        want = sm.seqmul_matmul_plain(mag_a, sign_a, mag_b, sign_b, n=n, t=t)
    else:
        lut = artifacts.product_lut_u16(n, t, True, torch.device("cpu"))
        mag_a, mag_b = mag_a.to(torch.uint8), mag_b.to(torch.uint8)
        plan = lm.launch_plan(m, k, n_cols, n, sms=4)
        part = lambda s: _lut_int(lut, mag_a[:, s], sign_a[:, s], mag_b[s], sign_b[s], n)
        want = lm.lut_matmul_plain(lut, mag_a, sign_a, mag_b, sign_b, n=n)
    assert plan.splits > 1
    total = torch.zeros((m, n_cols), dtype=torch.int64)
    for s in range(plan.splits):
        total += part(slice(s * plan.k_chunk, min(k, (s + 1) * plan.k_chunk)))
    assert torch.equal(total.to(torch.float32), want)
