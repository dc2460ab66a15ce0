"""The port's M-RoPE against the JAX package's, and against its own RoPE.

``layers.mrope`` cuts the head_dim/2 frequency bands into sections, each
rotated by its own stream of the (3, B, S) t/h/w positions.  The same
numpy inputs go through both packages in float32, at reduced qwen2-vl's
sections (2, 3, 3) over head width 16 and the published (16, 24, 24) over
128, with three distinct streams (a patch grid: t fixed per frame, h and
w walking rows and columns, negative ids for left pads): within ``rtol =
atol = 1e-6``, since cos and sin are computed by another library in each.
With t = h = w the port's ``mrope`` must equal its ``rope`` bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.models import layers as jax_layers
from repro_torch.models import layers

TOL = dict(rtol=1e-6, atol=1e-6)


def _streams(b: int, s: int, seed: int) -> np.ndarray:
    """(3, B, S) int32 t/h/w ids: row 0 text (t = h = w = 0..S-1), row 1 a
    patch grid of width 4 after a left pad of 3, the rest random."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(-4, 4 * s, (3, b, s)).astype(np.int32)
    pos[:, 0] = np.arange(s)
    j = np.arange(s) - 3
    pos[0, 1], pos[1, 1], pos[2, 1] = np.where(j < 0, j, 2), j // 4, j % 4
    return pos


@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16), ((16, 24, 24), 128)],
                         ids=["reduced", "published"])
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_mrope_matches_reference(sections, hd, theta):
    b, s, h = 2, 11, 3
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    pos = _streams(b, s, seed=hd + 1)
    assert len({pos[i].tobytes() for i in range(3)}) == 3  # three distinct streams
    want = np.asarray(jax_layers.mrope(jnp.asarray(x), jnp.asarray(pos), theta, sections))
    got = layers.mrope(torch.from_numpy(x), torch.from_numpy(pos), theta, sections)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16), ((16, 24, 24), 128)],
                         ids=["reduced", "published"])
def test_mrope_equals_rope_on_equal_streams(sections, hd, dtype):
    """t = h = w: every band's angle is rope's, so the outputs are equal."""
    b, s, h = 3, 9, 2
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((b, s, h, hd))
                         .astype(np.float32)).to(dtype)
    pos = torch.from_numpy(np.random.default_rng(8).integers(-2, 5000, (b, s)))
    got = layers.mrope(x, pos[None].expand(3, b, s), 1_000_000.0, sections)
    want = layers.rope(x, pos, 1_000_000.0)
    assert got.dtype == dtype and torch.equal(got, want)


def test_mrope_rejects_sections_that_do_not_cover_half_the_head():
    x = torch.zeros((1, 2, 1, 16))
    with pytest.raises(ValueError, match="head_dim/2"):
        layers.mrope(x, torch.zeros((3, 1, 2), dtype=torch.int64), 1e4, (2, 3, 2))
    with pytest.raises(ValueError, match="streams"):
        layers.mrope(x, torch.zeros((2, 1, 2), dtype=torch.int64), 1e4, (2, 3, 3))
