"""The plain twins of the flash backward kernels' tiled walks against the
JAX package's Pallas kernels in interpret mode (``_flash_bwd_blocked``,
``_flash_bwd_parts``), and against the whole-row plain versions at ragged
s; split from ``tests/test_torch_flash_attention.py`` (whose helpers and
tolerances they use) so that the suite's workers can share the load."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galvatron_tpu.ops import flash_attention as jfa
from galvatron_tpu_torch.ops import flash_attention as tfa
from test_torch_flash_attention import TILE_CASES, _arrays, _t, _tables, _tiles_close
import _torch_threads  # noqa: F401


# the blocked pair's TMA route also runs at fp16 (the grid kernels' does not:
# TILE_CASES, which their tests read, stays bf16 / fp32)
BLOCKED_TILE_CASES = TILE_CASES + [(64, "fp16"), (128, "fp16")]
_DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
           "fp16": (jnp.float16, torch.float16)}


@pytest.mark.parametrize("d,dtype", BLOCKED_TILE_CASES)
def test_bwd_tiles_plain_matches_jax_blocked_kernel(d, dtype):
    """The blocked kernels' decomposition (the pre-pass's q', k' and delta,
    dk/dv summed per 128-key block over walked query tiles from the
    diagonal, dq per 128-query block over walked key tiles) against
    ``_flash_bwd_blocked`` in interpret mode (512-key blocks cut to 128, q
    sub-blocks of 64) at s = 384: three owned blocks, diagonal tiles of
    both walk sizes."""
    b, h, s = 1, 2, 384
    sm = 1 / np.sqrt(d)
    q, k, v, do = _arrays([(b, h, s, d)] * 4, seed=70 + d)
    cos, sin = _tables(s, d)
    jdt, tdt = _DTYPES[dtype]
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    out, lse = jfa._flash_fwd_blocked(jq, jk, jv, (cos, sin), sm, 128, True)
    jgrads = jfa._flash_bwd_blocked(jq, jk, jv, jdo, out, lse, (cos, sin), sm, 128, 64, True)
    tq, tk, tv, tdo = (_t(a, tdt).detach() for a in (q, k, v, do))
    tout = torch.from_numpy(np.array(out.astype(jnp.float32))).to(tdt)
    tcos, tsin = torch.from_numpy(cos), torch.from_numpy(sin)
    qr, kr, delta = tfa.flash_bwd_prepass_plain(tq, tk, tdo, tout, tcos, tsin, sm)
    tgrads = tfa.flash_bwd_tiles_plain(qr, kr, tv, tdo, torch.from_numpy(np.array(lse)), delta,
                                       sm, rope=(tcos, tsin))
    for got, ref in zip(tgrads, jgrads):
        assert got.dtype == tdt
        _tiles_close(got, ref.astype(jnp.float32), dtype)


@pytest.mark.parametrize("d,dtype", TILE_CASES)
@pytest.mark.parametrize("causal,rope", [(True, False), (False, False), (True, True),
                                         (False, True)])
def test_bwd_tiles_plain_matches_jax_grid_kernels(d, dtype, causal, rope):
    """The grid dk/dv decomposition (scale after the product, dk scaled by
    sm_scale, counter-rotated only with RoPE; q, k roped through the
    unscaled tables by the pre-pass, or raw) against ``_flash_bwd_parts`` in
    interpret mode (64-row blocks) on caller-given row statistics, causal or
    not, with and without RoPE, at s = 256."""
    b, h, s = 1, 2, 256
    sm = 1 / np.sqrt(d)
    q, k, v, do = _arrays([(b, h, s, d)] * 4, seed=80 + d + 2 * causal + rope)
    rng = np.random.RandomState(5)
    lse = (rng.standard_normal((b, h, s, 1)) * 0.1 + np.log(s)).astype(np.float32)
    delta = rng.standard_normal((b, h, s, 1)).astype(np.float32)
    tables = _tables(s, d) if rope else None
    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jgrads = jfa._flash_bwd_parts(*(jnp.asarray(a, jdt) for a in (q, k, v, do)), lse, delta,
                                  tables, sm, causal, 64, 64, True)
    tq, tk, tv, tdo = (_t(a, tdt).detach() for a in (q, k, v, do))
    trope = None if tables is None else tuple(torch.from_numpy(t) for t in tables)
    if trope is not None:  # the pre-pass with the unscaled tables on both
        tq, tk = tfa.rope_k_plain(tq, *trope), tfa.rope_k_plain(tk, *trope)
    tgrads = tfa.flash_bwd_tiles_plain(tq, tk, tv, tdo, torch.from_numpy(lse),
                                       torch.from_numpy(delta), sm, causal=causal, grid=True,
                                       rope=trope)
    for got, ref in zip(tgrads, jgrads):
        _tiles_close(got, ref.astype(jnp.float32), dtype)


@pytest.mark.parametrize("s", [100, 200, 300])
@pytest.mark.parametrize("walk", [64, 128])
def test_bwd_tiles_plain_matches_the_whole_row_plain_at_ragged_s(s, walk):
    """At an s no tile divides, the decomposition (the last owned block and
    walked tile partly past s, masked) equals the whole-row plain versions
    in fp32 within the summation-order tolerance: blocked, and grid causal
    and not, at both walked-tile sizes."""
    b, h, d = 1, 2, 32
    sm = 0.2
    q, k, v, do = (torch.from_numpy(a) for a in _arrays([(b, h, s, d)] * 4, seed=s + walk))
    cos, sin = (torch.from_numpy(t) for t in _tables(s, d))
    out, lse = tfa.flash_fwd_blocked_plain(q, k, v, cos, sin, sm)
    qr, kr, delta = tfa.flash_bwd_prepass_plain(q, k, do, out, cos, sin, sm)
    got = tfa.flash_bwd_tiles_plain(qr, kr, v, do, lse, delta, sm, rope=(cos, sin), walk=walk)
    ref = tfa.flash_bwd_blocked_plain(q, k, v, do, out, lse, cos, sin, sm)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5, rtol=0)
    for causal in (True, False):
        out, lse = tfa.flash_fwd_grid_plain(q, k, v, None, sm, causal)
        delta = (do * out).sum(-1, keepdim=True)
        got = tfa.flash_bwd_tiles_plain(q, k, v, do, lse, delta, sm, causal=causal, grid=True,
                                        walk=walk)
        ref = tfa.flash_bwd_grid_plain(q, k, v, do, lse, delta, None, sm, causal)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5, rtol=0)
