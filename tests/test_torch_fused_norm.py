"""The port's fused norms (``galvatron_tpu_torch/ops/fused_norm.py``) and the
``fused_norm=True`` model path against the JAX package on the CPU.

The plain versions of the four kernel functions are held to the Pallas
kernels (``_rms_fwd``, ``_rms_bwd``, ``_ln_fwd``, ``_ln_bwd`` with
``interpret=True``), the public functions and their gradients to
``fused_rmsnorm`` / ``fused_layernorm`` / ``fused_add_rmsnorm`` with
``force_pallas=True`` under ``jax.grad``, and the model's loss, every
gradient and a 5-step trajectory with ``fused_norm=True`` to the JAX model
with the same flag (on the CPU its norms take their plain reference, as in
the JAX package's own tests). On the CPU the port's wrappers run the plain
versions through the same ``torch.autograd.Function``s the card uses, so
the hand-written backward formulas are what is compared. Inputs come from
numpy seeds and go to both sides as the same arrays; fp32 unless said."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galvatron_tpu.core import optim as jopt
from galvatron_tpu.core.strategy import HybridParallelConfig
from galvatron_tpu.models import modeling as jm
from galvatron_tpu.ops import fused_norm as jfn
from galvatron_tpu.parallel import hybrid as jhybrid
from galvatron_tpu.parallel.mesh import build_mesh
from galvatron_tpu_torch import bridge
from galvatron_tpu_torch.core import dataloader as tdl
from galvatron_tpu_torch.core import optim as topt
from galvatron_tpu_torch.core import trainer
from galvatron_tpu_torch.core.arguments import initialize_galvatron
from galvatron_tpu_torch.core.optim import tree_leaves
from galvatron_tpu_torch.models import generation
from galvatron_tpu_torch.models import modeling as tm
from galvatron_tpu_torch.ops import fused_norm as fn
from galvatron_tpu_torch.parallel import hybrid as thybrid

H = 256  # tiles the 128-wide gate
N = 1030  # rows: not a power of two, two Pallas row blocks of 515
EPS = 1e-5
# fp32 on both sides, row and column sums in other orders: outputs and row
# statistics within 1e-5, gradients (column sums over 1030 rows) within 1e-4,
# the tolerances of tests/test_fused_norm.py
FWD_TOL = 1e-5
BWD_TOL = 1e-4
# bf16 in and out with fp32 statistics: one bf16 rounding of values up to ~4
BF16_TOL = 2e-2
# the model tolerances of test_torch_training.py / test_torch_gpt.py
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-6
GRAD_SCALE_TOL = 5e-6
TRAJ_ATOL = 1e-4


def _rand(*shape, seed=0, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).standard_normal(shape) * scale + shift).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)  # a copy: jax arrays are read-only


def _np(a):
    a = a.detach() if torch.is_tensor(a) else a
    return np.asarray(a.float() if torch.is_tensor(a) else a.astype(jnp.float32), np.float32)


def _close(got, ref, tol, what):
    np.testing.assert_allclose(_np(got), _np(ref), atol=tol, rtol=tol, err_msg=what)


def _inputs():
    x = _rand(N, H, seed=0, scale=1.5, shift=0.3)
    dy = _rand(N, H, seed=1)
    g = _rand(H, seed=2, scale=0.1, shift=1.0)
    b = _rand(H, seed=3, scale=0.1)
    return x, dy, g, b


# ---------------------------------------------------------------------------
# The four plain kernel functions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def test_rms_fwd_plain_matches_the_pallas_kernel():
    x, _, g, _ = _inputs()
    jy, jr = jfn._rms_fwd(jnp.asarray(x), jnp.asarray(g), EPS, True)
    y, r = fn.rms_fwd_plain(_t(x), _t(g), EPS)
    assert r.shape == (N, 1) and r.dtype == torch.float32
    _close(y, jy, FWD_TOL, "y")
    _close(r, jr, FWD_TOL, "rstd")


def test_rms_bwd_plain_matches_the_pallas_kernel():
    x, dy, g, _ = _inputs()
    _, jr = jfn._rms_fwd(jnp.asarray(x), jnp.asarray(g), EPS, True)
    jdx, jdg = jfn._rms_bwd(jnp.asarray(x), jnp.asarray(g), jr, jnp.asarray(dy), True)
    dx, dg = fn.rms_bwd_plain(_t(x), _t(g), _t(jr), _t(dy))
    assert dg.shape == (H,) and dg.dtype == torch.float32
    _close(dx, jdx, BWD_TOL, "dx")
    _close(dg, jdg, BWD_TOL, "dscale")


def test_ln_fwd_plain_matches_the_pallas_kernel():
    x, _, g, b = _inputs()
    jy, jmu, jrstd = jfn._ln_fwd(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), EPS, True)
    y, mu, rstd = fn.ln_fwd_plain(_t(x), _t(g), _t(b), EPS)
    assert mu.shape == rstd.shape == (N, 1)
    _close(y, jy, FWD_TOL, "y")
    _close(mu, jmu, FWD_TOL, "mu")
    _close(rstd, jrstd, FWD_TOL, "rstd")


def test_ln_bwd_plain_matches_the_pallas_kernel():
    x, dy, g, b = _inputs()
    _, jmu, jrstd = jfn._ln_fwd(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), EPS, True)
    jdx, jdg, jdb = jfn._ln_bwd(jnp.asarray(x), jnp.asarray(g), jmu, jrstd, jnp.asarray(dy), True)
    dx, dg, db = fn.ln_bwd_plain(_t(x), _t(g), _t(jmu), _t(jrstd), _t(dy))
    _close(dx, jdx, BWD_TOL, "dx")
    _close(dg, jdg, BWD_TOL, "dscale")
    _close(db, jdb, BWD_TOL, "dbias")


@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_wrappers_run_the_plain_versions_on_the_cpu_and_launch_nothing(norm):
    """On a CPU tensor a wrapper returns exactly its plain version's result
    and counts no launch."""
    x, dy, g, b = map(_t, _inputs())
    fn.reset_launch_counts()
    if norm == "rms":
        y, r = fn.rms_fwd(x, g, EPS)
        ry, rr = fn.rms_fwd_plain(x, g, EPS)
        got, want = (y, r, *fn.rms_bwd(x, g, r, dy)), (ry, rr, *fn.rms_bwd_plain(x, g, rr, dy))
    else:
        y, mu, r = fn.ln_fwd(x, g, b, EPS)
        ry, rmu, rr = fn.ln_fwd_plain(x, g, b, EPS)
        got = (y, mu, r, *fn.ln_bwd(x, g, mu, r, dy))
        want = (ry, rmu, rr, *fn.ln_bwd_plain(x, g, rmu, rr, dy))
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)
    assert fn.launch_counts() == {"rms_fwd": 0, "rms_bwd": 0, "ln_fwd": 0, "ln_bwd": 0}


# ---------------------------------------------------------------------------
# The public functions and their gradients against force_pallas under jax.grad
# ---------------------------------------------------------------------------


def _torch_grads(f, *arrays, dtype=torch.float32):
    leaves = [_t(a, dtype if i == 0 else torch.float32).requires_grad_(True)
              for i, a in enumerate(arrays)]
    out = f(*leaves)
    torch.sin(out.float()).sum().backward()
    return out, [t.grad for t in leaves]


def test_fused_rmsnorm_and_gradients_match_jax_over_leading_dims():
    x, g = _rand(3, 5, H, seed=4, scale=1.5), _rand(H, seed=5, scale=0.1, shift=1.0)
    jf = lambda x_, g_: jfn.fused_rmsnorm(x_, g_, EPS, force_pallas=True)  # noqa: E731
    jy = jf(jnp.asarray(x), jnp.asarray(g))
    jgrads = jax.grad(lambda *a: jnp.sum(jnp.sin(jf(*a))), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(g))
    y, grads = _torch_grads(lambda x_, g_: fn.fused_rmsnorm(x_, g_, EPS), x, g)
    assert y.shape == (3, 5, H)
    _close(y, jy, FWD_TOL, "y")
    for name, a, b in zip(("dx", "dscale"), grads, jgrads):
        _close(a, b, BWD_TOL, name)


def test_fused_layernorm_and_gradients_match_jax_over_leading_dims():
    x = _rand(2, 3, 4, H, seed=6, scale=2.0, shift=0.5)
    g, b = _rand(H, seed=7, scale=0.1, shift=1.0), _rand(H, seed=8, scale=0.1)
    jf = lambda x_, g_, b_: jfn.fused_layernorm(x_, g_, b_, EPS, force_pallas=True)  # noqa: E731
    args = tuple(map(jnp.asarray, (x, g, b)))
    jy = jf(*args)
    jgrads = jax.grad(lambda *a: jnp.sum(jnp.sin(jf(*a))), argnums=(0, 1, 2))(*args)
    y, grads = _torch_grads(lambda x_, g_, b_: fn.fused_layernorm(x_, g_, b_, EPS), x, g, b)
    assert y.shape == (2, 3, 4, H)
    _close(y, jy, FWD_TOL, "y")
    for name, a, b_ in zip(("dx", "dscale", "dbias"), grads, jgrads):
        _close(a, b_, BWD_TOL, name)


def test_fused_add_rmsnorm_and_gradients_match_jax():
    x, res = _rand(2, 4, H, seed=9), _rand(2, 4, H, seed=10)
    g = _rand(H, seed=11, scale=0.1, shift=1.0)

    def jloss(x_, r_, g_):
        y, s = jfn.fused_add_rmsnorm(x_, r_, g_, EPS, force_pallas=True)
        return jnp.sum(jnp.sin(y)) + jnp.sum(s * s)

    args = tuple(map(jnp.asarray, (x, res, g)))
    jy, js = jfn.fused_add_rmsnorm(*args, EPS, force_pallas=True)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*args)
    leaves = [_t(a).requires_grad_(True) for a in (x, res, g)]
    y, s = fn.fused_add_rmsnorm(*leaves, EPS)
    (torch.sin(y).sum() + (s * s).sum()).backward()
    _close(s, js, 1e-6, "x + residual")
    _close(y, jy, FWD_TOL, "y")
    for name, t, j in zip(("dx", "dresidual", "dscale"), leaves, jgrads):
        _close(t.grad, j, BWD_TOL, name)


@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_bf16_in_and_out_with_fp32_statistics(norm):
    """bf16 rows, fp32 scale/bias and statistics: the output is bf16 and
    within one rounding (2e-2 at these magnitudes) of the Pallas kernel's;
    dx comes back in bf16, dscale in the parameter's fp32."""
    x = _rand(2, 4, H, seed=12)
    g, b = _rand(H, seed=13, scale=0.1, shift=1.0), _rand(H, seed=14, scale=0.1)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = _t(x, torch.bfloat16).requires_grad_(True)
    tg, tb = _t(g).requires_grad_(True), _t(b).requires_grad_(True)
    if norm == "rms":
        jy = jfn.fused_rmsnorm(jx, jnp.asarray(g), EPS, force_pallas=True)
        y = fn.fused_rmsnorm(tx, tg, EPS)
    else:
        jy = jfn.fused_layernorm(jx, jnp.asarray(g), jnp.asarray(b), EPS, force_pallas=True)
        y = fn.fused_layernorm(tx, tg, tb, EPS)
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    _close(y, jy, BF16_TOL, "y")
    y.float().sum().backward()
    assert tx.grad.dtype == torch.bfloat16 and tg.grad.dtype == torch.float32
    assert torch.isfinite(tx.grad.float()).all()


@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_a_width_that_does_not_tile_takes_the_plain_reference_on_both_sides(norm, monkeypatch):
    """H = 100 fails the ``H % 128`` gate: both packages return their plain
    reference and the port never reaches a wrapper."""
    assert not fn._tiles(100) and not jfn._tiles(100) and fn._tiles(H) and jfn._tiles(H)

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was reached")

    for name in ("rms_fwd", "ln_fwd"):
        monkeypatch.setattr(fn, name, refuse)
    x = _rand(2, 3, 100, seed=15)
    g, b = _rand(100, seed=16, scale=0.1, shift=1.0), _rand(100, seed=17, scale=0.1)
    if norm == "rms":
        got = fn.fused_rmsnorm(_t(x), _t(g), EPS)
        want = jfn.fused_rmsnorm(jnp.asarray(x), jnp.asarray(g), EPS, force_pallas=True)
        assert torch.equal(got, fn.rmsnorm_ref(_t(x), _t(g), EPS))
    else:
        got = fn.fused_layernorm(_t(x), _t(g), _t(b), EPS)
        want = jfn.fused_layernorm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), EPS,
                                   force_pallas=True)
        assert torch.equal(got, fn.layernorm_ref(_t(x), _t(g), _t(b), EPS))
    _close(got, want, 1e-6, "plain path")


@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_plain_references_match_jax(norm):
    x = _rand(3, 7, 100, seed=18, scale=2.0, shift=-0.4)
    g, b = _rand(100, seed=19, scale=0.1, shift=1.0), _rand(100, seed=20, scale=0.1)
    if norm == "rms":
        _close(fn.rmsnorm_ref(_t(x), _t(g), EPS),
               jfn.rmsnorm_ref(jnp.asarray(x), jnp.asarray(g), EPS), 1e-6, "rmsnorm_ref")
    else:
        _close(fn.layernorm_ref(_t(x), _t(g), _t(b), EPS),
               jfn.layernorm_ref(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), EPS), 1e-6,
               "layernorm_ref")


# ---------------------------------------------------------------------------
# The wrappers' contract and the autograd entries
# ---------------------------------------------------------------------------


def _bad_operands():
    x, dy, g, b = map(_t, _inputs())
    r = torch.ones(N, 1)
    return {
        "fp16 rows": (TypeError, lambda: fn.rms_fwd(x.half(), g, EPS)),
        "width off the 128 gate": (ValueError, lambda: fn.rms_fwd(x[:, :100].contiguous(),
                                                                  g[:100].contiguous(), EPS)),
        "width past MAX_HIDDEN": (ValueError, lambda: fn.ln_fwd(
            torch.zeros(2, fn.MAX_HIDDEN + 128), torch.ones(fn.MAX_HIDDEN + 128),
            torch.zeros(fn.MAX_HIDDEN + 128), EPS)),
        "strided rows": (ValueError, lambda: fn.rms_fwd(x[:, ::2][:, :128], g[:128].contiguous(),
                                                        EPS)),
        "bf16 scale": (ValueError, lambda: fn.rms_fwd(x, g.bfloat16(), EPS)),
        "no rows": (ValueError, lambda: fn.rms_fwd(x[:0], g, EPS)),
        "3-d rows": (ValueError, lambda: fn.ln_fwd(x[None], g, b, EPS)),
        "dy of another dtype": (ValueError, lambda: fn.rms_bwd(x, g, r, dy.bfloat16())),
        "dy of another shape": (ValueError, lambda: fn.ln_bwd(x, g, r, r, dy[:-1])),
        "statistics of another shape": (ValueError, lambda: fn.ln_bwd(x, g, r[:, 0], r, dy)),
    }


@pytest.mark.parametrize("case", sorted(_bad_operands()))
def test_wrappers_raise_on_what_the_kernels_do_not_take(case):
    """The kernels' contract holds on every device: what the card would
    refuse raises on the CPU too, never a quiet other path."""
    exc, call = _bad_operands()[case]
    with pytest.raises(exc):
        call()


def test_functions_save_what_the_reference_rules_save_and_cast_parameter_gradients():
    """``_rmsnorm_fwd_rule`` saves (x2d, scale, r), ``_layernorm_fwd_rule``
    (x2d, scale, mu, rstd); dscale / dbias come back in the parameter's
    dtype."""
    x = _t(_rand(6, H, seed=21)).requires_grad_(True)
    g, b = _t(_rand(H, seed=22, shift=1.0)), _t(_rand(H, seed=23))
    y = fn.FusedRMSNorm.apply(x, g.requires_grad_(True), EPS)
    saved = y.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [(6, H), (H,), (6, 1)]
    y = fn.FusedLayerNorm.apply(x, g, b, EPS)
    assert [tuple(t.shape) for t in y.grad_fn.saved_tensors] == [(6, H), (H,), (6, 1), (6, 1)]
    gb, bb = (t.detach().bfloat16().requires_grad_(True) for t in (g, b))
    fn.fused_layernorm(x, gb, bb, EPS).sum().backward()
    assert gb.grad.dtype == bb.grad.dtype == torch.bfloat16 and x.grad.dtype == torch.float32


def test_functions_look_their_wrappers_up_at_call_time(monkeypatch):
    """A comparison swaps a wrapper for another function on the module; the
    autograd entries must then call that one."""
    calls = []

    def spy(name):
        real = getattr(fn, name)

        def wrapped(*a, **k):
            calls.append(name)
            return real(*a, **k)

        return wrapped

    for name in ("rms_fwd", "rms_bwd", "ln_fwd", "ln_bwd"):
        monkeypatch.setattr(fn, name, spy(name))
    x = _t(_rand(4, H, seed=24)).requires_grad_(True)
    g, b = _t(_rand(H, seed=25, shift=1.0)), _t(_rand(H, seed=26))
    fn.fused_rmsnorm(x, g, EPS).sum().backward()
    fn.fused_layernorm(x, g, b, EPS).sum().backward()
    assert calls == ["rms_fwd", "rms_bwd", "ln_fwd", "ln_bwd"]


@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_strided_input_and_expanded_gradient_are_made_unit_stride(norm):
    """x a transposed view and the incoming gradient ``y.sum()``'s expanded
    (stride-0) one: same values as the contiguous call with a dense dy."""
    base = _t(_rand(5, 3, H, seed=27))
    g, b = _t(_rand(H, seed=28, scale=0.1, shift=1.0)), _t(_rand(H, seed=29, scale=0.1))
    f = (lambda x_: fn.fused_rmsnorm(x_, g, EPS)) if norm == "rms" else (
        lambda x_: fn.fused_layernorm(x_, g, b, EPS))
    xv = base.clone().requires_grad_(True)
    y = f(xv.transpose(0, 1))
    assert not xv.transpose(0, 1).is_contiguous()
    y.sum().backward()
    xc = base.transpose(0, 1).contiguous().requires_grad_(True)
    yc = f(xc)
    (yc * torch.ones_like(yc)).sum().backward()
    assert torch.equal(y, yc)
    assert torch.equal(xv.grad.transpose(0, 1), xc.grad)


# ---------------------------------------------------------------------------
# The model with fused_norm=True against the JAX model with fused_norm=True
# ---------------------------------------------------------------------------

SHAPE = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=4, max_seq_len=64)
_GPT = dict(SHAPE, use_bias=True, pos_embed="learned", norm_type="layernorm",
            tie_word_embeddings=True)
FAMILIES = {
    "llama": dict(SHAPE, ffn_dim=256),
    "gpt": dict(_GPT, act_fn="gelu"),
    "opt": dict(_GPT, act_fn="relu"),
}


def _cfgs(family, attn="xla", recompute="policy", fused=True):
    kw = dict(FAMILIES[family], attn_impl=attn, mlp_recompute=recompute, fused_norm=fused)
    return (jm.ModelConfig(dtype=jnp.float32, **kw), tm.ModelConfig(dtype=torch.float32, **kw))


def _jax_params(jcfg, seed=0):
    """The JAX init with every bias and norm parameter redrawn (the init's
    zeros and ones would leave their paths untested)."""
    rng = np.random.RandomState(seed + 100)

    def redraw(path, a):
        key = jax.tree_util.keystr(path)
        if key.endswith("_b']") or key.endswith("'bias']"):
            return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        if key.endswith("'scale']"):
            return (1 + rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        return a

    params = jax.tree.map(np.asarray, jm.init_model_params(jax.random.key(seed), jcfg))
    return jax.tree_util.tree_map_with_path(redraw, params)


def _batch(b, s, seed=1):
    return np.random.RandomState(seed).randint(0, SHAPE["vocab_size"], (b, s + 1)).astype(np.int32)


def _torch_params(np_params, tcfg):
    params = bridge.params_from_jax(np_params, tcfg, "cpu")
    for t in tree_leaves(params):
        t.requires_grad_(True)
    return params


def _assert_leaves_close(torch_leaves, jax_tree, atol, what, scale_tol=0.0):
    jl = jax.tree_util.tree_leaves(jax_tree)
    assert len(torch_leaves) == len(jl)
    for i, (t, j) in enumerate(zip(torch_leaves, jl)):
        ref = np.asarray(j, np.float32)
        np.testing.assert_allclose(t.detach().float().numpy(), ref,
                                   atol=atol + scale_tol * float(np.abs(ref).max()), rtol=0,
                                   err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("family", ["llama", "opt"])
def test_fused_norm_equals_the_plain_norm_in_the_port(family):
    """``fused_norm`` changes which code computes the norms and what is
    saved, not the values: loss within 1e-6, gradients within 2e-6, under
    every recompute mode and per-layer checkpointing."""
    ref = _jax_params(_cfgs(family)[0], seed=3)
    batch = torch.from_numpy(_batch(2, 64, seed=4)).long()
    results = []
    for fused, recompute, ckpt in [(False, "off", "none"), (True, "off", "none"),
                                   (True, "gate", "none"), (True, "policy", "none"),
                                   (True, "policy", "full"), (True, "policy", "selective")]:
        _, tcfg = _cfgs(family, "flash", recompute, fused)
        params = _torch_params(ref, tcfg)
        loss = tm.lm_loss(params, batch, tcfg, layer_hook=thybrid._make_layer_hook(tcfg, ckpt))
        loss.backward()
        results.append((float(loss.detach()), [p.grad.clone() for p in tree_leaves(params)]))
    base_loss, base_grads = results[0]
    for loss, grads in results[1:]:
        assert abs(loss - base_loss) <= 1e-6
        for a, b in zip(grads, base_grads):
            torch.testing.assert_close(a, b, atol=2e-6, rtol=0)


def test_policy_with_fused_norm_leaves_the_one_region_branch(monkeypatch):
    """Under 'policy' + ``fused_norm`` the MLP branch is the plain one with
    the product-only recompute (``_ActDown``), never ``_MLPBranch``; without
    ``fused_norm`` it is the region."""
    seen = []
    for cls in (tm._MLPBranch, tm._ActDown):
        real = cls.apply
        monkeypatch.setattr(cls, "apply", staticmethod(
            lambda *a, _real=real, _name=cls.__name__: (seen.append(_name), _real(*a))[1]))
    batch = torch.from_numpy(_batch(2, 64)).long()
    for fused, want in ((True, {"_ActDown"}), (False, {"_MLPBranch"})):
        _, tcfg = _cfgs("llama", "xla", "policy", fused)
        params = _torch_params(_jax_params(_cfgs("llama")[0]), tcfg)
        seen.clear()
        tm.lm_loss(params, batch, tcfg).backward()
        assert set(seen) == want and len(seen) == 2


def _count_calls(monkeypatch, names):
    calls = {name: 0 for name in names}

    def spy(name):
        real = getattr(fn, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return real(*a, **k)

        return wrapped

    for name in names:
        monkeypatch.setattr(fn, name, spy(name))
    return calls


@pytest.mark.parametrize("ckpt,chunks,fwd_per_layer", [("none", 1, 2), ("selective", 1, 2),
                                                       ("full", 1, 4), ("none", 2, 2)])
def test_build_runtime_carries_fused_norm_under_every_ckpt_mode(monkeypatch, ckpt, chunks,
                                                                fwd_per_layer):
    """``rt.cfg`` keeps the field; a step calls the forward wrapper 2 x
    layers + 1 times a micro-batch (a fully recomputed layer runs it again
    inside the checkpoint) and the backward wrapper 2 x layers + 1 times."""
    _, tcfg = _cfgs("llama", "flash")
    rt = thybrid.build_runtime(tcfg, global_batch_size=4, seq_len=64, chunks=chunks, ckpt=ckpt,
                               mixed_precision="fp32", device="cpu")
    assert rt.cfg.fused_norm
    calls = _count_calls(monkeypatch, ("rms_fwd", "rms_bwd", "ln_fwd", "ln_bwd"))
    state = rt.init_state(0)
    _, loss = rt.train_step(state, torch.from_numpy(_batch(4, 64)))
    layers = tcfg.num_layers
    assert torch.isfinite(loss)
    assert calls == {"rms_fwd": (fwd_per_layer * layers + 1) * chunks,
                     "rms_bwd": (2 * layers + 1) * chunks, "ln_fwd": 0, "ln_bwd": 0}


#: (family, chunks, ckpt) of the 5-step trajectories, one file a family
#: (``tests/test_torch_fused_norm_{llama,gpt,opt}.py``) so that the suite's
#: workers share them
TRAJECTORY_CASES = [("llama", 1, "none"), ("llama", 2, "none"), ("llama", 1, "full"),
                    ("gpt", 1, "none"), ("gpt", 2, "none"), ("opt", 1, "none"),
                    ("opt", 2, "none")]


def five_step_trajectory(family, chunks, ckpt):
    """The whole fp32 train step with ``fused_norm=True`` on the flash path
    against the JAX runtime on a one-device mesh: the loss of each of 5
    AdamW steps and the parameters after them within 1e-4.

    ReLU (opt) is the one exception, with or without ``fused_norm``: a
    pre-activation within rounding of zero gates the other way in the two
    packages, which switches one token's whole contribution to that hidden
    unit's weights on or off, and AdamW normalises the difference to steps
    of up to lr. A few units' columns (under 1 % of a leaf) then drift, by
    at most 5 steps x lr; every other element, and every loss, stays within
    1e-4."""
    jcfg, tcfg = _cfgs(family, "flash")
    adam = dict(lr=1e-3, weight_decay=0.01, grad_clip=1.0)
    mesh, axes = build_mesh(pp=1, devices=jax.devices()[:1])
    hp = HybridParallelConfig.uniform(2, mixed_precision="fp32", chunks=chunks,
                                      ckpt={"none": False, "full": "full"}[ckpt])
    jrt = jhybrid.build_runtime(jcfg, hp, mesh=mesh, axes=axes, adam=jopt.AdamConfig(**adam),
                                global_batch_size=4, seq_len=64)
    ref = _jax_params(jcfg, seed=5)
    jstate = jrt.init_state_from(jax.tree.map(jnp.asarray, ref))
    trt = thybrid.build_runtime(tcfg, adam=topt.AdamConfig(**adam), global_batch_size=4, seq_len=64,
                                chunks=chunks, ckpt=ckpt, mixed_precision="fp32", device="cpu")
    tstate = trt.state_from(bridge.params_from_jax(ref, tcfg, "cpu"))
    loader = tdl.build_dataloader(tcfg, 4, 64, seed=9)
    for step in range(5):
        batch = next(loader)
        jstate, jloss = jrt.train_step(jstate, jnp.asarray(batch))
        tstate, tloss = trt.train_step(tstate, torch.from_numpy(batch))
        assert abs(float(tloss) - float(jloss)) <= TRAJ_ATOL, f"step {step}"
    # the key slot of the qkv bias has an exactly-zero gradient (softmax
    # ignores a per-row constant): AdamW amplifies the rounding noise left
    # there to ~lr a step, so that slot is held to 5 steps x lr
    tleaves, jleaves = [], []
    for t, (path, j) in zip(tree_leaves(tstate["params"]),
                            jax.tree_util.tree_flatten_with_path(jstate["params"])[0]):
        j = np.asarray(j)
        if jax.tree_util.keystr(path).endswith("'wqkv_b']"):
            np.testing.assert_allclose(t[1].detach().numpy(), j[1], atol=5 * adam["lr"], rtol=0)
            t, j = t[[0, 2]], j[[0, 2]]
        tleaves.append(t)
        jleaves.append(j)
    if family != "opt":
        _assert_leaves_close(tleaves, jleaves, TRAJ_ATOL, "params after 5 steps")
        return
    for i, (t, j) in enumerate(zip(tleaves, jleaves)):
        diff = np.abs(t.detach().numpy() - j)
        assert diff.max() <= 5 * adam["lr"] + TRAJ_ATOL, f"leaf {i}: {diff.max()}"
        assert (diff > TRAJ_ATOL).mean() <= 0.01, f"leaf {i}: {(diff > TRAJ_ATOL).mean()}"


def test_trainer_takes_a_model_config_and_reports_the_norm_counters(capsys):
    """``fused_norm`` has no flag (the reference has none): ``train(ns,
    cfg=...)`` is the entry. The returned launch counts cover the four norm
    kernels (0 on the CPU, where the plain versions run)."""
    ns = initialize_galvatron("train", [
        "--device", "cpu", "--train_iters", "2", "--global_train_batch_size", "2",
        "--mixed_precision", "fp32", "--check_loss", "1"])
    _, tcfg = _cfgs("opt")
    fn.reset_launch_counts()
    out = trainer.train(ns, cfg=tcfg.replace(max_seq_len=32))
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert {"rms_fwd", "rms_bwd", "ln_fwd", "ln_bwd", "flash_fwd", "flash_grid_dq"} <= set(
        out["launches"])
    assert not any(out["launches"][k] for k in ("rms_fwd", "rms_bwd", "ln_fwd", "ln_bwd"))
    assert "fused_norm=True" in capsys.readouterr().out


def test_serving_forward_reaches_the_fused_norm_when_the_field_is_set(monkeypatch):
    """``generation.forward_with_cache_paged`` goes through ``modeling.norm``:
    with the field set every norm of a call is the fused forward, and the
    logits equal the plain path's."""
    cfg = tm.ModelConfig(vocab_size=97, hidden_size=128, num_layers=2, num_heads=4, ffn_dim=256,
                         max_seq_len=64, dtype=torch.float32)
    params = tm.init_model_params(cfg, 0, "cpu")
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, 97, (2, 8)))
    tables = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    offsets = torch.zeros(2, dtype=torch.int32)
    logits = {}
    calls = _count_calls(monkeypatch, ("rms_fwd",))
    with torch.inference_mode():
        for fused in (False, True):
            c = cfg.replace(fused_norm=fused)
            pool = generation.init_kv_cache(c, 9, 16, "cpu")
            logits[fused], _ = generation.forward_with_cache_paged(params, tokens, c, pool,
                                                                   tables, offsets)
    assert calls["rms_fwd"] == 2 * cfg.num_layers + 1
    torch.testing.assert_close(logits[True], logits[False], atol=1e-5, rtol=0)
