"""Fused RMSNorm / LayerNorm, forward and backward.

Counterpart of ``galvatron_tpu/ops/fused_norm.py``, with its public names:
:func:`fused_rmsnorm`, :func:`fused_layernorm`, :func:`fused_add_rmsnorm`
over ``(..., H)``, the plain references :func:`rmsnorm_ref` /
:func:`layernorm_ref`, and the ``_tiles`` gate (``H % 128 == 0``; any other
width takes the plain reference, as there). ``modeling.norm`` comes here
when ``ModelConfig.fused_norm`` is set.

Each of the four kernel functions (``_rms_fwd``, ``_rms_bwd``, ``_ln_fwd``,
``_ln_bwd`` of the reference) has three pieces, side by side:

- a plain PyTorch version with the kernel's outputs, written from the
  kernel body's formulas and not as autograd of the forward, so that the
  backward arithmetic itself is what the tests hold to the JAX package
  (:func:`rms_fwd_plain`, :func:`rms_bwd_plain`, :func:`ln_fwd_plain`,
  :func:`ln_bwd_plain`);
- a wrapper (:func:`rms_fwd`, :func:`rms_bwd`, :func:`ln_fwd`,
  :func:`ln_bwd`): a CPU tensor goes to the plain version, a CUDA tensor
  launches the hand-written Hopper kernel of ``csrc/fused_norm.cu`` or
  raises. There is no fall back from the card to the plain version;
- a launch counter on the wrapper (``rms_fwd.launches``, ...), a plain
  integer incremented where the kernel is launched and nowhere else, and
  the same count by row width (``ln_fwd.widths``: {H: launches}) and by
  row dtype (``ln_fwd.dtypes``: {"torch.float16": launches, ...}).

:class:`FusedRMSNorm` and :class:`FusedLayerNorm` are the
``torch.autograd.Function``s over ``(n, H)`` rows (the reference's
``jax.custom_vjp`` pairs): the forward saves ``(x, scale, rstd)`` /
``(x, scale, mu, rstd)``, the backward is the backward kernel, and the
scale and bias gradients come back in the parameter's dtype. They look the
wrappers up when called, so a comparison can swap in the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from galvatron_tpu_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the widest row the kernels take (a thread owns at most 32 columns)
MAX_HIDDEN = 8192


# ---------------------------------------------------------------------------
# Plain references of the public functions
# ---------------------------------------------------------------------------


def rmsnorm_ref(x, scale, eps: float = 1e-5):
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * r * scale.float()).to(x.dtype)


def layernorm_ref(x, scale, bias, eps: float = 1e-5):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Plain versions of the four kernel functions
# ---------------------------------------------------------------------------


def rms_fwd_plain(x2d, scale, eps: float):
    """``_rms_fwd_kernel``: (y (n, H) in x's dtype, fp32 rstd (n, 1))."""
    x = x2d.float()
    r = torch.rsqrt((x * x).mean(dim=1, keepdim=True) + eps)
    return (x * r * scale.float()).to(x2d.dtype), r


def rms_bwd_plain(x2d, scale, rstd, dy):
    """``_rms_bwd_kernel``: (dx (n, H) in x's dtype, fp32 dscale (H,)).
    ``dx = r·(dy·g) − x·r³·Σ_j(dy_j g_j x_j)/H``; ``dscale = Σ_rows dy·x·r``."""
    x, g, r, dy32 = x2d.float(), scale.float(), rstd.float(), dy.float()
    dyg = dy32 * g
    dot = (dyg * x).sum(dim=1, keepdim=True)
    dx = r * dyg - x * (r * r * r) * (dot / x.shape[1])
    return dx.to(x2d.dtype), (dy32 * x * r).sum(dim=0)


def ln_fwd_plain(x2d, scale, bias, eps: float):
    """``_ln_fwd_kernel``: (y (n, H) in x's dtype, fp32 mu (n, 1), fp32 rstd
    (n, 1)); the variance is the mean of the centred squares."""
    x = x2d.float()
    mu = x.mean(dim=1, keepdim=True)
    xc = x - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=1, keepdim=True) + eps)
    return (xc * rstd * scale.float() + bias.float()).to(x2d.dtype), mu, rstd


def ln_bwd_plain(x2d, scale, mu, rstd, dy):
    """``_ln_bwd_kernel``: (dx (n, H) in x's dtype, fp32 dscale (H,), fp32
    dbias (H,)). ``dx = rstd·(dy·g − mean(dy·g) − x̂·mean(dy·g·x̂))``;
    ``dscale = Σ_rows dy·x̂``; ``dbias = Σ_rows dy``."""
    x, g, dy32 = x2d.float(), scale.float(), dy.float()
    xhat = (x - mu) * rstd
    dxhat = dy32 * g
    m1 = dxhat.mean(dim=1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=1, keepdim=True)
    dx = rstd * (dxhat - m1 - xhat * m2)
    return dx.to(x2d.dtype), (dy32 * xhat).sum(dim=0), dy32.sum(dim=0)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(name, x2d, vectors=(), stats=(), like=()):
    """The kernels' contract, on every device: contiguous (n, H) rows in
    bf16, fp16 or fp32 with n >= 1, H % 128 == 0 and H <= MAX_HIDDEN; contiguous
    fp32 (H,) ``vectors`` (scale, bias) and (n, 1) ``stats`` (rstd, mu);
    ``like`` tensors of x's shape and dtype, contiguous; all on one device."""
    if x2d.dim() != 2 or x2d.shape[0] < 1:
        raise ValueError(f"{name}: x must be (n, H) with n >= 1, got {tuple(x2d.shape)}")
    n, h = x2d.shape
    if x2d.dtype not in _DTYPE_CODE:
        raise TypeError(f"the {name} kernel takes bf16, fp16 or fp32 rows, got {x2d.dtype}")
    if not _tiles(h) or h > MAX_HIDDEN:
        raise ValueError(f"the {name} kernel takes H % 128 == 0 and H <= {MAX_HIDDEN}, got {h}")
    for t in like:
        if t.shape != x2d.shape or t.dtype != x2d.dtype:
            raise ValueError(f"{name}: dy must match x ({tuple(x2d.shape)}, {x2d.dtype}), got "
                             f"{tuple(t.shape)}, {t.dtype}")
    for t in vectors:
        if t.dtype != torch.float32 or tuple(t.shape) != (h,):
            raise ValueError(f"{name}: scale and bias must be fp32 ({h},), got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in stats:
        if t.dtype != torch.float32 or tuple(t.shape) != (n, 1):
            raise ValueError(f"{name}: row statistics must be fp32 ({n}, 1), got {t.dtype} "
                             f"{tuple(t.shape)}")
    tensors = (x2d, *like, *vectors, *stats)
    if any(t.device != x2d.device for t in tensors):
        raise ValueError(f"{name}: every operand must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"the {name} kernel takes contiguous tensors only")
    if x2d.device.type != "cpu" and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: every operand must be 16-byte aligned")


def _fn(name: str, n_ptrs: int, n_ints: int, n_floats: int = 0):
    """The ctypes function ``name`` of ``csrc/fused_norm.cu``: ``n_ptrs``
    pointers, ``n_ints`` ints, ``n_floats`` floats and the stream."""
    fn = getattr(_build.load("fused_norm"), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [
        ctypes.c_float] * n_floats + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name, x2d, fn, *args):
    with torch.cuda.device(x2d.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _bwd_blocks(x2d, layernorm: bool) -> int:
    """Blocks the backward kernel runs: what the card holds resident at
    once, at most one per row. Each writes one workspace row."""
    fn = _build.load("fused_norm").galvatron_fused_norm_bwd_blocks
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    n, h = x2d.shape
    with torch.cuda.device(x2d.device):
        resident = fn(int(layernorm), _DTYPE_CODE[x2d.dtype], h)
    if resident < 1:
        raise RuntimeError(f"the fused norm backward kernel cannot run at H={h}, {x2d.dtype}")
    return min(n, resident)


def rms_fwd(x2d, scale, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """RMSNorm forward over rows: (y (n, H) in x's dtype, fp32 rstd
    (n, 1)). CPU tensors run :func:`rms_fwd_plain`; CUDA tensors launch the
    forward kernel of ``csrc/fused_norm.cu``."""
    _check("rms_fwd", x2d, vectors=(scale,))
    if x2d.device.type == "cpu":
        return rms_fwd_plain(x2d, scale, eps)
    n, h = x2d.shape
    y = torch.empty_like(x2d)
    rstd = torch.empty((n, 1), dtype=torch.float32, device=x2d.device)
    _launch("rms_fwd", x2d, _fn("galvatron_rms_fwd", 4, 3, 1), x2d.data_ptr(), scale.data_ptr(),
            y.data_ptr(), rstd.data_ptr(), _DTYPE_CODE[x2d.dtype], n, h, float(eps))
    _count("rms_fwd", x2d)
    return y, rstd


rms_fwd.launches = 0
rms_fwd.widths = {}
rms_fwd.dtypes = dict.fromkeys(map(str, _DTYPE_CODE), 0)


def rms_bwd(x2d, scale, rstd, dy) -> Tuple[torch.Tensor, torch.Tensor]:
    """RMSNorm backward over rows: (dx (n, H) in x's dtype, fp32 dscale
    (H,)). CPU tensors run :func:`rms_bwd_plain`; CUDA tensors launch the
    backward kernel and the column-sum kernel of ``csrc/fused_norm.cu``
    (deterministic: per-block partial sums in a workspace, no atomics)."""
    _check("rms_bwd", x2d, vectors=(scale,), stats=(rstd,), like=(dy,))
    if x2d.device.type == "cpu":
        return rms_bwd_plain(x2d, scale, rstd, dy)
    n, h = x2d.shape
    blocks = _bwd_blocks(x2d, False)
    dx = torch.empty_like(x2d)
    dscale = torch.empty((h,), dtype=torch.float32, device=x2d.device)
    ws = torch.empty((blocks, h), dtype=torch.float32, device=x2d.device)
    _launch("rms_bwd", x2d, _fn("galvatron_rms_bwd", 7, 4), x2d.data_ptr(), scale.data_ptr(),
            rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(), dscale.data_ptr(), ws.data_ptr(),
            blocks, _DTYPE_CODE[x2d.dtype], n, h)
    _count("rms_bwd", x2d)
    return dx, dscale


rms_bwd.launches = 0
rms_bwd.widths = {}
rms_bwd.dtypes = dict.fromkeys(map(str, _DTYPE_CODE), 0)


def ln_fwd(x2d, scale, bias, eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LayerNorm forward over rows: (y (n, H) in x's dtype, fp32 mu (n, 1),
    fp32 rstd (n, 1)). CPU tensors run :func:`ln_fwd_plain`; CUDA tensors
    launch the forward kernel of ``csrc/fused_norm.cu``."""
    _check("ln_fwd", x2d, vectors=(scale, bias))
    if x2d.device.type == "cpu":
        return ln_fwd_plain(x2d, scale, bias, eps)
    n, h = x2d.shape
    y = torch.empty_like(x2d)
    mu = torch.empty((n, 1), dtype=torch.float32, device=x2d.device)
    rstd = torch.empty((n, 1), dtype=torch.float32, device=x2d.device)
    _launch("ln_fwd", x2d, _fn("galvatron_ln_fwd", 6, 3, 1), x2d.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), y.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
            _DTYPE_CODE[x2d.dtype], n, h, float(eps))
    _count("ln_fwd", x2d)
    return y, mu, rstd


ln_fwd.launches = 0
ln_fwd.widths = {}
ln_fwd.dtypes = dict.fromkeys(map(str, _DTYPE_CODE), 0)


def ln_bwd(x2d, scale, mu, rstd, dy) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LayerNorm backward over rows: (dx (n, H) in x's dtype, fp32 dscale
    (H,), fp32 dbias (H,)). CPU tensors run :func:`ln_bwd_plain`; CUDA
    tensors launch the backward kernel and the column-sum kernel of
    ``csrc/fused_norm.cu`` (deterministic, no atomics)."""
    _check("ln_bwd", x2d, vectors=(scale,), stats=(mu, rstd), like=(dy,))
    if x2d.device.type == "cpu":
        return ln_bwd_plain(x2d, scale, mu, rstd, dy)
    n, h = x2d.shape
    blocks = _bwd_blocks(x2d, True)
    dx = torch.empty_like(x2d)
    dscale = torch.empty((h,), dtype=torch.float32, device=x2d.device)
    dbias = torch.empty((h,), dtype=torch.float32, device=x2d.device)
    ws = torch.empty((2, blocks, h), dtype=torch.float32, device=x2d.device)
    _launch("ln_bwd", x2d, _fn("galvatron_ln_bwd", 9, 4), x2d.data_ptr(), scale.data_ptr(),
            mu.data_ptr(), rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
            dbias.data_ptr(), ws.data_ptr(), blocks, _DTYPE_CODE[x2d.dtype], n, h)
    _count("ln_bwd", x2d)
    return dx, dscale, dbias


ln_bwd.launches = 0
ln_bwd.widths = {}
ln_bwd.dtypes = dict.fromkeys(map(str, _DTYPE_CODE), 0)


#: the wrappers by name, whatever a caller has swapped in on the module for
#: a comparison: the counts live on these
_WRAPPERS = {"rms_fwd": rms_fwd, "rms_bwd": rms_bwd, "ln_fwd": ln_fwd, "ln_bwd": ln_bwd}


def _count(name: str, x2d) -> None:
    """One launch of kernel ``name`` over the rows ``x2d``."""
    fn = _WRAPPERS[name]
    fn.launches += 1
    fn.widths[x2d.shape[1]] = fn.widths.get(x2d.shape[1], 0) + 1
    fn.dtypes[str(x2d.dtype)] += 1


def launch_counts() -> dict:
    """The four kernels' launch counts as they stand."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def width_counts() -> dict:
    """The four kernels' launch counts by row width: {name: {H: launches}}."""
    return {name: dict(fn.widths) for name, fn in _WRAPPERS.items()}


def dtype_counts() -> dict:
    """The four kernels' launch counts by row dtype: {name: {dtype: launches}}."""
    return {name: dict(fn.dtypes) for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
        fn.widths.clear()
        fn.dtypes.update(dict.fromkeys(fn.dtypes, 0))


# ---------------------------------------------------------------------------
# Autograd entries (the reference's custom_vjp pairs)
# ---------------------------------------------------------------------------


def _rows(t):
    """``t`` with unit-stride rows: x may be a non-contiguous view, an
    incoming gradient an expanded one (stride 0, e.g. from ``y.sum()``)."""
    return t if t.is_contiguous() else t.contiguous()


class FusedRMSNorm(torch.autograd.Function):
    """``_rmsnorm`` over (n, H) rows: saves (x, scale, rstd)."""

    @staticmethod
    def forward(ctx, x2d, scale, eps):
        x2d, scale32 = _rows(x2d), _rows(scale.float())
        y, rstd = rms_fwd(x2d, scale32, eps)
        ctx.save_for_backward(x2d, scale32, rstd)
        ctx.scale_dtype = scale.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, scale32, rstd = ctx.saved_tensors
        dx, dscale = rms_bwd(x2d, scale32, rstd, _rows(dy.to(x2d.dtype)))
        return dx, dscale.to(ctx.scale_dtype), None


class FusedLayerNorm(torch.autograd.Function):
    """``_layernorm`` over (n, H) rows: saves (x, scale, mu, rstd)."""

    @staticmethod
    def forward(ctx, x2d, scale, bias, eps):
        x2d, scale32, bias32 = _rows(x2d), _rows(scale.float()), _rows(bias.float())
        y, mu, rstd = ln_fwd(x2d, scale32, bias32, eps)
        ctx.save_for_backward(x2d, scale32, mu, rstd)
        ctx.param_dtypes = (scale.dtype, bias.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, scale32, mu, rstd = ctx.saved_tensors
        dx, dscale, dbias = ln_bwd(x2d, scale32, mu, rstd, _rows(dy.to(x2d.dtype)))
        return dx, dscale.to(ctx.param_dtypes[0]), dbias.to(ctx.param_dtypes[1]), None


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _tiles(h: int) -> bool:
    """The reference's gate: the kernels run where H is a multiple of 128
    (here: whole 16-byte vectors in every dtype), else the plain reference."""
    return h % 128 == 0


def fused_rmsnorm(x, scale, eps: float = 1e-5):
    """RMSNorm over the last dim. x: (..., H); scale: (H,). Through
    :class:`FusedRMSNorm` where ``H % 128 == 0``, else :func:`rmsnorm_ref`."""
    h = x.shape[-1]
    if not _tiles(h):
        return rmsnorm_ref(x, scale, eps)
    return FusedRMSNorm.apply(x.reshape(-1, h), scale, eps).reshape(x.shape)


def fused_layernorm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last dim. x: (..., H); scale, bias: (H,)."""
    h = x.shape[-1]
    if not _tiles(h):
        return layernorm_ref(x, scale, bias, eps)
    return FusedLayerNorm.apply(x.reshape(-1, h), scale, bias, eps).reshape(x.shape)


def fused_add_rmsnorm(x, residual, scale, eps: float = 1e-5):
    """(normed, new_residual) where new_residual = x + residual and normed
    = rmsnorm(new_residual): the residual add ahead of the norm's one pass
    over the row."""
    s = x + residual
    return fused_rmsnorm(s, scale, eps), s
