"""Mamba-2 (state-space duality) mixer (the port's half of the JAX package's
``models/mamba.py``: ``_dims`` .. ``mamba_decode``, :35-262).

The full-sequence forward (training and prefill) goes through
``ops.ssd_scan``, the chunked SSD scan (in training through its autograd
Function, whose gradients reach the conv output that B and C are views of):
on a CUDA tensor the hand-written kernel, on a CPU tensor (or with
``ops.PLAIN``) the plain
``kernels.ref.ssd_chunked``, the twin of the reference's. Decode is the O(1)
recurrent update ``h = dA*h + dt*x (x) B; y = C.h + D*x``, which the reference
computes outside any kernel and the port in plain PyTorch. The gated norm goes
to ``ops.rmsnorm``.

On a mesh the mixer runs on the rank's heads of ``d_inner``: ``w_z``,
``w_x``, ``w_dt``, ``dt_bias``, ``A_log``, ``D``, ``conv_x``, ``norm`` and
``w_out`` are sharded over ``"model"``; ``w_bc`` and ``conv_bc`` are
replicated, B and C are computed whole on every rank and enter the model
region after their conv, so their gradient is summed over the ranks. The
gated norm normalises over the whole of ``d_inner``: on a model axis of more
than one rank its mean of squares is summed over ``"model"`` in plain
PyTorch (the kernel sees only the local slice); at one rank it is the
``ops.rmsnorm`` kernel, as without a mesh. Serving on a mesh keeps the
rank's heads of the SSD state and its channels of ``conv_x``
(``mamba_cache_spec``), ``conv_bc`` whole: ``mamba_prefill`` and
``mamba_decode`` take ``par`` as the training forward does.

Unlike the JAX package, whose arrays are immutable, ``mamba_decode`` updates
the cache it is given (the conv windows and the fp32 state) in place.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.common import rmsnorm
from repro_torch.models.parallel import copy_to_model, group_slice, reduce_from_model, sum_in_model, tensor_parallel
from repro_torch.models.params import ParamDef, const_init, fan_in_init, normal_init, ones_init

Cache = Dict[str, torch.Tensor]


def _dims(cfg: ArchConfig) -> Tuple[int, int, int, int, int]:
    s = cfg.ssm
    if s is None:
        raise ValueError(f"{cfg.name}: an SSM layer needs an SSMConfig")
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    return d_in, H, s.head_dim, s.n_groups, s.d_state


def mamba_def(cfg: ArchConfig) -> Dict[str, ParamDef]:
    d_in, H, P_, G, N = _dims(cfg)
    d, W = cfg.d_model, cfg.ssm.conv_width
    return {
        "w_z": ParamDef((d, d_in), (None, "model"), fan_in_init()),
        "w_x": ParamDef((d, d_in), (None, "model"), fan_in_init()),
        "w_bc": ParamDef((d, 2 * G * N), (None, None), fan_in_init()),
        "w_dt": ParamDef((d, H), (None, "model"), fan_in_init()),
        "dt_bias": ParamDef((H,), ("model",), const_init(0.5), torch.float32),
        # A = -exp(A_log) in (-1, 0) per unit dt
        "A_log": ParamDef((H,), ("model",), const_init(0.9), torch.float32),
        "D": ParamDef((H,), ("model",), ones_init(), torch.float32),
        "conv_x": ParamDef((W, d_in), (None, "model"), normal_init(0.1)),
        "conv_bc": ParamDef((W, 2 * G * N), (None, None), normal_init(0.1)),
        "norm": ParamDef((d_in,), ("model",), ones_init(), torch.float32),
        "w_out": ParamDef((d_in, d), ("model", None), fan_in_init()),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv by shifted adds, as the reference (its rounding
    order in bf16, and no cuDNN convolution, whose fp32 default is TF32).
    x (B, S, C), w (W, C)."""
    W, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + pad[:, i : i + S, :] * w[i]
    return out


def _conv_step(window: torch.Tensor, x_new: torch.Tensor, w: torch.Tensor):
    """One decode step of the causal conv. ``window`` (B, W, C) holds the last
    W inputs (oldest first) and is shifted in place: the oldest drops out and
    ``x_new`` (B, C) is appended. Returns (window, conv_out (B, C)), the
    output summed in fp32 and rounded once, as the reference's einsum."""
    window.copy_(torch.cat([window[:, 1:], x_new[:, None, :]], dim=1))
    out = (window.float() * w.float()).sum(dim=1).to(window.dtype)
    return window, out


def _proj_inputs(p, cfg: ArchConfig, x: torch.Tensor, par=None):
    """z, xs, bc, dt: on a mesh z, xs and dt of the rank's heads (x enters
    the model region), bc whole."""
    xr = copy_to_model(x, par)
    z = torch.matmul(xr, p["w_z"])
    xs = torch.matmul(xr, p["w_x"])
    bc = torch.matmul(x, p["w_bc"])
    dt = torch.matmul(xr.float(), p["w_dt"].float())  # fp32, as the reference
    dt = F.softplus(dt + p["dt_bias"])  # (B, S, H) fp32
    return z, xs, bc, dt


def _gated_norm(scale: torch.Tensor, y: torch.Tensor, d_in: int, ops, par, eps: float = 1e-6) -> torch.Tensor:
    """The rmsnorm of ``y`` over the whole of ``d_inner``: the kernel, or on a
    model axis of more than one rank (``y`` the rank's slice) the mean of
    squares summed over ``"model"``."""
    if not tensor_parallel(par):
        return rmsnorm({"scale": scale}, y, ops=ops)
    yf = y.float()
    var = sum_in_model(yf.square().sum(dim=-1, keepdim=True), par) / d_in
    return (yf * torch.rsqrt(var + eps) * scale).to(y.dtype)


def _mixer(p, cfg: ArchConfig, x: torch.Tensor, ops, par=None):
    """Full-sequence mixer -> (out, final SSD state, raw conv inputs xs and bc)."""
    s = cfg.ssm
    d_in, H, P_, G, N = _dims(cfg)
    B, S, _ = x.shape
    z, xs_raw, bc_raw, dt = _proj_inputs(p, cfg, x, par)
    xs = F.silu(_causal_conv(xs_raw, p["conv_x"]))
    bc = copy_to_model(F.silu(_causal_conv(bc_raw, p["conv_bc"])), par)
    g0, g1 = group_slice(H, G, par)
    Bm = bc[..., g0 * N : g1 * N].reshape(B, S, -1, N)  # strided views: the kernel reads them in place
    Cm = bc[..., (G + g0) * N : (G + g1) * N].reshape(B, S, -1, N)
    xh = xs.reshape(B, S, -1, P_)
    A = -torch.exp(p["A_log"])  # (H,)
    log_dA = dt * A  # (B, S, H)
    y, h_final = ops.ssd_scan(xh * dt[..., None], log_dA, Bm, Cm, chunk=s.chunk)
    y = y + xh.float() * p["D"][:, None]
    y = y.reshape(B, S, -1).to(x.dtype)
    y = y * F.silu(z)
    y = _gated_norm(p["norm"], y, d_in, ops, par)
    return reduce_from_model(torch.matmul(y, p["w_out"]), par), h_final, xs_raw, bc_raw


def mamba_forward(p, cfg: ArchConfig, x: torch.Tensor, ops=kernel_ops, par=None) -> torch.Tensor:
    """Full-sequence forward (prefill without the cache). x: (B, S, d_model)."""
    return _mixer(p, cfg, x, ops, par)[0]


def _last_inputs(raw: torch.Tensor, W: int) -> torch.Tensor:
    """The last ``W`` rows of ``raw`` (B, S, C), oldest first, zero-filled
    before the sequence start when S < W (the conv's own zero padding)."""
    return F.pad(raw[:, -W:], (0, 0, max(W - raw.shape[1], 0), 0))


def mamba_prefill(p, cfg: ArchConfig, x: torch.Tensor, ops=kernel_ops, par=None) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence forward that also returns the decode cache (final SSD
    state + conv windows over the last ``conv_width`` raw inputs); on a mesh
    the rank's heads of the state and channels of ``conv_x``, as
    ``mamba_cache_spec`` splits them."""
    out, h_final, xs_raw, bc_raw = _mixer(p, cfg, x, ops, par)
    W = cfg.ssm.conv_width
    cache = {"h": h_final, "conv_x": _last_inputs(xs_raw, W), "conv_bc": _last_inputs(bc_raw, W)}
    return out, cache


def mamba_make_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16, device=None) -> Cache:
    d_in, H, P_, G, N = _dims(cfg)
    W = cfg.ssm.conv_width
    return {
        "h": torch.zeros((batch, H, N, P_), dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, W, d_in), dtype=dtype, device=device),
        "conv_bc": torch.zeros((batch, W, 2 * G * N), dtype=dtype, device=device),
    }


def mamba_cache_spec(cfg: ArchConfig, batch_axes) -> Dict[str, tuple]:
    return {
        "h": (batch_axes, "model", None, None),
        "conv_x": (batch_axes, None, "model"),
        "conv_bc": (batch_axes, None, None),
    }


def mamba_decode(
    p, cfg: ArchConfig, x: torch.Tensor, cache: Cache, ops=kernel_ops, par=None
) -> Tuple[torch.Tensor, Cache]:
    """One-token recurrent step, x: (B, 1, d_model); updates ``cache`` in
    place. On a mesh the rank's heads (its slice of ``d_inner``, its state
    and ``conv_x`` channels), the gated norm summed over ``"model"``, the
    row-parallel ``w_out``."""
    d_in, H, P_, G, N = _dims(cfg)
    B = x.shape[0]
    z, xs, bc, dt = _proj_inputs(p, cfg, x, par)
    _, xs1 = _conv_step(cache["conv_x"], xs[:, 0], p["conv_x"])
    _, bc1 = _conv_step(cache["conv_bc"], bc[:, 0], p["conv_bc"])
    xs1 = F.silu(xs1)
    bc1 = F.silu(bc1)
    Bm = bc1[..., : G * N].reshape(B, G, N)
    Cm = bc1[..., G * N :].reshape(B, G, N)
    rep = H // G
    if rep > 1:
        Bm, Cm = Bm.repeat_interleave(rep, dim=1), Cm.repeat_interleave(rep, dim=1)
    if tensor_parallel(par):  # the groups of the rank's heads
        h0, h1 = par.model_slice(H)
        Bm, Cm = Bm[:, h0:h1], Cm[:, h0:h1]
    xh = xs1.reshape(B, -1, P_).float()
    dt1 = dt[:, 0]  # (B, H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt1 * A)  # (B, H)
    h = cache["h"]
    h.mul_(dA[..., None, None]).add_(
        torch.einsum("bhn,bhp->bhnp", Bm.float(), xh * dt1[..., None])
    )
    y = torch.einsum("bhn,bhnp->bhp", Cm.float(), h)
    y = y + xh * p["D"][:, None]
    y = y.reshape(B, 1, -1).to(x.dtype)
    y = y * F.silu(z)
    y = _gated_norm(p["norm"], y, d_in, ops, par)
    return reduce_from_model(torch.matmul(y, p["w_out"]), par), cache
