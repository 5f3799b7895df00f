"""Kimi Delta Attention (KDA), the linear-attention mixer of
`models/kimi_linear.py`: a per-channel gated delta rule (Kimi Linear,
arXiv:2510.26692; flash-linear-attention's `fla/layers/kda.py`).

Per doc and head, with a state S [dk, dv] that starts at zero:

    S_t = (I − β_t k_t k_tᵀ) Diag(α_t) S_{t−1} + β_t k_t v_tᵀ,   o_t = S_tᵀ q_t

α_t = exp(g_t) per key channel (g ≤ 0), β_t one value a head, q scaled by
`scale`. `kda` runs it chunk by chunk (C = 64 positions): inside a chunk,
with Γ_i the running sum of g up to position i of the chunk and S_0 the
state entering it,

    A_ij = Σ_c k_ic k_jc exp(Γ_ic − Γ_jc)  (i > j),   T = (I + Diag(β) A)⁻¹
    P_ij = Σ_c q_ic k_jc exp(Γ_ic − Γ_jc)  (i ≥ j)
    W = T Diag(β) (v − (exp(Γ) ⊙ k) S_0)                 (the WY/UT form)
    O = (exp(Γ) ⊙ q) S_0 + P W
    S_C = Diag(exp(Γ_C)) S_0 + (exp(Γ_C − Γ) ⊙ k)ᵀ W

Each exponent is a difference Γ_i − Γ_j with i ≥ j, or Γ_i itself, so it is
≤ 0 and nothing overflows whatever the decay (exp(−Γ) alone would).

On a CUDA tensor `kda` launches the two kernels of `csrc/kda.cu`
(`kda_intra_kernel`: every chunk's T, W's parts, Q̃, K̂ and P in parallel;
`kda_state_kernel`: the sequential pass of the state over the chunks, dv
cut in slices so that two docs of 32 heads fill the card; products on
mma.sync with bf16 operands, the state and sums in fp32). On the CPU it
takes the plain version `kda_chunked_reference`, the same algebra in the
input's float type (float32 or float64) chunk by chunk, vectorised over
docs and heads. Both return o [B, L, H, dv] in fp32. Positions are on the
right of each row's doc: padding after the doc never reaches it.

The mixer's elementwise passes around it are here too, each one pass over
its rows on a card, its plain torch version on the CPU: `conv_silu` (the
short causal convolution, SiLU and, for q and k, the per-head L2 norm:
`kda_conv_kernel`), `decay` (g = −exp(A_log)·softplus(f + dt_bias):
`kda_gate_kernel`) and `gated_norm` (RMSNorm(o)·w·sigmoid(gate):
`kda_gated_norm_kernel`).

Counters: `kda.launches.<kernel>` for the five, and
`kda.plain_calls.<plain>` for `kda_chunked_reference`,
`conv_silu_reference`, `decay_reference` and `gated_norm_reference`. The
mixer's span `encoder.attn.linear` is the model's (`models/kimi_linear.py`).
They replace no TPU kernel: the JAX package has no linear attention.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import tracing
from .kernel_build import library

CHUNK = 64
# (dk, dv) the kernels are built for: the published widths and the test ones
DIMS = ((128, 128), (16, 16))
_LAUNCH = "kda.launches."
_PLAIN = "kda.plain_calls."


def kda_chunked_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                          beta: torch.Tensor, scale: float, chunk: int = CHUNK) -> torch.Tensor:
    """Plain version: q, k [B, L, H, dk], v [B, L, H, dv], g [B, L, H, dk]
    (log-decays, ≤ 0), beta [B, L, H] -> o [B, L, H, dv] in fp32 (float64
    for float64 inputs), computed as the module docstring's chunked form,
    one chunk at a time."""
    tracing.count(_PLAIN + "kda_chunked_reference")
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    B, L, H, dk = q.shape
    dv = v.shape[-1]
    pad = (-L) % chunk

    def heads(t):  # [B, L, H, d] -> [B, H, L + pad, d] in acc
        t = t.to(acc).transpose(1, 2)
        return torch.nn.functional.pad(t, (0, 0, 0, pad)) if pad else t

    qh, kh, vh, gh = heads(q) * scale, heads(k), heads(v), heads(g)
    bh = heads(beta.unsqueeze(-1))[..., 0]
    S = torch.zeros((B, H, dk, dv), dtype=acc, device=q.device)
    out = torch.empty((B, H, L + pad, dv), dtype=acc, device=q.device)
    lower = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    eye = torch.eye(chunk, dtype=acc, device=q.device)
    for s in range(0, L + pad, chunk):
        sl = slice(s, s + chunk)
        qc, kc, vc, bc = qh[:, :, sl], kh[:, :, sl], vh[:, :, sl], bh[:, :, sl]
        G = gh[:, :, sl].cumsum(2)
        diff = G[:, :, :, None, :] - G[:, :, None, :, :]  # [B, H, i, j, dk]
        decay = torch.where(lower[:, :, None], diff, float("-inf")).exp()
        kd = decay * kc[:, :, None, :, :]
        A = (kc[:, :, :, None, :] * kd).sum(-1).tril(-1)
        P = (qc[:, :, :, None, :] * kd).sum(-1)
        M = eye + bc[..., None] * A
        eg = G.exp()
        rhs = bc[..., None] * torch.cat([eg * kc, vc], dim=-1)
        X = torch.linalg.solve_triangular(M, rhs, upper=False, unitriangular=True)
        W = X[..., dk:] - X[..., :dk] @ S
        out[:, :, sl] = (eg * qc) @ S + P @ W
        kend = ((G[:, :, -1:] - G).exp() * kc).transpose(-1, -2)
        S = G[:, :, -1, :, None].exp() * S + kend @ W
    return out[:, :, :L].transpose(1, 2).contiguous()


def short_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The causal depthwise convolution over positions: x [B, L, C], w [C,
    K] fp32 -> [B, L, C] fp32, out_t = Σ_s w[:, s]·x_{t−K+1+s}, zeros before
    position 0 (each row's doc starts at 0)."""
    K = w.shape[1]
    xf = x.float()
    out = xf * w[:, K - 1]
    for s in range(1, K):
        out[:, s:].addcmul_(xf[:, :-s], w[:, K - 1 - s])
    return out


def conv_silu_reference(x: torch.Tensor, w: torch.Tensor, d: int, norm: bool) -> torch.Tensor:
    """Plain version of `conv_silu`, in fp32, returned in x's dtype."""
    tracing.count(_PLAIN + "conv_silu_reference")
    B, L, _ = x.shape
    y = torch.nn.functional.silu(short_conv(x, w)).view(B, L, -1, d)
    if norm:
        y = y * torch.rsqrt(y.pow(2).sum(-1, keepdim=True) + 1e-6)
    return y.to(x.dtype)


def decay_reference(f: torch.Tensor, a_log: torch.Tensor, dt_bias: torch.Tensor,
                    d: int) -> torch.Tensor:
    """Plain version of `decay`."""
    tracing.count(_PLAIN + "decay_reference")
    B, L, _ = f.shape
    g = torch.nn.functional.softplus(f + dt_bias).mul_(-a_log.exp().repeat_interleave(d))
    return g.view(B, L, -1, d)


def gated_norm_reference(o: torch.Tensor, w: torch.Tensor, gate: torch.Tensor, eps: float,
                         dtype: torch.dtype) -> torch.Tensor:
    """Plain version of `gated_norm`, in fp32, returned in `dtype`."""
    tracing.count(_PLAIN + "gated_norm_reference")
    of = o.float()
    y = of * torch.rsqrt(of.pow(2).mean(-1, keepdim=True) + eps) * w
    return (y * torch.sigmoid(gate.view(o.shape))).to(dtype)


def conv_silu(x: torch.Tensor, w: torch.Tensor, d: int, norm: bool) -> torch.Tensor:
    """x [B, L, H·d] (a projection's output), w [H·d, K] fp32 -> [B, L, H, d]
    in x's dtype: SiLU of the causal depthwise convolution (zeros before
    each row's position 0), each head's row divided by sqrt(Σ y² + 1e-6)
    when `norm`; in fp32 inside. `kda_conv_kernel` on a card (bf16)."""
    if x.device.type == "cpu":
        return conv_silu_reference(x, w, d, norm)
    B, L, C = x.shape
    if x.dtype != torch.bfloat16 or x.stride(-1) != 1:
        raise TypeError(f"kda_conv_kernel takes bf16 with a unit last stride, got {x.dtype}")
    w = w.float().contiguous()
    y = torch.empty((B, L, C), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().kda_conv_bf16(x.data_ptr(), x.stride(0), x.stride(1), w.data_ptr(),
                                  y.data_ptr(), B, L, C // d, d, w.shape[1], int(norm),
                                  _stream(x))
    _check("kda_conv_kernel", rc)
    return y.view(B, L, C // d, d)


def decay(f: torch.Tensor, a_log: torch.Tensor, dt_bias: torch.Tensor, d: int) -> torch.Tensor:
    """The log-decays g = −exp(A_log[h])·softplus(f + dt_bias) of f [B, L,
    H·d] fp32 (u·W_fa·W_fb) -> [B, L, H, d] fp32. `kda_gate_kernel` on a
    card."""
    if f.device.type == "cpu":
        return decay_reference(f, a_log, dt_bias, d)
    B, L, C = f.shape
    f = f.float().contiguous()
    a_log, dt_bias = a_log.float().contiguous(), dt_bias.float().contiguous()
    g = torch.empty_like(f)
    with torch.cuda.device(f.device):
        rc = _lib().kda_gate_f32(f.data_ptr(), a_log.data_ptr(), dt_bias.data_ptr(),
                                 g.data_ptr(), f.numel(), C // d, d, _stream(f))
    _check("kda_gate_kernel", rc)
    return g.view(B, L, C // d, d)


def gated_norm(o: torch.Tensor, w: torch.Tensor, gate: torch.Tensor, eps: float,
               dtype: torch.dtype) -> torch.Tensor:
    """The output's gated norm: o [B, L, H, dv] fp32 over each head's row,
    RMSNorm(o)·w·sigmoid(gate) with gate [B, L, H·dv] fp32 -> [B, L, H, dv]
    in `dtype`. `kda_gated_norm_kernel` on a card (bf16)."""
    if o.device.type == "cpu":
        return gated_norm_reference(o, w, gate, eps, dtype)
    if dtype != torch.bfloat16:
        raise TypeError(f"kda_gated_norm_kernel writes bf16, not {dtype}")
    o, gate, w = o.float().contiguous(), gate.float().contiguous(), w.float().contiguous()
    d = o.shape[-1]
    out = torch.empty(o.shape, dtype=dtype, device=o.device)
    with torch.cuda.device(o.device):
        rc = _lib().kda_gated_norm_f32(o.data_ptr(), w.data_ptr(), gate.data_ptr(),
                                       out.data_ptr(), o.numel() // d, d, float(eps), _stream(o))
    _check("kda_gated_norm_kernel", rc)
    return out


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _lib():
    lib = library("kda")
    if not getattr(lib, "_argtypes_set", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.kda_conv_bf16.argtypes = [p, ll, ll, p, p, i, i, i, i, i, i, p]
        lib.kda_conv_bf16.restype = i
        lib.kda_gate_f32.argtypes = [p, p, p, p, ll, i, i, p]
        lib.kda_gate_f32.restype = i
        lib.kda_gated_norm_f32.argtypes = [p, p, p, p, ll, i, ctypes.c_float, p]
        lib.kda_gated_norm_f32.restype = i
        lib.kda_intra_bf16.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                                       ctypes.c_float, p]
        lib.kda_intra_bf16.restype = i
        lib.kda_state_bf16.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
        lib.kda_state_bf16.restype = i
        lib.kda_chunk.argtypes = []
        lib.kda_chunk.restype = i
        if lib.kda_chunk() != CHUNK:
            raise RuntimeError(f"kda kernels take chunks of {lib.kda_chunk()}, not {CHUNK}")
        lib._argtypes_set = True
    return lib


def _check(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    tracing.count(_LAUNCH + name)


def _launch(q, k, v, g, beta, scale):
    B, L, H, dk = q.shape
    dv = v.shape[-1]
    if (dk, dv) not in DIMS:
        raise ValueError(f"kda kernels take (dk, dv) in {DIMS}, got {(dk, dv)}")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"kda kernels take bf16 q, k, v, got {q.dtype}, {k.dtype}, {v.dtype}")
    g, beta = g.float(), beta.float()
    ts = (q, k, v, g, beta.unsqueeze(-1))
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("kda kernels want the last dim contiguous")
    strides = (ctypes.c_longlong * 15)(*[s for t in ts for s in t.stride()[:3]])
    N = -(-L // CHUNK)
    dev = dict(device=q.device)
    wk = torch.empty((B, H, N, CHUNK * dk), dtype=torch.bfloat16, **dev)
    qg, kgt = torch.empty_like(wk), torch.empty_like(wk)
    p = torch.empty((B, H, N, CHUNK * CHUNK), dtype=torch.bfloat16, **dev)
    u = torch.empty((B, H, N, CHUNK * dv), dtype=torch.float32, **dev)
    gend = torch.empty((B, H, N, dk), dtype=torch.float32, **dev)
    o = torch.empty((B, L, H, dv), dtype=torch.float32, **dev)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.kda_intra_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                                beta.data_ptr(), strides, wk.data_ptr(), u.data_ptr(),
                                qg.data_ptr(), kgt.data_ptr(), p.data_ptr(), gend.data_ptr(),
                                B, L, H, dk, dv, float(scale), stream)
        _check("kda_intra_kernel", rc)
        rc = lib.kda_state_bf16(wk.data_ptr(), u.data_ptr(), qg.data_ptr(), kgt.data_ptr(),
                                p.data_ptr(), gend.data_ptr(), o.data_ptr(), B, L, H, dk, dv,
                                stream)
        _check("kda_state_kernel", rc)
    return o


def kda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, beta: torch.Tensor,
        scale: float) -> torch.Tensor:
    """The KDA recurrence over q, k [B, L, H, dk], v [B, L, H, dv] (the
    compute dtype; bf16 on a card), g [B, L, H, dk] log-decays and beta
    [B, L, H] (fp32) -> o [B, L, H, dv] fp32: the kernels on a CUDA tensor,
    the plain version on the CPU."""
    if q.shape != k.shape or q.shape != g.shape or v.shape[:3] != q.shape[:3] \
            or tuple(beta.shape) != tuple(q.shape[:3]):
        raise ValueError(f"kda wants q, k, g [B, L, H, dk], v [B, L, H, dv], beta [B, L, H]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(g.shape)}, {tuple(beta.shape)}")
    if q.device.type == "cpu":
        return kda_chunked_reference(q, k, v, g, beta, scale)
    return _launch(q, k, v, g, beta, scale)
