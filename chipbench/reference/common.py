"""Plain fp32 PyTorch operations shared by the families' references.

No kernel, no cache, no batching tricks: the textbook forms, with TF32
off.  ``quant="fp8"`` rounds both operands of every projection to
float8 e4m3 (the activations per row, the weights per output column,
each scaled to the format's largest value) and multiplies them in fp32:
the control, the precision below the bf16 that the configurations
state.  The router and the LM head stay fp32 under it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def as_run(c: dict, key: str):
    """A key's value as the program runs it: the file's, or the ``run``
    value of the key's entry under ``departures``."""
    d = c.get("departures", {})
    return d[key]["run"] if key in d else c[key]


def strict_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to e4m3 with one scale per slice along ``dim``."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def proj(x: torch.Tensor, w: torch.Tensor, quant: str | None) -> torch.Tensor:
    """``x @ w`` in fp32 (a projection: the weight is (in, out))."""
    w = w.float()
    if quant == "fp8":
        return fp8(x, -1) @ fp8(w, 0)
    if quant is not None:
        raise ValueError(f"unknown quantization {quant!r}")
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x / rms(x) * (1 + w)."""
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * (1.0 + w.float())


def act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu_pytorch_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def glu(x, w_gate, w_up, w_down, activation: str, quant) -> torch.Tensor:
    return proj(act(activation, proj(x, w_gate, quant)) * proj(x, w_up, quant), w_down, quant)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, Dh) rotated by position (0..S-1), the two halves of
    each head as the real and imaginary parts."""
    s, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float64) / dh))
    ang = (torch.arange(s, dtype=torch.float64)[:, None] * inv).to(x.device)
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    a, b = x[..., : dh // 2], x[..., dh // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(c: dict, p: dict, x: torch.Tensor, quant) -> torch.Tensor:
    """Causal multi-head attention with rotary positions over (B, S, D)."""
    b, s, _ = x.shape
    h, kh, dh = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    q = rope(proj(x, p["wq"], quant).view(b, s, h, dh), c["rope_theta"])
    k = rope(proj(x, p["wk"], quant).view(b, s, kh, dh), c["rope_theta"])
    v = proj(x, p["wv"], quant).view(b, s, kh, dh)
    k = k.repeat_interleave(h // kh, dim=2)
    v = v.repeat_interleave(h // kh, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    future = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
    w = torch.softmax(logits.masked_fill(future, float("-inf")), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, s, h * dh)
    return proj(out, p["wo"], quant)


def head(c: dict, params: dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm and LM head, fp32; columns past the vocabulary masked."""
    logits = rms_norm(x, params["final_norm"], c["rms_norm_eps"]) @ params["lm_head"].float()
    if logits.shape[-1] > c["vocab_size"]:
        logits[..., c["vocab_size"]:] = float("-inf")
    return logits


def layer(tree: dict, *index: int) -> dict:
    """One layer's leaves of a tree stacked on leading layer axes."""
    return {k: layer(v, *index) if isinstance(v, dict) else v[index]
            for k, v in tree.items()}
