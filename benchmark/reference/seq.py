"""The plain reference of the seq family, in torch (float32 arithmetic with
TF32 off). It imports nothing of the program and takes nothing the program
made: it reads the params file itself, and builds every decision's history
again from the records in produce order.

- ``histories``: a record's history is its customer's last ``L`` records up
  to and including it, in produce order, zero left-padded (newest last).
- ``forward``: the sequence scorer at the rounding points the program's
  ``models/seq.py`` states for serving (``logits_readout``): rows
  normalized in float32; every dense product on operands rounded to bf16
  (to nearest, ties to even) summed in float32 (a product of two bf16
  values is exact in float32), plus the float32 bias, then rounded to bf16;
  layer norms with float32 statistics, ``rsqrt(var + 1e-6)`` and a float32
  scale and bias, rounded back to bf16; tanh GELU in float32; sinusoidal
  positions (the sin half then the cos half) of an ``L``-long table, in
  float32, rounded to bf16 and added; attention without a padding mask,
  scores and softmax in float32 at scale ``1/sqrt(Dh)``, the weights
  rounded to bf16 and P.V summed in float32; residual sums rounded to
  bf16; the last block K/V over all ``L`` and Q, proj and MLP for the last
  token only; the head's logit in float32, then the sigmoid.
- ``bits=8``: the control one precision step below, the same forward with
  every dense product taken in int8: weights symmetric per output channel
  (``scale = max(max|W[:, o]| / 127, 1e-8)``), activations symmetric per
  token and dynamic, integer sums exact in float32, then
  ``acc * s_x * scale + b`` in float32.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

EPS = 1e-8


def load(path: str, device: str = "cpu") -> dict:
    """The params file's leaves by name (``blocks/0/qkv/w``, ...) as
    float32 tensors on ``device``."""
    with np.load(path) as z:
        return {k: torch.as_tensor(z[k].astype(np.float32), device=device) for k in z.files}


def same_params(p: dict, served: dict) -> float:
    """The widest gap between the params file's leaves and ``served`` (host
    copies of what the program served, by the same names); inf when the
    names differ."""
    if set(served) != set(p):
        return math.inf
    return max(float(np.max(np.abs(np.asarray(served[k], np.float32)
                                   - p[k].cpu().numpy()), initial=0.0)) for k in p)


def histories(rows: np.ndarray, keys: np.ndarray, index: np.ndarray,
              length: int) -> np.ndarray:
    """(len(index), length, F) float32: the history of each record of
    ``index`` (positions in produce order)."""
    n = len(keys)
    order = np.argsort(keys, kind="stable")  # grouped by customer, produce order within
    where = np.empty(n, np.int64)
    where[order] = np.arange(n)
    sk = keys[order]
    first = np.searchsorted(sk, sk, side="left")  # each sorted slot's customer's first slot
    s = where[np.asarray(index, np.int64)]
    slots = s[:, None] + np.arange(1 - length, 1)[None, :]
    valid = slots >= first[s][:, None]
    out = np.zeros((len(s), length, rows.shape[1]), np.float32)
    out[valid] = rows[order[slots[valid]]]
    return out


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _quantize(t: torch.Tensor, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 values (as float32) and their scale along ``axis``."""
    scale = torch.clamp(t.abs().amax(dim=axis, keepdim=True) / 127.0, min=EPS)
    return torch.clamp(torch.round(t / scale), -127, 127), scale


class Forward:
    """The forward of one params tree at ``bits`` (16: bf16 serving; 8: the
    int8 control)."""

    def __init__(self, p: dict, n_heads: int, bits: int = 16):
        self.p, self.n_heads, self.bits = p, n_heads, bits
        self.n_blocks = sum(1 for k in p if k.startswith("blocks/") and k.endswith("/qkv/w"))
        if bits == 8:
            self.wq = {k: _quantize(v, 0) for k, v in p.items() if k.endswith("/w")}

    def dense(self, h: torch.Tensor, name: str, cols: slice = slice(None)) -> torch.Tensor:
        """(..., Din) bf16 values -> (..., Dout) bf16 values."""
        b = self.p[f"{name}/b"][cols]
        if self.bits == 16:
            return bf16(torch.matmul(bf16(h), bf16(self.p[f"{name}/w"][:, cols])) + b)
        wq, ws = self.wq[f"{name}/w"]
        hq, hs = _quantize(h, -1)
        acc = torch.matmul(hq, wq[:, cols])
        return bf16(acc * hs * ws[:, cols] + b)

    def layer_norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return bf16((x - mu) * torch.rsqrt(var + 1e-6) * self.p[f"{name}/scale"]
                    + self.p[f"{name}/bias"])

    def attention(self, q, k, v):
        b, lq, d = q.shape
        dh = d // self.n_heads

        def heads(t):
            return t.reshape(b, t.shape[1], self.n_heads, dh).transpose(1, 2)

        scale = 1.0 / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32))
        s = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * scale.to(q.device)
        a = bf16(torch.matmul(bf16(torch.softmax(s, dim=-1)), heads(v)))
        return a.transpose(1, 2).reshape(b, lq, d)

    def positions(self, length: int, d: int, device) -> torch.Tensor:
        pos = torch.arange(length, device=device, dtype=torch.float32)[:, None]
        dim = torch.arange(d // 2, device=device, dtype=torch.float32)[None, :]
        log_base = torch.log(torch.tensor(10000.0, dtype=torch.float32, device=device))
        freq = torch.exp(-log_base * 2.0 * dim / d)
        angles = pos * freq
        return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, F) float32 histories -> (B,) float64 probabilities."""
        p = self.p
        h = bf16((x - p["norm/mu"]) / p["norm/sigma"])
        h = self.dense(h, "embed")
        length, d = h.shape[1], h.shape[2]
        h = bf16(h + bf16(self.positions(length, d, h.device))[None])
        for i in range(self.n_blocks):
            blk = f"blocks/{i}"
            z = self.layer_norm(h, f"{blk}/ln1")
            if i == self.n_blocks - 1:  # the readout: the last token's output
                kv = self.dense(z, f"{blk}/qkv", slice(d, 3 * d))
                k, v = kv[..., :d], kv[..., d:]
                q = self.dense(z[:, -1:], f"{blk}/qkv", slice(0, d))
                h = h[:, -1:]
            else:
                q, k, v = self.dense(z, f"{blk}/qkv").split(d, dim=-1)
            h = bf16(h + self.dense(self.attention(q, k, v), f"{blk}/proj"))
            z = self.layer_norm(h, f"{blk}/ln2")
            m = bf16(torch.nn.functional.gelu(self.dense(z, f"{blk}/mlp_in"),
                                              approximate="tanh"))
            h = bf16(h + self.dense(m, f"{blk}/mlp_out"))
        last = self.layer_norm(h[:, -1], "head/ln")
        z = torch.matmul(bf16(last), bf16(p["head/w"])).reshape(-1) + p["head/b"]
        return torch.sigmoid(z.double())


@contextlib.contextmanager
def exact_float32():
    """float32 matmuls in float32 (no TF32) while open."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@torch.no_grad()
def score(fwd: Forward, hist: np.ndarray) -> np.ndarray:
    """(B, L, F) histories -> (B,) probabilities (float64)."""
    with exact_float32():
        return fwd(torch.as_tensor(hist, device=fwd.p["embed/w"].device)).cpu().numpy()


def score_traffic(fwd: Forward, traffic: dict, length: int, rows: int = 4096) -> np.ndarray:
    """The probability of each record of ``traffic["index"]`` on its
    history, in blocks of ``rows`` records, so the reference fits."""
    index = np.asarray(traffic["index"], np.int64)
    out = [score(fwd, histories(traffic["rows"], traffic["keys"], index[i:i + rows], length))
           for i in range(0, len(index), rows)]
    return np.concatenate(out) if out else np.zeros(0)
