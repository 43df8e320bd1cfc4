"""Mamba-2 (mamba2-2.7b: attention-free SSD blocks), plain float32
PyTorch.

Per layer, with ``x = rmsnorm(h)``: ``z, xs, B, C, dt_raw`` are five
projections of ``x``; ``xs``, ``B`` and ``C`` each go through a causal
depthwise conv of width ``ssm_conv`` (with bias) and SiLU; ``dt =
softplus(dt_raw + dt_bias)`` and the log decay ``a = -exp(A_log) dt``
per head; the scan is the SSD's quadratic form

    y_t = sum_{s <= t} (C_t . B_s) exp(a_{s+1} + ... + a_t) dt_s xs_s

over heads of ``ssm_headdim`` channels (``B``, ``C`` shared by the
heads of a group); then ``y += D xs``, ``y *= silu(z)``, a gated
RMSNorm over ``d_inner`` and the output projection, added to ``h``.
Final RMSNorm, and the head tied to the embedding where the
configuration says ``tie_embeddings`` (the released model does).
Departures from the published model, the port's layout: norm weights
are offsets from 1, the conv weights are split per segment, and the
weights are random draws (below).

:func:`draw` makes the weights from the seed on the card in the port's
leaf layout (stacked on a leading layer axis; ``A_log``, ``D`` and
``dt_bias`` float32, the rest bf16). :func:`token_flops` and
:func:`prefill_flops` count the work of live tokens from these
equations alone.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from .common import mm, normal, rms_norm, uniform, unembed

EPS = 1e-6


def _sizes(c: Dict):
    din = c["ssm_expand"] * c["d_model"]
    gn = c["ssm_ngroups"] * c["ssm_state"]
    return din, gn, din // c["ssm_headdim"]


def draw(c: Dict, gen: torch.Generator) -> Dict:
    """Random weights: projections with std ``fan_in**-0.5``, conv
    weights ``width**-0.5``, conv biases and norm offsets 0.1, embedding
    and head 0.02; ``A = -exp(A_log)`` uniform in [-16, -1], ``D``
    uniform in [0.5, 1.5], ``dt_bias`` the inverse softplus of a
    log-uniform dt in [1e-3, 1e-1] (the Mamba-2 paper's ranges)."""
    L, d, k, V = c["n_layers"], c["d_model"], c["ssm_conv"], c["vocab"]
    din, gn, H = _sizes(c)
    bf = torch.bfloat16

    def dense(n_in, n_out):
        return normal(gen, (L, n_in, n_out), n_in ** -0.5, bf)

    dt = torch.exp(uniform(gen, (L, H), math.log(1e-3), math.log(1e-1)))
    params = {
        "embed": {"table": normal(gen, (V, d), 0.02, bf)},
        "layers": {
            "ln": {"scale": normal(gen, (L, d), 0.1, bf)},
            "ssm": {
                "w_z": dense(d, din), "w_x": dense(d, din),
                "w_b": dense(d, gn), "w_c": dense(d, gn), "w_dt": dense(d, H),
                "conv_x_w": normal(gen, (L, k, din), k ** -0.5, bf),
                "conv_x_b": normal(gen, (L, din), 0.1, bf),
                "conv_b_w": normal(gen, (L, k, gn), k ** -0.5, bf),
                "conv_b_b": normal(gen, (L, gn), 0.1, bf),
                "conv_c_w": normal(gen, (L, k, gn), k ** -0.5, bf),
                "conv_c_b": normal(gen, (L, gn), 0.1, bf),
                "A_log": torch.log(uniform(gen, (L, H), 1.0, 16.0)),
                "D": uniform(gen, (L, H), 0.5, 1.5),
                "dt_bias": dt + torch.log(-torch.expm1(-dt)),
                "gate_norm": normal(gen, (L, din), 0.1, bf),
                "out_proj": dense(din, d),
            },
        },
        "final_norm": {"scale": normal(gen, (d,), 0.1, bf)},
    }
    if not c.get("tie_embeddings"):
        params["lm_head"] = {"table": normal(gen, (V, d), 0.02, bf)}
    return params


def token_flops(c: Dict, context: int) -> float:
    """FLOPs of one token (the same at any ``context``): 2 per
    multiply-add of every layer's projections and of the head, 2 per
    (tap, channel) of the conv, 4 per (channel, state) of the
    recurrence."""
    d = c["d_model"]
    din, gn, H = _sizes(c)
    per_layer = 2 * (d * (2 * din + 2 * gn + H) + din * d) \
        + 2 * c["ssm_conv"] * (din + 2 * gn) + 4 * din * c["ssm_state"]
    return float(c["n_layers"] * per_layer + 2 * d * c["vocab"])


def prefill_flops(c: Dict, n: int) -> float:
    """The first ``n`` live tokens of a prompt."""
    return token_flops(c, 1) * n


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv: x [L, C], w [k, C] (w[k-1] on the current
    row), b [C]."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[i:i + x.shape[0]] * w[i].float() for i in range(k)) \
        + b.float()


def _scan(xh: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
          c: torch.Tensor) -> torch.Tensor:
    """SSD, quadratic form: xh [L, H, P] (dt-scaled), a [L, H], b/c
    [L, G, N] -> y [L, H, P]. The decays' running sums in float64."""
    L, H, _ = xh.shape
    rep = H // b.shape[1]
    cs = torch.cumsum(a.double().T, dim=-1)                 # [H, L]
    seg = cs[:, :, None] - cs[:, None, :]                   # [H, t, s]
    causal = torch.ones(L, L, dtype=torch.bool, device=xh.device).tril()
    decay = torch.exp(seg.masked_fill(~causal, float("-inf"))).float()
    bh = b.repeat_interleave(rep, dim=1)                    # [L, H, N]
    ch = c.repeat_interleave(rep, dim=1)
    scores = torch.einsum("thn,shn->hts", ch, bh) * decay
    return torch.einsum("hts,shp->thp", scores, xh)


def final_hidden(c: Dict, p: Dict, ids: torch.Tensor,
                 low: bool = False) -> torch.Tensor:
    """The final-norm output ``[L, d]`` (float32) over token ids [L]."""
    din, gn, H = _sizes(c)
    G, N, P = c["ssm_ngroups"], c["ssm_state"], c["ssm_headdim"]
    h = p["embed"]["table"][ids].float()
    lay = p["layers"]
    s = lay["ssm"]
    for i in range(c["n_layers"]):
        x = rms_norm(h, lay["ln"]["scale"][i], EPS)
        z = mm(x, s["w_z"][i], low)
        xs = F.silu(_conv(mm(x, s["w_x"][i], low), s["conv_x_w"][i],
                          s["conv_x_b"][i]))
        b = F.silu(_conv(mm(x, s["w_b"][i], low), s["conv_b_w"][i],
                         s["conv_b_b"][i]))
        cc = F.silu(_conv(mm(x, s["w_c"][i], low), s["conv_c_w"][i],
                          s["conv_c_b"][i]))
        dt = F.softplus(mm(x, s["w_dt"][i], low) + s["dt_bias"][i])
        a = -torch.exp(s["A_log"][i]) * dt                  # [L, H]
        xheads = xs.unflatten(-1, (H, P))
        y = _scan(xheads * dt[..., None], a, b.unflatten(-1, (G, N)),
                  cc.unflatten(-1, (G, N)))
        y = (y + s["D"][i][:, None] * xheads).flatten(1) * F.silu(z)
        y = rms_norm(y, s["gate_norm"][i], EPS)
        h = h + mm(y, s["out_proj"][i], low)
    return rms_norm(h, p["final_norm"]["scale"], EPS)


def logits(c: Dict, p: Dict, h: torch.Tensor, low: bool = False):
    head = p["embed"] if c.get("tie_embeddings") else p["lm_head"]
    return unembed(h, head["table"], low)
