"""Dense decoder-only transformer (h2o-danube-1.8b: Llama/Mistral
blocks with grouped-query attention and a sliding window), plain
float32 PyTorch.

Per layer: ``h += Wo · attn(rope(Wq x), rope(Wk x), Wv x)`` with ``x =
rmsnorm(h)``, causal within ``sliding_window`` keys, query head ``i``
reading key/value head ``i // (H / Hk)``; then ``h += W2 (silu(W1 x) *
W3 x)`` with ``x = rmsnorm(h)``. Final RMSNorm, untied output head.
Rotary embedding on the two halves of each head (not interleaved),
angles ``pos / theta^(2i/D)``. Departures from the published model,
all of them the port's layout: norm weights are stored as offsets from
1, and the weights are random draws (below), not the released ones.

:func:`draw` makes the weights from the seed on the card, one call a
leaf, in the leaf layout the port's params take (per-layer leaves
stacked on a leading layer axis; attention weights split by head).
:func:`token_flops` and :func:`prefill_flops` count the work of live
tokens from these equations alone.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .common import mm, normal, rms_norm, unembed

EPS = 1e-6


def draw(c: Dict, gen: torch.Generator) -> Dict:
    """Random bf16 weights: projections with std ``fan_in**-0.5``,
    embedding and head 0.02, norm offsets 0.1."""
    L, d, H, Hk = c["n_layers"], c["d_model"], c["n_heads"], c["n_kv_heads"]
    hd, ff, V = c["head_dim"], c["d_ff"], c["vocab"]
    bf = torch.bfloat16

    def dense(shape, fan_in):
        return normal(gen, (L, *shape), fan_in ** -0.5, bf)

    def norm(*lead):
        return {"scale": normal(gen, (*lead, d), 0.1, bf)}

    return {
        "embed": {"table": normal(gen, (V, d), 0.02, bf)},
        "layers": {
            "ln1": norm(L),
            "attn": {"wq": dense((d, H, hd), d), "wk": dense((d, Hk, hd), d),
                     "wv": dense((d, Hk, hd), d),
                     "wo": dense((H, hd, d), H * hd)},
            "ln2": norm(L),
            "mlp": {"w1": dense((d, ff), d), "w2": dense((ff, d), ff),
                    "w3": dense((d, ff), d)},
        },
        "final_norm": norm(),
        "lm_head": {"table": normal(gen, (V, d), 0.02, bf)},
    }


def token_flops(c: Dict, context: int) -> float:
    """FLOPs of one token at ``context`` visible positions (itself
    included): 2 per multiply-add of every layer's projections and of
    the head, and 4 per (query head, visible key, channel) of
    attention, the keys cut to the window."""
    L, d, H, Hk = c["n_layers"], c["d_model"], c["n_heads"], c["n_kv_heads"]
    hd, ff = c["head_dim"], c["d_ff"]
    keys = min(context, c.get("sliding_window") or context)
    per_layer = 2 * (d * hd * (2 * H + 2 * Hk) + 3 * d * ff) \
        + 4 * H * hd * keys
    return float(L * per_layer + 2 * d * c["vocab"])


def prefill_flops(c: Dict, n: int) -> float:
    """The first ``n`` live tokens of a prompt: token ``j`` sees ``j``
    positions (the attention term summed in closed form)."""
    window = c.get("sliding_window") or n
    keys = sum(min(j, window) for j in range(1, n + 1)) \
        if window < n else n * (n + 1) // 2
    return token_flops(c, 0) * n \
        + 4 * c["n_layers"] * c["n_heads"] * c["head_dim"] * keys


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [L, heads, D] at positions 0..L-1."""
    L, _, D = x.shape
    pos = torch.arange(L, device=x.device, dtype=torch.float32)
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, device=x.device,
                                         dtype=torch.float32) / D)
    ang = pos[:, None] * freqs                              # [L, D/2]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, window) -> torch.Tensor:
    """q [L, H, D], k/v [L, Hk, D] -> [L, H, D], causal (and windowed)."""
    L, H, D = q.shape
    group = H // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("qhd,khd->hqk", q * D ** -0.5, k)
    qp = torch.arange(L, device=q.device)[:, None]
    kp = torch.arange(L, device=q.device)[None, :]
    seen = kp <= qp
    if window is not None:
        seen &= qp - kp < window
    s = s.masked_fill(~seen, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)


def final_hidden(c: Dict, p: Dict, ids: torch.Tensor,
                 low: bool = False) -> torch.Tensor:
    """The final-norm output ``[L, d]`` (float32) over token ids [L]."""
    H, Hk, hd = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    theta, window = float(c["rope_theta"]), c.get("sliding_window")
    h = p["embed"]["table"][ids].float()
    lay = p["layers"]
    for i in range(c["n_layers"]):
        a = lay["attn"]
        x = rms_norm(h, lay["ln1"]["scale"][i], EPS)
        q = mm(x, a["wq"][i].flatten(1), low).unflatten(-1, (H, hd))
        k = mm(x, a["wk"][i].flatten(1), low).unflatten(-1, (Hk, hd))
        v = mm(x, a["wv"][i].flatten(1), low).unflatten(-1, (Hk, hd))
        o = _attention(_rope(q, theta), _rope(k, theta), v, window)
        h = h + mm(o.flatten(1), a["wo"][i].flatten(0, 1), low)
        m = lay["mlp"]
        x = rms_norm(h, lay["ln2"]["scale"][i], EPS)
        g = F.silu(mm(x, m["w1"][i], low)) * mm(x, m["w3"][i], low)
        h = h + mm(g, m["w2"][i], low)
    return rms_norm(h, p["final_norm"]["scale"], EPS)


def logits(c: Dict, p: Dict, h: torch.Tensor, low: bool = False):
    return unembed(h, p["lm_head"]["table"], low)
