"""The slot-ring decode kernel's arithmetic, plan and dispatch, on the CPU.

``ref.slot_decode_split_ref`` is the plain version of what the CUDA slot
decode kernel (``slot_decode_launch`` in ``csrc/paged_decode.cu``)
computes in its own order: each lane's visible slots ``[0, min(len,
S))`` cut into runs of ``tokens_per_split``, a partial softmax state per
run, merged in run order. Here it is held against the port's unsplit
plain version (``ref.decode_attention_ref``) and the JAX package's
``repro.kernels.ops.decode_attention`` (JAX on the CPU) on the same
numpy inputs, over 1, 2, 3 and one-token-each splits, lengths 0, 1, on
and beside a split's edge and ``S``, softcap 30, and GQA groups 3 and
8. The kernel takes no window (a ring holds only the positions inside a
model's window, and no model path passes one). The JAX oracle's softmax
makes NaN on a lane with no visible slot; the port's versions give
zeros there, so that lane is held to zeros and left out of the JAX
comparison.

Also: ``paged_attention.slot_plan`` on ints (the runs tile each lane's
slots), the operand checks of the in-place strided read, the dispatch
of ``ops.decode_attention`` (``impl='cuda'`` raises on CPU tensors;
``auto`` and ``reference`` take the plain version there; where the
dispatch answers as for CUDA tensors, a window raises and names
``impl='reference'``), and ``impl`` threaded through the slot-ring
decode steps and ``make_serve_step``.

Tolerances: float32 ``atol=rtol=1e-5`` (same math, summation order
differs); bfloat16 ``atol=rtol=2e-2`` (outputs round to bf16 at
different points of the two pipelines), as in
``test_torch_decode_split.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.configs import smoke_config
from repro_torch.kernels import ops, paged_attention, ref
from repro_torch.models import encdec, hybrid, transformer
from repro_torch.models.registry import get_api

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
D, S = 32, 48
# (H, Hk): group 3, as full-width smollm; group 8, as paligemma-3b
HEADS = [(6, 2), (8, 1)]
# tokens per split: one split, two, three, and one token each
PER = {"1": S, "2": S // 2, "3": S // 3, "all": 1}


def _tol(dtype):
    return (dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16"
            else dict(atol=1e-5, rtol=1e-5))


def _lens(per):
    """Lengths 0 and 1, on a split's edge, one past and one before it,
    mid-split and the whole ring."""
    return (0, 1, per, min(per + 1, S), max(per - 1, 2),
            min(per + per // 2, S - 1), S)


@functools.lru_cache(maxsize=None)
def _scene(lens, heads, dtype):
    """numpy float32 queries and cache; the same as torch tensors of
    ``dtype`` (lengths int32)."""
    H, Hk = heads
    rng = np.random.default_rng(47)
    B = len(lens)
    arrays = dict(q=rng.standard_normal((B, H, D), dtype=np.float32),
                  k=rng.standard_normal((B, S, Hk, D), dtype=np.float32),
                  v=rng.standard_normal((B, S, Hk, D), dtype=np.float32),
                  lens=np.asarray(lens, np.int32))
    td = DTYPES[dtype][1]
    tensors = {n: torch.from_numpy(a) if a.dtype == np.int32
               else torch.from_numpy(a).to(td) for n, a in arrays.items()}
    return arrays, tensors


def _jax(lens, heads, dtype, softcap):
    a, _ = _scene(lens, heads, dtype)
    jd = DTYPES[dtype][0]
    out = jax_ops.decode_attention(
        *(jnp.asarray(a[n]).astype(jd) for n in ("q", "k", "v")),
        jnp.asarray(a["lens"]), logit_softcap=softcap)
    return np.asarray(out.astype(jnp.float32))


def _close(got, want, dtype):
    np.testing.assert_allclose(got, want, **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [None, 30.0], ids=["plain", "softcap"])
@pytest.mark.parametrize("heads", HEADS, ids=["group3", "group8"])
@pytest.mark.parametrize("splits", list(PER))
def test_slot_split_ref_matches_plain_and_jax(splits, heads, softcap, dtype):
    per = PER[splits]
    lens = _lens(per)
    _, t = _scene(lens, heads, dtype)
    got = ref.slot_decode_split_ref(t["q"], t["k"], t["v"], t["lens"],
                                    tokens_per_split=per,
                                    logit_softcap=softcap)
    assert got.dtype == t["q"].dtype and got.shape == t["q"].shape
    assert torch.all(got[0] == 0)                 # cache_len 0 -> zeros
    want = ref.decode_attention_ref(t["q"], t["k"], t["v"], t["lens"],
                                    logit_softcap=softcap)
    _close(got.float().numpy(), want.float().numpy(), dtype)
    _close(got[1:].float().numpy(), _jax(lens, heads, dtype, softcap)[1:],
           dtype)


def test_slot_split_ref_length_one_is_its_value():
    """A lane of length 1 attends slot 0 alone: its output is that
    slot's value for every head of the group, in every plan."""
    _, t = _scene(_lens(8), (6, 2), "float32")
    for per in (1, 8, S):
        got = ref.slot_decode_split_ref(t["q"], t["k"], t["v"], t["lens"],
                                        tokens_per_split=per)
        want = t["v"][1, 0].repeat_interleave(3, dim=0)
        torch.testing.assert_close(got[1], want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("B,Hk,S_", [(1, 1, 1), (2, 3, 37), (4, 3, 32768),
                                    (8, 8, 4096), (256, 8, 1090),
                                    (64, 20, 1500)])
def test_slot_plan_tiles_each_lanes_token_range(B, Hk, S_):
    per, n = paged_attention.slot_plan(B, Hk, S_)
    assert isinstance(per, int) and isinstance(n, int)
    assert n >= 1 and 1 <= per <= S_
    assert per * n >= S_                      # every slot in a run
    assert per * (n - 1) < S_                 # no run starts past the ring
    assert (per, n) == paged_attention.split_plan(B, Hk, S_, 1)


def test_slot_plan_at_the_cells_shapes():
    # the h2o-danube cells: 256 lanes x 8 kv heads fill the card alone
    assert paged_attention.slot_plan(256, 8, 1090) == (1090, 1)
    # few lanes over a 32k ring split the token axis to fill the SMs
    per, n = paged_attention.slot_plan(4, 3, 32768)
    assert n > 1 and per >= paged_attention._MIN_SPLIT_TOKENS


def _layer_view(dtype=torch.bfloat16, L=3, B=4, Hk=2):
    cache = torch.zeros(L, B, S, Hk, D, dtype=dtype)
    return cache[1], cache[2]


def test_slot_operands_read_a_layer_view_in_place():
    """A layer's view of the ``[L, B, S, Hk, D]`` cache passes as it is
    (the kernel reads it through its strides, no copy); a cache whose
    ``(Hk, D)`` rows are not contiguous, whose K and V strides differ,
    or whose rows start off 16 bytes is refused, never copied."""
    k, v = _layer_view()
    q = torch.zeros(4, 4, D, dtype=torch.bfloat16)
    lens = torch.zeros(4, dtype=torch.int32)
    paged_attention.check_slot_operands(q, k, v, lens)
    paged_attention.check_slot_operands(q, k[:, :40], v[:, :40], lens)
    with pytest.raises(ValueError, match="contiguous"):
        kt = k.transpose(2, 3).contiguous().transpose(2, 3)
        paged_attention.check_slot_operands(q, kt, kt, lens)
    with pytest.raises(ValueError, match="strides"):
        longer = torch.zeros(4, S + 8, 2, D, dtype=torch.bfloat16)[:, :S]
        paged_attention.check_slot_operands(q, k, longer, lens)
    base = torch.zeros(4 * S * 2 * D + 1, dtype=torch.bfloat16)
    off = base[1:].view(4, S, 2, D)
    with pytest.raises(ValueError, match="16 bytes"):
        paged_attention.check_slot_operands(q, off, off, lens)
    with pytest.raises(TypeError):
        paged_attention.check_slot_operands(q.float(), k, v, lens)
    with pytest.raises(ValueError, match="lanes"):
        paged_attention.check_slot_operands(q, k, v, lens[:3])


def test_slot_wrapper_on_cpu_is_the_plain_version():
    _, t = _scene(_lens(8), (6, 2), "float32")
    args = (t["q"], t["k"], t["v"], t["lens"])
    before = paged_attention.slot_decode_launches
    got = paged_attention.slot_decode_attention(*args, logit_softcap=30.0)
    want = ref.decode_attention_ref(*args, logit_softcap=30.0)
    assert torch.equal(got, want)
    assert paged_attention.slot_decode_launches == before
    with pytest.raises(TypeError, match="window"):    # the kernel has none
        paged_attention.slot_decode_attention(*args, window=20)


def test_decode_attention_dispatch_on_cpu(monkeypatch):
    """``impl='cuda'`` raises on CPU tensors; ``auto`` and ``reference``
    run the plain version and never reach the kernel's wrapper."""
    _, t = _scene(_lens(8), (6, 2), "float32")
    args = (t["q"], t["k"], t["v"], t["lens"])
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(*args, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.decode_attention(*args, impl="triton")

    def no_kernel(*a, **kw):
        raise AssertionError("a CPU tensor reached the slot kernel")

    monkeypatch.setattr(ops, "_slot_decode_cuda", no_kernel)
    want = ref.decode_attention_ref(*args)
    for impl in ("auto", "reference"):
        assert torch.equal(ops.decode_attention(*args, impl=impl), want)


def test_decode_attention_dispatch_as_on_cuda(monkeypatch):
    """Where the dispatch answers as for CUDA tensors, ``auto`` and
    ``cuda`` reach the slot kernel's wrapper (no window); a window, which
    the kernel does not take, raises and names ``impl='reference'``,
    and never falls to the plain version on its own."""
    _, t = _scene(_lens(8), (6, 2), "float32")
    args = (t["q"], t["k"], t["v"], t["lens"])
    calls = []

    def kernel(*a, **kw):
        calls.append(kw)
        return ref.decode_attention_ref(*a, **kw)

    monkeypatch.setattr(ops, "_use_kernel",
                        lambda impl, x: impl in ("auto", "cuda"))
    monkeypatch.setattr(ops, "_slot_decode_cuda", kernel)
    for impl in ("auto", "cuda"):
        ops.decode_attention(*args, logit_softcap=30.0, impl=impl)
        with pytest.raises(ValueError, match="impl='reference'"):
            ops.decode_attention(*args, window=20, impl=impl)
    assert calls == [dict(logit_softcap=30.0)] * 2
    got = ops.decode_attention(*args, window=20, impl="reference")
    assert torch.equal(got, ref.decode_attention_ref(*args, window=20))
    assert len(calls) == 2


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-1.2b",
                                  "whisper-large-v3"])
def test_decode_steps_hand_impl_to_every_decode_attention(arch, monkeypatch):
    """The slot-ring decode steps pass ``impl`` to each of their
    ``ops.decode_attention`` calls (one an attention layer; whisper's
    self- and cross-attention), so a check can run the plain path."""
    cfg = smoke_config(arch).replace(dtype="float32")
    api = get_api(cfg)
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    B, Lp = 2, 8
    batch = {"tokens": torch.randint(1, cfg.vocab, (B, Lp),
                                     generator=torch.Generator().manual_seed(1))}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros(B, cfg.enc_seq, cfg.d_model)
    _, cache = api.prefill(cfg, params, batch, max_len=32)
    seen = []
    plain = ops.decode_attention

    def spy(*a, impl="auto", **kw):
        seen.append(impl)
        return plain(*a, impl=impl, **kw)

    monkeypatch.setattr(ops, "decode_attention", spy)
    step = {"dense": transformer.decode_step, "hybrid": hybrid.decode_step,
            "encdec": encdec.decode_step}[cfg.family]
    tok = torch.ones(B, dtype=torch.long)
    base = {k: v.clone() for k, v in cache.items()}
    got, _ = step(cfg, params, base, tok, cache["lens"], impl="reference")
    n_attn = (len(hybrid._app_positions(cfg)) if cfg.family == "hybrid"
              else 2 * cfg.n_layers if cfg.family == "encdec"
              else cfg.n_layers)
    assert seen == ["reference"] * n_attn
    seen.clear()
    again, _ = step(cfg, params, {k: v.clone() for k, v in cache.items()},
                    tok, cache["lens"])
    assert seen == ["auto"] * n_attn
    assert torch.equal(got, again)            # the same plain path on the CPU


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-1.2b",
                                  "whisper-large-v3", "mamba2-2.7b"])
def test_serve_step_hands_impl_to_the_decode_step(arch, monkeypatch):
    """``make_serve_step(cfg, impl=...)`` passes ``impl`` to every
    ``ops.decode_attention`` of the decode step (none in mamba2's), so
    the caller of a cache split on S can ask for the plain ops; the
    tokens are those of the default step on the CPU."""
    from repro_torch.models.steps import make_serve_step
    cfg = smoke_config(arch).replace(dtype="float32")
    api = get_api(cfg)
    params = api.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    B, Lp = 2, 8
    batch = {"tokens": torch.randint(1, cfg.vocab, (B, Lp),
                                     generator=torch.Generator().manual_seed(1))}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros(B, cfg.enc_seq, cfg.d_model)
    _, cache = api.prefill(cfg, params, batch, max_len=32)
    seen = []
    plain = ops.decode_attention

    def spy(*a, impl="auto", **kw):
        seen.append(impl)
        return plain(*a, impl=impl, **kw)

    monkeypatch.setattr(ops, "decode_attention", spy)
    tok = torch.ones(B, dtype=torch.long)
    pos = torch.tensor(Lp, dtype=torch.int32)
    got, _ = make_serve_step(cfg, impl="reference")(
        params, {k: v.clone() for k, v in cache.items()}, tok, pos, None)
    n_attn = len(seen)
    assert seen == ["reference"] * n_attn
    assert (n_attn == 0) == (cfg.family == "ssm")
    want, _ = make_serve_step(cfg)(
        params, {k: v.clone() for k, v in cache.items()}, tok, pos, None)
    assert seen[n_attn:] == ["auto"] * n_attn
    assert torch.equal(got, want)
