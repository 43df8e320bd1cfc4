"""Chip smoke test of the PyTorch/H100 port: builds the CUDA kernels,
holds each against its plain PyTorch version, times them, serves
full-width smollm-135m through the paged and the slot-ring engines and
through a prefill/decode-disaggregated cluster of paged engines, and
trains full-width mamba2-2.7b and smollm-135m, on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA GPU and the
CUDA toolkit (nvcc). It imports the port (``src/repro_torch``) only.
Phases, each printed as it ends, stopping with a non-zero exit at the
first that fails:

1. device        the GPU's name and nvidia-smi's name and power limit;
2. build         seconds to build every kernel from kernels/csrc/, and
                 each kernel's registers and spills (nvcc -Xptxas -v);
3. kernel_check  each kernel against its plain version on the card:
                 smoke and full-width shapes, f32 and bf16, softcap on
                 and off, poisoned page-table tails, chunk 1/16/128 at
                 q_offset > 0, and the 64-row / 64-key tile edges at
                 q_offset 128 (ragged rows, kv_len mid-page and inside
                 the chunk, D 24/80/256); flash attention at the engine's
                 prefill buckets, full-width h2o-danube (D 80, window,
                 prefix), D 256, Lq 1/16 against Lk 200, the dense
                 trainer's batch 8 x 512 and the tile edges (ragged row
                 and key counts, window and prefix edges inside a tile,
                 D 24/80/256); per-sequence paged
                 decode on the batched kernel's shapes; both decode
                 kernels where their page splits matter (tables of 64
                 and 128 pages, lengths up to 2,047 on, past and before
                 a split edge and mid-split, a batch of empty slots but
                 one) against the plain version and the split-order
                 plain version, two calls bit-identical, the merge
                 counters left at 0; the SSD scan at
                 the JAX test shapes, a ragged L, G 2, L < chunk,
                 mamba2-2.7b's (L 2048 and 1000) and zamba2's shapes,
                 N 256 with a chunk of 100, 16 chunks, and N 4 with
                 H / G 1, against the plain version and its three
                 stages (ref.ssd_chunked_pieces), two calls
                 bit-identical;
                 gradients through the flash and SSD autograd Functions
                 at the trainers' shapes against plain autograd;
4. kernel_times  each kernel at its main path's full-width shapes: its
                 time per call (CUDA events, the host's issue time
                 included), the plain version's, a library call's where
                 one PyTorch call computes the same function (SDPA over
                 the gathered K/V, a yardstick the port never calls; none
                 for the SSD scan; its CUDA launches per call are
                 counted), the kernel's and the library call's
                 device time (torch.profiler), the bound (least time for
                 the bytes and FLOPs it needs) and the rates reached in
                 the device time (TFLOP/s, GB/s); chunked prefill also
                 after a 128-token prefix-cache hit, the batched decode
                 also at long context (8 x 1,900-2,047 tokens);
5. engine        full-width smollm-135m, bf16, 24 requests through
                 DriftScheduler("sjf") and the paged engine, with the
                 kernels' launch counts checked against the iterations;
6. engine_profile  a few iterations of the same engine under
                 torch.profiler: device time per iteration and its share
                 of the wall time;
7. engine_check  one full-width prefill chunk and one decode step with
                 the kernels against the same calls on the plain versions,
                 within the plain path's own bf16-vs-float32 deviation;
8. engine_slot   full-width smollm-135m, bf16, 24 requests through
                 DriftScheduler("sjf") and the slot-ring engine
                 (paged=False), flash-attention launches checked against
                 the prefills and no paged kernel launched;
9. engine_slot_profile  the slot-ring engine under torch.profiler;
10. engine_slot_check  one full-width 256-token prefill (flash kernel)
                 and one decode step from its cache, against the plain
                 path, within its bf16-vs-float32 deviation; beside it,
                 ungated, the plain path summed over other key blocks
                 against itself (how far an equally valid order moves
                 the logits);
11. cluster_pd   full-width smollm-135m, bf16, behind the cluster
                 driver's pd_disaggregated routing: one prefill and two
                 decode paged engines on the card, 24 requests under
                 DriftScheduler("sjf"); each prefilled sequence's KV
                 pages move on the card to a decode engine; every
                 request handed off once, chunked-prefill launches
                 checked against the prefill engine's chunks and
                 batched-decode launches against the decode engines'
                 iterations, no other kernel, every pool's pages
                 conserved;
12. cluster_pd_check  one sequence prefilled on the prefill engine: its
                 extracted pages bit-equal to the source pool's, the
                 destination's pages after injection bit-equal to the
                 payload, and one batched-decode step of it on each
                 engine giving bit-identical logits;
13. train        mamba2-2.7b at full width and depth (64 layers), bf16,
                 through the training launcher's code: 6 AdamW steps on
                 batch 2 x 2048 synthetic tokens with per-layer remat;
                 SSD launches exactly 2 x 64 x 6 and no attention kernel;
14. train_profile  one more step of it under torch.profiler, with the
                 device time launched inside the SSD kernel's forward,
                 the plain SSD backward and the AdamW update;
15. train_check  one step's loss, grad norm and gradients of w_x,
                 out_proj, A_log and the embedding at full width, depth
                 cut to 8 layers: the kernel path against the plain path,
                 within the plain path's own bf16-vs-float32 deviation;
                 beside it, ungated, the plain path at chunk 128 (the
                 same function, summed in another order) against itself;
16. train_dense  smollm-135m at full width, batch 8 x 512, 4 steps;
                 flash-attention launches exactly 2 x 30 x 4;
17. train_dense_check  one step of it at full depth (30 layers): loss,
                 grad norm and the gradients of wq, wk, wv and the
                 embedding, kernel path against plain path as train_check,
                 but gated in float32 (through 30 bf16 layers the two
                 bf16 paths decorrelate; their deviation is printed).

Each engine, cluster and train phase sets every kernel's launch count
to 0 just before it runs and reads the counts just after.

The line before the last is the kernel table as JSON, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import torch

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of bytes / memory rate and FLOPs / the bf16
# tensor-core peak (the timed inputs are bf16).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

# Tolerances of kernel vs plain version, same inputs on the card. Both
# accumulate in float32 and differ only in summation order: float32
# outputs agree to a few ulps of values of order 1; bfloat16 outputs are
# rounded from nearly equal float32 values, so at most about one bf16
# ulp (2**-8 relative) apart.
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-2, 1e-2)}
# The SSD scan's float32 output at a position sums up to a chunk of
# products and the decayed state, terms as large as the call's largest
# outputs: its rounding error scales with max |y| of the call, not with
# the element, so its float32 atol is 1e-5 * max |y| (the bf16 tolerance
# covers one bf16 ulp as for the other kernels).
SSD_F32_ATOL_PER_MAX = 1e-5
# Logits of the full-width model through 30 layers in bf16: the kernels
# may move them by no more than bf16 itself does, i.e. the largest
# difference between the plain path in bf16 and the same path in
# float32 on the same inputs (measured in the run).
TIMING_REPS = 60


def phase(label: str, /, **fields) -> None:
    print(json.dumps({"phase": label, **fields}, default=float), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

def page_scene(gen, B, Hk, D, P, pps, dtype, dev, extra=3):
    """A random pool and non-overlapping page tables."""
    n_pages = B * pps + extra
    k = torch.randn(n_pages, P, Hk, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(n_pages, P, Hk, D, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n_pages, generator=gen, device=dev)[:B * pps]
    return k, v, perm.reshape(B, pps).to(torch.int32)


def poison(table, lens, P, n_pages):
    """Garbage past each sequence's last page, far out of range."""
    out = table.clone()
    for b, n in enumerate(lens):
        out[b, -(-int(n) // P):] = n_pages * 13 + b
    return out


def decode_inputs(gen, B, H, Hk, D, P, pps, lens, dtype, dev):
    k, v, table = page_scene(gen, B, Hk, D, P, pps, dtype, dev)
    q = torch.randn(B, H, D, generator=gen, device=dev).to(dtype)
    kn = torch.randn(B, Hk, D, generator=gen, device=dev).to(dtype)
    vn = torch.randn(B, Hk, D, generator=gen, device=dev).to(dtype)
    return q, k, v, table, torch.tensor(lens, dtype=torch.int32, device=dev), kn, vn


def prefill_inputs(gen, B, C, H, Hk, D, P, pps, offsets, dtype, dev):
    k, v, table = page_scene(gen, B, Hk, D, P, pps, dtype, dev)
    q = torch.randn(B, C, H, D, generator=gen, device=dev).to(dtype)
    off = torch.tensor(offsets, dtype=torch.int32, device=dev)
    return q, k, v, table, off, off + C


def flash_inputs(gen, B, Lq, Lk, H, Hk, D, dtype, dev):
    q = torch.randn(B, Lq, H, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Lk, Hk, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Lk, Hk, D, generator=gen, device=dev).to(dtype)
    return q, k, v


def ssd_inputs(gen, B, L, H, G, P, N, dtype, dev):
    """x, b, c ~ 0.5 N(0, 1) and log decays a = -0.1 |N(0, 1)|, as the
    JAX package's SSD tests draw them."""
    x = torch.randn(B, L, H, P, generator=gen, device=dev) * 0.5
    a = -torch.randn(B, L, H, generator=gen, device=dev).abs() * 0.1
    b = torch.randn(B, L, G, N, generator=gen, device=dev) * 0.5
    c = torch.randn(B, L, G, N, generator=gen, device=dev) * 0.5
    return [t.to(dtype) for t in (x, a, b, c)]


def max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def within(got, want, dtype, ssd=False):
    atol, rtol = TOL[dtype]
    if ssd and dtype == torch.float32:
        atol = max(atol, SSD_F32_ATOL_PER_MAX * want.float().abs().max().item())
    return bool(((got.float() - want.float()).abs()
                 <= atol + rtol * want.float().abs()).all())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def device_phase():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi exited {smi.returncode}: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    phase("device", name=name, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)
    print(smi_line, flush=True)
    return name, smi_line


_BUILTIN_TYPES = {"f": "float", "i": "int", "b": "bool", "j": "unsigned"}


def kernel_name(symbol):
    """A mangled kernel symbol's last name with its template arguments:
    ``flash_attention_bf16_kernel<64>``,
    ``paged_decode_split_kernel<__nv_bfloat16,1,3,1>``."""
    mangled = re.match(r"_ZN?", symbol)
    i, name = (mangled.end() if mangled else len(symbol)), symbol
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while symbol[j].isdigit():
            j += 1
        n = int(symbol[i:j])
        name, i = symbol[j:j + n], j + n
    args = []
    if symbol[i:i + 1] == "I":
        i += 1
        while i < len(symbol) and symbol[i] != "E":
            if symbol[i] == "L":                      # literal: L<type><value>E
                j = symbol.index("E", i)
                args.append(symbol[i + 2:j].replace("n", "-"))
                i = j + 1
            elif symbol[i].isdigit():                 # a named type
                j = i
                while symbol[j].isdigit():
                    j += 1
                n = int(symbol[i:j])
                args.append(symbol[j:j + n])
                i = j + n
            else:                                     # a builtin type
                args.append(_BUILTIN_TYPES.get(symbol[i], symbol[i]))
                i += 1
    return name + (f"<{','.join(args)}>" if args else "")


def ptxas_summary(log):
    """Each kernel's registers and spill bytes from nvcc's ``-Xptxas -v``
    log: {kernel: "R regs, S spill"}."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
            continue
        spill = re.search(r"(\d+) bytes spill stores", line)
        if name and spill:
            out[name] = f"{spill.group(1)} spill"
        regs = re.search(r"Used (\d+) registers", line)
        if name and regs:
            out[name] = f"{regs.group(1)} regs, " + out.get(name, "? spill")
            name = None
    return out


def build_phase():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    phase("build", seconds=time.perf_counter() - t0, sources=list(logs),
          ptxas={n: ptxas_summary(log) for n, log in logs.items()})


def kernel_check_phase(dev):
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(0)
    n_cases, worst = 0, {}
    shapes_decode = [  # B, H, Hk, D, P, pps
        (3, 3, 1, 24, 8, 12),      # smoke smollm
        (8, 9, 3, 64, 16, 32),     # full-width smollm, the engine's table
        (2, 16, 2, 128, 16, 8),
        (2, 8, 1, 256, 32, 4),     # > 48 KB of shared memory
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, Hk, D, P, pps in shapes_decode:
            cap = P * pps - 1
            lens = [0] + [(7 + 37 * b) % cap for b in range(1, B)]
            for softcap in (None, 30.0):
                for poisoned in (False, True):
                    q, k, v, table, sl, kn, vn = decode_inputs(
                        gen, B, H, Hk, D, P, pps, lens, dtype, dev)
                    pt = poison(table, lens, P, k.shape[0]) if poisoned else table
                    mp = min(pps, 2 ** math.ceil(math.log2(
                        max(1, -(-max(lens) // P)))))
                    got = ops.batched_paged_decode_attention(
                        q, k, v, pt, sl, kn, vn, max_pages=mp,
                        logit_softcap=softcap, impl="cuda")
                    want = ops.batched_paged_decode_attention(
                        q, k, v, table, sl, kn, vn, logit_softcap=softcap,
                        impl="reference")
                    torch.cuda.synchronize()
                    err = max_err(got, want)
                    key = ("decode", str(dtype).split(".")[-1])
                    worst[key] = max(worst.get(key, 0.0), err)
                    n_cases += 1
                    if not within(got, want, dtype):
                        fail(f"decode kernel vs plain: {dtype} B{B} H{H} Hk{Hk} "
                             f"D{D} P{P} softcap={softcap} poisoned={poisoned}: "
                             f"max abs err {err} > tol {TOL[dtype]}")
    shapes_prefill = [  # B, H, Hk, D, P, pps
        (2, 3, 1, 24, 8, 24),      # smoke smollm
        (2, 9, 3, 64, 16, 32),     # full-width smollm
        (1, 8, 2, 256, 16, 16),    # > 48 KB of shared memory
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, Hk, D, P, pps in shapes_prefill:
            for C in (1, 16, 128):
                cap = P * pps - C
                offsets = [min(cap, 64 + 13 * b) for b in range(B)]
                for softcap in (None, 30.0):
                    for poisoned in (False, True):
                        q, k, v, table, off, kv = prefill_inputs(
                            gen, B, C, H, Hk, D, P, pps, offsets, dtype, dev)
                        pt = (poison(table, kv.tolist(), P, k.shape[0])
                              if poisoned else table)
                        got = ops.chunked_prefill_attention(
                            q, k, v, pt, off, kv, logit_softcap=softcap,
                            impl="cuda")
                        want = ops.chunked_prefill_attention(
                            q, k, v, table, off, kv, logit_softcap=softcap,
                            impl="reference")
                        torch.cuda.synchronize()
                        err = max_err(got, want)
                        key = ("prefill", str(dtype).split(".")[-1])
                        worst[key] = max(worst.get(key, 0.0), err)
                        n_cases += 1
                        if not within(got, want, dtype):
                            fail(f"prefill kernel vs plain: {dtype} B{B} H{H} "
                                 f"Hk{Hk} D{D} P{P} C{C} softcap={softcap} "
                                 f"poisoned={poisoned}: max abs err {err} > "
                                 f"tol {TOL[dtype]}")
    # the tile edges at q_offset 128 (a prefix-cache hit): ragged row
    # counts, kv_len mid-page and, for the second sequence, before the
    # chunk ends (its later rows must be zeros), poisoned table tails
    for dtype in (torch.float32, torch.bfloat16):
        for C, H, Hk, D in ((128, 9, 3, 64), (100, 9, 3, 64), (50, 3, 1, 24),
                            (70, 32, 8, 80), (33, 8, 2, 256)):
            for softcap in (None, 30.0):
                q, k, v, table, off, _ = prefill_inputs(
                    gen, 2, C, H, Hk, D, 16, 24, [128, 128], dtype, dev)
                lens = [128 + C, 128 + C // 2 + 3]
                kv = torch.tensor(lens, dtype=torch.int32, device=dev)
                pt = poison(table, lens, 16, k.shape[0])
                got = ops.chunked_prefill_attention(
                    q, k, v, pt, off, kv, logit_softcap=softcap, impl="cuda")
                want = ops.chunked_prefill_attention(
                    q, k, v, table, off, kv, logit_softcap=softcap,
                    impl="reference")
                torch.cuda.synchronize()
                err = max_err(got, want)
                key = ("prefill", str(dtype).split(".")[-1])
                worst[key] = max(worst.get(key, 0.0), err)
                n_cases += 1
                if not within(got, want, dtype) or got[1, lens[1] - 128:].any():
                    fail(f"prefill kernel vs plain at the tile edges: {dtype} "
                         f"C{C} H{H} Hk{Hk} D{D} kv_lens {lens} softcap="
                         f"{softcap}: max abs err {err} > tol {TOL[dtype]} "
                         "(or a row past kv_len not zero)")
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, Hk, D, P, pps in shapes_decode:
            lens = [0] + [(9 + 37 * b) % (P * pps) + 1 for b in range(1, B)]
            for softcap in (None, 30.0):
                for poisoned in (False, True):
                    q, k, v, table, sl, _, _ = decode_inputs(
                        gen, B, H, Hk, D, P, pps, lens, dtype, dev)
                    pt = poison(table, lens, P, k.shape[0]) if poisoned else table
                    got = ops.paged_decode_attention(
                        q, k, v, pt, sl, logit_softcap=softcap, impl="cuda")
                    want = ops.paged_decode_attention(
                        q, k, v, table, sl, logit_softcap=softcap,
                        impl="reference")
                    torch.cuda.synchronize()
                    err = max_err(got, want)
                    key = ("paged_decode", str(dtype).split(".")[-1])
                    worst[key] = max(worst.get(key, 0.0), err)
                    n_cases += 1
                    if not within(got, want, dtype) or got[0].any():
                        fail(f"per-sequence decode kernel vs plain: {dtype} B{B} "
                             f"H{H} Hk{Hk} D{D} P{P} softcap={softcap} "
                             f"poisoned={poisoned}: max abs err {err} > tol "
                             f"{TOL[dtype]} (or a seq_len-0 row not zero)")
    n_cases += decode_split_checks(gen, dev, worst)
    shapes_flash = [  # B, Lq, Lk, H, Hk, D, mask keywords
        (2, 40, 40, 3, 1, 24, {}),                        # smoke smollm
        (2, 40, 40, 4, 2, 16, dict(window=16)),           # smoke h2o-danube
        (1, 64, 64, 9, 3, 64, {}),                        # the engine's buckets
        (1, 128, 128, 9, 3, 64, {}),
        (1, 256, 256, 9, 3, 64, {}),
        (1, 256, 256, 32, 8, 80, dict(window=64, prefix_len=16)),  # h2o-danube
        (1, 64, 64, 8, 2, 256, {}),                       # > 48 KB of smem
        (1, 1, 200, 9, 3, 64, {}),                        # Lq < Lk, ragged
        (1, 16, 200, 9, 3, 64, dict(window=64)),
        (8, 512, 512, 9, 3, 64, {}),                      # the dense trainer's
        # the bf16 kernel's 64-row and 64-key tile edges: ragged row and
        # key counts, window and prefix edges inside a tile, D 24/80/256
        (2, 50, 50, 9, 3, 64, {}),
        (1, 70, 200, 9, 3, 64, {}),
        (1, 100, 200, 8, 2, 64, dict(window=40, prefix_len=20)),
        (1, 96, 131, 6, 2, 64, dict(causal=False, window=70)),
        (2, 37, 77, 3, 1, 24, dict(prefix_len=70)),
        (1, 90, 150, 32, 8, 80, dict(window=33, prefix_len=5)),
        (1, 40, 90, 8, 2, 256, dict(window=50)),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for B, Lq, Lk, H, Hk, D, kw in shapes_flash:
            for softcap in (None, 30.0):
                q, k, v = flash_inputs(gen, B, Lq, Lk, H, Hk, D, dtype, dev)
                got = ops.attention(q, k, v, logit_softcap=softcap,
                                    impl="cuda", **kw)
                want = ops.attention(q, k, v, logit_softcap=softcap,
                                     impl="reference", **kw)
                torch.cuda.synchronize()
                err = max_err(got, want)
                key = ("flash", str(dtype).split(".")[-1])
                worst[key] = max(worst.get(key, 0.0), err)
                n_cases += 1
                if not within(got, want, dtype):
                    fail(f"flash kernel vs plain: {dtype} B{B} Lq{Lq} Lk{Lk} "
                         f"H{H} Hk{Hk} D{D} {kw} softcap={softcap}: max abs "
                         f"err {err} > tol {TOL[dtype]}")
    shapes_ssd = [  # B, L, H, G, P, N, chunk
        (1, 128, 4, 1, 16, 16, 32),       # the JAX test shapes
        (2, 256, 8, 2, 32, 64, 64),
        (1, 64, 2, 1, 64, 128, 64),
        (2, 100, 8, 1, 16, 16, 32),       # smoke mamba2, ragged last chunk
        (2, 200, 8, 2, 16, 32, 64),       # G 2, ragged
        (2, 40, 4, 1, 16, 16, 64),        # L < chunk
        (2, 2048, 80, 1, 64, 128, 256),   # mamba2-2.7b, the train shape
        (1, 1000, 80, 1, 64, 128, 256),   # mamba2-2.7b, ragged
        (1, 512, 64, 1, 64, 64, 256),     # zamba2
        (2, 250, 8, 2, 32, 256, 100),     # N 256; chunk 100, not a multiple of 16
        (1, 4096, 8, 2, 64, 128, 256),    # L = 16 chunks
        (2, 65, 4, 4, 128, 4, 16),        # N 4, H / G 1, 4 chunks + 1 token
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for B, L, H, G, P, N, Q in shapes_ssd:
            x, a, b, c = ssd_inputs(gen, B, L, H, G, P, N, dtype, dev)
            got = ops.ssd(x, a, b, c, chunk=Q, impl="cuda")
            again = ops.ssd(x, a, b, c, chunk=Q, impl="cuda")
            want = ops.ssd(x, a, b, c, chunk=Q, impl="reference")
            pieces = ref.ssd_chunked_pieces(x, a, b, c, chunk=Q)
            torch.cuda.synchronize()
            err = max(max_err(got, want), max_err(got, pieces))
            key = ("ssd", str(dtype).split(".")[-1])
            worst[key] = max(worst.get(key, 0.0), err)
            n_cases += 1
            if not (within(got, want, dtype, ssd=True)
                    and within(got, pieces, dtype, ssd=True)):
                fail(f"ssd kernel vs plain (chunked and in stages): {dtype} "
                     f"B{B} L{L} H{H} G{G} P{P} N{N} chunk {Q}: max abs err "
                     f"{err} > tol {TOL[dtype]} (f32 atol "
                     f"{SSD_F32_ATOL_PER_MAX} x max |y|)")
            if not torch.equal(got, again):
                fail(f"ssd kernel not bit-identical across two calls: {dtype} "
                     f"B{B} L{L} H{H} G{G} P{P} N{N} chunk {Q}")
            del x, a, b, c, got, again, want, pieces
    # the autograd Functions at the trainers' shapes, bf16: the backward
    # is the plain version's, recomputed from the same saved inputs, so
    # the gradients through the kernel equal plain autograd's
    grad_cases = [
        ("flash", lambda *t, impl: ops.attention(*t, impl=impl),
         flash_inputs(gen, 8, 512, 512, 9, 3, 64, torch.bfloat16, dev)),
        ("ssd", lambda *t, impl: ops.ssd(*t, chunk=256, impl=impl),
         ssd_inputs(gen, 2, 2048, 80, 1, 64, 128, torch.bfloat16, dev)),
    ]
    for name, fn, inputs in grad_cases:
        r = torch.randn(inputs[0].shape, generator=gen, device=dev).to(
            torch.bfloat16)
        grads = {}
        for impl in ("cuda", "reference"):
            ins = [t.clone().requires_grad_() for t in inputs]
            out = fn(*ins, impl=impl)
            if out.grad_fn is None:
                fail(f"{name} kernel output has no grad_fn (impl={impl})")
            grads[impl] = torch.autograd.grad(out, ins, r)
        torch.cuda.synchronize()
        err = max(max_err(g, w) for g, w in zip(grads["cuda"],
                                                 grads["reference"]))
        key = (f"{name}_grad", "bfloat16")
        worst[key] = max(worst.get(key, 0.0), err)
        n_cases += 1
        if not all(within(g, w, torch.bfloat16)
                   for g, w in zip(grads["cuda"], grads["reference"])):
            fail(f"{name} gradients through the kernel vs plain autograd at "
                 f"the trainer's shape: max abs err {err}")
    phase("kernel_check", cases=n_cases,
          max_abs_err={f"{k}/{d}": e for (k, d), e in worst.items()},
          tol={str(d).split(".")[-1]: t for d, t in TOL.items()},
          ssd_f32_atol_per_max_abs=SSD_F32_ATOL_PER_MAX)


def split_lens(B, P, pps, per, longest):
    """Sequence lengths that end on split edges (``per`` pages each),
    one token past and before them, mid-split, the longest, and 0."""
    edge = per * P
    picks = [longest, edge, edge + 1, 3 * edge - 1, 2 * edge + edge // 2,
             0, min(5 * edge, P * pps - 1), 7]
    return [min(n, P * pps - 1) for n in picks[:B]]


def decode_split_checks(gen, dev, worst):
    """Both decode kernels where their page splits matter: long tables
    (up to 2,047 tokens) with lengths on, just past and just before a
    split edge and mid-split, the 32-q-head layout, and a batch whose
    slots but one are empty; float32 and bf16, softcap on and off,
    poisoned table tails. Each output against the plain version and
    against ``ref.paged_decode_split_ref`` at the same plan, and two
    calls bit-identical. Returns the number of cases."""
    from repro_torch.kernels import ops, paged_attention, ref
    scenes = []                      # (B, H, Hk, D, P, pps, lens)
    for B, H, Hk, D, P, pps, longest in ((8, 9, 3, 64, 16, 128, 2047),
                                         (4, 32, 8, 128, 16, 64, 1023)):
        mp = min(pps, 2 ** math.ceil(math.log2(-(-longest // P))))
        per, _ = paged_attention.split_plan(B, Hk, mp, P)
        scenes.append((B, H, Hk, D, P, pps, split_lens(B, P, pps, per,
                                                        longest)))
    scenes.append((8, 9, 3, 64, 16, 32, [0, 0, 0, 0, 0, 300, 0, 0]))
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, Hk, D, P, pps, lens in scenes:
            mp = min(pps, 2 ** math.ceil(math.log2(max(1, -(-max(lens) // P)))))
            for softcap in (None, 30.0):
                for poisoned in (False, True):
                    q, k, v, table, sl, kn, vn = decode_inputs(
                        gen, B, H, Hk, D, P, pps, lens, dtype, dev)
                    pt = poison(table, lens, P, k.shape[0]) if poisoned else table
                    for name, steps in (("decode", mp), ("paged_decode", pps)):
                        fused = name == "decode"
                        if fused:
                            call = functools.partial(
                                ops.batched_paged_decode_attention, q, k, v,
                                pt, sl, kn, vn, max_pages=mp,
                                logit_softcap=softcap, impl="cuda")
                            want = ops.batched_paged_decode_attention(
                                q, k, v, table, sl, kn, vn,
                                logit_softcap=softcap, impl="reference")
                        else:
                            call = functools.partial(
                                ops.paged_decode_attention, q, k, v, pt, sl,
                                logit_softcap=softcap, impl="cuda")
                            want = ops.paged_decode_attention(
                                q, k, v, table, sl, logit_softcap=softcap,
                                impl="reference")
                        per, S = paged_attention.split_plan(B, Hk, steps, P)
                        split = ref.paged_decode_split_ref(
                            q, k, v, table, sl, *((kn, vn) if fused else ()),
                            pages_per_split=per, n_page_steps=steps,
                            logit_softcap=softcap)
                        got, again = call(), call()
                        torch.cuda.synchronize()
                        err = max(max_err(got, want), max_err(got, split))
                        key = (name, str(dtype).split(".")[-1])
                        worst[key] = max(worst.get(key, 0.0), err)
                        n_cases += 1
                        empty = [b for b, n in enumerate(lens) if n == 0]
                        if not (within(got, want, dtype)
                                and within(got, split, dtype)):
                            fail(f"{name} kernel at split edges: {dtype} B{B} "
                                 f"H{H} Hk{Hk} D{D} P{P} pps{pps} lens {lens} "
                                 f"plan ({per}, {S}) softcap={softcap} "
                                 f"poisoned={poisoned}: max abs err {err} > "
                                 f"tol {TOL[dtype]}")
                        if not torch.equal(got, again):
                            fail(f"{name} kernel not bit-identical across two "
                                 f"calls: {dtype} B{B} lens {lens}")
                        if not fused and got[empty].any():
                            fail(f"paged_decode kernel: a seq_len-0 row is not "
                                 f"zero ({dtype} B{B} lens {lens})")
    for tickets in paged_attention._tickets.values():
        if tickets.any():
            fail("paged decode: a merge counter was left nonzero")
    return n_cases


def time_ms(fn, flush):
    """Median over TIMING_REPS of one call between CUDA events, after a
    warm-up, with L2 flushed before each call (the engine reaches each
    layer's pages cold: the pool is larger than L2)."""
    for _ in range(5):
        fn()
    times = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(TIMING_REPS):
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, flush, reps=20, tries=3):
    """The device time of one call: its kernels' time on the card, summed
    by torch.profiler over ``reps`` calls with L2 flushed before each
    (the flush's own fill left out). ``time_ms`` also holds the host's
    time to issue the call, which the card waits through on a small one.
    A profile that caught no kernel is taken again, up to ``tries``
    times; None if none did."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "FillFunctor<unsigned char>" not in e.key
                 and not e.key.startswith("Memset"))
        if us > 0:
            return us / 1e3 / reps
    return None


def kernels_per_call(fn):
    """CUDA kernels one call of ``fn`` launches, counted by
    torch.profiler (fills and memsets left out, as in ``device_ms``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "FillFunctor<unsigned char>" not in e.key
               and not e.key.startswith("Memset"))


def decode_timing_scene(dev):
    """The engine's decode call at full width: 8 slots, 9 q over 3 kv
    heads, D 64, page 16, 32-page tables, bf16, lengths mid-run."""
    gen = torch.Generator(device=dev).manual_seed(1)
    B, H, Hk, D, P, pps = 8, 9, 3, 64, 16, 32
    lens = [128, 135, 142, 150, 160, 171, 183, 191]
    args = decode_inputs(gen, B, H, Hk, D, P, pps, lens, torch.bfloat16, dev)
    max_pages = 16                    # next power of two over ceil(191/16)
    return args, max_pages


def long_decode_timing_scene(dev):
    """The batched decode call at long context: 8 sequences of 1,900 to
    2,047 tokens, full-width smollm-135m heads, 128-page tables, bf16."""
    gen = torch.Generator(device=dev).manual_seed(7)
    B, H, Hk, D, P, pps = 8, 9, 3, 64, 16, 128
    lens = [1900 + 21 * b for b in range(B)]
    args = decode_inputs(gen, B, H, Hk, D, P, pps, lens, torch.bfloat16, dev)
    return args, 128                 # next power of two over ceil(2047/16)


def prefill_timing_scene(dev, q_offset=0):
    """The engine's prefill call at full width: one 128-token chunk (the
    chunk budget) at ``q_offset`` (0, or 128 after a prefix-cache hit:
    256 resident tokens), bf16."""
    gen = torch.Generator(device=dev).manual_seed(2)
    return prefill_inputs(gen, 1, 128, 9, 3, 64, 16, 32, [q_offset],
                          torch.bfloat16, dev)


def decode_bound(q, lens, P, Hk, D, max_pages):
    e = q.element_size()
    B, H, _ = q.shape
    toks = [min(int(n), max_pages * P) for n in lens]
    n_bytes = (2 * B * H * D * e                     # q in, out
               + sum(toks) * Hk * D * 2 * e          # K and V read once
               + B * Hk * D * 2 * e                  # k_new, v_new
               + sum(-(-t // P) for t in toks) * 4 + B * 4)
    flops = sum(4 * H * D * (t + 1) for t in toks)
    return n_bytes, flops


def prefill_bound(q, offsets, kv_lens, P, Hk, D):
    e = q.element_size()
    B, C, H, _ = q.shape
    n_bytes = flops = 0
    for off, kv in zip(offsets, kv_lens):
        off, kv = int(off), int(kv)
        n_bytes += 2 * C * H * D * e + kv * Hk * D * 2 * e + -(-kv // P) * 4 + 8
        flops += sum(4 * H * D * (min(off + c, kv - 1) + 1)
                     for c in range(C) if off + c < kv)
    return n_bytes, flops


def paged_decode_bound(q, lens, P, Hk, D):
    e = q.element_size()
    B, H, _ = q.shape
    n_bytes = (2 * B * H * D * e + sum(lens) * Hk * D * 2 * e
               + sum(-(-n // P) for n in lens) * 4 + B * 4)
    return n_bytes, sum(4 * H * D * n for n in lens)


def flash_bound(q, k, causal=True, window=None, prefix_len=0):
    """Bytes of q, k, v and out once each, and 4 * D FLOPs per visible
    (query head, key) pair under this call's mask."""
    e = q.element_size()
    B, Lq, H, D = q.shape
    Lk, Hk = k.shape[1], k.shape[2]
    q_pos = torch.arange(Lq)[:, None] + (Lk - Lq)
    k_pos = torch.arange(Lk)[None, :]
    mask = torch.ones(Lq, Lk, dtype=torch.bool)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    if prefix_len:
        mask |= k_pos < prefix_len
    n_bytes = 2 * B * Lq * H * D * e + 2 * B * Lk * Hk * D * e
    return n_bytes, 4 * B * H * D * int(mask.sum())


def ssd_bound(B, L, H, G, P, N, chunk, elem):
    """Bytes of x, a, b, c and y once each, and the least matrix-product
    FLOPs the function needs on these chunks of q tokens: the causal
    half of C B^T once per (batch, group) (q (q + 1) N), the decayed
    scores times X per (batch, head) over the same half (q (q + 1) P),
    and per head C . state^T for every chunk but the first (its state is
    zero) and the state update for every chunk but the last (no final
    state is returned), 2 q N P each. The elementwise decays (about
    q^2 / 2 exponentials per head and chunk) add under 1% and are left
    out."""
    n_bytes = (2 * B * L * H * P + B * L * H + 2 * B * L * G * N) * elem
    qs = [min(chunk, L - i) for i in range(0, L, chunk)]
    flops = (B * G * sum(q * (q + 1) * N for q in qs)
             + B * H * sum(q * (q + 1) * P for q in qs)
             + B * H * 2 * N * P * (sum(qs[1:]) + sum(qs[:-1])))
    return n_bytes, flops


def sdpa_paged_inputs(q, k, v, table, lens):
    """Gathered contiguous K/V and the length mask, for the per-sequence
    decode kernel's function."""
    B, H, D = q.shape
    Hk = k.shape[2]
    kg = k[table.long()].reshape(B, -1, Hk, D)
    vg = v[table.long()].reshape(B, -1, Hk, D)
    mask = torch.arange(kg.shape[1], device=q.device)[None] < lens.long()[:, None]
    return (q[:, :, None], kg.transpose(1, 2).contiguous(),
            vg.transpose(1, 2).contiguous(), mask[:, None, None])


def flash_timing_scene(dev, B, L):
    """Full-width smollm-135m attention: ``B`` sequences of ``L`` tokens
    (the slot-ring engine's one-prompt bucket, or the dense trainer's
    batch), 9 q over 3 kv heads, D 64, causal, bf16."""
    gen = torch.Generator(device=dev).manual_seed(4)
    return flash_inputs(gen, B, L, L, 9, 3, 64, torch.bfloat16, dev)


def sdpa_decode_inputs(q, k, v, table, lens, kn, vn):
    """Gathered contiguous K/V with the new token placed at seq_len, and
    the length mask: what SDPA needs to compute the decode kernel's
    function."""
    B, H, D = q.shape
    Hk = k.shape[2]
    kg = k[table.long()].reshape(B, -1, Hk, D)
    vg = v[table.long()].reshape(B, -1, Hk, D)
    pad = kg.new_zeros(B, 1, Hk, D)
    kg, vg = torch.cat([kg, pad], 1), torch.cat([vg, pad], 1)
    rows = torch.arange(B, device=q.device)
    kg[rows, lens.long()] = kn
    vg[rows, lens.long()] = vn
    S = kg.shape[1]
    mask = torch.arange(S, device=q.device)[None] <= lens.long()[:, None]
    return (q[:, :, None], kg.transpose(1, 2).contiguous(),
            vg.transpose(1, 2).contiguous(), mask[:, None, None])


def sdpa_prefill_inputs(q, k, v, table, off, kv):
    B, C, H, D = q.shape
    Hk = k.shape[2]
    kg = k[table.long()].reshape(B, -1, Hk, D)
    vg = v[table.long()].reshape(B, -1, Hk, D)
    S = kg.shape[1]
    q_pos = off.long()[:, None] + torch.arange(C, device=q.device)
    k_pos = torch.arange(S, device=q.device)
    mask = (k_pos[None, None] <= q_pos[:, :, None]) & \
        (k_pos[None, None] < kv.long()[:, None, None])
    return (q.transpose(1, 2).contiguous(), kg.transpose(1, 2).contiguous(),
            vg.transpose(1, 2).contiguous(), mask[:, None])


def timings(kernel, plain, library, flush):
    """A row's times: ``ms``, ``plain_ms`` and ``library_ms`` per call
    (CUDA events, the host's issue time included, as in every earlier
    table), and ``device_ms`` and ``library_device_ms``, the kernels'
    own time on the card."""
    out = dict(ms=time_ms(kernel, flush), plain_ms=time_ms(plain, flush),
               library_ms=None, device_ms=device_ms(kernel, flush),
               library_device_ms=None)
    if library is not None:
        out.update(library_ms=time_ms(library, flush),
                   library_device_ms=device_ms(library, flush))
    return out


def kernel_times_phase(dev):
    from repro_torch.kernels import ops, paged_attention, ssd_scan
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = []

    # the engine's decode call is the table's row; 8 sequences of ~2,000
    # tokens are timed beside it (there the bound is microseconds)
    extra = []
    for scene, path in ((decode_timing_scene, "paged engine (decode)"),
                        (long_decode_timing_scene,
                         "long context (8 x 1,900-2,047 tokens)")):
        (q, k, v, table, lens, kn, vn), mp = scene(dev)
        args = (q, k, v, table, lens, kn, vn)
        got = ops.batched_paged_decode_attention(*args, max_pages=mp,
                                                 impl="cuda")
        want = ops.batched_paged_decode_attention(*args, impl="reference")
        err = max_err(got, want)
        if not within(got, want, torch.bfloat16):
            fail(f"decode kernel vs plain, {path}: max abs err {err}")
        sq, sk, sv, smask = sdpa_decode_inputs(*args)
        _, P, Hk, D = k.shape
        n_bytes, flops = decode_bound(q, lens.tolist(), P, Hk, D, mp)
        (rows if scene is decode_timing_scene else extra).append(dict(
            name="batched_paged_decode_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/paged_decode.cu",
            replaces="src/repro/kernels/paged_attention.py:242",
            max_abs_err=err, path=path,
            split_plan=paged_attention.split_plan(q.shape[0], Hk, mp, P),
            **timings(lambda: ops.batched_paged_decode_attention(
                *args, max_pages=mp, impl="cuda"),
                lambda: ops.batched_paged_decode_attention(
                    *args, impl="reference"),
                lambda: sdpa(sq, sk, sv, attn_mask=smask, enable_gqa=True),
                flush),
            bytes=n_bytes, flops=flops))

    # the chunk at q_offset 0 is the table's row; the same chunk after a
    # 128-token prefix-cache hit is timed beside it
    for q_offset in (0, 128):
        q, k, v, table, off, kv = prefill_timing_scene(dev, q_offset)
        args = (q, k, v, table, off, kv)
        got = ops.chunked_prefill_attention(*args, impl="cuda")
        want = ops.chunked_prefill_attention(*args, impl="reference")
        err = max_err(got, want)
        if not within(got, want, torch.bfloat16):
            fail(f"prefill kernel vs plain at engine shapes, q_offset "
                 f"{q_offset}: max abs err {err}")
        sq, sk, sv, smask = sdpa_prefill_inputs(*args)
        _, P, Hk, D = k.shape
        n_bytes, flops = prefill_bound(q, off.tolist(), kv.tolist(), P, Hk, D)
        (extra if q_offset else rows).append(dict(
            name="chunked_prefill_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/chunked_prefill.cu",
            replaces="src/repro/kernels/chunked_prefill.py:112",
            max_abs_err=err, q_offset=q_offset, kv_len=int(kv[0]),
            path=("paged engine (prefill chunk after a prefix-cache hit)"
                  if q_offset else "paged engine (prefill chunks)"),
            **timings(lambda: ops.chunked_prefill_attention(
                *args, impl="cuda"),
                lambda: ops.chunked_prefill_attention(
                    *args, impl="reference"),
                lambda: sdpa(sq, sk, sv, attn_mask=smask, enable_gqa=True),
                flush),
            bytes=n_bytes, flops=flops))

    (q, k, v, table, lens, _, _), _ = decode_timing_scene(dev)
    args = (q, k, v, table, lens)
    got = ops.paged_decode_attention(*args, impl="cuda")
    want = ops.paged_decode_attention(*args, impl="reference")
    err = max_err(got, want)
    if not within(got, want, torch.bfloat16):
        fail(f"per-sequence decode kernel vs plain at engine shapes: "
             f"max abs err {err}")
    sq, sk, sv, smask = sdpa_paged_inputs(*args)
    _, P, Hk, D = k.shape
    n_bytes, flops = paged_decode_bound(q, lens.tolist(), P, Hk, D)
    rows.append(dict(
        name="paged_decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_decode.cu",
        replaces="src/repro/kernels/paged_attention.py:108",
        max_abs_err=err,
        split_plan=paged_attention.split_plan(q.shape[0], Hk,
                                              table.shape[1], P),
        **timings(lambda: ops.paged_decode_attention(*args, impl="cuda"),
                  lambda: ops.paged_decode_attention(*args,
                                                     impl="reference"),
                  lambda: sdpa(sq, sk, sv, attn_mask=smask, enable_gqa=True),
                  flush),
        bytes=n_bytes, flops=flops))

    # the slot-ring engine run prefills 64-token buckets only (its
    # prompts are all <= 64 tokens): that is the main path's shape and
    # the table's row; the largest bucket, 256, and the dense trainer's
    # batch 8 x 512 are timed beside it
    for B, L, path in ((1, 64, "slot-ring engine (prefill)"),
                       (1, 256, "slot-ring engine (prefill)"),
                       (8, 512, "trainer (dense forward)")):
        q, k, v = flash_timing_scene(dev, B, L)
        got = ops.attention(q, k, v, impl="cuda")
        want = ops.attention(q, k, v, impl="reference")
        err = max_err(got, want)
        if not within(got, want, torch.bfloat16):
            fail(f"flash kernel vs plain at B {B} L {L}: max abs err {err}")
        sq, sk, sv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        n_bytes, flops = flash_bound(q, k)
        (rows if L == 64 else extra).append(dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:124",
            max_abs_err=err, batch=B, tokens=L, path=path,
            **timings(lambda: ops.attention(q, k, v, impl="cuda"),
                      lambda: ops.attention(q, k, v, impl="reference"),
                      lambda: sdpa(sq, sk, sv, is_causal=True,
                                   enable_gqa=True), flush),
            bytes=n_bytes, flops=flops))

    # the trainer's SSD call on mamba2-2.7b: batch 2 x 2048 tokens, 80
    # heads of 64, state 128, one group, chunk 256, bf16
    gen = torch.Generator(device=dev).manual_seed(6)
    shape = (2, 2048, 80, 1, 64, 128)
    x, a, b, c = ssd_inputs(gen, *shape, torch.bfloat16, dev)
    got = ops.ssd(x, a, b, c, chunk=256, impl="cuda")
    want = ops.ssd(x, a, b, c, chunk=256, impl="reference")
    err = max_err(got, want)
    if not within(got, want, torch.bfloat16, ssd=True):
        fail(f"ssd kernel vs plain at the train shape: max abs err {err}")
    # ungated: the share of bf16 outputs that differ from bf16 of the plain
    # version in float32 (one ulp each; tensor cores truncate their sums)
    want32 = ops.ssd(*(t.float() for t in (x, a, b, c)), chunk=256,
                     impl="reference").to(torch.bfloat16)
    mismatch = (got != want32).float().mean().item()
    del want32
    n_bytes, flops = ssd_bound(*shape, 256, x.element_size())
    # one call is one count of ssd_scan.launches and three CUDA launches
    # (chunk states, state pass, chunk scan)
    n_cuda = kernels_per_call(lambda: ops.ssd(x, a, b, c, chunk=256,
                                              impl="cuda"))
    if n_cuda != ssd_scan.cuda_launches(shape[1], 256):
        fail(f"ssd_scan: {n_cuda} CUDA launches per call, want "
             f"{ssd_scan.cuda_launches(shape[1], 256)}")
    rows.append(dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:88",
        max_abs_err=err, cuda_launches_per_call=n_cuda,
        bf16_share_off_f32_plain=mismatch,
        **timings(lambda: ops.ssd(x, a, b, c, chunk=256, impl="cuda"),
                  lambda: ops.ssd(x, a, b, c, chunk=256, impl="reference"),
                  None, flush),
        bytes=n_bytes, flops=flops))
    del x, a, b, c, got, want

    path = {"batched_paged_decode_attention": "paged engine (decode)",
            "paged_decode_attention": "none (no engine path)",
            "ssd_scan": "trainer (mamba2 forward)"}
    for r in rows + extra:
        r.setdefault("path", path.get(r["name"]))
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / BF16_FLOPS_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        # the rates the kernel reached: FLOPs and bytes over its device time
        if r["device_ms"]:
            r["tflop_per_s"] = r["flops"] / r["device_ms"] / 1e9
            r["gb_per_s"] = r["bytes"] / r["device_ms"] / 1e6
        phase("kernel_times", **r)
    torch.cuda.synchronize()
    return rows


# the engines' configurations, both at full width: the paged cache (with
# chunked prefill and the prefix cache) and the slot-ring cache
# (paged=False, the default of both engines)
PAGED_ENGINE = dict(paged=True, n_slots=8, max_len=512, page_size=16,
                    prompt_buckets=(64, 128, 256), chunk_prefill_tokens=128,
                    prefix_cache=True, prefix_cache_pages=64)
SLOT_ENGINE = dict(paged=False, n_slots=8, max_len=512,
                   prompt_buckets=(64, 128, 256), chunk_prefill_tokens=128)


def kernel_counters():
    """Each kernel's name -> (module, attribute) of its launch count."""
    from repro_torch.kernels import (chunked_prefill, flash_attention,
                                     paged_attention, ssd_scan)
    return {
        "batched_paged_decode_attention": (paged_attention, "launches"),
        "chunked_prefill_attention": (chunked_prefill, "launches"),
        "paged_decode_attention": (paged_attention, "paged_decode_launches"),
        "flash_attention": (flash_attention, "launches"),
        "ssd_scan": (ssd_scan, "launches"),
    }


def reset_launches() -> None:
    for mod, attr in kernel_counters().values():
        setattr(mod, attr, 0)


def read_launches() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in kernel_counters().items()}


def serve(cfg, params, dev, ecfg, n, seed, **gen_kw):
    """A fresh engine with ``n`` requests of the port's generator queued
    under DriftScheduler("sjf")."""
    from repro_torch.core.scheduler import DriftScheduler
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.workload.generator import GeneratorConfig, WorkloadGenerator
    sched = DriftScheduler("sjf")
    eng = ServingEngine(cfg, params, sched, EngineConfig(**ecfg), device=dev)
    gen = WorkloadGenerator(GeneratorConfig(
        total_requests=n, calibration_requests=n, max_tokens=64, seed=seed,
        **gen_kw))
    reqs = [r for _, r in gen.plan(seed=seed).calibration]
    for i, r in enumerate(reqs):
        sched.submit(r, 1e-6 * i)
    return eng, sched, reqs


def drain(eng):
    """Serve everything queued, with every launch count set to 0 just
    before and read just after: (metrics, wall seconds, launches)."""
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = eng.run_until_drained()
    torch.cuda.synchronize()
    return metrics, time.perf_counter() - t0, read_launches()


def engine_phase(dev):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_api

    cfg = get_config("smollm-135m")
    t0 = time.perf_counter()
    params = get_api(cfg).init(cfg, torch.Generator().manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng, sched, reqs = serve(cfg, params, dev, PAGED_ENGINE, 24, 0,
                             shared_prefix_tokens=64)
    metrics, wall, launches = drain(eng)

    tokens = sum(r.observed_output_tokens for r in sched.completed)
    chunk_lens = {}
    for _, n in eng.prefill_chunk_log:
        chunk_lens[n] = chunk_lens.get(n, 0) + 1
    phase("engine", arch=cfg.name, n_layers=cfg.n_layers, dtype=cfg.dtype,
          init_s=init_s, wall_s=wall, iterations=eng.step_count,
          decode_iterations=eng.n_decode_launches,
          prefill_chunks=eng.n_prefill_launches,
          completed=metrics.n_completed, tokens=tokens,
          tokens_per_s=tokens / wall, ms_per_iteration=1e3 * wall / eng.step_count,
          prefix=eng.prefix_cache_stats(), chunk_lengths=chunk_lens,
          launches=launches)
    if metrics.n_completed != len(reqs):
        fail(f"engine completed {metrics.n_completed} of {len(reqs)}")
    if launches["batched_paged_decode_attention"] != \
            cfg.n_layers * eng.n_decode_launches:
        fail(f"decode launches {launches} != {cfg.n_layers} x "
             f"{eng.n_decode_launches} decode iterations")
    if eng.n_prefill_launches <= 0 or launches["chunked_prefill_attention"] \
            != cfg.n_layers * eng.n_prefill_launches:
        fail(f"prefill launches {launches} != {cfg.n_layers} x "
             f"{eng.n_prefill_launches} prefill chunks")
    if launches["paged_decode_attention"] or launches["flash_attention"] \
            or launches["ssd_scan"]:
        fail(f"the paged engine launched a kernel of another path: {launches}")
    if eng.prefix_cache_stats()["hits"] <= 0:
        fail("no prefix-cache hit in the engine run")
    return cfg, params, eng, launches


def engine_slot_phase(cfg, params, dev):
    """The slot-ring engine (paged=False) on the same model: each
    admission prefills its bucket in one shot (one flash-attention
    launch per layer), then decodes from the contiguous cache."""
    eng, sched, reqs = serve(cfg, params, dev, SLOT_ENGINE, 24, 0)
    metrics, wall, launches = drain(eng)
    tokens = sum(r.observed_output_tokens for r in sched.completed)
    # a request's first token comes from its one single-shot prefill
    prefills = sum(r.prefill_end is not None for r in sched.completed)
    buckets = {}
    for r in sched.completed:
        b = next((b for b in SLOT_ENGINE["prompt_buckets"]
                  if max(r.prompt_tokens, 1) <= b),
                 SLOT_ENGINE["prompt_buckets"][-1])
        buckets[b] = buckets.get(b, 0) + 1
    phase("engine_slot", arch=cfg.name, n_layers=cfg.n_layers,
          dtype=cfg.dtype, wall_s=wall, iterations=eng.step_count,
          decode_iterations=eng.n_decode_launches, prefills=prefills,
          prefill_buckets=buckets, completed=metrics.n_completed,
          tokens=tokens, tokens_per_s=tokens / wall,
          ms_per_iteration=1e3 * wall / eng.step_count, launches=launches)
    if metrics.n_completed != len(reqs) or prefills != len(reqs):
        fail(f"slot-ring engine completed {metrics.n_completed} of "
             f"{len(reqs)} ({prefills} prefills)")
    if launches["flash_attention"] != cfg.n_layers * prefills:
        fail(f"flash launches {launches} != {cfg.n_layers} x {prefills} "
             "prefills")
    others = {k: n for k, n in launches.items() if k != "flash_attention"}
    if any(others.values()):
        fail(f"the slot-ring engine launched a kernel of another path: {others}")
    return launches


def engine_profile_phase(cfg, params, dev, label, ecfg, steps=24, **gen_kw):
    """Where an engine iteration's time goes: ``steps`` iterations of a
    fresh full-width engine under torch.profiler. Device time is the sum
    of kernel and copy time on the GPU; its share of the profiled wall
    time is how busy the host keeps the card."""
    from torch.profiler import ProfilerActivity, profile
    eng, _, _ = serve(cfg, params, dev, ecfg, 8, 1, **gen_kw)
    for i in range(4):                     # admit + prefill, then decode
        eng.step(float(i))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            eng.step(4.0 + i)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    profile_summary(label, prof, steps, wall_ms, "iteration")


def profile_summary(label, prof, steps, wall_ms, unit, skip=(), **fields):
    """Device time per ``unit`` (iteration or step), its share of the
    profiled wall time, and the top device items. Device-side events
    only (kernels, copies): a CPU op's own device time is the same
    kernels again, and so is the device-side span of a profiler range
    named in ``skip``."""
    per_kernel = {}     # kernel name cut to 60 characters -> (us, count)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key in skip:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        us, n = per_kernel.get(e.key[:60], (0.0, 0))
        per_kernel[e.key[:60]] = (us + dev_us, n + e.count)
    device_ms = sum(us for us, _ in per_kernel.values()) / 1e3
    launches = sum(n for _, n in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    phase(label, **{
        f"{unit}s": steps,
        f"profiled_wall_ms_per_{unit}": wall_ms / steps,
        f"device_ms_per_{unit}": device_ms / steps,
        "device_busy_share": device_ms / wall_ms,
        f"device_launches_per_{unit}": launches / steps,
        f"top_device_ms_per_{unit}": {
            k: round(us / 1e3 / steps, 4) for k, (us, _) in top},
        f"top_launches_per_{unit}": {
            k: n / steps for k, (_, n) in top}}, **fields)
    if device_ms <= 0:
        fail(f"{label}: profiler saw no device time")


def check_logits(label, kern, plain, plain32, **fields):
    """Kernel-path logits against the plain path's, within the plain
    path's own bf16-vs-float32 deviation; a greedy flip only at a
    near-tie of the plain path."""
    from repro_torch.models.steps import sample_logits
    tol = max(max_err(a, b) for a, b in zip(plain, plain32))
    worst, ties, rows = 0.0, 0, 0
    for got, want in zip(kern, plain):
        worst = max(worst, max_err(got, want))
        g_tok, w_tok = sample_logits(got, None), sample_logits(want, None)
        rows += len(g_tok)
        for b in torch.nonzero(g_tok != w_tok).flatten().tolist():
            gap = (want[b, w_tok[b]] - want[b, g_tok[b]]).item()
            if gap > tol:
                fail(f"{label}: greedy token differs in row {b}: kernels "
                     f"{g_tok[b].item()} vs plain {w_tok[b].item()}, "
                     f"plain-path gap {gap} > {tol}")
            ties += 1
    phase(label, max_abs_logit_err=worst, tol_bf16_vs_f32_plain=tol,
          logit_std=plain[-1].std().item(), greedy_rows=rows,
          near_tie_flips=ties, **fields)
    if worst > tol:
        fail(f"{label}: logits kernels vs plain: max abs err {worst} > {tol}")


def engine_slot_check_phase(cfg, params, dev):
    """One full-width prefill of four 256-token prompts (flash kernel)
    and one decode step from the cache it made, against the same calls
    through the plain versions."""
    from repro_torch.kernels import ref
    from repro_torch.models import transformer
    plain_flash = ref.flash_attention_chunked
    gen = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(1, cfg.vocab, (4, 256), generator=gen, device=dev)
    step = torch.randint(1, cfg.vocab, (4,), generator=gen, device=dev)

    def run(impl, dtype):
        p = params if dtype is None else _cast(params, dtype)
        c = cfg if dtype is None else cfg.replace(dtype="float32")
        lp, cache = transformer.prefill(c, p, tokens, max_len=512, impl=impl)
        ld, _ = transformer.decode_step(c, p, cache, step, 256)
        return lp.float(), ld.float()

    reset_launches()
    kern = run("auto", None)
    n_flash = read_launches()["flash_attention"]
    plain, plain32 = run("reference", None), run("reference", torch.float32)
    # the gate's resolution: the plain path again with its online softmax
    # over 16- to 128-key blocks (the same float32 function, summed in
    # another order) against the plain path; printed, not gated
    spread = {}
    for block_kv in (16, 32, 64, 128):
        with mock.patch.object(ref, "flash_attention_chunked", functools.partial(
                plain_flash, block_kv=block_kv)):
            reordered = run("reference", None)
        spread[block_kv] = max(max_err(a, b) for a, b in zip(reordered, plain))
    torch.cuda.synchronize()
    if n_flash != cfg.n_layers:
        fail(f"engine_slot_check: {n_flash} flash launches for one "
             f"{cfg.n_layers}-layer prefill")
    check_logits("engine_slot_check", kern, plain, plain32,
                 plain_reordered_max_abs_logit_err=spread)


def engine_check_phase(cfg, params, eng, dev):
    """One full-width prefill chunk and one decode step through the
    kernels against the same calls through the plain versions, each
    from a copy of the engine's pool after its run."""
    from repro_torch.models import transformer
    gen = torch.Generator(device=dev).manual_seed(3)
    pps = eng.alloc.pages_per_seq
    n_pages = eng.pool.n_pages
    tables = torch.randperm(n_pages - 1, generator=gen, device=dev)[
        :8 * pps].reshape(8, pps).to(torch.int32)
    chunk = torch.randint(1, cfg.vocab, (1, 128), generator=gen, device=dev)
    q_offset = torch.tensor([64], dtype=torch.int32, device=dev)
    step_tokens = torch.randint(1, cfg.vocab, (8,), generator=gen, device=dev)
    lens = torch.tensor([192, 0, 77, 130, 255, 16, 200, 98],
                        dtype=torch.int32, device=dev)
    step_tables = tables.clone()
    step_tables[1] = n_pages - 1                   # an inactive slot

    def run(impl, dtype):
        p = params if dtype is None else _cast(params, dtype)
        c = cfg if dtype is None else cfg.replace(dtype="float32")
        k, v = eng.pool.k, eng.pool.v
        lp = transformer.prefill_chunk_paged(
            c, p, {"k": k.to(dtype or k.dtype, copy=True),
                   "v": v.to(dtype or v.dtype, copy=True)},
            chunk, tables[:1], q_offset, impl=impl)
        ld = transformer.decode_step_paged(
            c, p, {"k": k.to(dtype or k.dtype, copy=True),
                   "v": v.to(dtype or v.dtype, copy=True)},
            step_tokens, step_tables, lens, max_pages=16, impl=impl)
        return lp.float(), ld.float()

    kern, plain = run("auto", None), run("reference", None)
    plain32 = run("reference", torch.float32)
    torch.cuda.synchronize()
    check_logits("engine_check", kern, plain, plain32)


# ---------------------------------------------------------------------------
# prefill/decode disaggregation over the paged engines
# ---------------------------------------------------------------------------

def cluster_pd_phase(cfg, params, dev):
    """One prefill engine and two decode engines (PAGED_ENGINE each) on
    the card behind ``make_engine_cluster``'s pd_disaggregated routing:
    every request prefills on engine 0 (chunked-prefill kernel), its
    first token hands it off, its KV pages are gathered off the source
    pool into tensors on the card and scattered into a decode engine's
    pool, which decodes it (batched-decode kernel)."""
    from repro_torch.cluster.driver import make_engine_cluster
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.workload.generator import GeneratorConfig, WorkloadGenerator
    drv = make_engine_cluster(
        cfg, params, 3, policy="sjf", routing="pd_disaggregated",
        n_prefill_replicas=1, engine_config=EngineConfig(**PAGED_ENGINE),
        device=dev)
    pre = drv.replicas[0].engine
    decoders = [rep.engine for rep in drv.replicas[1:]]
    moved = []                         # KV bytes of each handoff
    extract = pre.extract_sequence

    def counted_extract(slot):
        payload = extract(slot)
        if not (payload["k"].is_cuda and payload["v"].is_cuda):
            fail("cluster_pd: a KV payload left the card")
        moved.append(payload["k"].nbytes + payload["v"].nbytes)
        return payload
    pre.extract_sequence = counted_extract
    rounds = 0
    step = drv.step

    def counted_step(now):
        nonlocal rounds
        rounds += 1
        return step(now)
    drv.step = counted_step

    gen = WorkloadGenerator(GeneratorConfig(
        total_requests=24, calibration_requests=24, max_tokens=64, seed=0,
        shared_prefix_tokens=64))
    reqs = [r for _, r in gen.plan(seed=0).calibration]
    for i, r in enumerate(reqs):
        if not drv.submit(r, 1e-6 * i):
            fail(f"cluster_pd: request {i} was shed")
    metrics, wall, launches = drain(drv)

    done = [r for rep in drv.replicas for r in rep.sched.completed]
    tokens = sum(r.observed_output_tokens for r in done)
    engines = [dict(rid=rep.rid, role=rep.role.value,
                    iterations=rep.engine.step_count,
                    decode_iterations=rep.engine.n_decode_launches,
                    prefill_chunks=rep.engine.n_prefill_launches,
                    completed=len(rep.sched.completed),
                    handoffs_out=rep.n_handoffs_out,
                    handoffs_in=rep.n_handoffs_in)
               for rep in drv.replicas]
    decode_iterations = sum(e.n_decode_launches for e in decoders)
    phase("cluster_pd", arch=cfg.name, n_layers=cfg.n_layers, dtype=cfg.dtype,
          engines=engines, wall_s=wall, rounds=rounds,
          completed=metrics.n_completed, tokens=tokens,
          tokens_per_s=tokens / wall, ms_per_round=1e3 * wall / rounds,
          handoffs=drv.n_handoffs, kv_bytes_moved=sum(moved),
          kv_bytes_per_handoff=sum(moved) / max(len(moved), 1),
          prefix=pre.prefix_cache_stats(), launches=launches)
    if metrics.n_completed != len(reqs) or len(done) != len(reqs):
        fail(f"cluster_pd completed {metrics.n_completed} of {len(reqs)}")
    if drv.n_handoffs != len(reqs) or len(moved) != len(reqs) or any(
            r.prefill_rid != 0 or r.decode_rid not in (1, 2)
            or r.handoff_time is None for r in done):
        fail(f"cluster_pd: {drv.n_handoffs} handoffs ({len(moved)} "
             f"payloads) for {len(reqs)} requests, each wants one from "
             "engine 0 to a decode engine")
    if pre.n_decode_launches:
        fail(f"cluster_pd: the prefill engine ran {pre.n_decode_launches} "
             "decode iterations")
    if pre.n_prefill_launches <= 0 or any(e.n_prefill_launches
                                          for e in decoders):
        fail("cluster_pd: prefill chunks "
             f"{[e['prefill_chunks'] for e in engines]}, want them on the "
             "prefill engine only")
    if launches["chunked_prefill_attention"] != \
            cfg.n_layers * pre.n_prefill_launches:
        fail(f"cluster_pd: prefill launches {launches} != {cfg.n_layers} x "
             f"{pre.n_prefill_launches} prefill chunks")
    if launches["batched_paged_decode_attention"] != \
            cfg.n_layers * decode_iterations:
        fail(f"cluster_pd: decode launches {launches} != {cfg.n_layers} x "
             f"{decode_iterations} decode iterations")
    if launches["paged_decode_attention"] or launches["flash_attention"] \
            or launches["ssd_scan"]:
        fail(f"cluster_pd launched a kernel of another path: {launches}")
    for rep in drv.replicas:
        e = rep.engine
        held = e.alloc.free_pages + e.ledger.owned_pages() + (
            e.prefix_tree.total_pages() if e.prefix_tree else 0)
        if held != e.alloc.n_pages:
            fail(f"cluster_pd: engine {rep.rid} holds {held} of "
                 f"{e.alloc.n_pages} pages")
    return drv


def cluster_pd_check_phase(cfg, params, drv, dev):
    """One more sequence through the drained cluster's prefill engine
    and, by hand, into decode engine 1: the payload against the source
    pool's pages, the destination's pages against the payload, and one
    batched-decode step of the sequence on each engine (same kernel,
    same inputs, batch 1) against each other, all bit for bit."""
    from repro_torch.models import transformer
    from repro_torch.workload.generator import GeneratorConfig, WorkloadGenerator
    src, dst = drv.replicas[0].engine, drv.replicas[1].engine
    gen = WorkloadGenerator(GeneratorConfig(
        total_requests=4, calibration_requests=4, max_tokens=64, seed=1,
        shared_prefix_tokens=64))
    plan = gen.plan(seed=1).calibration
    # a request whose shared prefix the source's tree holds, if any: its
    # payload then carries tree pages as well as its own
    _, req = next(((t, r) for t, r in plan if src.prefix_cached_tokens(r)),
                  plan[0])
    got = {}

    def capture(slot, r, now):
        pages = list(src.ledger.table(slot))
        payload = src.extract_sequence(slot)
        got.update(pages=pages, payload=payload, equal=all(
            torch.equal(payload["k"][:, i], src.pool.k[:, p])
            and torch.equal(payload["v"][:, i], src.pool.v[:, p])
            for i, p in enumerate(pages)))
        return True
    src.handoff_hook = capture
    now = float(src.step_count)
    src.sched.submit(req, now)
    for _ in range(16):
        if got:
            break
        src.step(now)
        now += 1.0
    if not got:
        fail("cluster_pd_check: the sequence never finished its prefill")
    if not got["equal"]:
        fail("cluster_pd_check: the extracted KV differs from the source's "
             "pages")
    payload = got["payload"]

    dst.accept_handoff(req, payload)
    if dst.sched.dispatch(now) is not req:
        fail("cluster_pd_check: the handed-off request was not dispatched")
    slot = dst.free_slots()[0]
    dst._admit_prefilled(req, slot, dst.pop_pending_injection(req.req_id), now)
    pages = list(dst.ledger.table(slot))
    index = torch.tensor(pages, device=dev)
    injected = (torch.equal(dst.pool.k[:, index], payload["k"])
                and torch.equal(dst.pool.v[:, index], payload["v"]))

    def decode(eng, pages):
        table = torch.full((1, eng.alloc.pages_per_seq), eng.pool.n_pages - 1,
                           dtype=torch.int32)       # padding: scratch page
        table[0, :len(pages)] = torch.tensor(pages, dtype=torch.int32)
        return transformer.decode_step_paged(
            cfg, params, {"k": eng.pool.k, "v": eng.pool.v},
            torch.tensor([payload["last_token"]], device=dev), table.to(dev),
            torch.tensor([payload["seq_len"]], dtype=torch.int32, device=dev),
            max_pages=eng.alloc.pages_per_seq)

    reset_launches()
    want, logits = decode(src, got["pages"]), decode(dst, pages)
    torch.cuda.synchronize()
    launches = read_launches()
    dst._release_slot(slot)
    phase("cluster_pd_check", seq_len=payload["seq_len"],
          prompt_len=payload["prompt_len"],
          cached_prefix_tokens=req.cached_prompt_tokens, pages=len(pages),
          kv_bytes=payload["k"].nbytes + payload["v"].nbytes,
          source_pages=got["pages"], destination_pages=pages,
          extract_equal=got["equal"], inject_equal=injected,
          logits_equal=torch.equal(logits, want),
          max_abs_logit_err=max_err(logits, want), launches=launches)
    if not injected:
        fail("cluster_pd_check: the destination's pages differ from the "
             "payload")
    if launches["batched_paged_decode_attention"] != 2 * cfg.n_layers or \
            sum(launches.values()) != 2 * cfg.n_layers:
        fail(f"cluster_pd_check: launches {launches}, want "
             f"{2 * cfg.n_layers} batched-decode launches and no other")
    if not torch.equal(logits, want):
        fail("cluster_pd_check: decode logits differ between the engines "
             f"(max abs err {max_err(logits, want)})")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN = dict(arch="mamba2-2.7b", batch=2, seq=2048, steps=6, lr=3e-4)
TRAIN_CHECK_LAYERS = 8
DENSE_TRAIN = dict(arch="smollm-135m", batch=8, seq=512, steps=4, lr=3e-4)


def n_params(tree) -> int:
    from repro_torch.distributed.optimizer import tree_leaves
    return sum(t.numel() for t in tree_leaves(tree))


def run_steps(setup, n, dev):
    """``n`` train steps through the launcher's code from step 0, with
    every launch count set to 0 just before and read just after: (per
    step (loss, grad norm, seconds), launches)."""
    from repro_torch.launch.train import batch_on
    params, opt_state, step_fn, ds = setup
    batches = [batch_on(ds, s, dev) for s in range(n)]
    log = []
    reset_launches()
    torch.cuda.synchronize()
    for s in range(n):
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batches[s])
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])  # synchronises
        log.append((loss, gnorm, time.perf_counter() - t0))
    torch.cuda.synchronize()
    return log, read_launches()


def train_setup(spec, dev, **cfg_kw):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_dataset
    from repro_torch.launch.train import build
    cfg = get_config(spec["arch"]).replace(**cfg_kw)
    params, _, opt_state, step_fn = build(cfg, steps=spec["steps"],
                                          lr=spec["lr"], seed=0, device=dev)
    ds = make_dataset("synthetic", cfg, spec["seq"], spec["batch"])
    return cfg, (params, opt_state, step_fn, ds)


def train_phase(dev):
    """Full-width, full-depth mamba2-2.7b: 6 AdamW steps, remat on."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, setup = train_setup(TRAIN, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log, launches = run_steps(setup, TRAIN["steps"], dev)
    secs = statistics.median(t for _, _, t in log[1:])
    tokens = TRAIN["batch"] * TRAIN["seq"]
    want = 2 * cfg.n_layers * TRAIN["steps"]
    phase("train", arch=cfg.name, n_layers=cfg.n_layers, dtype=cfg.dtype,
          params=n_params(setup[0]), param_count=cfg.param_count(),
          batch=TRAIN["batch"], seq=TRAIN["seq"],
          remat=True, init_s=init_s, loss=[l for l, _, _ in log],
          grad_norm=[g for _, g, _ in log], step_s=[t for _, _, t in log],
          median_step_s_2_to_6=secs, tokens_per_s=tokens / secs,
          peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
          launches=launches, ssd_launches_expected=want)
    if not all(math.isfinite(l) and math.isfinite(g) for l, g, _ in log):
        fail(f"train: a loss or grad norm is not finite: {log}")
    if launches["ssd_scan"] != want:
        fail(f"train: {launches['ssd_scan']} SSD launches, want 2 x "
             f"{cfg.n_layers} x {TRAIN['steps']} = {want}")
    others = {k: n for k, n in launches.items() if k != "ssd_scan"}
    if any(others.values()):
        fail(f"train: an attention kernel ran in the SSM trainer: {others}")
    return cfg, setup


def train_profile_phase(setup, dev):
    """One more step of the same trainer under torch.profiler, with the
    device time of the kernels launched inside each profiler range of
    the step: the SSD kernel's forward calls, the plain SSD backward
    and the AdamW update (ungated)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.launch.train import batch_on
    from repro_torch.models.steps import OPTIMIZER_UPDATE
    ranges = (ops.SSD_FORWARD, ops.SSD_BACKWARD, OPTIMIZER_UPDATE)
    params, opt_state, step_fn, ds = setup
    batch = batch_on(ds, TRAIN["steps"], dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    range_ms = {r: 0.0 for r in ranges}
    range_calls = {r: 0 for r in ranges}
    for e in prof.events():
        if e.name in range_ms and e.device_type == torch.autograd.DeviceType.CPU:
            range_ms[e.name] += e.device_time_total / 1e3
            range_calls[e.name] += 1
    # the profiler gives a range the kernels PyTorch launched in it, not
    # those launched through ctypes: the SSD forward's device time is its
    # own kernels', by name
    fwd_us, fwd_n = 0.0, 0
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and re.search(r"\bssd_(states|state_pass|scan)_?\w*<", e.key)):
            fwd_us += e.self_device_time_total
            fwd_n += e.count
    range_ms[ops.SSD_FORWARD] = fwd_us / 1e3
    profile_summary("train_profile", prof, 1, wall_ms, "step", skip=ranges,
                    range_device_ms_per_step=range_ms,
                    range_calls_per_step=range_calls,
                    ssd_forward_cuda_launches_per_step=fwd_n)


def train_check_phase(dev, label, spec, names, kernel, n_layers=None,
                      gate="bfloat16", reorder=None):
    """Loss, grad norm and the gradients of the leaves ``names`` (name ->
    path in the tree) of one step at full width, depth cut to
    ``n_layers`` if given: the kernel path against the plain path, within
    the plain path's bf16-vs-float32 deviation. ``kernel`` runs twice per
    layer (forward and its recompute under remat).

    ``gate`` is the dtype of the kernel-vs-plain comparison that must
    hold. "bfloat16" compares the two bf16 paths. "float32" runs the
    kernel path once more in float32 and compares it with the float32
    plain path; the bf16 comparison is then printed only. That is for a
    model deep enough that the two bf16 paths decorrelate: one bf16 ulp
    of a kernel output changes later roundings everywhere, so the bf16
    kernel path deviates from the bf16 plain path about as much as bf16
    deviates from float32, and one such draw is no bound on another.

    ``reorder`` (config fields) gives the plain path another, equally
    valid order of its sums; its deviation from the plain path is
    printed, ungated: how far a change of order alone moves these
    numbers."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_dataset
    from repro_torch.distributed.optimizer import global_norm, tree_leaves
    from repro_torch.launch.train import batch_on
    from repro_torch.models.registry import get_api
    from repro_torch.models.steps import grads_of, loss_fn
    full = get_config(spec["arch"])
    cfg = full.replace(n_layers=n_layers or full.n_layers)
    params = get_api(cfg).init(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    batch = batch_on(make_dataset("synthetic", cfg, spec["seq"],
                                  spec["batch"]), 0, dev)

    def run(impl, dtype, c=cfg):
        p = params if dtype is None else _cast(params, dtype)
        c = c if dtype is None else c.replace(dtype="float32")
        for leaf in tree_leaves(p):
            leaf.requires_grad_(True)
        loss, _ = loss_fn(c, p, batch, remat=True, impl=impl)
        grads = grads_of(loss, p)
        out = {"loss": loss.detach().float(),
               "grad_norm": global_norm(grads).float()}
        for name, path in names.items():
            g = grads
            for key in path:
                g = g[key]
            out[name] = g.float()
        return out

    reset_launches()
    kern = run("auto", None)
    n_kernel = read_launches()[kernel]
    plain, plain32 = run("reference", None), run("reference", torch.float32)
    torch.cuda.synchronize()
    if n_kernel != 2 * cfg.n_layers:
        fail(f"{label}: {n_kernel} {kernel} launches for one "
             f"{cfg.n_layers}-layer step with remat")
    err = {k: max_err(kern[k], plain[k]) for k in kern}
    tol = {k: max_err(plain[k], plain32[k]) for k in kern}
    gated, extra = err, {}
    if gate == "float32":
        kern32 = run("auto", torch.float32)
        gated = {k: max_err(kern32[k], plain32[k]) for k in kern}
        extra = {"max_abs_err_kernel_vs_plain_f32": gated,
                 "ratio_bf16_kernel_vs_plain_to_tol":
                     {k: err[k] / tol[k] for k in kern if tol[k] > 0}}
    if reorder:
        other = run("reference", None, cfg.replace(**reorder))
        extra["plain_reordered"] = reorder
        extra["max_abs_err_plain_reordered_vs_plain"] = {
            k: max_err(other[k], plain[k]) for k in kern}
    phase(label, arch=cfg.name, n_layers=cfg.n_layers,
          depth_cut_from=full.n_layers, batch=spec["batch"], seq=spec["seq"],
          launches={kernel: n_kernel}, gated_on=gate, **extra,
          loss={k: v["loss"].item() for k, v in
                (("kernel", kern), ("plain", plain), ("plain_f32", plain32))},
          grad_norm={k: v["grad_norm"].item() for k, v in
                     (("kernel", kern), ("plain", plain),
                      ("plain_f32", plain32))},
          max_abs_err_kernel_vs_plain=err, tol_bf16_vs_f32_plain=tol,
          grad_abs_max={k: plain[k].abs().max().item() for k in names})
    bad = [k for k in kern if gated[k] > tol[k]]
    if bad:
        fail(f"{label}: kernel path off the plain path ({gate}) by more "
             f"than bf16 itself in {bad}: {gated} vs {tol}")


def train_dense_phase(dev):
    """Full-width smollm-135m: 4 AdamW steps on batch 8 x 512, remat on;
    the flash kernel runs twice per layer and step."""
    cfg, setup = train_setup(DENSE_TRAIN, dev)
    log, launches = run_steps(setup, DENSE_TRAIN["steps"], dev)
    want = 2 * cfg.n_layers * DENSE_TRAIN["steps"]
    secs = statistics.median(t for _, _, t in log[1:])
    phase("train_dense", arch=cfg.name, n_layers=cfg.n_layers,
          params=n_params(setup[0]), batch=DENSE_TRAIN["batch"],
          seq=DENSE_TRAIN["seq"], loss=[l for l, _, _ in log],
          grad_norm=[g for _, g, _ in log], step_s=[t for _, _, t in log],
          median_step_s=secs,
          tokens_per_s=DENSE_TRAIN["batch"] * DENSE_TRAIN["seq"] / secs,
          launches=launches, flash_launches_expected=want)
    if not all(math.isfinite(l) and math.isfinite(g) for l, g, _ in log):
        fail(f"train_dense: a loss or grad norm is not finite: {log}")
    if launches["flash_attention"] != want:
        fail(f"train_dense: {launches['flash_attention']} flash launches, "
             f"want 2 x {cfg.n_layers} x {DENSE_TRAIN['steps']} = {want}")
    others = {k: n for k, n in launches.items() if k != "flash_attention"}
    if any(others.values()):
        fail(f"train_dense: a kernel of another path ran: {others}")
    return launches


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.detach().to(dtype)


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    src = Path(__file__).resolve().parent / "src"
    sys.path.insert(0, str(src))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, _ = device_phase()
    build_phase()
    kernel_check_phase(dev)
    rows = kernel_times_phase(dev)
    cfg, params, eng, paged_launches = engine_phase(dev)
    engine_profile_phase(cfg, params, dev, "engine_profile", PAGED_ENGINE,
                         shared_prefix_tokens=64)
    engine_check_phase(cfg, params, eng, dev)
    del eng
    slot_launches = engine_slot_phase(cfg, params, dev)
    engine_profile_phase(cfg, params, dev, "engine_slot_profile", SLOT_ENGINE)
    engine_slot_check_phase(cfg, params, dev)
    drv = cluster_pd_phase(cfg, params, dev)
    cluster_pd_check_phase(cfg, params, drv, dev)
    del params, drv
    torch.cuda.empty_cache()

    _, setup = train_phase(dev)
    train_launches = read_launches()
    train_profile_phase(setup, dev)
    del setup
    torch.cuda.empty_cache()
    train_check_phase(dev, "train_check", TRAIN, {
        "w_x": ("layers", "ssm", "w_x"),
        "out_proj": ("layers", "ssm", "out_proj"),
        "A_log": ("layers", "ssm", "A_log"), "embed": ("embed", "table")},
        "ssd_scan", n_layers=TRAIN_CHECK_LAYERS, reorder={"ssm_chunk": 128})
    torch.cuda.empty_cache()
    train_dense_phase(dev)
    torch.cuda.empty_cache()
    train_check_phase(dev, "train_dense_check", DENSE_TRAIN, {
        "wq": ("layers", "attn", "wq"), "wk": ("layers", "attn", "wk"),
        "wv": ("layers", "attn", "wv"), "embed": ("embed", "table")},
        "flash_attention", gate="float32")

    # each kernel's launches on the run whose path it is on: the engines'
    # for the attention kernels (the per-sequence paged decode is on no
    # engine path: 0 in both), the mamba2 trainer's for the SSD scan
    on_path = {"batched_paged_decode_attention": paged_launches,
               "chunked_prefill_attention": paged_launches,
               "paged_decode_attention": paged_launches,
               "flash_attention": slot_launches,
               "ssd_scan": train_launches}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for r in rows:
        r["launches"] = on_path[r["name"]][r["name"]]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
