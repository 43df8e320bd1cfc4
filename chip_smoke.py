"""Chip smoke test of the PyTorch/H100 port: builds the CUDA kernels,
holds each against its plain PyTorch version, times them, serves
full-width smollm-135m through the paged and the slot-ring engines and
through a prefill/decode-disaggregated cluster of paged engines, serves
full-width minitron-8b (both engines), mamba2-2.7b, zamba2-1.2b and
whisper-large-v3 (slot-ring), paligemma-3b (both engines), grok-1-314b
(both engines, depth cut to 4) and llama4-scout-17b-a16e (slot-ring,
depth cut to 8), trains full-width mamba2-2.7b, smollm-135m and
whisper-large-v3, runs six of the assigned (arch x shape) cells' step
units at full width, and the port's serving and training examples,
then runs the sharded train, serve and int8 all-reduce paths on a 1x1
NCCL mesh, on one GPU, while the one-card dry run counts all 33 cells
on the meta device in a process beside it (and the 16x16 dry run one
cell a family, in another).

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
                 counters left at 0; D 128 at the minitron and zamba2
                 paths' shapes: both decode kernels at 8 kv heads and
                 groups 3 and 4, minitron-8b's 128-token chunk at
                 q_offset 0 and 128, flash attention at L 64 / 256 with
                 group 4 and zamba2's shared block (32 heads, group 1)
                 at L 4,608 with its window of 4096; flash attention
                 with more queries than keys (Lq 32/40/70 against Lk
                 16/16/64, causal rows before position 0 zeros) and at
                 whisper-large-v3's shapes (20 heads of 64: the
                 encoder's 1,500 x 1,500 non-causal, 64 and 128 queries
                 against 1,500 keys, a causal 128 bucket); the SSD scan at
                 the JAX test shapes, a ragged L, G 2, L < chunk,
                 mamba2-2.7b's (L 2048 and 1000) and zamba2's shapes,
                 N 256 with a chunk of 100, 16 chunks, and N 4 with
                 H / G 1, against the plain version and its three
                 stages (ref.ssd_chunked_pieces), two calls
                 bit-identical; the slot decode at h2o-danube's cell
                 shape (256 lanes over 1,090 slots, 32 q over 8 kv
                 heads of 80, a layer's view of the cache), whisper's
                 cross-attention, paligemma-3b's and grok-1's heads
                 and a split 32k ring, against the plain version
                 and the split order's (ref.slot_decode_split_ref), two
                 calls bit-identical;
                 gradients through the flash and SSD autograd Functions
                 at the trainers' shapes against plain autograd;
                 and, on a generator of their own, the vlm and MoE
                 shapes: flash attention at paligemma-3b's prefill (8 q
                 over 1 kv head of 256, a 256-key prefix-LM prefix
                 before 64, 256 and 37 tokens, and 4 x (256 + 128)) and
                 at grok-1's and llama4-scout's 64-, 128- and 256-token
                 buckets (groups 6 and 5, D 128);
                 both decode kernels at groups 5 and 6 and at
                 paligemma-3b's group 8, D 256, at their split edges;
                 the chunk at groups 5 and 6, q_offset 0 and 128; the
                 flash gradient at paligemma-3b's prefix shape; flash
                 attention at the cells' shapes (smollm-135m's heads,
                 causal 1 x 32,768 and 8 x 4,096), on a generator of
                 their own;
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
                 also at long context (8 x 1,900-2,047 tokens); the
                 decode call, the chunk and the 64-token flash bucket also
                 at minitron-8b's heads (D 128, group 4), the bucket
                 at zamba2's shared block, and whisper-large-v3's
                 encoder (1,500 x 1,500) and cross-attention (128 x
                 1,500) calls, non-causal, beside SDPA; paligemma-3b's
                 320-token prefill (256-token prefix, SDPA given the
                 mask) and decode (D 256), and grok-1's decode call and
                 chunk with softcap 30 (SDPA without the cap); flash
                 attention at the cells' 1 x 32,768 and 8 x 4,096 (SDPA
                 over K/V expanded to the 9 query heads); the slot
                 decode at h2o-danube's cell shape (lengths of its ring
                 late in a window; bound by its bytes, Sum lens x 2,560
                 B), the decode_32k cell's ring and whisper's
                 cross-attention (SDPA as the port would call it: the
                 cache's transposed views, the length mask built in the
                 call, its kernels a call counted);
5. engine        full-width smollm-135m, bf16, 24 requests through
                 DriftScheduler("sjf") and the paged engine, with the
                 kernels' launch counts checked against the iterations;
6. engine_profile  a few iterations of the same engine under
                 torch.profiler: device time per iteration and its share
                 of the wall time;
7. engine_check  one full-width prefill chunk and one decode step with
                 the kernels against the same calls on the plain versions,
                 within the plain path's own bf16-vs-float32 deviation,
                 and beside it, on a line ``engine_check_f32``, the same
                 calls in float32 within the same tolerance;
8. engine_slot   full-width smollm-135m, bf16, 24 requests through
                 DriftScheduler("sjf") and the slot-ring engine
                 (paged=False), flash-attention launches checked against
                 the prefills, slot decode launches against the decode
                 iterations, and no paged kernel launched;
9. engine_slot_profile  the slot-ring engine under torch.profiler;
10. engine_slot_check  one full-width 256-token prefill (flash kernel)
                 and one decode step from its cache (slot decode kernel),
                 against the plain
                 path, within its bf16-vs-float32 deviation; beside it,
                 ungated, the plain path summed over other key blocks
                 against itself (how far an equally valid order moves
                 the logits); and ``engine_slot_check_f32``, the same
                 calls in float32, gated within the same tolerance;
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
13. engine_minitron  full-width minitron-8b (32 layers, d_model 4096, 32 q
                 over 8 kv heads of 128, vocab 256,000; 9.9 B params),
                 bf16, weights drawn on a generator on the card (seed
                 printed), through the paged engine on the engine phase's
                 24 requests: batched-decode launches exactly 32 x decode
                 iterations, chunked-prefill 32 x chunks, no other
                 kernel, a prefix-cache hit, every page accounted for;
                 init seconds and peak memory;
14. engine_minitron_profile  the same engine under torch.profiler;
15. engine_minitron_slot  the same requests through the slot-ring
                 engine: flash launches exactly 32 x prefills, no other;
16. engine_minitron_check  one prefill chunk and one decode step at full
                 width, depth cut to 8 layers, from a pool of random K/V:
                 kernel path against plain path gated in float32, the
                 bf16 deviation printed;
17. engine_mamba2  full-width mamba2-2.7b (64 layers), bf16, 24 requests
                 through the slot-ring engine: no kernel launched (its
                 prefill scan and decode step are plain, as in JAX);
                 state bytes per slot, peak memory;
18. engine_mamba2_profile  the same engine under torch.profiler;
19. engine_mamba2_check  depth cut to 8 layers, float32: prefill's last
                 logits and one decode step's logits against
                 mamba2.forward through the SSD kernel on the same tokens
                 and one more, within 4x the plain forward's own
                 deviation when summed over chunks of 128;
20. engine_zamba2  full-width zamba2-1.2b (38 Mamba layers; the shared
                 block at width 4096, 32 heads of 128, window 4096,
                 applied 7 times), bf16, 24 requests through the
                 slot-ring engine: flash launches exactly 7 x prefills,
                 no other;
21. engine_zamba2_profile  the same engine under torch.profiler;
22. engine_zamba2_check  four full-width 256-token prefills (flash
                 kernel) and one decode step, kernel path against plain
                 path gated in float32, the bf16 deviation printed;
23. engine_whisper  full-width whisper-large-v3 (32 encoder and 32
                 decoder layers, d_model 1280, 20 heads of 64, vocab
                 51,866; 1.53 B params), bf16, 24 requests through the
                 slot-ring engine at max_len 448: flash launches exactly
                 96 x prefills (encoder, decoder self- and
                 cross-attention), no other kernel;
24. engine_whisper_profile  the same engine under torch.profiler;
25. engine_whisper_check  one prefill of 4 x 128 tokens over random
                 frames [4, 1500, 1280] (96 flash launches) and one
                 decode step, kernel path against plain path gated in
                 float32, the bf16 deviation printed;
26. engine_paligemma  full-width paligemma-3b (18 layers, d_model 2048,
                 8 q over 1 kv head of 256, vocab 257,216; 2.51 B
                 params), bf16, zero patches from the engine, the
                 engine phase's 24 requests through the paged engine:
                 flash launches exactly 18 x single-shot prefills (no
                 chunk kernel: a vlm prefills single-shot, as in JAX),
                 batched decode 18 x decode iterations;
27. engine_paligemma_slot  the same requests through the slot-ring
                 engine at max_len 640: flash 18 x prefills, no other;
28. engine_paligemma_profile  the paged engine under torch.profiler;
29. engine_paligemma_check  one prefill of 4 x (256 + 128) over random
                 patches (flash kernel with the prefix-LM mask) and one
                 paged decode step, kernel path against plain path gated
                 in float32, the bf16 deviation printed;
30. engine_grok  full-width grok-1-314b (d_model 6144, 48 q over 8 kv
                 heads of 128, d_ff 32,768, 8 experts top-2, softcap
                 30), depth cut from 64 to 4 layers (21.3 B params),
                 through the paged engine: batched decode 4 x decode
                 iterations, chunked prefill 4 x chunks, no other
                 kernel; peak memory;
31. engine_grok_slot  the same requests through the slot-ring engine:
                 flash 4 x prefills, no other;
32. engine_grok_profile  the paged engine under torch.profiler;
33. engine_grok_check  the 4-layer model freed, one prefill chunk and one
                 decode step at full width and 1 layer, gated in
                 float32, with the kernel and plain paths' routing (each
                 MoE call's top experts and kept entries) compared;
34. engine_llama4  full-width llama4-scout-17b-a16e (d_model 5120, 40 q
                 over 8 kv heads of 128, 16 experts top-1), depth cut
                 from 48 to 8 layers (18.7 B params), through the
                 slot-ring engine: flash 8 x prefills, no other; peak
                 memory;
35. train        mamba2-2.7b at full width and depth (64 layers), bf16,
                 through the training launcher's code: 6 AdamW steps on
                 batch 2 x 2048 synthetic tokens with per-layer remat;
                 SSD launches exactly 2 x 64 x 6 and no attention kernel;
36. train_profile  one more step of it under torch.profiler, with the
                 device time launched inside the SSD kernel's forward,
                 the plain SSD backward and the AdamW update;
37. train_check  one step's loss, grad norm and gradients of w_x,
                 out_proj, A_log and the embedding at full width, depth
                 cut to 8 layers: the kernel path against the plain path,
                 within the plain path's own bf16-vs-float32 deviation,
                 in bf16 and in float32 (both gated); beside it,
                 ungated, the plain path at chunk 128 (the same function,
                 summed in another order) against itself;
38. train_dense  smollm-135m at full width, batch 8 x 512, 4 steps;
                 flash-attention launches exactly 2 x 30 x 4;
39. train_dense_check  one step of it at full depth (30 layers): loss,
                 grad norm and the gradients of wq, wk, wv and the
                 embedding, kernel path against plain path as train_check,
                 but gated in float32 (through 30 bf16 layers the two
                 bf16 paths decorrelate; their deviation is printed);
40. train_whisper  whisper-large-v3 at full width and depth, batch 2 x
                 448 decoder tokens over the launcher's stub frames, 3
                 AdamW steps with remat: finite losses, flash launches
                 exactly 2 x 96 x 3;
41. cell_<arch>_<shape>  six assigned cells at full width and depth,
                 the batch cut to what one card holds (printed as
                 ``reduced``), inputs from a seed on the card:
                 smollm-135m's prefill_32k (make_prefill_step, 2 x
                 32,768: B4 30 launches a step), decode_32k
                 (make_serve_step, 32 sequences, every one of the 32,768
                 cache entries valid) and train_4k (make_train_step with
                 AdamW, 8 x 4,096: B4 60 a step), and the long_500k
                 decode step of mamba2-2.7b, zamba2-1.2b and
                 h2o-danube-1.8b at position 524,287 (state, window
                 rings full); each the median step time of 3 after a
                 warm-up (CUDA events), tokens/s, peak GiB, B4 and
                 slot decode launches, and the cost counter's bound at the cut
                 batch (``launch/dryrun.count_cell`` on meta) with the
                 measured time over it;
42. cells_check  smollm-135m's prefill_32k step, depth cut to 2 layers,
                 at L 32,768 and 20,007: the kernel path's last logits
                 and cache against the plain path, gated in float32;
43. example_serving  the port's multi_tenant_serving example at full
                 width (smollm-135m, 32 requests, sjf): its lines, ms an
                 iteration, tokens/s, B4 launches exactly 30 x prefills
                 and slot decode 30 x decode iterations;
44. example_train  the port's train_lm example, --preset full, 3 steps,
                 a checkpoint in a temporary directory: B4 2 x 30 x 3;
45. dryrun       the one-card dry run (``python -m
                 repro_torch.launch.dryrun``), started in its own process
                 when the run begins: one line per cell (FLOPs and bytes
                 counted on meta, model FLOPs, the bound on the H100,
                 whether argument + output bytes fit one card); any cell
                 in error fails the run;
46. mesh_setup   a one-rank NCCL process group and the 1x1 (data, model)
                 mesh on the card;
47. mesh_train   full-width smollm-135m, 8 x 512, 4 AdamW steps in train
                 mode (DTensor params, ZeRO-1 moments) through
                 ``launch/sharded.py``: B4 through ``local_map``, 60 a
                 step; s/step beside train_dense's; a float32 gate
                 against the unsharded step;
48. mesh_train_ssd  full-width mamba2-2.7b cut to 8 layers, 2 x 2,048,
                 2 steps: B5 16 a step; the float32 gate;
49. mesh_serve   full-width smollm-135m's prefill (2 x 4,096, B4) and
                 serve (8 sequences, 4,096-token cache) steps in serve
                 mode, beside the same units unsharded; float32 gate;
                 and a cache split on S (DTensors, S on the model axis):
                 auto and cuda raise and launch no slot kernel,
                 impl='reference' equals the plain version;
50. mesh_dp_int8  make_compressed_dp_grad_fn over NCCL on smollm-135m's
                 whole gradient tree: ms a step, int8 wire bytes, and
                 JAX's unbiasedness bound after 50 steps;
51. dryrun_mesh  one cell a family on the 16x16 mesh (MESH_CELLS),
                 counted on meta DTensors over a fake process group in
                 a process started after the engine phases: per-device
                 FLOPs, bytes, collective bytes by kind, the bound;
                 gated on per-device FLOPs x 256 >= the one-card count;
52. total        the whole run's seconds.

Each engine, cluster, train, cell, example and mesh phase sets every
kernel's launch count to 0 just before it runs and reads the counts
just after.

The line before the last is the kernel table as JSON, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
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
    ``paged_decode_split_kernel<__nv_bfloat16,1,3,1>`` (an enum argument
    as its value)."""
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
                # an enum's type is a nested name N...E, a builtin one letter
                t = (symbol.index("E", i) + 1 if symbol[i + 1] == "N"
                     else i + 2)
                j = symbol.index("E", t)
                args.append(symbol[t:j].replace("n", "-"))
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
    # the vlm and MoE models' cases draw on a generator of their own, so
    # the earlier cases' inputs stay as they were; their worst errors go
    # under keys of their own (moe_vlm_*)
    gen_mv = torch.Generator(device=dev).manual_seed(20)
    n_cases, worst = 0, {}
    shapes_decode = [  # B, H, Hk, D, P, pps
        (3, 3, 1, 24, 8, 12),      # smoke smollm
        (8, 9, 3, 64, 16, 32),     # full-width smollm, the engine's table
        (2, 16, 2, 128, 16, 8),
        (2, 8, 1, 256, 32, 4),     # > 48 KB of shared memory
        (8, 24, 8, 128, 16, 32),   # full-width minitron-4b, group 3
        (8, 32, 8, 128, 16, 32),   # full-width minitron-8b, group 4
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
    # the D 128 models' chunk, 8 kv heads: minitron-8b's (group 4), then
    # llama4-scout's and grok-1's (groups 5 and 6), 128 tokens at q_offset
    # 0 and, after a prefix-cache hit, at 128
    for g, heads, tag in ((gen, (32,), ""), (gen_mv, (40, 48), "moe_vlm_")):
        for dtype in (torch.float32, torch.bfloat16):
            for H, q_offset, softcap in itertools.product(heads, (0, 128),
                                                          (None, 30.0)):
                q, k, v, table, off, kv = prefill_inputs(
                    g, 1, 128, H, 8, 128, 16, 32, [q_offset], dtype, dev)
                pt = poison(table, kv.tolist(), 16, k.shape[0])
                got = ops.chunked_prefill_attention(
                    q, k, v, pt, off, kv, logit_softcap=softcap, impl="cuda")
                want = ops.chunked_prefill_attention(
                    q, k, v, table, off, kv, logit_softcap=softcap,
                    impl="reference")
                torch.cuda.synchronize()
                err = max_err(got, want)
                key = (tag + "prefill", str(dtype).split(".")[-1])
                worst[key] = max(worst.get(key, 0.0), err)
                n_cases += 1
                if not within(got, want, dtype):
                    fail(f"prefill kernel vs plain at the D 128 chunk: "
                         f"{dtype} H{H} q_offset {q_offset} softcap="
                         f"{softcap}: max abs err {err} > tol {TOL[dtype]}")
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
    n_cases += decode_split_checks(
        gen, dev, worst, split_scenes(SPLIT_GEOMETRIES) + [EMPTY_BATCH_SCENE])
    n_cases += decode_split_checks(gen_mv, dev, worst,
                                   split_scenes(MOE_VLM_SPLIT_GEOMETRIES),
                                   tag="moe_vlm_")
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
        # D 128: minitron-8b's slot-ring buckets (group 4) and zamba2's
        # shared block (group 1) with its window's edge inside a tile
        (1, 64, 64, 32, 8, 128, {}),
        (1, 256, 256, 32, 8, 128, {}),
        (1, 4608, 4608, 32, 32, 128, dict(window=4096)),
        # more queries than keys (query i at Lk - Lq + i < 0 for the
        # first Lq - Lk; causal rows there see no key and are zeros)
        (2, 32, 16, 4, 4, 64, dict(causal=False)),
        (1, 40, 16, 4, 4, 64, {}),
        (1, 70, 64, 9, 3, 64, dict(window=16)),
        # whisper-large-v3 (20 heads of 64, MHA): the encoder's 1,500
        # frames, cross-attention of 64- and 128-token buckets against
        # them, and the decoder's 128-token bucket
        (1, 1500, 1500, 20, 20, 64, dict(causal=False)),
        (1, 64, 1500, 20, 20, 64, dict(causal=False)),
        (1, 128, 1500, 20, 20, 64, dict(causal=False)),
        (1, 128, 128, 20, 20, 64, {}),
    ]
    shapes_flash_mv = [
        # paligemma-3b (8 q over 1 kv head of 256): its 256 patches as a
        # prefix-LM prefix before 64, 256 and 37 tokens (the last puts the
        # prefix edge inside a 64-key tile), and its check's 4 x (256 + 128)
        (1, 320, 320, 8, 1, 256, dict(prefix_len=256)),
        (1, 512, 512, 8, 1, 256, dict(prefix_len=256)),
        (1, 293, 293, 8, 1, 256, dict(prefix_len=256)),
        (4, 384, 384, 8, 1, 256, dict(prefix_len=256)),
        # grok-1 (48 q over 8 kv heads of 128) and llama4-scout (40 over 8)
        # at the 64-, 128- and 256-token buckets; their engine runs
        # prefill the 128 bucket only
        (1, 64, 64, 48, 8, 128, {}),
        (1, 128, 128, 48, 8, 128, {}),
        (1, 256, 256, 48, 8, 128, {}),
        (1, 64, 64, 40, 8, 128, {}),
        (1, 128, 128, 40, 8, 128, {}),
        (1, 256, 256, 40, 8, 128, {}),
    ]
    # B4 at the cells' shapes, smollm-135m's heads: prefill_32k's one
    # causal sequence of 32,768 and train_4k's 8 x 4,096, on a generator
    # of their own (worst errors under cells_*)
    shapes_flash_cells = [(1, 32768, 32768, 9, 3, 64, {}),
                          (8, 4096, 4096, 9, 3, 64, {})]
    gen_cells = torch.Generator(device=dev).manual_seed(21)
    for g, shapes, tag in ((gen, shapes_flash, ""),
                           (gen_mv, shapes_flash_mv, "moe_vlm_"),
                           (gen_cells, shapes_flash_cells, "cells_")):
        for dtype in (torch.float32, torch.bfloat16):
            for B, Lq, Lk, H, Hk, D, kw in shapes:
                for softcap in (None, 30.0):
                    q, k, v = flash_inputs(g, B, Lq, Lk, H, Hk, D, dtype, dev)
                    got = ops.attention(q, k, v, logit_softcap=softcap,
                                        impl="cuda", **kw)
                    want = ops.attention(q, k, v, logit_softcap=softcap,
                                         impl="reference", **kw)
                    torch.cuda.synchronize()
                    err = max_err(got, want)
                    key = (tag + "flash", str(dtype).split(".")[-1])
                    worst[key] = max(worst.get(key, 0.0), err)
                    n_cases += 1
                    # causal rows before position 0 see no key: zeros
                    empty = max(Lq - Lk, 0) if kw.get("causal", True) else 0
                    if not within(got, want, dtype) or got[:, :empty].any():
                        fail(f"flash kernel vs plain: {dtype} B{B} Lq{Lq} "
                             f"Lk{Lk} H{H} Hk{Hk} D{D} {kw} softcap="
                             f"{softcap}: max abs err {err} > tol "
                             f"{TOL[dtype]} (or one of the {empty} rows with "
                             "no visible key not zero)")
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
    # the gradients through the kernel equal plain autograd's; and B4 at
    # paligemma-3b's prefix shape
    grad_cases = [
        ("flash", lambda *t, impl: ops.attention(*t, impl=impl),
         flash_inputs(gen, 8, 512, 512, 9, 3, 64, torch.bfloat16, dev), gen),
        ("ssd", lambda *t, impl: ops.ssd(*t, chunk=256, impl=impl),
         ssd_inputs(gen, 2, 2048, 80, 1, 64, 128, torch.bfloat16, dev), gen),
        ("moe_vlm_flash",
         lambda *t, impl: ops.attention(*t, prefix_len=256, impl=impl),
         flash_inputs(gen_mv, 2, 320, 320, 8, 1, 256, torch.bfloat16, dev),
         gen_mv),
    ]
    for name, fn, inputs, g in grad_cases:
        r = torch.randn(inputs[0].shape, generator=g, device=dev).to(
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
    n_cases += slot_decode_checks(dev, worst)
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


# (B, H, Hk, D, P, pps, longest) of the split-edge checks: smollm-135m's
# heads at 2,047 tokens and minitron-8b's 32-q-head layout
SPLIT_GEOMETRIES = ((8, 9, 3, 64, 16, 128, 2047),
                    (4, 32, 8, 128, 16, 64, 1023))
# llama4-scout's and grok-1's groups 5 and 6 (D 128; the dispatch runs
# them on the group-8 instantiation with a part-used head chunk) and
# paligemma-3b's group 8 at D 256 on its 32-page table
MOE_VLM_SPLIT_GEOMETRIES = ((4, 40, 8, 128, 16, 64, 1023),
                            (4, 48, 8, 128, 16, 64, 1023),
                            (8, 8, 1, 256, 16, 32, 511))
# (B, H, Hk, D, P, pps, lens): a batch whose slots but one are empty
EMPTY_BATCH_SCENE = (8, 9, 3, 64, 16, 32, [0, 0, 0, 0, 0, 300, 0, 0])


def split_scenes(geometries):
    """(B, H, Hk, D, P, pps, lens) for each geometry: lengths on, just
    past and just before a split edge of its plan, and mid-split."""
    from repro_torch.kernels import paged_attention
    scenes = []
    for B, H, Hk, D, P, pps, longest in geometries:
        mp = min(pps, 2 ** math.ceil(math.log2(-(-longest // P))))
        per, _ = paged_attention.split_plan(B, Hk, mp, P)
        scenes.append((B, H, Hk, D, P, pps, split_lens(B, P, pps, per,
                                                        longest)))
    return scenes


def decode_split_checks(gen, dev, worst, scenes, tag=""):
    """Both decode kernels where their page splits matter: ``scenes``
    of (B, H, Hk, D, P, pps, lens), long tables (up to 2,047 tokens);
    float32 and bf16, softcap on and off, poisoned table tails. Each
    output against the plain version and against
    ``ref.paged_decode_split_ref`` at the same plan, and two calls
    bit-identical; worst errors under ``tag`` + the kernel's name.
    Returns the number of cases."""
    from repro_torch.kernels import ops, paged_attention, ref
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
                        key = (tag + name, str(dtype).split(".")[-1])
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


# (B, S, H, Hk, D, softcap, fixed lengths, ring padding) of the slot
# decode kernel's checks, by name: h2o-danube's cells (256 lanes over the
# 1,090-slot ring, lengths drawn with 0 and S among them, a layer's view
# of an [L, B, S, Hk, D] cache as the model passes it), whisper-large-v3's
# cross-attention (D 64, 1,500 positions), paligemma-3b (8 q over 1 kv
# head of 256), grok-1 (group 6, softcap 30), and the decode_32k cell's
# 32k ring (the token axis split; its checks add lengths on and beside a
# split's edge); a padded ring reads a view whose lane stride is not S
# rows. tests/test_torch_cuda.py imports this table.
SLOT_SCENES = {
    "danube": (256, 1090, 32, 8, 80, None, (0, 1090, 1, 193), 0),
    "whisper_cross": (8, 1500, 20, 20, 64, None, (1500,) * 8, 0),
    "paligemma": (8, 640, 8, 1, 256, None, (0, 640, 289), 16),
    "grok": (8, 512, 48, 8, 128, 30.0, (0, 512, 1), 8),
    "decode_32k": (6, 32768, 9, 3, 64, None, (32768, 20007, 0), 0),
}


def slot_scene(gen, dev, B, S, H, Hk, D, fixed, pad, dtype):
    """q, the K/V views of layer 1 of an [L, B, S + pad, Hk, D] cache
    (the first S slots), and lengths: ``fixed`` first, the rest drawn
    over [0, S]."""
    ring = torch.randn(2, 2, B, S + pad, Hk, D, generator=gen,
                       device=dev).to(dtype)
    q = torch.randn(B, H, D, generator=gen, device=dev).to(dtype)
    rest = torch.randint(0, S + 1, (B - len(fixed),), generator=gen,
                         device=dev)
    lens = torch.cat([torch.tensor(fixed, dtype=torch.long, device=dev),
                      rest]).to(torch.int32)
    return q, ring[0, 1, :, :S], ring[1, 1, :, :S], lens


def slot_decode_checks(dev, worst):
    """The slot decode kernel at ``SLOT_SCENES``, float32 and bf16,
    against the plain version and ``ref.slot_decode_split_ref`` at the
    same plan; two calls bit-identical, lanes of length 0 zeros, the
    merge counters left at 0; worst errors under ``slot_decode``.
    Returns the number of cases."""
    from repro_torch.kernels import ops, paged_attention, ref
    gen = torch.Generator(device=dev).manual_seed(26)
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for name, (B, S, H, Hk, D, softcap, fixed, pad) in SLOT_SCENES.items():
            per, n_splits = paged_attention.slot_plan(B, Hk, S)
            if name == "decode_32k":
                fixed = fixed + (per, per + 1)
            q, k, v, lens = slot_scene(gen, dev, B, S, H, Hk, D, fixed, pad,
                                       dtype)
            kw = dict(logit_softcap=softcap)
            got = ops.decode_attention(q, k, v, lens, impl="cuda", **kw)
            again = ops.decode_attention(q, k, v, lens, impl="cuda", **kw)
            want = ops.decode_attention(q, k, v, lens, impl="reference", **kw)
            split = ref.slot_decode_split_ref(q, k, v, lens,
                                              tokens_per_split=per, **kw)
            torch.cuda.synchronize()
            err = max(max_err(got, want), max_err(got, split))
            key = ("slot_decode", str(dtype).split(".")[-1])
            worst[key] = max(worst.get(key, 0.0), err)
            n_cases += 1
            if not (within(got, want, dtype) and within(got, split, dtype)):
                fail(f"slot decode kernel vs plain, {name}: {dtype} plan "
                     f"({per}, {n_splits}): max abs err {err} > tol "
                     f"{TOL[dtype]}")
            if not torch.equal(got, again):
                fail(f"slot decode kernel not bit-identical across two "
                     f"calls: {name} {dtype}")
            if got[lens == 0].any():
                fail(f"slot decode kernel: a length-0 lane is not zero "
                     f"({name} {dtype})")
            del q, k, v, got, again, want, split
    for tickets in paged_attention._tickets.values():
        if tickets.any():
            fail("slot decode: a merge counter was left nonzero")
    return n_cases


def time_ms(fn, flush, reps=TIMING_REPS):
    """Median over ``reps`` of one call between CUDA events, after a
    warm-up, with L2 flushed before each call (the engine reaches each
    layer's pages cold: the pool is larger than L2)."""
    for _ in range(5):
        fn()
    times = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(reps):
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


# the attention heads (H, Hk, D) of full-width smollm-135m, minitron-8b,
# zamba2-1.2b's shared block and whisper-large-v3
SMOLLM_HEADS = (9, 3, 64)
MINITRON_8B_HEADS = (32, 8, 128)
ZAMBA2_HEADS = (32, 32, 128)
WHISPER_HEADS = (20, 20, 64)
# h2o-danube-1.8b (group 4, D 80); paligemma-3b (group 8 at D 256) and
# grok-1-314b (group 6, softcap 30)
DANUBE_HEADS = (32, 8, 80)
PALIGEMMA_HEADS = (8, 1, 256)
GROK_HEADS = (48, 8, 128)


def decode_timing_scene(dev, heads=SMOLLM_HEADS):
    """The engine's decode call at full width: 8 slots, ``heads`` (9 q
    over 3 kv heads, D 64, by default), page 16, 32-page tables, bf16,
    lengths mid-run."""
    gen = torch.Generator(device=dev).manual_seed(1)
    (H, Hk, D), B, P, pps = heads, 8, 16, 32
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


def prefill_timing_scene(dev, q_offset=0, heads=SMOLLM_HEADS):
    """The engine's prefill call at full width: one 128-token chunk (the
    chunk budget) at ``q_offset`` (0, or 128 after a prefix-cache hit:
    256 resident tokens), ``heads``, bf16."""
    gen = torch.Generator(device=dev).manual_seed(2)
    return prefill_inputs(gen, 1, 128, *heads, 16, 32, [q_offset],
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


def slot_decode_bound(q, lens, Hk, D):
    """Bytes of q and out once each, each lane's ``lens`` K and V rows
    once (2 x Hk x D values a slot: 2,560 bytes at h2o-danube's 8 kv
    heads of 80 in bf16) and its length; 4 * H * D FLOPs a visible
    (lane, slot)."""
    e = q.element_size()
    B, H, _ = q.shape
    n_bytes = 2 * B * H * D * e + sum(lens) * Hk * D * 2 * e + B * 4
    return n_bytes, sum(4 * H * D * n for n in lens)


def slot_timing_scene(dev, B, S, heads, lens=None):
    """The slot ring's decode call: ``B`` lanes over an ``S``-slot ring
    (layer 1's view of an [L, B, S, Hk, D] cache), ``heads``, bf16.
    Lengths ``lens``, or those of the h2o-danube paced cell's ring late
    in a window: ~158 live lanes of 1-386 tokens (a mean of 193) and 98
    free ones that have climbed to 500-1,090."""
    gen = torch.Generator(device=dev).manual_seed(27)
    H, Hk, D = heads
    ring = torch.randn(2, 2, B, S, Hk, D, generator=gen, device=dev).to(
        torch.bfloat16)
    q = torch.randn(B, H, D, generator=gen, device=dev).to(torch.bfloat16)
    if lens is None:
        live = torch.randint(1, 387, (158,), generator=gen, device=dev)
        free = torch.randint(500, S + 1, (B - 158,), generator=gen, device=dev)
        lens = torch.cat([live, free])
    lens = torch.as_tensor(lens, device=dev).to(torch.int32)
    return q, ring[0, 1], ring[1, 1], lens


def flash_bound(q, k, causal=True, window=None, prefix_len=0):
    """Bytes of q, k, v and out once each, and 4 * D FLOPs per visible
    (query head, key) pair under this call's mask."""
    e = q.element_size()
    B, Lq, H, D = q.shape
    Lk, Hk = k.shape[1], k.shape[2]
    n_bytes = 2 * B * Lq * H * D * e + 2 * B * Lk * Hk * D * e
    if causal and window is None and not prefix_len and Lq == Lk:
        # the causal triangle, without an Lq x Lk mask on the host
        return n_bytes, 4 * B * H * D * (Lq * (Lq + 1) // 2)
    q_pos = torch.arange(Lq)[:, None] + (Lk - Lq)
    k_pos = torch.arange(Lk)[None, :]
    mask = torch.ones(Lq, Lk, dtype=torch.bool)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    if prefix_len:
        mask |= k_pos < prefix_len
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


def flash_timing_scene(dev, B, L, heads=SMOLLM_HEADS):
    """Full-width attention: ``B`` sequences of ``L`` tokens (the
    slot-ring engine's one-prompt bucket, or the dense trainer's batch),
    ``heads`` (smollm-135m's 9 q over 3 kv heads, D 64, by default),
    causal, bf16."""
    gen = torch.Generator(device=dev).manual_seed(4)
    return flash_inputs(gen, B, L, L, *heads, torch.bfloat16, dev)


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


def timings(kernel, plain, library, flush, plain_reps=TIMING_REPS):
    """A row's times: ``ms``, ``plain_ms`` (median of ``plain_reps``) and
    ``library_ms`` per call (CUDA events, the host's time to enqueue the
    call included, as in every earlier table), and ``device_ms`` and
    ``library_device_ms``, the kernels' own time on the card."""
    out = dict(ms=time_ms(kernel, flush),
               plain_ms=time_ms(plain, flush, plain_reps),
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
    # tokens, minitron-8b's heads (D 128, group 4), paligemma-3b's (D 256,
    # group 8) and grok-1's (group 6) with its softcap 30 are timed beside
    # it (there the bound is microseconds). SDPA has no softcap: on
    # grok-1's row it is a yardstick without the cap.
    extra = []
    for scene, softcap, path in (
            (decode_timing_scene, None, "paged engine (decode)"),
            (long_decode_timing_scene, None,
             "long context (8 x 1,900-2,047 tokens)"),
            (functools.partial(decode_timing_scene, heads=MINITRON_8B_HEADS),
             None, "paged engine (decode), minitron-8b"),
            (functools.partial(decode_timing_scene, heads=PALIGEMMA_HEADS),
             None, "pg decode: paged engine (decode), paligemma-3b"),
            (functools.partial(decode_timing_scene, heads=GROK_HEADS),
             30.0, "grok decode: paged engine (decode), grok-1-314b, "
                   "softcap 30")):
        (q, k, v, table, lens, kn, vn), mp = scene(dev)
        args = (q, k, v, table, lens, kn, vn)
        cap = dict(logit_softcap=softcap)
        got = ops.batched_paged_decode_attention(*args, max_pages=mp,
                                                 impl="cuda", **cap)
        want = ops.batched_paged_decode_attention(*args, impl="reference",
                                                  **cap)
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
            max_abs_err=err, path=path, softcap=softcap,
            split_plan=paged_attention.split_plan(q.shape[0], Hk, mp, P),
            **timings(lambda: ops.batched_paged_decode_attention(
                *args, max_pages=mp, impl="cuda", **cap),
                lambda: ops.batched_paged_decode_attention(
                    *args, impl="reference", **cap),
                lambda: sdpa(sq, sk, sv, attn_mask=smask, enable_gqa=True),
                flush),
            bytes=n_bytes, flops=flops))

    # the chunk at q_offset 0 is the table's row; the same chunk after a
    # 128-token prefix-cache hit, minitron-8b's chunk (D 128, group 4)
    # and grok-1's (group 6, softcap 30; SDPA without the cap) are timed
    # beside it
    for q_offset, heads, softcap, path in (
            (0, SMOLLM_HEADS, None, "paged engine (prefill chunks)"),
            (128, SMOLLM_HEADS, None,
             "paged engine (prefill chunk after a prefix-cache hit)"),
            (0, MINITRON_8B_HEADS, None,
             "paged engine (prefill chunks), minitron-8b"),
            (0, GROK_HEADS, 30.0, "grok chunk: paged engine (prefill "
                                  "chunks), grok-1-314b, softcap 30")):
        q, k, v, table, off, kv = prefill_timing_scene(dev, q_offset, heads)
        args = (q, k, v, table, off, kv)
        cap = dict(logit_softcap=softcap)
        got = ops.chunked_prefill_attention(*args, impl="cuda", **cap)
        want = ops.chunked_prefill_attention(*args, impl="reference", **cap)
        err = max_err(got, want)
        if not within(got, want, torch.bfloat16):
            fail(f"prefill kernel vs plain at engine shapes, q_offset "
                 f"{q_offset}: max abs err {err}")
        sq, sk, sv, smask = sdpa_prefill_inputs(*args)
        _, P, Hk, D = k.shape
        n_bytes, flops = prefill_bound(q, off.tolist(), kv.tolist(), P, Hk, D)
        (rows if (q_offset, heads) == (0, SMOLLM_HEADS) else extra).append(dict(
            name="chunked_prefill_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/chunked_prefill.cu",
            replaces="src/repro/kernels/chunked_prefill.py:112",
            max_abs_err=err, q_offset=q_offset, kv_len=int(kv[0]),
            path=path, softcap=softcap,
            **timings(lambda: ops.chunked_prefill_attention(
                *args, impl="cuda", **cap),
                lambda: ops.chunked_prefill_attention(
                    *args, impl="reference", **cap),
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
    # the table's row; the largest bucket, 256, the dense trainer's
    # batch 8 x 512, minitron-8b's and zamba2-1.2b's 64-token buckets
    # (D 128; zamba2's shared block with its window of 4096), and
    # paligemma-3b's 320-token prefill (its 256 patches as a prefix-LM
    # prefix before a 64-token bucket; D 256, group 8) are timed beside it
    for B, L, heads, mask, path in (
            (1, 64, SMOLLM_HEADS, {}, "slot-ring engine (prefill)"),
            (1, 256, SMOLLM_HEADS, {}, "slot-ring engine (prefill)"),
            (8, 512, SMOLLM_HEADS, {}, "trainer (dense forward)"),
            (1, 64, MINITRON_8B_HEADS, {},
             "slot-ring engine (prefill), minitron-8b"),
            (1, 64, ZAMBA2_HEADS, dict(window=4096),
             "slot-ring engine (prefill), zamba2-1.2b"),
            (1, 320, PALIGEMMA_HEADS, dict(prefix_len=256),
             "pg prefill: slot-ring and paged prefill (paligemma-3b)")):
        q, k, v = flash_timing_scene(dev, B, L, heads)
        got = ops.attention(q, k, v, impl="cuda", **mask)
        want = ops.attention(q, k, v, impl="reference", **mask)
        err = max_err(got, want)
        if not within(got, want, torch.bfloat16):
            fail(f"flash kernel vs plain at B {B} L {L} heads {heads}: max "
                 f"abs err {err}")
        sq, sk, sv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        n_bytes, flops = flash_bound(q, k, **mask)
        # SDPA's causal mask is the window's for L <= window; a prefix-LM
        # mask goes to SDPA as a boolean attn_mask
        prefix = mask.get("prefix_len", 0)
        pos = torch.arange(L, device=dev)
        sdpa_mask = (dict(attn_mask=(pos[None] <= pos[:, None])
                          | (pos[None] < prefix))
                     if prefix else dict(is_causal=True))
        (rows if (L, heads) == (64, SMOLLM_HEADS) else extra).append(dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:124",
            max_abs_err=err, batch=B, tokens=L, heads=heads,
            window=mask.get("window"), prefix_len=prefix, path=path,
            **timings(lambda: ops.attention(q, k, v, impl="cuda", **mask),
                      lambda: ops.attention(q, k, v, impl="reference",
                                            **mask),
                      lambda: sdpa(sq, sk, sv, enable_gqa=True, **sdpa_mask),
                      flush),
            bytes=n_bytes, flops=flops))

    # whisper-large-v3's two non-causal calls, beside the table's row:
    # "w3 enc", the encoder's 1,500 x 1,500 frames, and "w3 cross", the
    # decoder's 128-token bucket against them. SDPA with is_causal=False
    # computes the same function.
    gen = torch.Generator(device=dev).manual_seed(17)
    for Lq, path in ((1500, "w3 enc: encoder (whisper-large-v3)"),
                     (128, "w3 cross: cross-attention (whisper-large-v3)")):
        q, k, v = flash_inputs(gen, 1, Lq, 1500, *WHISPER_HEADS,
                               torch.bfloat16, dev)
        got = ops.attention(q, k, v, causal=False, impl="cuda")
        want = ops.attention(q, k, v, causal=False, impl="reference")
        err = max_err(got, want)
        if not within(got, want, torch.bfloat16):
            fail(f"flash kernel vs plain, {path}: max abs err {err}")
        sq, sk, sv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        n_bytes, flops = flash_bound(q, k, causal=False)
        extra.append(dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:124",
            max_abs_err=err, batch=1, tokens=Lq, keys=1500,
            heads=WHISPER_HEADS, causal=False, path=path,
            **timings(lambda: ops.attention(q, k, v, causal=False,
                                            impl="cuda"),
                      lambda: ops.attention(q, k, v, causal=False,
                                            impl="reference"),
                      lambda: sdpa(sq, sk, sv, is_causal=False), flush),
            bytes=n_bytes, flops=flops))
        del q, k, v, sq, sk, sv, got, want

    # the slot ring's decode call at the h2o-danube cells' shape is the
    # table's row; the decode_32k cell's (32 lanes of 32,768 slots,
    # smollm-135m's heads) and whisper-large-v3's cross-attention (8
    # lanes of 1,500 encoder positions, 20 heads of 64) beside it. SDPA
    # is timed as the port would call it in the kernel's place: on the
    # layer cache's [B, Hk, S, D] transposed views, with the length mask
    # built inside the timed call, over the whole ring (the same
    # function); its kernels a call are counted beside it.
    for B, S, heads, lens, path in (
            (256, 1090, DANUBE_HEADS, None,
             "slot-ring engine (decode), h2o-danube-1.8b cells"),
            (32, 32768, SMOLLM_HEADS, [32768] * 32,
             "decode_32k cell (smollm-135m)"),
            (8, 1500, WHISPER_HEADS, [1500] * 8,
             "w3 cross decode: slot-ring engine (whisper-large-v3)")):
        q, k, v, lens = slot_timing_scene(dev, B, S, heads, lens)
        args = (q, k, v, lens)
        got = ops.decode_attention(*args, impl="cuda")
        want = ops.decode_attention(*args, impl="reference")
        err = max_err(got, want)
        if not within(got, want, torch.bfloat16):
            fail(f"slot decode kernel vs plain, {path}: max abs err {err}")
        _, _, Hk, D = k.shape

        def library(q=q, k=k, v=v, lens=lens, S=S):
            mask = torch.arange(S, device=dev)[None] < lens.long()[:, None]
            return sdpa(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                        attn_mask=mask[:, None, None],
                        enable_gqa=True)[:, :, 0]

        lib_err = max_err(library(), want)
        n_bytes, flops = slot_decode_bound(q, lens.tolist(), Hk, D)
        (rows if S == 1090 else extra).append(dict(
            name="slot_decode_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/paged_decode.cu",
            replaces="none (src/repro/kernels/ops.py:67 is plain jnp)",
            max_abs_err=err, path=path, batch=B, slots=S, heads=heads,
            sum_lens=int(lens.sum()),
            split_plan=paged_attention.slot_plan(B, Hk, S),
            library_max_abs_err=lib_err,
            library_kernels_per_call=kernels_per_call(library),
            **timings(lambda: ops.decode_attention(*args, impl="cuda"),
                      lambda: ops.decode_attention(*args, impl="reference"),
                      library, flush, plain_reps=10),
            bytes=n_bytes, flops=flops))
        del q, k, v, got, want

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

    # the cells' B4 calls at smollm-135m's heads: prefill_32k's causal
    # 1 x 32,768 and train_4k's 8 x 4,096. SDPA gets K/V expanded to the
    # 9 query heads (its flash backend, whatever it does with GQA). Last
    # in the phase, the plain version timed over 5 calls at 32,768: after
    # 65 of its 0.3 s calls in a row, torch.profiler's captures in the
    # same process lose kernels (the SSD row's count read 1 of 3)
    for B, L, path in ((1, 32768, "prefill_32k cell (smollm-135m)"),
                       (8, 4096, "train_4k cell (smollm-135m, forward)")):
        q, k, v = flash_timing_scene(dev, B, L)
        got = ops.attention(q, k, v, impl="cuda")
        want = ops.attention(q, k, v, impl="reference")
        err = max_err(got, want)
        if not within(got, want, torch.bfloat16):
            fail(f"flash kernel vs plain, {path}: max abs err {err}")
        group = SMOLLM_HEADS[0] // SMOLLM_HEADS[1]
        sq = q.transpose(1, 2).contiguous()
        sk, sv = (t.repeat_interleave(group, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        n_bytes, flops = flash_bound(q, k)
        extra.append(dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:124",
            max_abs_err=err, batch=B, tokens=L, heads=SMOLLM_HEADS,
            path=path, library_kv_expanded=True,
            **timings(lambda: ops.attention(q, k, v, impl="cuda"),
                      lambda: ops.attention(q, k, v, impl="reference"),
                      lambda: sdpa(sq, sk, sv, is_causal=True), flush,
                      plain_reps=5 if L > 4096 else TIMING_REPS),
            bytes=n_bytes, flops=flops))
        del q, k, v, sq, sk, sv, got, want

    path = {"batched_paged_decode_attention": "paged engine (decode)",
            "slot_decode_attention": "slot-ring engine (decode)",
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
# depth of the minitron-8b and mamba2-2.7b check phases (full width)
CHECK_LAYERS = 8


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
        "slot_decode_attention": (paged_attention, "slot_decode_launches"),
    }


def decode_attention_per_step(cfg):
    """``ops.decode_attention`` calls, each one slot decode launch, in
    one slot-ring decode step: one an attention layer (zamba2: one an
    application of the shared block; whisper: self- and
    cross-attention a layer), none for Mamba-2."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        from repro_torch.models import hybrid
        return len(hybrid._app_positions(cfg))
    return 2 * cfg.n_layers if cfg.family == "encdec" else cfg.n_layers


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


def paged_engine_run(label, cfg, params, dev, **fields):
    """The paged engine (PAGED_ENGINE) on 24 requests (seed 0,
    ``max_tokens=64``, 64-token shared prefixes, sjf): every request
    completes, batched decode launched ``n_layers`` x decode iterations
    and chunked prefill ``n_layers`` x chunks (a vlm: flash attention
    ``n_layers`` x single-shot prefills, no chunk), no other kernel, a
    prefix-cache hit, and every page accounted for after the run."""
    eng, sched, reqs = serve(cfg, params, dev, PAGED_ENGINE, 24, 0,
                             shared_prefix_tokens=64)
    metrics, wall, launches = drain(eng)

    tokens = sum(r.observed_output_tokens for r in sched.completed)
    chunk_lens = {}
    for _, n in eng.prefill_chunk_log:
        chunk_lens[n] = chunk_lens.get(n, 0) + 1
    prefills = sum(r.prefill_end is not None for r in sched.completed)
    vlm = cfg.family == "vlm"
    if vlm:
        fields["single_shot_prefills"] = prefills
    if label != "engine":
        fields["peak_memory_gb"] = peak_gb()
    phase(label, arch=cfg.name, n_layers=cfg.n_layers, dtype=cfg.dtype,
          **fields, wall_s=wall, iterations=eng.step_count,
          decode_iterations=eng.n_decode_launches,
          prefill_chunks=eng.n_prefill_launches,
          completed=metrics.n_completed, tokens=tokens,
          tokens_per_s=tokens / wall, ms_per_iteration=1e3 * wall / eng.step_count,
          prefix=eng.prefix_cache_stats(), chunk_lengths=chunk_lens,
          launches=launches)
    if metrics.n_completed != len(reqs):
        fail(f"{label} completed {metrics.n_completed} of {len(reqs)}")
    if launches["batched_paged_decode_attention"] != \
            cfg.n_layers * eng.n_decode_launches:
        fail(f"{label}: decode launches {launches} != {cfg.n_layers} x "
             f"{eng.n_decode_launches} decode iterations")
    if vlm:
        # prefix-LM prefill, single-shot through B4 (JAX's rule)
        if prefills != len(reqs) or launches["flash_attention"] != \
                cfg.n_layers * prefills:
            fail(f"{label}: flash launches {launches} != {cfg.n_layers} x "
                 f"{prefills} single-shot prefills")
        other = ("paged_decode_attention", "chunked_prefill_attention",
                 "ssd_scan", "slot_decode_attention")
    else:
        if eng.n_prefill_launches <= 0 or \
                launches["chunked_prefill_attention"] != \
                cfg.n_layers * eng.n_prefill_launches:
            fail(f"{label}: prefill launches {launches} != {cfg.n_layers} x "
                 f"{eng.n_prefill_launches} prefill chunks")
        other = ("paged_decode_attention", "flash_attention", "ssd_scan",
                 "slot_decode_attention")
    if any(launches[k] for k in other):
        fail(f"{label}: the paged engine launched a kernel of another path: "
             f"{launches}")
    if eng.prefix_cache_stats()["hits"] <= 0:
        fail(f"{label}: no prefix-cache hit in the engine run")
    held = eng.alloc.free_pages + eng.ledger.owned_pages() + \
        eng.prefix_tree.total_pages()
    if held != eng.alloc.n_pages:
        fail(f"{label}: {held} of {eng.alloc.n_pages} pages accounted for")
    return eng, launches


def engine_phase(dev):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_api

    cfg = get_config("smollm-135m")
    t0 = time.perf_counter()
    params = get_api(cfg).init(cfg, torch.Generator().manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng, launches = paged_engine_run("engine", cfg, params, dev,
                                     init_s=init_s)
    return cfg, params, eng, launches


def engine_slot_phase(cfg, params, dev, label="engine_slot",
                      flash_per_prefill=None, gen_kw=None,
                      ecfg=SLOT_ENGINE, **fields):
    """The slot-ring engine (``ecfg``, paged=False) on the same model:
    each admission prefills its bucket in one shot (one flash-attention
    launch per attention layer: ``flash_per_prefill``, default
    ``n_layers``; 0 for an SSM), then decodes from the contiguous cache
    (one slot decode launch per ``decode_attention_per_step``) or the
    O(1) states. ``gen_kw`` goes to the request generator."""
    if flash_per_prefill is None:
        flash_per_prefill = cfg.n_layers
    slot_per_decode = decode_attention_per_step(cfg)
    eng, sched, reqs = serve(cfg, params, dev, ecfg, 24, 0,
                             **(gen_kw or {}))
    metrics, wall, launches = drain(eng)
    tokens = sum(r.observed_output_tokens for r in sched.completed)
    # a request's first token comes from its one single-shot prefill
    prefills = sum(r.prefill_end is not None for r in sched.completed)
    buckets = {}
    for r in sched.completed:
        b = next((b for b in ecfg["prompt_buckets"]
                  if max(r.prompt_tokens, 1) <= b),
                 ecfg["prompt_buckets"][-1])
        buckets[b] = buckets.get(b, 0) + 1
    phase(label, arch=cfg.name, n_layers=cfg.n_layers,
          dtype=cfg.dtype, wall_s=wall, iterations=eng.step_count,
          decode_iterations=eng.n_decode_launches, prefills=prefills,
          prefill_buckets=buckets, completed=metrics.n_completed,
          tokens=tokens, tokens_per_s=tokens / wall,
          ms_per_iteration=1e3 * wall / eng.step_count, launches=launches,
          **({} if label == "engine_slot" else dict(
              **fields, flash_per_prefill=flash_per_prefill,
              peak_memory_gb=peak_gb(),
              cache_bytes_per_slot={
                  k: t.nbytes // ecfg["n_slots"]
                  for k, t in eng.cache.items()})))
    if metrics.n_completed != len(reqs) or prefills != len(reqs):
        fail(f"{label} completed {metrics.n_completed} of "
             f"{len(reqs)} ({prefills} prefills)")
    if launches["flash_attention"] != flash_per_prefill * prefills:
        fail(f"{label}: flash launches {launches} != {flash_per_prefill} x "
             f"{prefills} prefills")
    if launches["slot_decode_attention"] != \
            slot_per_decode * eng.n_decode_launches:
        fail(f"{label}: slot decode launches {launches} != "
             f"{slot_per_decode} x {eng.n_decode_launches} decode iterations")
    others = {k: n for k, n in launches.items()
              if k not in ("flash_attention", "slot_decode_attention")}
    if any(others.values()):
        fail(f"{label}: the slot-ring engine launched a kernel of another "
             f"path: {others}")
    return launches


def engine_profile_phase(cfg, params, dev, label, ecfg, steps=24,
                         fields=None, **gen_kw):
    """Where an engine iteration's time goes: ``steps`` iterations of a
    fresh full-width engine under torch.profiler. Device time is the sum
    of kernel and copy time on the GPU; its share of the profiled wall
    time is how busy the host keeps the card. ``fields`` are printed
    with it."""
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
    profile_summary(label, prof, steps, wall_ms, "iteration", **(fields or {}))


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


def check_logits(label, kern, plain, plain32, kern32=None, **fields):
    """Kernel-path logits against the plain path's, within the plain
    path's own bf16-vs-float32 deviation; a greedy flip only at a
    near-tie of the plain path. With ``kern32`` (the kernel path in
    float32) the gate is float32, as train_dense_check's: ``kern32``
    against ``plain32`` within the same tolerance, and the bf16
    deviation is printed, ungated (through many bf16 layers the two
    bf16 paths decorrelate: one bf16 ulp of a kernel output changes
    later roundings everywhere)."""
    from repro_torch.models.steps import sample_logits
    tol = max(max_err(a, b) for a, b in zip(plain, plain32))
    gated = (kern, plain) if kern32 is None else (kern32, plain32)
    worst, ties, rows = 0.0, 0, 0
    for got, want in zip(*gated):
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
    if kern32 is not None:
        bf16 = max(max_err(a, b) for a, b in zip(kern, plain))
        fields = dict(gated_on="float32", max_abs_logit_err_bf16_ungated=bf16,
                      ratio_bf16_to_tol=bf16 / tol, **fields)
    phase(label, max_abs_logit_err=worst, tol_bf16_vs_f32_plain=tol,
          logit_std=plain[-1].std().item(), greedy_rows=rows,
          near_tie_flips=ties, **fields)
    if worst > tol:
        fail(f"{label}: logits kernels vs plain: max abs err {worst} > {tol}")


def engine_slot_check_phase(cfg, params, dev):
    """One full-width prefill of four 256-token prompts (flash kernel)
    and one decode step from the cache it made (slot decode kernel),
    against the same calls through the plain versions."""
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
        ld, _ = transformer.decode_step(c, p, cache, step, 256, impl=impl)
        return lp.float(), ld.float()

    reset_launches()
    kern = run("auto", None)
    n_flash = read_launches()["flash_attention"]
    n_slot = read_launches()["slot_decode_attention"]
    plain, plain32 = run("reference", None), run("reference", torch.float32)
    kern32 = run("auto", torch.float32)
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
    if n_flash != cfg.n_layers or n_slot != cfg.n_layers:
        fail(f"engine_slot_check: {n_flash} flash and {n_slot} slot decode "
             f"launches for one {cfg.n_layers}-layer prefill and decode step")
    check_logits("engine_slot_check", kern, plain, plain32,
                 plain_reordered_max_abs_logit_err=spread)
    # ROADMAP B0: a float32 gate beside the bf16 one
    check_logits("engine_slot_check_f32", kern, plain, plain32, kern32=kern32)


def engine_check_phase(cfg, params, pool, pps, dev, label="engine_check",
                       gate="bfloat16", **fields):
    """One full-width prefill chunk and one decode step through the
    kernels against the same calls through the plain versions, each
    from a copy of ``pool`` (a PagedPool; ``pps`` pages per sequence)
    with random page tables. ``gate`` "float32" runs every path in
    float32 as well and gates on that pair (``check_logits``); "both"
    keeps the bf16 gate and adds the float32 one beside it, on a line
    ``<label>_f32`` (ROADMAP B0). For an
    MoE model the routing of the kernel and the plain path (each
    layer's top experts and kept entries) is compared too and the
    entries that differ printed (``routing_differences``): a routing
    flip moves logits far more than a kernel's rounding does."""
    from repro_torch.models import transformer
    gen = torch.Generator(device=dev).manual_seed(3)
    n_pages = pool.n_pages
    tables = torch.randperm(n_pages - 1, generator=gen, device=dev)[
        :8 * pps].reshape(8, pps).to(torch.int32)
    chunk = torch.randint(1, cfg.vocab, (1, 128), generator=gen, device=dev)
    q_offset = torch.tensor([64], dtype=torch.int32, device=dev)
    step_tokens = torch.randint(1, cfg.vocab, (8,), generator=gen, device=dev)
    lens = torch.tensor([192, 0, 77, 130, 255, 16, 200, 98],
                        dtype=torch.int32, device=dev)
    step_tables = tables.clone()
    step_tables[1] = n_pages - 1                   # an inactive slot
    p32 = _cast(params, torch.float32)
    c32 = cfg.replace(dtype="float32")

    routes = {}

    def run(impl, f32):
        p, c, dtype = (p32, c32, torch.float32) if f32 else (params, cfg, None)
        k, v = pool.k, pool.v
        with recorded_routes() as routes[impl, f32]:
            lp = transformer.prefill_chunk_paged(
                c, p, {"k": k.to(dtype or k.dtype, copy=True),
                       "v": v.to(dtype or v.dtype, copy=True)},
                chunk, tables[:1], q_offset, impl=impl)
            ld = transformer.decode_step_paged(
                c, p, {"k": k.to(dtype or k.dtype, copy=True),
                       "v": v.to(dtype or v.dtype, copy=True)},
                step_tokens, step_tables, lens, max_pages=16, impl=impl)
        return lp.float(), ld.float()

    reset_launches()
    kern = run("auto", False)
    launches = read_launches()
    plain, plain32 = run("reference", False), run("reference", True)
    kern32 = run("auto", True) if gate in ("float32", "both") else None
    torch.cuda.synchronize()
    want = {"chunked_prefill_attention": cfg.n_layers,
            "batched_paged_decode_attention": cfg.n_layers}
    if {k: n for k, n in launches.items() if n} != want:
        fail(f"{label}: launches {launches}, want {want}")
    if gate == "float32":
        fields.update(launches=launches)
    if cfg.family == "moe":
        fields["routing_differences"] = {
            name: routing_differences(routes["auto", f32],
                                      routes["reference", f32])
            for name, f32 in (("bfloat16", False), ("float32", True))
            if ("auto", f32) in routes}
    if gate == "both":
        check_logits(label, kern, plain, plain32, **fields)
        check_logits(f"{label}_f32", kern, plain, plain32, kern32=kern32,
                     launches=launches)
        return
    check_logits(label, kern, plain, plain32, kern32=kern32, **fields)


@contextlib.contextmanager
def recorded_routes():
    """A list of each MoE layer's routing, (top experts [G, g, K], kept
    entries [G, g, K]), as ``layers.moe_route`` computes it inside the
    ``with`` block, in call order (empty for a model without MoE)."""
    from repro_torch.models import layers
    routes, route = [], layers.moe_route

    def record(cfg, p, xg):
        r = route(cfg, p, xg)
        routes.append((r["top_e"], r["keep"]))
        return r

    with mock.patch.object(layers, "moe_route", record):
        yield routes


def routing_differences(a, b):
    """Per MoE call (a prefill chunk's layers, then a decode step's) of
    two runs: how many (token, k) entries picked another expert and how
    many were kept in one run and dropped in the other, of how many."""
    if len(a) != len(b):
        fail(f"routing: {len(a)} MoE calls against {len(b)}")
    return [{"top_e": int((ea != eb).sum()), "keep": int((ka != kb).sum()),
             "entries": ea.numel()} for (ea, ka), (eb, kb) in zip(a, b)]


def init_on_card(arch, dev, card, seed, n_layers=None):
    """``arch``'s config (depth cut to ``n_layers`` if given) and random
    params drawn on a generator on the card: (cfg, params, fields to
    print: the card's name and power limit ``card``, the seed, the cut,
    the seconds the init took)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_api
    full = get_config(arch)
    cfg = full.replace(n_layers=n_layers or full.n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = get_api(cfg).init(cfg, torch.Generator(device=dev).manual_seed(seed),
                               device=dev)
    torch.cuda.synchronize()
    fields = dict(card=card, init_seed=seed, init_generator=str(dev),
                  init_s=time.perf_counter() - t0,
                  n_params=n_params(params), param_bytes=n_params(params, True))
    if n_layers:
        fields["depth_cut_from"] = full.n_layers
    return cfg, params, fields


def peak_gb():
    return torch.cuda.max_memory_allocated() / 2 ** 30


def engine_minitron_phases(dev, card):
    """Full-width minitron-8b (32 layers, bf16, 9.9 B params) on both
    caches: the paged engine (B1 and B2), its profile, the slot-ring
    engine on the same requests (B4), and one prefill chunk and decode
    step at full width, depth cut to 8 layers, gated in float32."""
    from repro_torch.serving.kv_cache import PagedPool
    cfg, params, fields = init_on_card("minitron-8b", dev, card, 8)
    _, launches = paged_engine_run("engine_minitron", cfg, params, dev,
                                   **fields)
    engine_profile_phase(cfg, params, dev, "engine_minitron_profile",
                         PAGED_ENGINE, fields=dict(card=card),
                         shared_prefix_tokens=64)
    engine_slot_phase(cfg, params, dev, "engine_minitron_slot",
                      gen_kw=dict(shared_prefix_tokens=64), card=card)
    del params
    torch.cuda.empty_cache()

    cfg, params, fields = init_on_card("minitron-8b", dev, card, 9,
                                       n_layers=CHECK_LAYERS)
    pps = -(-PAGED_ENGINE["max_len"] // PAGED_ENGINE["page_size"])
    pool = PagedPool.create(cfg, 8 * pps + PAGED_ENGINE["prefix_cache_pages"]
                            + 1, PAGED_ENGINE["page_size"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(10)
    for t in (pool.k, pool.v):          # K/V of unit scale, as the model's
        t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    engine_check_phase(cfg, params, pool, pps, dev,
                       label="engine_minitron_check", gate="float32",
                       arch=cfg.name, n_layers=cfg.n_layers, **fields, pool_contents="random N(0, 1) K/V, seed 10")
    del params, pool
    torch.cuda.empty_cache()
    return launches


def engine_mamba2_phases(dev, card):
    """Full-width mamba2-2.7b (64 layers, bf16) on the slot-ring engine,
    which launches no kernel (the SSD prefill and the decode step are
    plain, as in JAX), and its profile."""
    cfg, params, fields = init_on_card("mamba2-2.7b", dev, card, 12)
    engine_slot_phase(cfg, params, dev, "engine_mamba2", flash_per_prefill=0,
                      **fields)
    engine_profile_phase(cfg, params, dev, "engine_mamba2_profile",
                         SLOT_ENGINE, fields=dict(card=card))
    del params
    torch.cuda.empty_cache()


def engine_mamba2_check_phase(dev, card):
    """The serving path, which has no kernel, against the B5 kernel: at
    full width, depth cut to 8 layers, float32, prefill's last logits
    and one decode step's logits against ``mamba2.forward`` (the SSD
    kernel) on the same tokens and those plus one. The tolerance is 4x
    the plain forward's own float32 deviation when its scan is summed
    over chunks of 128 instead of 256 (the same function in another
    order): each of the two compared paths is such a reordering of the
    exact sum (2x), and the kernel splits its float32 operands into
    bf16 parts for the tensor cores where the plain path multiplies in
    float32 (2x more)."""
    from repro_torch.models import mamba2
    cfg, params, fields = init_on_card("mamba2-2.7b", dev, card, 13,
                                       n_layers=CHECK_LAYERS)
    cfg = cfg.replace(dtype="float32")
    params = _cast(params, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(14)
    L = 256
    tokens = torch.randint(1, cfg.vocab, (2, L + 1), generator=gen, device=dev)
    reset_launches()
    logits_k, _ = mamba2.forward(cfg, params, tokens, impl="auto")
    lp, cache = mamba2.prefill(cfg, params, tokens[:, :L])
    ld, _ = mamba2.decode_step(cfg, params, cache, tokens[:, L], cache["lens"])
    torch.cuda.synchronize()
    launches = read_launches()
    plain, _ = mamba2.forward(cfg, params, tokens, impl="reference")
    plain128, _ = mamba2.forward(cfg.replace(ssm_chunk=128), params, tokens,
                                 impl="reference")
    kern = logits_k[:, L - 1:L + 1]
    serve_ = torch.stack([lp, ld], dim=1)
    reorder = max_err(plain128[:, L - 1:L + 1], plain[:, L - 1:L + 1])
    tol = 4 * reorder
    err = max_err(serve_, kern)
    phase("engine_mamba2_check", arch=cfg.name, n_layers=cfg.n_layers,
          dtype=cfg.dtype, **fields, tokens=L, batch=2,
          max_abs_logit_err_serve_vs_kernel=err, tol=tol,
          plain_chunk128_vs_chunk256=reorder,
          max_abs_logit_err_serve_vs_plain=max_err(
              serve_, plain[:, L - 1:L + 1]),
          max_abs_logit_err_kernel_vs_plain=max_err(
              kern, plain[:, L - 1:L + 1]),
          logit_std=plain[:, L].std().item(), launches=launches)
    if {k: n for k, n in launches.items() if n} != {"ssd_scan": cfg.n_layers}:
        fail(f"engine_mamba2_check: launches {launches}, want "
             f"{cfg.n_layers} SSD launches (the forward) and no other")
    if not math.isfinite(err) or err > tol:
        fail(f"engine_mamba2_check: serving logits vs the kernel forward: "
             f"max abs err {err} > {tol}")
    del params
    torch.cuda.empty_cache()


def engine_zamba2_phases(dev, card):
    """Full-width zamba2-1.2b (38 Mamba layers, 7 applications of the
    shared block, bf16) on the slot-ring engine: B4 once per application
    and prefill, nothing else; its profile; and one prefill and decode
    step, B4 against plain, gated in float32."""
    from repro_torch.models import hybrid
    cfg, params, fields = init_on_card("zamba2-1.2b", dev, card, 15)
    n_apps = len(hybrid._app_positions(cfg))
    engine_slot_phase(cfg, params, dev, "engine_zamba2",
                      flash_per_prefill=n_apps, **fields)
    engine_profile_phase(cfg, params, dev, "engine_zamba2_profile",
                         SLOT_ENGINE, fields=dict(card=card))

    gen = torch.Generator(device=dev).manual_seed(16)
    tokens = torch.randint(1, cfg.vocab, (4, 256), generator=gen, device=dev)
    step = torch.randint(1, cfg.vocab, (4,), generator=gen, device=dev)
    p32, c32 = _cast(params, torch.float32), cfg.replace(dtype="float32")

    def run(p, c, impl):
        lp, cache = hybrid.prefill(c, p, tokens, max_len=512, impl=impl)
        ld, _ = hybrid.decode_step(c, p, cache, step, cache["lens"],
                                   impl=impl)
        return lp.float(), ld.float()

    reset_launches()
    kern = run(params, cfg, "auto")
    launches = read_launches()
    plain, plain32 = run(params, cfg, "reference"), run(p32, c32, "reference")
    kern32 = run(p32, c32, "auto")
    torch.cuda.synchronize()
    if {k: n for k, n in launches.items() if n} != {
            "flash_attention": n_apps, "slot_decode_attention": n_apps}:
        fail(f"engine_zamba2_check: launches {launches}, want {n_apps} "
             "flash launches for one prefill and as many slot decode "
             "launches for one decode step")
    check_logits("engine_zamba2_check", kern, plain, plain32, kern32=kern32,
                 arch=cfg.name, n_layers=cfg.n_layers, applications=n_apps,
                 launches=launches, card=card)
    del params, p32
    torch.cuda.empty_cache()


# whisper-large-v3 on the slot-ring cache: SLOT_ENGINE's 8 slots and
# buckets, max_len 448 (its published max_target_positions)
WHISPER_ENGINE = dict(SLOT_ENGINE, max_len=448)


def whisper_flash_per_prefill(cfg):
    """B4 launches of one encdec prefill: each encoder layer's
    self-attention, each decoder layer's causal self-attention and its
    cross-attention."""
    return cfg.n_enc_layers + 2 * cfg.n_layers


def engine_whisper_phases(dev, card):
    """Full-width whisper-large-v3 (32 encoder and 32 decoder layers,
    bf16) on the slot-ring engine: B4 96 times a prefill (encoder 1,500
    x 1,500 non-causal, decoder causal, cross-attention bucket x 1,500)
    and nothing else; its profile; and one prefill of 4 x 128 tokens
    over random frames and one decode step, B4 against plain, gated in
    float32."""
    from repro_torch.models import encdec
    cfg, params, fields = init_on_card("whisper-large-v3", dev, card, 18)
    per_prefill = whisper_flash_per_prefill(cfg)
    engine_slot_phase(cfg, params, dev, "engine_whisper",
                      flash_per_prefill=per_prefill, ecfg=WHISPER_ENGINE,
                      n_enc_layers=cfg.n_enc_layers,
                      max_len=WHISPER_ENGINE["max_len"], **fields)
    engine_profile_phase(cfg, params, dev, "engine_whisper_profile",
                         WHISPER_ENGINE, fields=dict(card=card))

    gen = torch.Generator(device=dev).manual_seed(19)
    tokens = torch.randint(1, cfg.vocab, (4, 128), generator=gen, device=dev)
    step = torch.randint(1, cfg.vocab, (4,), generator=gen, device=dev)
    frames = 0.02 * torch.randn(4, cfg.enc_seq, cfg.d_model, generator=gen,
                                device=dev)
    p32, c32 = _cast(params, torch.float32), cfg.replace(dtype="float32")

    def run(p, c, impl):
        lp, cache = encdec.prefill(c, p, tokens, frames=frames,
                                   max_len=WHISPER_ENGINE["max_len"],
                                   impl=impl)
        ld, _ = encdec.decode_step(c, p, cache, step, cache["lens"],
                                   impl=impl)
        return lp.float(), ld.float()

    reset_launches()
    kern = run(params, cfg, "auto")
    launches = read_launches()
    plain, plain32 = run(params, cfg, "reference"), run(p32, c32, "reference")
    kern32 = run(p32, c32, "auto")
    torch.cuda.synchronize()
    want = {"flash_attention": per_prefill,
            "slot_decode_attention": decode_attention_per_step(cfg)}
    if {k: n for k, n in launches.items() if n} != want:
        fail(f"engine_whisper_check: launches {launches}, want {want} for "
             f"one prefill and one decode step")
    check_logits("engine_whisper_check", kern, plain, plain32, kern32=kern32,
                 arch=cfg.name, n_layers=cfg.n_layers,
                 n_enc_layers=cfg.n_enc_layers, batch=4, tokens=128,
                 frames="0.02 N(0, 1), seed 19", launches=launches, card=card)
    del params, p32, frames
    torch.cuda.empty_cache()


# paligemma-3b on the slot-ring cache: SLOT_ENGINE's 8 slots and buckets,
# max_len 640 >= 256 patches + the 256 bucket + 64 tokens + 2, so that
# no ring fills up (ROADMAP C2: decode is capped at max_len - bucket - 2,
# which does not count the prefix)
PALIGEMMA_SLOT = dict(SLOT_ENGINE, max_len=640)
# depths of the MoE runs at full width: a 4-layer grok-1 is 21.3 B
# params (42.6 GB in bf16), an 8-layer llama4-scout 18.7 B (37.4 GB);
# the grok check's one layer fits beside its float32 copy
GROK_LAYERS, GROK_CHECK_LAYERS, LLAMA4_LAYERS = 4, 1, 8


def engine_paligemma_phases(dev, card):
    """Full-width paligemma-3b (18 layers, d_model 2048, 8 q over 1 kv
    head of 256, vocab 257,216; 2.51 B params), bf16, zero patches from
    the engine: the paged engine (B4 once per layer and single-shot
    prefill, B1 once per layer and decode iteration, no B2), the
    slot-ring engine at max_len 640 (B4 only), the paged engine's
    profile, and the check."""
    cfg, params, fields = init_on_card("paligemma-3b", dev, card, 20)
    paged_engine_run("engine_paligemma", cfg, params, dev, **fields)
    engine_slot_phase(cfg, params, dev, "engine_paligemma_slot",
                      ecfg=PALIGEMMA_SLOT,
                      gen_kw=dict(shared_prefix_tokens=64),
                      max_len=PALIGEMMA_SLOT["max_len"], card=card)
    engine_profile_phase(cfg, params, dev, "engine_paligemma_profile",
                         PAGED_ENGINE, fields=dict(card=card),
                         shared_prefix_tokens=64)
    engine_paligemma_check_phase(cfg, params, dev, card)
    del params
    torch.cuda.empty_cache()


def engine_paligemma_check_phase(cfg, params, dev, card):
    """One prefill of 4 x (256 + 128): random patches (0.02 N(0, 1),
    rounded to bf16 for every path) and 128 tokens, B4 with the
    prefix-LM mask; and one paged decode step of 8 slots (one idle) from
    a pool of random K/V, B1: the kernel path against the plain path,
    gated in float32, the bf16 deviation printed."""
    from repro_torch.models import transformer
    from repro_torch.serving.kv_cache import PagedPool
    gen = torch.Generator(device=dev).manual_seed(24)
    tokens = torch.randint(1, cfg.vocab, (4, 128), generator=gen, device=dev)
    patches = (0.02 * torch.randn(4, cfg.prefix_len, cfg.d_model,
                                  generator=gen, device=dev)).to(torch.bfloat16)
    P = PAGED_ENGINE["page_size"]
    pps = -(-PAGED_ENGINE["max_len"] // P)
    pool = PagedPool.create(cfg, 8 * pps + 1, P, device=dev)
    for t in (pool.k, pool.v):          # K/V of unit scale, as the model's
        t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    tables = torch.randperm(8 * pps, generator=gen, device=dev).reshape(
        8, pps).to(torch.int32)
    tables[1] = pool.n_pages - 1                   # an idle slot
    lens = torch.tensor([192, 0, 77, 130, 255, 16, 200, 98],
                        dtype=torch.int32, device=dev)
    step = torch.randint(1, cfg.vocab, (8,), generator=gen, device=dev)
    p32, c32 = _cast(params, torch.float32), cfg.replace(dtype="float32")

    def run(p, c, impl):
        dtype = torch.float32 if c is c32 else pool.k.dtype
        lp, _ = transformer.prefill(c, p, tokens, patches=patches,
                                    max_len=PALIGEMMA_SLOT["max_len"],
                                    impl=impl)
        ld = transformer.decode_step_paged(
            c, p, {"k": pool.k.to(dtype, copy=True),
                   "v": pool.v.to(dtype, copy=True)},
            step, tables, lens, max_pages=16, impl=impl)
        return lp.float(), ld.float()

    reset_launches()
    kern = run(params, cfg, "auto")
    launches = read_launches()
    plain, plain32 = run(params, cfg, "reference"), run(p32, c32, "reference")
    kern32 = run(p32, c32, "auto")
    torch.cuda.synchronize()
    want = {"flash_attention": cfg.n_layers,
            "batched_paged_decode_attention": cfg.n_layers}
    if {k: n for k, n in launches.items() if n} != want:
        fail(f"engine_paligemma_check: launches {launches}, want {want}")
    check_logits("engine_paligemma_check", kern, plain, plain32,
                 kern32=kern32, arch=cfg.name, n_layers=cfg.n_layers,
                 batch=4, tokens=128, prefix_len=cfg.prefix_len,
                 patches="0.02 N(0, 1) in bf16, seed 24",
                 pool_contents="random N(0, 1) K/V, seed 24",
                 launches=launches, card=card)
    del p32, pool


def engine_grok_phases(dev, card):
    """Full-width grok-1-314b (d_model 6144, 48 q over 8 kv heads of 128,
    d_ff 32,768, 8 experts top-2, softcap 30), depth cut from 64 to 4
    layers (21.3 B params, 42.6 GB in bf16): the paged engine (B2 once
    per layer and chunk, B1 once per layer and decode iteration), the
    slot-ring engine (B4 once per layer and prefill), the paged engine's
    profile; then, the 4-layer model freed, one prefill chunk and decode
    step at full width and one layer, gated in float32, with the kernel
    and plain paths' routing compared."""
    from repro_torch.serving.kv_cache import PagedPool
    cfg, params, fields = init_on_card("grok-1-314b", dev, card, 21,
                                       n_layers=GROK_LAYERS)
    paged_engine_run("engine_grok", cfg, params, dev, **fields)
    engine_slot_phase(cfg, params, dev, "engine_grok_slot",
                      gen_kw=dict(shared_prefix_tokens=64), card=card)
    engine_profile_phase(cfg, params, dev, "engine_grok_profile",
                         PAGED_ENGINE, fields=dict(card=card),
                         shared_prefix_tokens=64)
    del params
    torch.cuda.empty_cache()

    cfg, params, fields = init_on_card("grok-1-314b", dev, card, 22,
                                       n_layers=GROK_CHECK_LAYERS)
    pps = -(-PAGED_ENGINE["max_len"] // PAGED_ENGINE["page_size"])
    pool = PagedPool.create(cfg, 8 * pps + PAGED_ENGINE["prefix_cache_pages"]
                            + 1, PAGED_ENGINE["page_size"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    for t in (pool.k, pool.v):          # K/V of unit scale, as the model's
        t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    engine_check_phase(cfg, params, pool, pps, dev, label="engine_grok_check",
                       gate="float32", arch=cfg.name, n_layers=cfg.n_layers,
                       **fields, pool_contents="random N(0, 1) K/V, seed 23")
    del params, pool
    torch.cuda.empty_cache()


def engine_llama4_phases(dev, card):
    """Full-width llama4-scout-17b-a16e (d_model 5120, 40 q over 8 kv
    heads of 128, 16 experts top-1), depth cut from 48 to 8 layers (18.7
    B params, 37.4 GB in bf16), on the slot-ring engine: B4 once per
    layer and prefill, nothing else; launch counts and peak memory."""
    cfg, params, fields = init_on_card("llama4-scout-17b-a16e", dev, card, 25,
                                       n_layers=LLAMA4_LAYERS)
    engine_slot_phase(cfg, params, dev, "engine_llama4",
                      gen_kw=dict(shared_prefix_tokens=64), **fields)
    del params
    torch.cuda.empty_cache()


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
# 448 decoder tokens: whisper's published max_target_positions
WHISPER_TRAIN = dict(arch="whisper-large-v3", batch=2, seq=448, steps=3,
                     lr=3e-4)


def n_params(tree, in_bytes=False) -> int:
    from repro_torch.distributed.optimizer import tree_leaves
    return sum(t.nbytes if in_bytes else t.numel() for t in tree_leaves(tree))


def run_steps(cfg, setup, n, dev):
    """``n`` train steps through the launcher's code from step 0 (its
    batches, with the stub frontend inputs drawn as the launcher draws
    them), with every launch count set to 0 just before and read just
    after: (per step (loss, grad norm, seconds), launches)."""
    from repro_torch.launch.train import batch_on
    params, opt_state, step_fn, ds = setup
    rng = np.random.default_rng(0)
    batches = [batch_on(cfg, ds, s, rng, dev) for s in range(n)]
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
    log, launches = run_steps(cfg, setup, TRAIN["steps"], dev)
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


def train_profile_phase(cfg, setup, dev):
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
    batch = batch_on(cfg, ds, TRAIN["steps"], np.random.default_rng(0), dev)
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
    plain path; the bf16 comparison is then printed only. "both" gates
    the two comparisons (ROADMAP B0: a float32 gate beside the bf16
    one). That is for a
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
    batch = batch_on(cfg, make_dataset("synthetic", cfg, spec["seq"],
                                       spec["batch"]), 0,
                     np.random.default_rng(0), dev)

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
    if gate in ("float32", "both"):
        kern32 = run("auto", torch.float32)
        err32 = {k: max_err(kern32[k], plain32[k]) for k in kern}
        gated = err32 if gate == "float32" else \
            {k: max(err[k], err32[k]) for k in kern}
        extra = {"max_abs_err_kernel_vs_plain_f32": err32,
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
    log, launches = run_steps(cfg, setup, DENSE_TRAIN["steps"], dev)
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
    return secs


def train_whisper_phase(dev, card):
    """Full-width whisper-large-v3: 3 AdamW steps on batch 2 x 448
    decoder tokens over the launcher's stub frames (2 x 1,500 x 1,280),
    remat on: B4 runs for every encoder and decoder attention in the
    forward and again in its recompute, 2 x 96 a step."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, setup = train_setup(WHISPER_TRAIN, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log, launches = run_steps(cfg, setup, WHISPER_TRAIN["steps"], dev)
    want = 2 * whisper_flash_per_prefill(cfg) * WHISPER_TRAIN["steps"]
    secs = statistics.median(t for _, _, t in log[1:])
    phase("train_whisper", arch=cfg.name, n_layers=cfg.n_layers,
          n_enc_layers=cfg.n_enc_layers, dtype=cfg.dtype,
          params=n_params(setup[0]), param_count=cfg.param_count(),
          batch=WHISPER_TRAIN["batch"], seq=WHISPER_TRAIN["seq"],
          frames=[WHISPER_TRAIN["batch"], cfg.enc_seq, cfg.d_model],
          remat=True, init_s=init_s, loss=[l for l, _, _ in log],
          grad_norm=[g for _, g, _ in log], step_s=[t for _, _, t in log],
          median_step_s_2_to_3=secs,
          tokens_per_s=WHISPER_TRAIN["batch"] * WHISPER_TRAIN["seq"] / secs,
          peak_memory_gb=peak_gb(), launches=launches,
          flash_launches_expected=want, card=card)
    if not all(math.isfinite(l) and math.isfinite(g) for l, g, _ in log):
        fail(f"train_whisper: a loss or grad norm is not finite: {log}")
    if launches["flash_attention"] != want:
        fail(f"train_whisper: {launches['flash_attention']} flash launches, "
             f"want 2 x {whisper_flash_per_prefill(cfg)} x "
             f"{WHISPER_TRAIN['steps']} = {want}")
    others = {k: n for k, n in launches.items() if k != "flash_attention"}
    if any(others.values()):
        fail(f"train_whisper: a kernel of another path ran: {others}")
    del setup
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the assigned cells: the one-card dry run on meta, the step units on the
# card at full width, and the port's examples
# ---------------------------------------------------------------------------

def start_dryrun(out_dir):
    """The port's dry run over every (arch x shape) cell, on the meta
    device in a process of its own (no card; about two and a half
    minutes of one CPU core), started first so that it runs beside the
    card's phases. ``dryrun_phase`` reads its records."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "all",
         "--shape", "all", "--out", out_dir, "--force"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def dryrun_phase(proc, out_dir, t_start):
    """One line per cell of the dry run started by ``start_dryrun``: its
    FLOPs and bytes counted on meta, the model FLOPs, the lower bound on
    the H100 and whether argument + output bytes fit one card. Fails on
    a cell in error or a cell missing."""
    from repro_torch.configs import ARCHS, SHAPES, cells_for, get_config
    log, _ = proc.communicate(timeout=900)
    wall = time.perf_counter() - t_start
    recs = [json.loads(p.read_text())
            for p in sorted(Path(out_dir).glob("*.json"))]
    status = {}
    for r in recs:
        status[r["status"]] = status.get(r["status"], 0) + 1
        if r["status"] != "ok":
            phase("dryrun", arch=r["arch"], shape=r["shape"],
                  status=r["status"], reason=r.get("reason", r.get("error")))
            continue
        rf = r["roofline"]
        phase("dryrun", arch=r["arch"], shape=r["shape"], status="ok",
              flops=r["cost_analysis"]["flops"],
              bytes=r["cost_analysis"]["bytes accessed"],
              model_flops=rf["model_flops_total"],
              bound_s=rf["step_time_lower_bound_s"],
              bound_io_s=max(rf["compute_s"], rf["memory_io_lower_s"]),
              bottleneck=rf["bottleneck"],
              argument_bytes=r["memory_analysis"]["argument_size_in_bytes"],
              output_bytes=r["memory_analysis"]["output_size_in_bytes"],
              fits_one_card=r["fits_one_card"], count_s=r["run_s"])
    want = sum(len(cells_for(get_config(a))) for a in ARCHS)
    phase("dryrun", cells=len(recs), status=status, seconds_from_start=wall)
    if proc.returncode != 0 or status.get("error") or \
            len(recs) != len(ARCHS) * len(SHAPES) or status.get("ok") != want:
        fail(f"dryrun: exit {proc.returncode}, {status} of {len(recs)} "
             f"records, want {want} ok:\n{log[-3000:]}")


# The cells run on the card: (arch, shape, batch). The batch is cut to
# what one H100 holds (from SHAPES' global batch); depth and widths are
# the published ones. decode_32k at 128 sequences needs 96.6 GB of cache.
CELLS = (("smollm-135m", "prefill_32k", 2), ("smollm-135m", "decode_32k", 32),
         ("smollm-135m", "train_4k", 8), ("mamba2-2.7b", "long_500k", 1),
         ("zamba2-1.2b", "long_500k", 1), ("h2o-danube-1.8b", "long_500k", 1))
CELL_SEED = 22
CELL_REPS = 3


def flash_per_step(cfg, kind):
    """B4 launches of one step of a dense model: one a layer in a
    prefill, two in a train step (forward and remat recompute), none in
    a decode step (plain, as in JAX)."""
    return {"prefill": 1, "train": 2, "decode": 0}[kind] * cfg.n_layers


def cell_phase(dev, card, arch, shape_name, batch):
    """``arch``'s ``shape_name`` cell on the card at full width and depth,
    batch cut to ``batch``: the step unit (``make_prefill_step``,
    ``make_serve_step`` with every cache entry valid, or
    ``make_train_step`` with AdamW) on inputs drawn from CELL_SEED on
    the card; one warm-up and CELL_REPS timed steps (CUDA events), the
    launch counts set to 0 just before and read just after; the cost
    counter's bound at the cut batch beside the measured time."""
    import dataclasses
    from repro_torch.configs import SHAPES
    from repro_torch.launch.dryrun import count_cell
    from repro_torch.launch.mesh import HW
    from repro_torch.models.registry import get_api
    from repro_torch.models.steps import make_prefill_step, make_serve_step
    label = f"cell_{arch}_{shape_name}"
    shape = SHAPES[shape_name]
    cut = dataclasses.replace(shape, global_batch=batch)
    L = shape.seq_len
    torch.cuda.reset_peak_memory_stats()
    if shape.kind == "train":
        from repro_torch.configs import get_config
        from repro_torch.launch.train import build
        cfg, fields = get_config(arch), dict(card=card, init_seed=CELL_SEED)
        params, _, opt_state, step = build(cfg, steps=100, lr=3e-4,
                                           seed=CELL_SEED, device=dev)
    else:
        cfg, params, fields = init_on_card(arch, dev, card, CELL_SEED)
    gen = torch.Generator(device=dev).manual_seed(CELL_SEED + 1)
    if shape.kind == "train":
        tokens = torch.randint(0, cfg.vocab, (batch, L + 1), generator=gen,
                               device=dev, dtype=torch.int32)
        batch_in = {"tokens": tokens[:, :-1].contiguous(),
                    "labels": tokens[:, 1:].contiguous()}
        run = lambda: step(params, opt_state, batch_in)[2]["loss"]  # noqa: E731
        n_tokens = batch * L
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg, max_len=L)
        batch_in = {"tokens": torch.randint(0, cfg.vocab, (batch, L),
                                            generator=gen, device=dev,
                                            dtype=torch.int32)}
        run = lambda: step(params, batch_in, None)[0]  # noqa: E731
        n_tokens = batch * L
    else:
        # every cache entry valid: lens L - 1 becomes min(L, ring) in the
        # step, which then reads the whole cache (a window's full ring)
        cache = get_api(cfg).init_cache(cfg, batch, L, device=dev)
        for t in cache.values():
            if t.is_floating_point():
                t.normal_(generator=gen)
        cache["lens"].fill_(L - 1)
        tokens = torch.randint(0, cfg.vocab, (batch,), generator=gen,
                               device=dev, dtype=torch.int32)
        pos = torch.tensor(L - 1, dtype=torch.int32, device=dev)
        step = make_serve_step(cfg)
        run = lambda: step(params, cache, tokens, pos, None)[0]  # noqa: E731
        n_tokens = batch
        fields["cache_bytes"] = sum(t.nbytes for t in cache.values())
    torch.cuda.synchronize()
    reset_launches()
    out = run()
    torch.cuda.synchronize()
    times = []
    for _ in range(CELL_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    launches = read_launches()
    peak = peak_gb()
    if shape.kind == "train":
        ok = bool(torch.isfinite(out))
    else:
        ok = out.shape == (batch,) and int(out.min()) >= 0 and \
            int(out.max()) < cfg.vocab
    t = statistics.median(times)
    rec = count_cell(cfg, cut)
    rf = rec["roofline"]
    bound_io = max(rf["compute_s"], rf["memory_io_lower_s"])
    flash = flash_per_step(cfg, shape.kind)
    slot = decode_attention_per_step(cfg) if shape.kind == "decode" else 0
    steps = CELL_REPS + 1
    phase(label, arch=arch, shape=shape_name, kind=shape.kind, **fields,
          n_layers=cfg.n_layers, dtype=cfg.dtype,
          reduced=dict(global_batch=[shape.global_batch, batch]),
          seq_len=L, step_s=t, step_s_all=times, tokens_per_s=n_tokens / t,
          peak_gib=peak, flash_launches=launches["flash_attention"],
          flash_per_step=launches["flash_attention"] / steps,
          slot_decode_per_step=launches["slot_decode_attention"] / steps,
          launches=launches, flops=rec["cost_analysis"]["flops"],
          bytes=rec["cost_analysis"]["bytes accessed"],
          model_flops=rf["model_flops_total"],
          mfu=rf["model_flops_total"] / t / HW["peak_flops_bf16"],
          bound_s=rf["step_time_lower_bound_s"], bound_by=rf["bottleneck"],
          time_over_bound=t / rf["step_time_lower_bound_s"],
          bound_io_s=bound_io, time_over_io_bound=t / bound_io,
          count_s=rec["run_s"])
    if not ok:
        fail(f"{label}: output out of range or not finite: {out}")
    want = {"flash_attention": flash * steps,
            "slot_decode_attention": slot * steps}
    if {k: n for k, n in launches.items() if n} != \
            {k: n for k, n in want.items() if n}:
        fail(f"{label}: launches {launches}, want {flash} flash and {slot} "
             f"slot decode launches a step over {steps} steps and no other "
             f"kernel")
    del params, run, out
    torch.cuda.empty_cache()


CELLS_CHECK_LAYERS = 2
CELLS_CHECK_LENGTHS = (32_768, 20_007)


def cells_check_phase(dev, card):
    """smollm-135m's prefill_32k step at full width, depth cut to 2
    layers, one sequence of 32,768 tokens and one of 20,007 (not a
    multiple of 64): the kernel path's first token, last logits and
    cache against ``impl="reference"``, gated in float32 as the other
    checks of full-width models (within the plain path's own
    bf16-vs-float32 deviation), the bf16 deviation printed."""
    from repro_torch.models.registry import get_api
    cfg, params, fields = init_on_card("smollm-135m", dev, card, CELL_SEED,
                                       n_layers=CELLS_CHECK_LAYERS)
    p32, c32 = _cast(params, torch.float32), cfg.replace(dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(CELL_SEED + 2)
    for L in CELLS_CHECK_LENGTHS:
        tokens = torch.randint(0, cfg.vocab, (1, L), generator=gen,
                               device=dev, dtype=torch.int32)

        def run(p, c, impl):
            logits, cache = get_api(c).prefill(c, p, {"tokens": tokens},
                                               max_len=L, impl=impl)
            return logits.float(), cache["k"].float(), cache["v"].float()

        reset_launches()
        kern = run(params, cfg, "auto")
        launches = read_launches()
        plain = run(params, cfg, "reference")
        plain32, kern32 = run(p32, c32, "reference"), run(p32, c32, "auto")
        torch.cuda.synchronize()
        if {k: n for k, n in launches.items() if n} != \
                {"flash_attention": cfg.n_layers}:
            fail(f"cells_check: launches {launches}, want {cfg.n_layers} "
                 "flash launches")
        cache_tol = max(max_err(a, b) for a, b in zip(plain[1:], plain32[1:]))
        cache_err = max(max_err(a, b) for a, b in zip(kern32[1:], plain32[1:]))
        check_logits("cells_check", kern[:1], plain[:1], plain32[:1],
                     kern32=kern32[:1], arch=cfg.name, n_layers=cfg.n_layers,
                     depth_cut_from=30, seq_len=L, launches=launches,
                     max_abs_cache_err_f32=cache_err,
                     tol_cache_bf16_vs_f32_plain=cache_tol, card=card)
        if cache_err > cache_tol:
            fail(f"cells_check L {L}: cache kernels vs plain in float32: max "
                 f"abs err {cache_err} > {cache_tol}")
        del kern, plain, plain32, kern32
    del params, p32
    torch.cuda.empty_cache()


def example_serving_phase(dev, card):
    """The port's multi_tenant_serving example as a user runs it on the
    card (full-width smollm-135m, 32 requests, sjf), launch counts set
    to 0 just before and read just after: every request completes, B4
    launched 30 x prefills, the slot decode 30 x decode iterations, no
    other kernel."""
    from repro_torch.examples import multi_tenant_serving
    reset_launches()
    eng, wall = multi_tenant_serving.main(
        ["--preset", "full", "--requests", "32", "--policy", "sjf",
         "--device", str(dev)])
    torch.cuda.synchronize()
    launches = read_launches()
    done = eng.sched.completed
    prefills = sum(r.prefill_end is not None for r in done)
    tokens = sum(r.observed_output_tokens for r in done)
    phase("example_serving", arch=eng.cfg.name, n_layers=eng.cfg.n_layers,
          card=card, completed=len(done), iterations=eng.step_count,
          prefills=prefills, tokens=tokens, wall_s=wall,
          ms_per_iteration=1e3 * wall / eng.step_count,
          tokens_per_s=tokens / wall, flash_launches=launches[
              "flash_attention"], launches=launches)
    if len(done) != 32 or prefills != 32:
        fail(f"example_serving: {len(done)} completed, {prefills} prefills")
    want = {"flash_attention": eng.cfg.n_layers * prefills,
            "slot_decode_attention":
                eng.cfg.n_layers * eng.n_decode_launches}
    if {k: n for k, n in launches.items() if n} != want:
        fail(f"example_serving: launches {launches}, want {want} only")
    del eng
    torch.cuda.empty_cache()


def example_train_phase(dev, card):
    """The port's train_lm example with ``--preset full`` (smollm-135m,
    8 x 128) for 3 steps on the card, its checkpoint written to a
    temporary directory: B4 launched 2 x 30 x 3 times, the checkpoint
    at step 3."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.examples import train_lm
    flash = 2 * get_config("smollm-135m").n_layers * 3
    with tempfile.TemporaryDirectory() as ckpt:
        reset_launches()
        t0 = time.perf_counter()
        rc = train_lm.main(["--preset", "full", "--steps", "3", "--device",
                            str(dev), "--checkpoint-dir", ckpt])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        latest = CheckpointManager(ckpt).latest_step()
    phase("example_train", card=card, exit=rc, wall_s=wall,
          checkpoint_step=latest, flash_launches=launches["flash_attention"],
          launches=launches)
    if rc != 0 or latest != 3 or launches["flash_attention"] != flash \
            or any(n for k, n in launches.items() if k != "flash_attention"):
        fail(f"example_train: exit {rc}, checkpoint at {latest}, launches "
             f"{launches} (want {flash} flash launches only)")
    torch.cuda.empty_cache()



# ---------------------------------------------------------------------------
# the sharded steps on a one-card NCCL mesh, and the mesh dry run
# ---------------------------------------------------------------------------

MESH_TRAIN_SSD = dict(arch="mamba2-2.7b", batch=2, seq=2048, steps=2,
                      lr=3e-4, n_layers=8)
MESH_SERVE = dict(arch="smollm-135m", prefill_batch=2, prefill_len=4096,
                  decode_batch=8, cache_len=4096)
DP_INT8_STEPS = 50
# float32 gates of the sharded steps against the same step unsharded on
# the same weights (the CPU test's, tests/test_torch_mesh.py): loss and
# grad norm to rtol 1e-5, params after one AdamW step at lr 1e-3 within
# 5e-5 (5% of lr), caches within atol=rtol=1e-5, tokens equal
MESH_LOSS_RTOL = 1e-5
MESH_PARAM_ATOL = 5e-5
MESH_CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
GATE_OPT = dict(lr=1e-3, warmup_steps=1)


def mesh_setup_phase(dev):
    """A one-rank NCCL process group on an in-process store and the 1x1
    (data, model) mesh on the card."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    mesh = make_mesh((1, 1), ("data", "model"))
    probe = torch.ones(4, device=dev)
    dist.all_reduce(probe, group=mesh.get_group("data"))
    torch.cuda.synchronize()
    phase("mesh_setup", backend=dist.get_backend(), world_size=1,
          mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
          device_type=mesh.device_type, seconds=time.perf_counter() - t0)
    if probe.tolist() != [1.0] * 4:
        fail(f"mesh_setup: all_reduce over one rank gave {probe.tolist()}")
    return mesh


def _leaf_err(a, b):
    from repro_torch.distributed.optimizer import tree_leaves
    return max(max_err(x.detach(), y.detach())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def mesh_train_gate(label, cfg, mesh, batch, dev, params_fn):
    """One float32 AdamW step (GATE_OPT) sharded on ``mesh`` against the
    same step unsharded, from the same params (``params_fn()``) and
    batch: relative loss and grad-norm errors and the largest param
    difference after the step, gated at MESH_LOSS_RTOL and
    MESH_PARAM_ATOL."""
    from repro_torch.distributed.optimizer import Optimizer, OptimizerConfig
    from repro_torch.launch import sharded
    from repro_torch.models.steps import make_train_step
    c32 = cfg.replace(dtype="float32")
    opt = Optimizer(OptimizerConfig(**GATE_OPT))
    step = make_train_step(c32, opt)
    ref_p = _cast(params_fn(), torch.float32)
    ref_p, _, ref_m = step(ref_p, opt.init(ref_p), batch)
    p, st, db, _ = sharded.place_train(c32, mesh,
                                       _cast(params_fn(), torch.float32),
                                       opt, batch)
    p, _, m = sharded.sharded(step, mesh)(p, st, db)
    got = {"loss": float(sharded.full(m["loss"])),
           "grad_norm": float(m["grad_norm"])}
    rel = {k: abs(got[k] / float(ref_m[k]) - 1) for k in got}
    perr = _leaf_err(sharded.full(p), ref_p)
    del ref_p, p, st
    torch.cuda.empty_cache()
    gate = dict(gated_on="float32", rel_err=rel, param_max_abs_err=perr,
                tol=dict(loss_rtol=MESH_LOSS_RTOL, param_atol=MESH_PARAM_ATOL,
                         lr=GATE_OPT["lr"]))
    if max(rel.values()) > MESH_LOSS_RTOL or perr > MESH_PARAM_ATOL:
        fail(f"{label}: sharded step off the unsharded one: {gate}")
    return gate


def mesh_train_phase(dev, card, mesh, dense_step_s):
    """Full-width smollm-135m on the 1x1 mesh: 4 AdamW steps at the
    train_dense shape (8 x 512) in train mode (params and ZeRO-1 moments
    as DTensors, sharded.place_train), B4 through ops' local_map, 60
    launches a step; the step time over train_dense's is DTensor's host
    cost on one card. Then the float32 gate (mesh_train_gate)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_dataset
    from repro_torch.launch import cell_shardings as cs
    from repro_torch.launch import sharded
    from repro_torch.launch.train import batch_on, build
    from repro_torch.models.steps import make_train_step
    spec = DENSE_TRAIN
    cfg = get_config(spec["arch"])
    ds = make_dataset("synthetic", cfg, spec["seq"], spec["batch"])
    init = lambda: build(cfg, steps=spec["steps"], lr=spec["lr"], seed=0,  # noqa: E731
                         device=dev)[:2]
    params, opt = init()
    torch.cuda.reset_peak_memory_stats()
    params, opt_state, _, policy = sharded.place_train(
        cfg, mesh, params, opt, batch_on(cfg, ds, 0,
                                         np.random.default_rng(0), dev))
    step = sharded.sharded(make_train_step(cfg, opt), mesh)
    rng = np.random.default_rng(0)
    batches = [batch_on(cfg, ds, s, rng, dev) for s in range(DENSE_TRAIN["steps"])]
    log = []
    reset_launches()
    torch.cuda.synchronize()
    for b in batches:
        t0 = time.perf_counter()
        db = cs.attach(b, cs.train_batch_shardings(mesh, b))
        params, opt_state, m = step(params, opt_state, db)
        loss = float(sharded.full(m["loss"]))
        log.append((loss, float(m["grad_norm"]), time.perf_counter() - t0))
    torch.cuda.synchronize()
    launches = read_launches()
    peak = peak_gb()
    secs = statistics.median(t for _, _, t in log[1:])
    want = 2 * cfg.n_layers * DENSE_TRAIN["steps"]
    del params, opt_state, step
    torch.cuda.empty_cache()
    gate = mesh_train_gate("mesh_train", cfg, mesh, batches[0], dev,
                           lambda: init()[0])
    phase("mesh_train", arch=cfg.name, card=card, mesh="1x1",
          n_layers=cfg.n_layers, batch=DENSE_TRAIN["batch"],
          seq=DENSE_TRAIN["seq"], param_policy=policy,
          loss=[l for l, _, _ in log], grad_norm=[g for _, g, _ in log],
          step_s=[t for _, _, t in log], median_step_s=secs,
          tokens_per_s=DENSE_TRAIN["batch"] * DENSE_TRAIN["seq"] / secs,
          peak_gib=peak, train_dense_step_s=dense_step_s,
          step_over_train_dense=secs / dense_step_s, launches=launches,
          flash_per_step=launches["flash_attention"] / DENSE_TRAIN["steps"],
          flash_launches_expected=want, **gate)
    if not all(math.isfinite(l) and math.isfinite(g) for l, g, _ in log):
        fail(f"mesh_train: a loss or grad norm is not finite: {log}")
    if launches["flash_attention"] != want or \
            any(n for k, n in launches.items() if k != "flash_attention"):
        fail(f"mesh_train: launches {launches}, want {want} flash launches")


def mesh_train_ssd_phase(dev, card, mesh):
    """Full-width mamba2-2.7b, depth cut to 8 layers (time), on the 1x1
    mesh: 2 AdamW steps at 2 x 2,048 in train mode, B5 through ops'
    local_map, 16 calls a step (forward and remat recompute); then the
    float32 gate at the same depth."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_dataset
    from repro_torch.distributed.optimizer import Optimizer, OptimizerConfig
    from repro_torch.launch import cell_shardings as cs
    from repro_torch.launch import sharded
    from repro_torch.launch.train import batch_on
    from repro_torch.models.registry import get_api
    from repro_torch.models.steps import make_train_step
    spec = MESH_TRAIN_SSD
    full = get_config(spec["arch"])
    cfg = full.replace(n_layers=spec["n_layers"])

    def init():
        return get_api(cfg).init(cfg, torch.Generator(device=dev).manual_seed(0),
                                 device=dev)

    ds = make_dataset("synthetic", cfg, spec["seq"], spec["batch"])
    rng = np.random.default_rng(0)
    batches = [batch_on(cfg, ds, s, rng, dev) for s in range(spec["steps"])]
    opt = Optimizer(OptimizerConfig(lr=spec["lr"], warmup_steps=10))
    torch.cuda.reset_peak_memory_stats()
    params, state, _, policy = sharded.place_train(cfg, mesh, init(), opt,
                                                   batches[0])
    step = sharded.sharded(make_train_step(cfg, opt), mesh)
    log = []
    reset_launches()
    torch.cuda.synchronize()
    for b in batches:
        t0 = time.perf_counter()
        params, state, m = step(params, state,
                                cs.attach(b, cs.train_batch_shardings(mesh, b)))
        log.append((float(sharded.full(m["loss"])), float(m["grad_norm"]),
                    time.perf_counter() - t0))
    torch.cuda.synchronize()
    launches = read_launches()
    peak = peak_gb()
    del params, state, step
    torch.cuda.empty_cache()
    gate = mesh_train_gate("mesh_train_ssd", cfg, mesh, batches[0], dev, init)
    want = 2 * cfg.n_layers * spec["steps"]
    phase("mesh_train_ssd", arch=cfg.name, card=card, mesh="1x1",
          n_layers=cfg.n_layers, reduced=dict(n_layers=[full.n_layers,
                                                        cfg.n_layers]),
          batch=spec["batch"], seq=spec["seq"], param_policy=policy,
          loss=[l for l, _, _ in log], grad_norm=[g for _, g, _ in log],
          step_s=[t for _, _, t in log],
          tokens_per_s=spec["batch"] * spec["seq"] / log[-1][2],
          peak_gib=peak, launches=launches,
          ssd_per_step=launches["ssd_scan"] / spec["steps"],
          ssd_launches_expected=want, **gate)
    if not all(math.isfinite(l) and math.isfinite(g) for l, g, _ in log):
        fail(f"mesh_train_ssd: a loss or grad norm is not finite: {log}")
    if launches["ssd_scan"] != want or \
            any(n for k, n in launches.items() if k != "ssd_scan"):
        fail(f"mesh_train_ssd: launches {launches}, want {want} SSD calls")


def seq_split_dispatch(dev, mesh):
    """``ops.decode_attention`` on a cache split on S on the card (K/V
    DTensors sharded on S over the model axis, h2o-danube's heads,
    float32): ``auto`` and ``cuda`` raise, since the slot kernel cannot
    reduce across ranks, and launch nothing; ``impl='reference'`` runs
    the plain DTensor ops, against the plain version on the tensors."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels import ops, paged_attention, ref
    from repro_torch.launch import sharded
    gen = torch.Generator(device=dev).manual_seed(CELL_SEED + 3)
    B, S, (H, Hk, D) = 8, 256, DANUBE_HEADS
    q, k, v = (torch.randn(*shape, generator=gen, device=dev) for shape in
               ((B, H, D), (B, S, Hk, D), (B, S, Hk, D)))
    lens = torch.tensor([0, 1, 17, 255, 256, 100, 3, 64], dtype=torch.int32,
                        device=dev)
    rep = [Replicate(), Replicate()]
    args = (distribute_tensor(q, mesh, rep),
            *(distribute_tensor(t, mesh, [Replicate(), Shard(1)])
              for t in (k, v)),
            distribute_tensor(lens, mesh, rep))
    before = paged_attention.slot_decode_launches
    raised = {}
    with sharded.on_mesh(mesh):
        for impl in ("auto", "cuda"):
            try:
                ops.decode_attention(*args, impl=impl)
            except ValueError as e:
                raised[impl] = "impl='reference'" in str(e)
        got = ops.decode_attention(*args, impl="reference").full_tensor()
    torch.cuda.synchronize()
    err = max_err(got, ref.decode_attention_ref(q, k, v, lens))
    out = dict(raised=raised, reference_err=err,
               slot_launches=paged_attention.slot_decode_launches - before)
    if (raised != {"auto": True, "cuda": True} or out["slot_launches"]
            or err > TOL[torch.float32][0]):
        fail(f"mesh_serve: a cache split on S on the card: {out}")
    return out


def mesh_serve_phase(dev, card, mesh):
    """Full-width smollm-135m's serving units on the 1x1 mesh in serve
    mode: make_prefill_step at 2 x 4,096 (B4, 30 launches) and
    make_serve_step for 8 sequences over a 4,096-token cache placed by
    cache_shardings, each timed (CUDA events, median of 3 after a
    warm-up) beside the same units unsharded; then both in float32
    against the unsharded units: tokens equal, caches within
    MESH_CACHE_TOL."""
    from repro_torch.distributed.optimizer import tree_leaves
    from repro_torch.launch import sharded
    from repro_torch.models.registry import get_api
    from repro_torch.models.steps import make_prefill_step, make_serve_step
    spec = MESH_SERVE
    cfg, params, fields = init_on_card(spec["arch"], dev, card, CELL_SEED)
    gen = torch.Generator(device=dev).manual_seed(CELL_SEED + 2)
    L = spec["prefill_len"]
    batch = {"tokens": torch.randint(0, cfg.vocab, (spec["prefill_batch"], L),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    S, B = spec["cache_len"], spec["decode_batch"]
    cache = get_api(cfg).init_cache(cfg, B, S, device=dev)
    for t in cache.values():
        if t.is_floating_point():
            t.normal_(generator=gen)
    cache["lens"].fill_(S - 1)
    tokens = torch.randint(0, cfg.vocab, (B,), generator=gen, device=dev,
                           dtype=torch.int32)
    pos = torch.tensor(S - 1, dtype=torch.int32, device=dev)

    def units(c, p, cache_in):
        prefill = make_prefill_step(c, max_len=L)
        serve = make_serve_step(c)
        dp, db, policy = sharded.place_prefill(c, mesh, p, batch)
        dparams, dcache, dtok, _ = sharded.place_decode(c, mesh, p, cache_in,
                                                        tokens)
        return (sharded.sharded(lambda: prefill(dp, db, None), mesh),
                sharded.sharded(lambda: serve(dparams, dcache, dtok, pos, None),
                                mesh), policy)

    def median_ms(run):
        run()
        torch.cuda.synchronize()
        ts = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        return statistics.median(ts)

    run_prefill, run_serve, policy = units(cfg, params, cache)
    reset_launches()
    times = {"prefill": median_ms(run_prefill), "decode": median_ms(run_serve)}
    launches = read_launches()
    # the same units unsharded: DTensor's host cost on one card
    plain_prefill, plain_serve = make_prefill_step(cfg, max_len=L), \
        make_serve_step(cfg)
    plain_cache = {k: v.clone() for k, v in cache.items()}
    unsharded = {
        "prefill": median_ms(lambda: plain_prefill(params, batch, None)),
        "decode": median_ms(lambda: plain_serve(params, plain_cache, tokens,
                                                pos, None))}
    del plain_cache
    # the float32 gate: sharded against unsharded units, same inputs
    c32, p32 = cfg.replace(dtype="float32"), _cast(params, torch.float32)
    del params
    c32_cache = {k: (v.float() if v.is_floating_point() else v).clone()
                 for k, v in cache.items()}
    sp, ss, _ = units(c32, p32, {k: v.clone() for k, v in c32_cache.items()})
    tok_s, cache_s = sp()
    ntok_s, ncache_s = ss()
    tok_u, cache_u = make_prefill_step(c32, max_len=L)(p32, batch, None)
    ntok_u, ncache_u = make_serve_step(c32)(p32, c32_cache, tokens, pos, None)
    cache_s, ncache_s = sharded.full(cache_s), sharded.full(ncache_s)
    errs = {"prefill_cache": max(max_err(a, b) for a, b in
                                 zip(tree_leaves(cache_s),
                                     tree_leaves(cache_u))),
            "decode_cache": max(max_err(a, b) for a, b in
                                zip(tree_leaves(ncache_s),
                                    tree_leaves(ncache_u)))}
    same = {"prefill_tokens": bool(torch.equal(sharded.full(tok_s), tok_u)),
            "decode_tokens": bool(torch.equal(sharded.full(ntok_s), ntok_u))}
    close = all(torch.allclose(a.double(), b.double(), **MESH_CACHE_TOL)
                for x, y in ((cache_s, cache_u), (ncache_s, ncache_u))
                for a, b in zip(tree_leaves(x), tree_leaves(y)))
    phase("mesh_serve", arch=cfg.name, mesh="1x1", param_policy=policy,
          **fields, prefill_batch=spec["prefill_batch"], prefill_len=L,
          decode_batch=B, cache_len=S, prefill_ms=times["prefill"],
          decode_ms=times["decode"], unsharded_ms=unsharded,
          over_unsharded={k: times[k] / unsharded[k] for k in times},
          prefill_tokens_per_s=spec["prefill_batch"] * L / times["prefill"] * 1e3,
          decode_tokens_per_s=B / times["decode"] * 1e3,
          launches=launches,
          flash_per_prefill=launches["flash_attention"] / 4,
          gated_on="float32", tokens_equal=same, max_abs_err=errs,
          tol=MESH_CACHE_TOL, seq_split=seq_split_dispatch(dev, mesh),
          peak_gib=peak_gb())
    want = {"flash_attention": 4 * cfg.n_layers,
            "slot_decode_attention": 4 * cfg.n_layers}
    if {k: n for k, n in launches.items() if n} != want:
        fail(f"mesh_serve: launches {launches}, want {cfg.n_layers} flash "
             f"launches a prefill and {cfg.n_layers} slot decode launches "
             f"a decode step, over 4 of each")
    if not all(same.values()) or not close:
        fail(f"mesh_serve: sharded units off the unsharded ones: {same} "
             f"{errs}")
    del p32, cache, c32_cache
    torch.cuda.empty_cache()


def mesh_dp_int8_phase(dev, card, mesh):
    """make_compressed_dp_grad_fn over NCCL (the 1x1 mesh's data group)
    on full-width smollm-135m's whole gradient tree (2 x 128 tokens):
    ms a step (gradients plus the compressed all-reduce) and of the
    compressed all-reduce alone, and the bytes the algorithm puts on the
    wire a step (int8 values plus one float32 scale a leaf). Gate
    (float32): JAX's unbiasedness bound -- over DP_INT8_STEPS steps of
    the same gradient with the error carried, the summed reduced
    gradients are within 1% (relative to the largest entry) of
    DP_INT8_STEPS times the gradient, for every leaf."""
    from repro_torch.distributed.optimizer import (
        compressed_psum, make_compressed_dp_grad_fn, tree_leaves, tree_map)
    from repro_torch.models.steps import grads_of, loss_fn
    cfg, params, fields = init_on_card("smollm-135m", dev, card, CELL_SEED)
    gen = torch.Generator(device=dev).manual_seed(CELL_SEED + 3)
    toks = torch.randint(0, cfg.vocab, (2, 129), generator=gen, device=dev,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    group = mesh.get_group("data")
    lossf = lambda p, b: loss_fn(cfg, p, b)[0]  # noqa: E731
    grad_fn = make_compressed_dp_grad_fn(lossf, group)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    g = grads_of(lossf(params, batch), params)
    g32 = [t.detach().float() for t in tree_leaves(g)]
    err = [torch.zeros_like(t) for t in g32]
    total = [torch.zeros_like(t) for t in g32]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DP_INT8_STEPS):
        for i, a in enumerate(g32):
            red, err[i] = compressed_psum(a, err[i], group)
            total[i].add_(red)
    torch.cuda.synchronize()
    psum_ms = 1e3 * (time.perf_counter() - t0) / DP_INT8_STEPS
    rel = max(float((t - DP_INT8_STEPS * a).abs().max()
                    / (DP_INT8_STEPS * a).abs().max().clamp_min(1e-30))
              for t, a in zip(total, g32))
    # the grad fn itself: gradients and the compressed all-reduce a step
    e2 = tree_map(lambda t: torch.zeros_like(t, dtype=torch.float32), g)
    grad_fn(params, batch, e2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        _, e2 = grad_fn(params, batch, e2)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / 3
    leaves = g32
    wire = sum(t.numel() + 4 for t in leaves)
    phase("mesh_dp_int8", arch=cfg.name, mesh="1x1", group="data", **fields,
          steps=DP_INT8_STEPS, leaves=len(leaves),
          grad_elems=sum(t.numel() for t in leaves),
          wire_bytes_per_step=wire,
          float32_bytes_per_step=4 * sum(t.numel() for t in leaves),
          psum_ms_per_step=psum_ms, grad_fn_ms_per_step=step_ms,
          gated_on="float32", rel_err_after_steps=rel, tol=0.01)
    if not rel < 0.01:
        fail(f"mesh_dp_int8: relative error {rel} after {DP_INT8_STEPS} "
             "steps, want < 0.01")
    del params, g, g32, err, total, e2
    torch.cuda.empty_cache()


# One cell of each family on 16x16: both meshes' full sweep takes 21
# minutes of one CPU core (PERF.md), so chip_smoke runs one cell
# a family, covering the three step kinds and the param policies, and
# PERF.md records the full sweep from the CLI
MESH_CELLS = (("smollm-135m", "train_4k"), ("grok-1-314b", "decode_32k"),
              ("paligemma-3b", "prefill_32k"),
              ("whisper-large-v3", "train_4k"),
              ("mamba2-2.7b", "long_500k"), ("zamba2-1.2b", "train_4k"))


def start_dryrun_mesh(out_dir):
    """The mesh half of the dry run on 16x16 for MESH_CELLS (the dry
    run's ``run_cell(..., multi_pod=False)``, as ``python -m
    repro_torch.launch.dryrun --mesh single`` runs it), on meta DTensors
    over a fake process group of 256 ranks, in a process of its own
    beside the card's phases; ``dryrun_mesh_phase`` reads its
    records."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    code = ("import sys\n"
            "from repro_torch.launch.dryrun import run_cell, status_line\n"
            f"for arch, shape in {MESH_CELLS!r}:\n"
            f"    rec = run_cell(arch, shape, out_dir={out_dir!r}, force=True,"
            " multi_pod=False)\n"
            "    print(status_line(rec), flush=True)\n")
    return subprocess.Popen(
        [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def dryrun_mesh_phase(proc, out_dir, card_dir, t_start):
    """One line per cell of the 16x16 dry run: per-device FLOPs, bytes,
    collective bytes by kind and the bound. Gate against the unsharded
    count: each ok cell's per-device FLOPs times its 256 devices are at
    least the one-card count of the same cell (the ``dryrun`` records:
    sharding may replicate work, never drop it). Fails on a cell in
    error or missing."""
    log, _ = proc.communicate(timeout=900)
    wall = time.perf_counter() - t_start
    recs = [json.loads(p.read_text())
            for p in sorted(Path(out_dir).glob("*.json"))]
    card = {(r["arch"], r["shape"]): r for r in
            (json.loads(p.read_text()) for p in Path(card_dir).glob("*.json"))
            if r["status"] == "ok"}
    status, short = {}, []
    for r in recs:
        status[r["status"]] = status.get(r["status"], 0) + 1
        if r["status"] != "ok":
            phase("dryrun_mesh", arch=r["arch"], shape=r["shape"],
                  status=r["status"], reason=r.get("reason", r.get("error")))
            continue
        rf = r["roofline"]
        one = card.get((r["arch"], r["shape"]))
        total = r["cost_analysis"]["flops"] * r["n_chips"]
        if one is None or total < one["cost_analysis"]["flops"]:
            short.append((r["arch"], r["shape"]))
        phase("dryrun_mesh", arch=r["arch"], shape=r["shape"], status="ok",
              mesh=r["mesh"], n_chips=r["n_chips"],
              param_policy=r["param_policy"],
              flops_per_dev=r["cost_analysis"]["flops"],
              bytes_per_dev=r["cost_analysis"]["bytes accessed"],
              flops_all_devs_over_one_card=(
                  total / one["cost_analysis"]["flops"] if one else None),
              collective_bytes=r["collective_bytes"],
              collective_ops=r["collective_ops"],
              bound_s=rf["step_time_lower_bound_s"],
              bottleneck=rf["bottleneck"], count_s=r["run_s"])
    phase("dryrun_mesh", cells=len(recs), status=status,
          seconds_from_start=wall)
    if proc.returncode != 0 or status.get("ok") != len(MESH_CELLS) or short:
        fail(f"dryrun_mesh: exit {proc.returncode}, {status} of {len(recs)} "
             f"records, want {want} ok; below the one-card count: {short}:\n"
             f"{log[-3000:]}")


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

    import torch.distributed as dist
    t_start = time.perf_counter()
    procs = []
    with tempfile.TemporaryDirectory(prefix="dryrun_") as dry_dir, \
            tempfile.TemporaryDirectory(prefix="dryrun_mesh_") as mesh_dir:
        procs.append(start_dryrun(dry_dir))
        try:
            return run_phases(procs, dry_dir, mesh_dir, t_start)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            if dist.is_initialized():
                dist.destroy_process_group()


def run_phases(procs, dry_dir, dry_mesh_dir, t_start) -> int:
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, card = device_phase()
    build_phase()
    kernel_check_phase(dev)
    rows = kernel_times_phase(dev)
    cfg, params, eng, paged_launches = engine_phase(dev)
    engine_profile_phase(cfg, params, dev, "engine_profile", PAGED_ENGINE,
                         shared_prefix_tokens=64)
    engine_check_phase(cfg, params, eng.pool, eng.alloc.pages_per_seq, dev,
                       gate="both")
    del eng
    slot_launches = engine_slot_phase(cfg, params, dev)
    engine_profile_phase(cfg, params, dev, "engine_slot_profile", SLOT_ENGINE)
    engine_slot_check_phase(cfg, params, dev)
    drv = cluster_pd_phase(cfg, params, dev)
    cluster_pd_check_phase(cfg, params, drv, dev)
    del params, drv
    torch.cuda.empty_cache()
    engine_minitron_phases(dev, card)
    engine_mamba2_phases(dev, card)
    engine_mamba2_check_phase(dev, card)
    engine_zamba2_phases(dev, card)
    engine_whisper_phases(dev, card)
    engine_paligemma_phases(dev, card)
    engine_grok_phases(dev, card)
    engine_llama4_phases(dev, card)
    # the mesh dry run starts after the host-bound engine phases
    procs.append(start_dryrun_mesh(dry_mesh_dir))

    train_cfg, setup = train_phase(dev)
    train_launches = read_launches()
    train_profile_phase(train_cfg, setup, dev)
    del setup
    torch.cuda.empty_cache()
    train_check_phase(dev, "train_check", TRAIN, {
        "w_x": ("layers", "ssm", "w_x"),
        "out_proj": ("layers", "ssm", "out_proj"),
        "A_log": ("layers", "ssm", "A_log"), "embed": ("embed", "table")},
        "ssd_scan", n_layers=TRAIN_CHECK_LAYERS, reorder={"ssm_chunk": 128},
        gate="both")
    torch.cuda.empty_cache()
    dense_step_s = train_dense_phase(dev)
    torch.cuda.empty_cache()
    train_check_phase(dev, "train_dense_check", DENSE_TRAIN, {
        "wq": ("layers", "attn", "wq"), "wk": ("layers", "attn", "wk"),
        "wv": ("layers", "attn", "wv"), "embed": ("embed", "table")},
        "flash_attention", gate="float32")
    torch.cuda.empty_cache()
    train_whisper_phase(dev, card)
    torch.cuda.empty_cache()
    for arch, shape, batch in CELLS:
        cell_phase(dev, card, arch, shape, batch)
    cells_check_phase(dev, card)
    example_serving_phase(dev, card)
    example_train_phase(dev, card)
    mesh = mesh_setup_phase(dev)
    mesh_train_phase(dev, card, mesh, dense_step_s)
    mesh_train_ssd_phase(dev, card, mesh)
    mesh_serve_phase(dev, card, mesh)
    mesh_dp_int8_phase(dev, card, mesh)
    dryrun_phase(procs[0], dry_dir, t_start)
    dryrun_mesh_phase(procs[1], dry_mesh_dir, dry_dir, t_start)
    phase("total", seconds=time.perf_counter() - t_start, card=card)

    # each kernel's launches on the run whose path it is on: the engines'
    # for the attention kernels (the per-sequence paged decode is on no
    # engine path: 0 in both), the mamba2 trainer's for the SSD scan
    on_path = {"batched_paged_decode_attention": paged_launches,
               "chunked_prefill_attention": paged_launches,
               "paged_decode_attention": paged_launches,
               "flash_attention": slot_launches,
               "ssd_scan": train_launches,
               "slot_decode_attention": slot_launches}
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
