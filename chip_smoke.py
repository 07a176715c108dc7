#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one
NVIDIA card: builds its CUDA kernels from the sources in this checkout,
holds each against its plain PyTorch version, serves requests through
``DecodeEngine`` at the full width of llama3-8b (without a mesh, and on
a one-device tensor-parallel mesh whose steps are single mixed
launches), and trains bench.py's default configuration (llama3-8b layer
width, 2 layers) through ``TrainStep``.

    python3 chip_smoke.py            # on a machine with a CUDA card
    python3 chip_smoke.py --cpu      # rehearsal: debug and tiny
                                     # presets, plain versions, no
                                     # kernel, no result
    python3 chip_smoke.py --profile  # also torch.profiler splits of a
                                     # decode step, a mixed step and a
                                     # train step

Phases, each printed as it ends:
  1. the card's name and power limit; every kernel built (one nvcc per
     source, the five sources at once: paged_decode, paged_decode_int8,
     mixed_paged, flash_fwd, flash_bwd), with the build seconds and
     ptxas's register and spill counts (none allowed in a tensor-core,
     mixed or paged-decode kernel); TF32 off for every fp32 product;
  2. each kernel against its plain version at the shapes the main path
     gives it: max-abs error, and its time beside the plain version's,
     one PyTorch library call's and the card's bound for the same work
     (paged_decode in bf16, fp16 and fp32 at bs 16, paged_decode_int8
     with bf16 and fp32 queries at bs 16 and 32, rows of 1, 1999, 512
     and 0 keys, a poisoned NULL page, each timed by CUDA events and
     device-only under torch.profiler and required to beat its plain
     version; both also at hd=64, G=8, bs=32 with rows on and just past
     64-key split boundaries; bf16/fp16 row by row, two launches and NaN
     in the NULL page (int8: in its scales) bit-identical, the split
     size and workspace bytes printed; mixed_paged in
     bf16, fp16 and fp32 at T=128 with rows (q_len, kv_len) of (128,
     1536), (1, 1999), (5, 512) and (0, 0), at a decode-only T=16 shape,
     and at hd=64, G=8, bs=32 with windows across split boundaries, the
     NULL page poisoned with 1e3 and then with NaN: each launch's route,
     two launches bit-identical, bf16/fp16 row by row, the workspace's
     bytes);
  3. a small input served on the card and on the CPU with the same
     weights: identical greedy tokens;
  4. fp KV serving: llama3-8b (32 layers, bf16, random weights from
     --seed) behind DecodeEngine(capacity=4, block_size=16) serves 7
     requests of 32-512 prompt tokens and 16 new tokens each, two of
     them sharing a 3-page prompt prefix. Launch counts are zeroed just
     before and read just after; the paged-decode kernel must have
     launched once per layer and decode step. The first decode step is
     replayed with the kernel and with the plain attention;
  5. int8 KV with chunked prefill on the same model:
     DecodeEngine(s_max=1600, kv_dtype="int8", chunked_prefill=True,
     prefill_chunk=128) serves 8 requests of 64-1536 prompt tokens fed
     in by 128-token chunks beside the running decodes. Counts zeroed
     just before and read just after: the int8 kernel launched once per
     layer and decode step, the fp kernel never. One decode step of a
     1536-token row is replayed with every layer's kernel output held
     against the plain int8 version, and kernel and plain argmaxes held
     equal where the top-2 margin exceeds the step's largest logit
     difference;
  6. speculative decoding on the same model (int8 KV, chunked prefill):
     4 requests of repeating prompts, 32 new tokens each; verify steps
     are prefills, so no paged-decode kernel launches;
  7. the FlashAttention-2 kernels (flash_fwd, flash_dq, flash_dkv)
     against their plain versions at B=2, S=2048, H=32, Hkv=8, D=128,
     causal and not, and at a ragged S=1000, in bf16 and fp32, in fp16
     at S=2048 and 1000 causal, and at D=16, 32 and 64 (B=1, S=300, H=8,
     Hkv=2) in bf16 and fp16: out and lse, then dq, dk and dv, and the
     route each launch took (tensor cores for bf16/fp16, CUDA cores for
     fp32); two bf16 dQ and two bf16 dK/dV launches bit-identical;
     at S=2048 causal each kernel's time beside its bound, its plain
     version and PyTorch's SDPA (forward, backward, both), per type;
  8. the tiny preset in fp32 on the card and on the CPU from the same
     weights and batches: the first gradients, then 3 AdamW steps'
     losses and parameters, within stated tolerances;
  9. bench.py's train step: llama3-8b layer width, 2 layers, vocab
     32000, bf16 with fp32 master weights (AdamW, lr 1e-4), recompute
     "core_attn", batch 6 x 2048 of bench.py's batches; the first loss
     through the kernels against the plain attention's, then 1 warm-up
     and 10 timed steps with the counts zeroed just before: tokens/s,
     MFU by bench.py's formula, peak memory, a falling loss, and each
     FA2 kernel launched once per layer and step (the forward twice:
     "core_attn" recomputes it), all on the tensor-core route;
 10. (run after phase 6) the tensor-parallel mesh engine at llama3-8b
     on phase 4's model:
     DecodeEngine(capacity=4, s_max=1600, block_size=16,
     mesh=make_tp_mesh(1), chunked_prefill=True, prefill_chunk=128,
     spec_decode=True) serves phase 5's 8 requests and 2 of repeating
     prompts, 16 new tokens each; every step is one mixed step. Counts
     zeroed just before and read just after: mixed_paged launched once
     per layer and mixed step, all on the tensor-core route,
     paged_decode never. Decode tokens/s, the
     median mixed-step wall at T=16 and T=128, device calls, peak
     memory; one mixed step holding a 128-token chunk beside decode
     lanes is replayed with the kernel and the plain attention (bf16:
     every layer's attention within tolerance, the engine's tokens
     reproduced, argmax flips counted and held where the top-2 margin
     exceeds the step's largest logit difference; fp32: every layer
     within 2e-5, equal argmaxes at every valid slot); with --profile
     the replayed
     step's device time is split into the mixed kernel, GEMMs and rest;
 10a. the tiny preset in fp32 behind the mesh engine (chunked prefill,
     speculative decoding): identical tokens and counters on the card
     at tp=1, on the card at tp=2 (two ranks on one device: the kernel
     on kv-head shards) and on the CPU at tp=2, and identical tokens
     without a mesh.
Then one JSON line of per-kernel numbers, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA card the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12          # HBM3, SXM data sheet
H100_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}   # dense tensor core / fp32 CUDA core


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def say(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, flush=None):
    """Median milliseconds of ``fn`` by CUDA events, each run after
    ``flush`` (which overwrites the L2 cache) so inputs come cold from
    device memory, as they do for a decode step."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, kernel, iters=20, flush=None):
    """Device-only time of ``fn``: ``iters`` more runs, each after
    ``flush``, under torch.profiler (apart from the event-timed runs,
    whose host wall the profiler would stretch). Each kernel whose name
    holds ``kernel`` gives its device time per launch (its sum over its
    launch count, which is robust to records the profiler drops); a run
    launches each once. Returns (their sum in ms, {kernel: ms a launch},
    launches seen a run)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    by_kernel = {}
    seen = 0
    for e in device_kernels(prof)[0]:
        if kernel in e.key and e.count:
            short = re.search(r"(\w+_kernel)", e.key)
            by_kernel[short.group(1) if short else e.key[:60]] = \
                e.self_device_time_total / e.count / 1e3
            seen += e.count
    return sum(by_kernel.values()), by_kernel, seen / iters


# -- phase 2: paged decode kernel against its plain version ------------------

PAGED_LENS = (1, 1999, 512, 0)
# Correctness only, at other widths the kernels take (PAGED_WIDE): rows
# that end on a split boundary (256 keys = 4 splits of 64), one key past
# one (321), one past the first (65), and an idle row
PAGED_WIDE = dict(G=8, hd=64, bs=32)
PAGED_WIDE_LENS = (256, 321, 65, 0)
# bf16/fp16 outputs are also held row by row: each (row, kv head, head)
# vector's largest error over its largest |plain| value. The output is
# fp32 and not rounded; the kernel widens the same 16-bit inputs exactly
# and differs from the plain version only in the order of its fp32 sums
# (64-key splits, then their merge) and in expf: about 1e-6 of a row.
# The limit, 2^-12, leaves room for a long row's cancellation; a wrong
# key, page or split moves a row by a large part of itself.
PAGED_ROW_TOL = 2**-12
PAGED_ROW_TOL_WHY = ("bf16/fp16: a (row, kv head, head) vector's largest "
                     "error over its largest |plain|; fp32 output, fp32 "
                     "sums by 64-key splits and their merge: 2^-12")


def paged_case(dtype, device, seed, lens=PAGED_LENS, kvh=8, G=4, hd=128,
               bs=16):
    """llama3-8b decode shapes unless told otherwise: B=4, kvh=8, G=4,
    hd=128, bs=16; rows of length 1, 1999, 512 (a multiple of bs) and 0
    (an all-NULL table), pages scattered over the pool."""
    B = len(lens)
    lens = np.asarray(lens, np.int32)
    mb = -(-int(lens.max()) // bs)
    n_pages = 1 + sum(-(-int(n) // bs) for n in lens) + 64
    rng = np.random.RandomState(seed)
    free = list(rng.permutation(np.arange(1, n_pages)))
    table = np.zeros((B, mb), np.int32)
    for b in range(B):
        for j in range(-(-int(lens[b]) // bs)):
            table[b, j] = free.pop()
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, kvh, G, hd), generator=g, device=device).to(dtype)
    kp = torch.randn((n_pages, bs, kvh, hd), generator=g,
                     device=device).to(dtype)
    vp = torch.randn((n_pages, bs, kvh, hd), generator=g,
                     device=device).to(dtype)
    kp[0] = 1e3                     # NULL page: never read within a length
    vp[0] = -1e3
    return (q, kp, vp, torch.as_tensor(table, device=device),
            torch.as_tensor(lens, device=device))


def paged_bound_ms(q, kp, table, lens):
    """Least time for the work this input needs: K and V of each row's
    valid keys read once, q, table and lengths read, out written."""
    B, kvh, G, hd = q.shape
    n = int(lens.sum())
    elt = q.element_size()
    nbytes = (2 * n * kvh * hd * elt + q.numel() * elt
              + q.numel() * 4 + table.numel() * 4 + lens.numel() * 4)
    flops = 4 * n * kvh * G * hd
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / H100_FLOPS[q.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def sdpa_yardstick(q, kp, vp, table, lens):
    """One PyTorch library call for the same function: gather the
    pages, then scaled_dot_product_attention with a key mask. Timed
    only; the port never calls it."""
    B, kvh, G, hd = q.shape
    mb, bs = table.shape[1], kp.shape[1]
    idx = table.reshape(-1).long()
    ck = kp[idx].reshape(B, mb * bs, kvh, hd).transpose(1, 2)
    cv = vp[idx].reshape(B, mb * bs, kvh, hd).transpose(1, 2)
    mask = (torch.arange(mb * bs, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    out = torch.nn.functional.scaled_dot_product_attention(
        q.reshape(B, kvh * G, 1, hd), ck, cv, attn_mask=mask,
        enable_gqa=True)
    return out.reshape(B, kvh, G, hd)


def check_paged_output(got, want, case, tol, row_tol):
    """The checks every paged-decode output passes: fp32 of q's shape,
    finite, exact zeros in the length-0 row 3, max-abs within ``tol``
    and, for 16-bit q (``row_tol``), each (row, kv head, head) vector
    within ``row_tol`` of its largest |plain|. Returns (max-abs,
    row-relative error or None)."""
    check(got.dtype == torch.float32 and got.shape == want.shape,
          f"{case}: output is fp32 of q's shape")
    check(bool(torch.isfinite(got).all()), f"{case}: output is finite")
    check(bool((got[3] == 0).all()), f"{case}: length-0 row gives zeros")
    err = float((got - want).abs().max())
    row_err = row_rel_err(got, want, False) if row_tol else None
    say("kernel", case=case, max_abs_err=err, tol=tol,
        row_rel_err=row_err, row_tol=row_tol,
        max_abs_out=float(want.abs().max()))
    check(err <= tol, f"{case} max-abs {err} <= {tol}")
    if row_tol:
        check(row_err <= row_tol, f"{case} row-relative {row_err} <= "
                                  f"{row_tol}")
    return err, row_err


def check_paged_bits(launch, got, poisoned, case):
    """On the card: a second launch, and a launch with NaN in the NULL
    page (``poisoned`` runs it), give the same bits as ``got``."""
    same_twice = bool(torch.equal(launch(), got))
    same_nan = bool(torch.equal(poisoned(), got))
    say("kernel", case=case, two_launches_bit_identical=same_twice,
        nan_null_page_identical=same_nan)
    check(same_twice, f"{case}: two launches give the same bits")
    check(same_nan, f"{case}: NaN in the NULL page changes no output bit")


def time_paged(launch, plain, library, want, bound, flush, case):
    """Event-timed ms of the kernel, its device-only ms (torch.profiler
    over 20 more flushed runs), the plain version's and the library
    route's ms; the kernel must beat its plain version. Returns the
    kernel's line for the JSON record."""
    ms = cuda_ms(launch, flush=flush)
    dev_ms, by_kernel, seen = device_ms(launch, "paged_decode", flush=flush)
    plain_ms = cuda_ms(plain, flush=flush)
    lib_ms = cuda_ms(library, flush=flush)
    lib_err = float((library()[:3].float() - want[:3]).abs().max())
    bound_ms, bound_by = bound
    say("kernel", case=case, ms=ms, device_ms=dev_ms,
        device_ms_by_kernel=json.dumps(by_kernel).replace(" ", ""),
        profiled_launches_per_call=seen, plain_ms=plain_ms,
        library_ms=lib_ms, library_max_abs_err=lib_err, bound_ms=bound_ms,
        bound_by=bound_by, share_of_bound=bound_ms / ms,
        device_share_of_bound=bound_ms / dev_ms)
    check(bool(by_kernel), f"{case}: the profiler saw the kernel")
    check(ms < plain_ms, f"{case}: {ms} ms faster than its plain "
                         f"version's {plain_ms} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)


def phase_kernels(on_card, seed):
    """paged_decode against paged_attn_reference in bf16, fp16 and fp32
    at llama3-8b decode shapes (timed beside its bound, its plain
    version and gather + SDPA) and at PAGED_WIDE (checked only): the
    whole-tensor tolerances, bf16/fp16 row by row (PAGED_ROW_TOL), and
    on the card two launches and a NaN NULL page bit-identical."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    device = "cuda" if on_card else "cpu"
    out = {}
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=device) \
        if on_card else None
    flush = (lambda: flush_buf.zero_()) if on_card else None
    say("kernel", name="paged_decode", split_keys=pa.DECODE_SPLIT_KEYS,
        row_tolerance=repr(PAGED_ROW_TOL_WHY))
    for lens, widths in ((PAGED_LENS, {}), (PAGED_WIDE_LENS, PAGED_WIDE)):
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float16, 2e-2),
                           (torch.float32, 1e-4)):
            args = paged_case(dtype, device, seed, lens, **widths)
            got = pa.paged_decode_attention(*args)
            want = pa.paged_attn_reference(*args)
            if on_card:
                torch.cuda.synchronize()
            B, kvh, G, hd = args[0].shape
            bs, mb = args[1].shape[1], args[3].shape[1]
            name = str(dtype).replace("torch.", "")
            case = (f"paged_decode/{name}/hd{hd}/G{G}/bs{bs}/rows"
                    f"{'-'.join(map(str, lens))}")
            say("kernel", case=case, splits=pa.decode_splits(mb, bs),
                workspace_bytes=4 * pa.decode_workspace_floats(
                    B, kvh, G, hd, mb, bs))
            err, _ = check_paged_output(
                got, want, case, tol,
                PAGED_ROW_TOL if dtype != torch.float32 else None)
            if not on_card:
                continue            # the plain version multiplies 0 x NaN
            kp_nan, vp_nan = args[1].clone(), args[2].clone()
            kp_nan[0], vp_nan[0] = float("nan"), float("nan")
            check_paged_bits(
                lambda: pa.paged_decode_attention(*args), got,
                lambda: pa.paged_decode_attention(args[0], kp_nan, vp_nan,
                                                  *args[3:]), case)
            del kp_nan, vp_nan
            if widths:
                continue            # correctness only
            out[name] = dict(max_abs_err=err, **time_paged(
                lambda: pa.paged_decode_attention(*args),
                lambda: pa.paged_attn_reference(*args),
                lambda: sdpa_yardstick(*args), want,
                paged_bound_ms(args[0], args[1], args[3], args[4]), flush,
                case))
    return out


# -- phase 2: int8 paged decode kernel against its plain version -------------

INT8_TOL = 1e-4     # f32 output of order 1: summation order and expf


def paged_int8_case(dtype, device, seed, bs, lens=PAGED_LENS, kvh=8, G=4,
                    hd=128):
    """The int8 kernel at llama3-8b decode shapes unless told otherwise:
    B=4, kvh=8, G=4, hd=128; rows of 1, 1999, 512 and 0 keys over
    scattered pages; codes in [-127, 127] and positive per-(page, head)
    scales near amax/127 of unit values. Page 0, the NULL page, holds
    +-127 codes at scale 1e3: a read of it within a row's length would
    show."""
    B = len(lens)
    lens = np.asarray(lens, np.int32)
    mb = -(-int(lens.max()) // bs)
    n_pages = 1 + sum(-(-int(n) // bs) for n in lens) + 64
    rng = np.random.RandomState(seed)
    free = list(rng.permutation(np.arange(1, n_pages)))
    table = np.zeros((B, mb), np.int32)
    for b in range(B):
        for j in range(-(-int(lens[b]) // bs)):
            table[b, j] = free.pop()
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, kvh, G, hd), generator=g, device=device).to(dtype)
    kp, vp = (torch.randint(-127, 128, (n_pages, bs, kvh, hd), generator=g,
                            device=device, dtype=torch.int8)
              for _ in range(2))
    ks, vs = ((torch.rand((n_pages, kvh), generator=g, device=device)
               + 0.5) * (3.0 / 127) for _ in range(2))
    kp[0], vp[0] = 127, -127
    ks[0], vs[0] = 1e3, 1e3
    return (q, kp, vp, torch.as_tensor(table, device=device),
            torch.as_tensor(lens, device=device)), (ks, vs)


def paged_int8_bound_ms(q, table, lens, bs):
    """Least time for the work: the valid keys' and values' codes read
    once, their pages' two scales, q, table and lengths read, out
    written; 4 flops per (key, query head, dim) at q's type's rate."""
    B, kvh, G, hd = q.shape
    n = int(lens.sum())
    pages = sum(-(-int(x) // bs) for x in lens.tolist())
    elt = q.element_size()
    nbytes = (2 * n * kvh * hd + 2 * pages * kvh * 4 + q.numel() * elt
              + q.numel() * 4 + table.numel() * 4 + lens.numel() * 4)
    flops = 4 * n * kvh * G * hd
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / H100_FLOPS[q.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def sdpa_int8_yardstick(q, kp, vp, table, lens, kv_scales):
    """The library route for the same function: gather and dequantize
    the pages, then scaled_dot_product_attention with a key mask in q's
    type. Timed only; the port never calls it."""
    from paddle_tpu_torch.kernels.paged_attention import gather_pages_dequant
    B, kvh, G, hd = q.shape
    ck = gather_pages_dequant(kp, table, kv_scales[0]).to(q.dtype)
    cv = gather_pages_dequant(vp, table, kv_scales[1]).to(q.dtype)
    mask = (torch.arange(ck.shape[1], device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    out = torch.nn.functional.scaled_dot_product_attention(
        q.reshape(B, kvh * G, 1, hd), ck.transpose(1, 2),
        cv.transpose(1, 2), attn_mask=mask, enable_gqa=True)
    return out.reshape(B, kvh, G, hd)


def phase_kernels_int8(on_card, seed):
    """paged_decode_int8 against paged_attn_reference_int8 with bf16 and
    fp32 queries at bs 16 and 32 (timed) and at PAGED_WIDE (checked
    only): INT8_TOL, bf16 row by row (PAGED_ROW_TOL), and on the card
    two launches and NaN scales of the NULL page bit-identical."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    device = "cuda" if on_card else "cpu"
    out = {}
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=device) \
        if on_card else None
    flush = (lambda: flush_buf.zero_()) if on_card else None
    cases = [(bs, PAGED_LENS, {}) for bs in (16, 32)]
    cases.append((PAGED_WIDE["bs"], PAGED_WIDE_LENS,
                  dict(G=PAGED_WIDE["G"], hd=PAGED_WIDE["hd"])))
    for bs, lens, widths in cases:
        for dtype in (torch.bfloat16, torch.float32):
            args, kv = paged_int8_case(dtype, device, seed, bs, lens,
                                       **widths)
            got = pa.paged_decode_attention(*args, kv_scales=kv)
            want = pa.paged_attn_reference_int8(*args, kv)
            if on_card:
                torch.cuda.synchronize()
            B, kvh, G, hd = args[0].shape
            mb = args[3].shape[1]
            name = str(dtype).replace("torch.", "")
            case = (f"paged_decode_int8/{name}/hd{hd}/G{G}/bs{bs}/rows"
                    f"{'-'.join(map(str, lens))}")
            say("kernel", case=case, splits=pa.decode_splits(mb, bs),
                workspace_bytes=4 * pa.decode_workspace_floats(
                    B, kvh, G, hd, mb, bs))
            err, _ = check_paged_output(
                got, want, case, INT8_TOL,
                PAGED_ROW_TOL if dtype != torch.float32 else None)
            if not on_card:
                continue
            ks_nan, vs_nan = kv[0].clone(), kv[1].clone()
            ks_nan[0], vs_nan[0] = float("nan"), float("nan")
            check_paged_bits(
                lambda: pa.paged_decode_attention(*args, kv_scales=kv), got,
                lambda: pa.paged_decode_attention(
                    *args, kv_scales=(ks_nan, vs_nan)), case)
            if widths:
                continue            # correctness only
            out[(name, bs)] = dict(max_abs_err=err, **time_paged(
                lambda: pa.paged_decode_attention(*args, kv_scales=kv),
                lambda: pa.paged_attn_reference_int8(*args, kv),
                lambda: sdpa_int8_yardstick(*args, kv), want,
                paged_int8_bound_ms(args[0], args[3], args[4], bs), flush,
                case))
    return out


# -- phase 2: mixed prefill-chunk + decode kernel against its plain version ---

MIXED_TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-2,
             torch.float32: 2e-5}
MIXED_TOL_WHY = ("max-abs error over the valid query slots; fp32: the "
                 "kernel multiplies by 1/sqrt(hd) where the plain version "
                 "divides, and sums in other orders (the reference's own "
                 "2e-5); bf16/fp16: times max(1, largest |value|), the "
                 "same arithmetic on 16-bit inputs")
# bf16 and fp16 are also held row by row: each valid query row's largest
# error over that row's largest |plain| value. The output is fp32 and
# not rounded. Q.K^T is exact products summed in fp32 in another order;
# P enters P.V as P_hi + P_lo in the input type, within 2^-16 of P
# (fp16: 2^-22, after scaling by 2^14); exp is ex2 with the scale folded
# in, a few ulps. Each of those is at most 2^-16 of a weight, and the
# weighted values of a row that averages 2000 keys cancel to about a
# tenth of their sum, which amplifies a relative error tenfold. The
# limit, 2^-12, leaves room for that; a wrong key, tile or split moves a
# row by a large part of itself.
MIXED_ROW_TOL = {torch.bfloat16: 2**-12, torch.float16: 2**-12}
MIXED_ROW_TOL_WHY = ("bf16/fp16: a valid query row's largest error over "
                     "its largest |plain|; fp32 output, P.V on P_hi + "
                     "P_lo (2^-16 of P), ex2 and fp32 sums in other "
                     "orders, amplified by a long row's cancellation: "
                     "2^-12")


def mixed_case(dtype, device, seed, rows, T, kvh=8, G=4, hd=128, bs=16):
    """The mixed kernel at llama3-8b shapes unless told otherwise:
    B=len(rows), kvh=8, G=4, hd=128, bs=16; ``rows`` of (q_len, kv_len)
    over scattered pages. The NULL page holds +1e3 keys and -1e3 values:
    a read of it within a row's length would show."""
    B = len(rows)
    q_lens = np.asarray([r[0] for r in rows], np.int32)
    kv_lens = np.asarray([r[1] for r in rows], np.int32)
    mb = -(-int(kv_lens.max()) // bs)
    n_pages = 1 + sum(-(-int(n) // bs) for n in kv_lens) + 64
    rng = np.random.RandomState(seed)
    free = list(rng.permutation(np.arange(1, n_pages)))
    table = np.zeros((B, mb), np.int32)
    for b in range(B):
        for j in range(-(-int(kv_lens[b]) // bs)):
            table[b, j] = free.pop()
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, T, kvh, G, hd), generator=g, device=device).to(dtype)
    kp, vp = (torch.randn((n_pages, bs, kvh, hd), generator=g,
                          device=device).to(dtype) for _ in range(2))
    kp[0], vp[0] = 1e3, -1e3
    return (q, kp, vp, torch.as_tensor(table, device=device),
            torch.as_tensor(kv_lens, device=device),
            torch.as_tensor(q_lens, device=device))


def valid_slots(q_lens, T):
    """[B, T] mask of the real query slots of a mixed launch."""
    return torch.arange(T, device=q_lens.device)[None, :] < q_lens[:, None]


def mixed_bound_ms(q, table, kv_lens, q_lens):
    """Least time for the work this input needs: each row's resident K
    and V read once, the valid queries read and their outputs written,
    table and lengths read; 4 flops per (valid query head, visible key,
    dim) for QK^T and PV, where query i of a row sees kv_len - q_len + i
    + 1 keys."""
    B, T, kvh, G, hd = q.shape
    elt = q.element_size()
    kv, ql = kv_lens.tolist(), q_lens.tolist()
    visible = sum(max(0, n - qn + i + 1) for n, qn in zip(kv, ql)
                  for i in range(qn))
    nbytes = (2 * sum(kv) * kvh * hd * elt + sum(ql) * kvh * G * hd
              * (elt + 4) + table.numel() * 4 + 2 * B * 4)
    flops = 4 * visible * kvh * G * hd
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / H100_FLOPS[q.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def sdpa_mixed_yardstick(q, kp, vp, table, kv_lens, q_lens):
    """One PyTorch library call for the same function: gather the pages,
    then scaled_dot_product_attention with each query's causal key mask
    (bool) over grouped heads. Timed only; the port never calls it."""
    B, T, kvh, G, hd = q.shape
    mb, bs = table.shape[1], kp.shape[1]
    idx = table.reshape(-1).long()
    ck = kp[idx].reshape(B, mb * bs, kvh, hd).transpose(1, 2)
    cv = vp[idx].reshape(B, mb * bs, kvh, hd).transpose(1, 2)
    pos = (kv_lens[:, None] - q_lens[:, None]
           + torch.arange(T, device=q.device)[None, :])
    j = torch.arange(mb * bs, device=q.device)[None, None, :]
    mask = ((j <= pos[:, :, None]) & (j < kv_lens[:, None, None]))[:, None]
    out = torch.nn.functional.scaled_dot_product_attention(
        q.permute(0, 2, 3, 1, 4).reshape(B, kvh * G, T, hd), ck, cv,
        attn_mask=mask, enable_gqa=True)
    return out.reshape(B, kvh, G, T, hd).permute(0, 3, 1, 2, 4)


MIXED_ROWS = {128: ((128, 1536), (1, 1999), (5, 512), (0, 0)),
              16: ((1, 1999), (1, 1536), (1, 512), (0, 0))}
# Correctness only, at other widths the kernel takes (MIXED_WIDE, T=128):
# a 128-token window at 972..1099 across the split boundary at 1024 (5
# splits), a decode row of 8 splits, a 37-token window at 220..256
# across the boundary at 256, an idle row.
MIXED_WIDE = dict(G=8, hd=64, bs=32)
MIXED_WIDE_ROWS = ((128, 1100), (1, 2047), (37, 257), (0, 0))


def phase_kernels_mixed(on_card, seed):
    """The mixed kernel against mixed_attn_reference on the valid query
    slots, in bf16, fp16 and fp32: at T=128 (a 128-token chunk at offset
    1408, a decode row, a verify window of 5 and an idle row), at the
    decode-only T=16, and at MIXED_WIDE's widths. Idle rows are exact
    zeros. On the card each launch's route is checked (tensor cores for
    bf16/fp16), two launches give the same bits, and with NaN in the
    NULL page the output is bit-identical; bf16/fp16 rows are held
    within MIXED_ROW_TOL. The MIXED_ROWS shapes are timed beside their
    bound, the plain version and gather + SDPA, and must beat the plain
    version."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    device = "cuda" if on_card else "cpu"
    out = {}
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=device) \
        if on_card else None
    flush = (lambda: flush_buf.zero_()) if on_card else None
    say("mixed", tolerance=repr(MIXED_TOL_WHY),
        row_tolerance=repr(MIXED_ROW_TOL_WHY),
        split_keys=pa.MIXED_SPLIT_KEYS)
    cases = [(T, rows, {}) for T, rows in MIXED_ROWS.items()]
    cases.append((128, MIXED_WIDE_ROWS, MIXED_WIDE))
    for T, rows, widths in cases:
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            args = mixed_case(dtype, device, seed, rows, T, **widths)
            pa.route_counts.clear()
            got = pa.mixed_paged_attention(*args)
            routes = dict(pa.route_counts)
            want = pa.mixed_attn_reference(*args)
            if on_card:
                torch.cuda.synchronize()
            B, _, kvh, G, hd = args[0].shape
            bs = args[1].shape[1]
            valid = valid_slots(args[5], T)
            check(got.dtype == torch.float32 and got.shape == want.shape,
                  "mixed kernel output is fp32 of q's shape")
            check(bool(torch.isfinite(got).all()),
                  "mixed kernel output is finite")
            check(bool((got[3] == 0).all()), "kv_len 0 row gives zeros")
            err = float((got - want)[valid].abs().max())
            scale = max(1.0, float(want[valid].abs().max()))
            name = str(dtype).replace("torch.", "")
            tol = MIXED_TOL[dtype] * (scale if dtype != torch.float32
                                      else 1.0)
            row_err = row_rel_err(got[valid], want[valid], False) \
                if dtype in MIXED_ROW_TOL else None
            case = dict(dtype=name, T=T, hd=hd, G=G, bs=bs,
                        rows=json.dumps(rows).replace(" ", ""))
            say("mixed", name="mixed_paged", **case, max_abs_err=err,
                tol=tol, row_rel_err=row_err,
                row_tol=MIXED_ROW_TOL.get(dtype),
                splits=pa.mixed_splits(args[3].shape[1], bs),
                workspace_bytes=4 * pa.mixed_workspace_floats(
                    B, T, kvh, G, hd, args[3].shape[1], bs),
                routes=json.dumps(routes))
            check(err <= tol, f"mixed_paged {case} max-abs {err} <= {tol}")
            if row_err is not None:
                check(row_err <= MIXED_ROW_TOL[dtype],
                      f"mixed_paged {case} row-relative {row_err} <= "
                      f"{MIXED_ROW_TOL[dtype]}")
            if not on_card:
                continue            # the plain version multiplies 0 x NaN
            way = pa.mixed_route(dtype)
            check(routes == {f"mixed_paged/{way}": 1},
                  f"mixed_paged {case} routes {routes}")
            same_twice = bool(torch.equal(pa.mixed_paged_attention(*args),
                                          got))
            kp_nan, vp_nan = args[1].clone(), args[2].clone()
            kp_nan[0], vp_nan[0] = float("nan"), float("nan")
            same_nan = bool(torch.equal(pa.mixed_paged_attention(
                args[0], kp_nan, vp_nan, *args[3:]), got))
            say("mixed", name="mixed_paged", **case,
                two_launches_bit_identical=same_twice,
                nan_null_page_identical=same_nan)
            check(same_twice, "two mixed launches give the same bits")
            check(same_nan, "NaN in the NULL page changes no output")
            del kp_nan, vp_nan
            if widths:
                continue            # correctness only
            ms = cuda_ms(lambda: pa.mixed_paged_attention(*args),
                         flush=flush)
            plain_ms = cuda_ms(lambda: pa.mixed_attn_reference(*args),
                               flush=flush)
            lib_ms = cuda_ms(lambda: sdpa_mixed_yardstick(*args),
                             flush=flush)
            lib = sdpa_mixed_yardstick(*args)
            lib_err = float((lib.float() - want)[valid].abs().max())
            bound_ms, bound_by = mixed_bound_ms(args[0], args[3], args[4],
                                                args[5])
            say("mixed", name="mixed_paged", dtype=name, T=T, route=way,
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_max_abs_err=lib_err, bound_ms=bound_ms,
                bound_by=bound_by, share_of_bound=bound_ms / ms)
            check(ms < plain_ms, f"mixed_paged {name} T={T}: {ms} ms "
                                 f"faster than its plain version's "
                                 f"{plain_ms} ms")
            out[(name, T)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by,
                                  library_ms=lib_ms)
    return out


# -- phases 3 and 4: serving --------------------------------------------------

def drive(eng, waves, on_card, record=None):
    """Submit each wave once the previous one has drained; returns the
    requests and the decode and prefill wall seconds."""
    reqs, t_decode, t_admit = [], 0.0, 0.0
    for wave in waves:
        reqs += [eng.submit(p, mn) for p, mn in wave]
        for _ in range(400):
            t = time.perf_counter()
            eng.admit([])
            t_admit += time.perf_counter() - t
            if record is not None:
                record(eng)
                record = None
            t = time.perf_counter()
            eng.decode_once()
            if on_card:
                torch.cuda.synchronize()
            t_decode += time.perf_counter() - t
            if eng.idle():
                break
        else:
            raise RuntimeError("engine did not drain")
    return reqs, t_decode, t_admit


def phase_small_reference(on_card, seed):
    """The debug preset in fp32, served on the card (kernel) and on the
    CPU (plain version) with the same weights: identical tokens."""
    from paddle_tpu_torch.inference.serving import DecodeEngine
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    cpu_model = LlamaForCausalLM(
        "debug", device="cpu",
        generator=torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    wave = [(rng.randint(1, 128, (n,)).astype(np.int32), mn)
            for n, mn in ((8, 16), (10, 16), (5, 4), (30, 6), (6, 9))]
    outs = []
    for model in (cpu_model, copy.deepcopy(cpu_model).to(
            "cuda" if on_card else "cpu")):
        eng = DecodeEngine(model, capacity=4, s_max=96, chunk=4,
                           block_size=8)
        reqs, _, _ = drive(eng, [wave], on_card and model is not cpu_model)
        outs.append([r.wait(timeout=1) for r in reqs])
    same = all(np.array_equal(a, b) for a, b in zip(*outs))
    say("small", preset="debug", requests=len(wave), identical=same)
    check(same, "greedy tokens on the card equal the CPU's")


def main_requests(vocab, seed):
    """7 requests of 16 new tokens: prompts of 32-512 tokens; the first
    and the last share a 48-token (3-page) prefix, and the last is
    submitted in the second wave, after the first has retired."""
    rng = np.random.RandomState(seed)
    tok = lambda n: rng.randint(1, vocab, (n,)).astype(np.int32)
    shared = tok(48)
    first = np.concatenate([shared, tok(20)])
    last = np.concatenate([shared, tok(40)])
    wave1 = [(first, 16), (tok(512), 16), (tok(32), 16), (tok(200), 16)]
    wave2 = [(tok(333), 16), (tok(128), 16), (last, 16)]
    return [wave1, wave2]


def phase_main(on_card, args):
    from paddle_tpu_torch.inference.serving import DecodeEngine
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.models import llama as ll
    device = "cuda" if on_card else "cpu"
    cfg = ll.LlamaConfig(**ll.LLAMA_PRESETS[args.preset])
    dtype = torch.bfloat16 if on_card else torch.float32
    t0 = time.perf_counter()
    model = ll.LlamaForCausalLM(
        cfg, dtype=dtype, device=device,
        generator=torch.Generator(device=device).manual_seed(args.seed))
    if on_card:
        torch.cuda.synchronize()
    say("main", preset=args.preset, layers=cfg.num_hidden_layers,
        hidden=cfg.hidden_size, heads=cfg.num_attention_heads,
        kv_heads=cfg.num_key_value_heads, vocab=cfg.vocab_size,
        dtype=str(dtype).replace("torch.", ""),
        init_s=round(time.perf_counter() - t0, 3))
    eng = DecodeEngine(model, capacity=4, s_max=640, chunk=8,
                       block_size=16)
    waves = main_requests(cfg.vocab_size, args.seed)
    snap = {}

    def record(e):
        # state at the first decode step (after the first admission and
        # the page growth that decode_once would do first; growing is
        # idempotent), for the first-step replay
        e._grow_rows()
        snap.update(kp=e._kp.clone(), vp=e._vp.clone(),
                    tables=e._tables.copy(), lens=e._lens.copy(),
                    tok=e._tok.copy(),
                    slots={i: r["req"] for i, r in enumerate(e._rows)
                           if r is not None})

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    pa.launch_counts.clear()
    reqs, t_decode, t_admit = drive(eng, waves, on_card, record=record)
    launches = dict(pa.launch_counts)
    st = eng.stats()
    n_req = sum(len(w) for w in waves)
    check(len(reqs) == n_req and all(r.error is None for r in reqs),
          "every request finished")
    for r in reqs:
        res = r.wait(timeout=1)
        check(res.size == r.ids.size + r.max_new,
              "each request returns prompt + its token count")
        check(bool(((res >= 0) & (res < cfg.vocab_size)).all()),
              "tokens lie in the vocabulary")
    check(st["prefix_hit_tokens"] >= 32,
          f"the shared prefix was served from the cache "
          f"({st['prefix_hit_tokens']} tokens)")
    expect = cfg.num_hidden_layers * st["device_steps"]
    if on_card:
        check(launches.get("paged_decode", 0) == expect,
              f"paged_decode launched {launches.get('paged_decode', 0)} "
              f"times, expected layers x decode steps = {expect}")
    decode_tokens = sum(r.max_new - 1 for r in reqs)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    say("main", requests=n_req, retired=st["retired"],
        prefix_hit_tokens=st["prefix_hit_tokens"],
        decode_steps=st["device_steps"], launches=json.dumps(launches),
        decode_s=round(t_decode, 4), admit_prefill_s=round(t_admit, 4),
        decode_tokens_per_s=round(decode_tokens / t_decode, 2),
        peak_mem_gib=round(peak / 2 ** 30, 3))

    replay_first_step(cfg, model, snap, device)
    return launches, model


def plain_attention_f64(q, kp, vp, table, lens):
    """The plain version's math in float64, cast to float32: the same
    function with other rounding, to show the noise floor of a bf16
    step."""
    B, mb = table.shape
    N, bs, kvh, hd = kp.shape
    idx = table.reshape(-1).long()
    ck = kp[idx].reshape(B, mb * bs, kvh, hd).double()
    cv = vp[idx].reshape(B, mb * bs, kvh, hd).double()
    mask = torch.arange(mb * bs, device=q.device)[None, :] < lens[:, None]
    s = torch.einsum("bngd,btnd->bngt", q.double(), ck) / hd ** 0.5
    p = torch.softmax(s.masked_fill(~mask[:, None, None, :],
                                    float("-inf")), dim=-1)
    return torch.einsum("bngt,btnd->bngd", p, cv).float()


def replay_first_step(cfg, model, snap, device):
    """Replay the main path's first decode step on the state recorded
    just before it.

    In bf16, as the engine ran it: every layer's kernel output is held
    against the plain version on the same inputs (<= 2e-2), the argmax
    equals the plain step's and the tokens the engine emitted. The bf16
    logits of the kernel step and the plain step are printed beside the
    noise floor of bf16 rounding (plain in fp32 against plain in fp64):
    kernel and plain agree to about 1e-7 before the cast to bf16, but
    each rounding flip grows over 32 layers of random weights, so the
    logits are not held to 5e-2 in bf16. In fp32, with the same weights
    and state upcast, rounding does not grow, and the kernel step's
    logits are held to the plain step's within 5e-2 with the same
    argmax."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.models import llama as ll
    pa_ref = pa.paged_attn_reference
    tok = torch.as_tensor(snap["tok"], device=device).long()
    tables = torch.as_tensor(snap["tables"], device=device)
    lens = torch.as_tensor(snap["lens"], device=device)
    rows = sorted(snap["slots"])
    layer_errs = []

    def kernel_checked(*a):
        out = pa.paged_decode_attention(*a)
        layer_errs.append(float((out - pa_ref(*a)).abs().max()))
        return out

    def step(weights, kp, vp, attn):
        with torch.no_grad():
            return ll._paged_decode_step(cfg, *weights, tok, kp.clone(),
                                         vp.clone(), tables, lens,
                                         attn=attn)[rows]

    w16 = model.weights()
    k16 = step(w16, snap["kp"], snap["vp"], kernel_checked)
    p16 = step(w16, snap["kp"], snap["vp"], pa_ref)
    f64 = step(w16, snap["kp"], snap["vp"], plain_attention_f64)
    emitted = [int(snap["slots"][s].result[snap["slots"][s].ids.size + 1])
               for s in rows]
    err16 = float((k16 - p16).abs().max())
    floor16 = float((p16 - f64).abs().max())
    say("main", first_step=str(w16[1].dtype).replace("torch.", ""),
        layers_checked=len(layer_errs),
        attention_max_abs_err=max(layer_errs), logits_max_abs_err=err16,
        noise_floor_plain_fp32_vs_fp64=floor16,
        same_argmax=bool((k16.argmax(-1) == p16.argmax(-1)).all()),
        engine_tokens=emitted, replay_argmax=k16.argmax(-1).tolist())
    check(bool(torch.isfinite(k16).all()), "first-step logits are finite")
    check(len(layer_errs) == cfg.num_hidden_layers
          and max(layer_errs) <= 2e-2,
          "every layer's attention agrees with the plain version")
    check(bool((k16.argmax(-1) == p16.argmax(-1)).all()),
          "bf16 first-step argmax equal with kernel and plain")
    check(emitted == k16.argmax(-1).tolist(),
          "engine's first decoded tokens = replay argmax")
    st, embed, fnorm, head = w16
    w32 = ({n: w.float() for n, w in st.items()}, embed.float(),
           fnorm.float(), head.float())
    k32 = step(w32, snap["kp"].float(), snap["vp"].float(),
               pa.paged_decode_attention)
    p32 = step(w32, snap["kp"].float(), snap["vp"].float(), pa_ref)
    err32 = float((k32 - p32).abs().max())
    same32 = bool((k32.argmax(-1) == p32.argmax(-1)).all())
    say("main", first_step="fp32", logits_max_abs_err=err32,
        same_argmax=same32)
    check(err32 <= 5e-2, f"fp32 first-step logits max-abs {err32} <= 5e-2")
    check(same32, "fp32 first-step argmax equal with kernel and plain")
    del w32


# -- phase 5: int8 KV with chunked prefill ------------------------------------

def int8_requests(vocab, seed):
    """8 requests of 16 new tokens: prompts of 1536, 1024, 512, 384, 256
    and 96 tokens, and two sharing a 48-token (3-page) prefix followed
    by 16 and 40 of their own; the second comes in a second wave, after
    the first has retired and published the prefix."""
    rng = np.random.RandomState(seed + 1)
    tok = lambda n: rng.randint(1, vocab, (n,)).astype(np.int32)
    shared = tok(48)
    wave1 = [(np.concatenate([shared, tok(16)]), 16)] + [
        (tok(n), 16) for n in (1536, 1024, 512, 384, 256, 96)]
    wave2 = [(np.concatenate([shared, tok(40)]), 16)]
    return [wave1, wave2]


def phase_int8_chunked(on_card, model, args):
    """The int8 + chunked-prefill engine on the main path's model. The
    engine's decode chunks and prefill chunks are timed by wrapping
    them; the first decode chunk in which a row of at least 1024 tokens
    decodes while other rows are mid-prefill is recorded for the
    replay."""
    from paddle_tpu_torch.inference.serving import DecodeEngine
    from paddle_tpu_torch.kernels import paged_attention as pa
    cfg = model.config
    eng = DecodeEngine(model, capacity=4, s_max=1600, chunk=8,
                       block_size=16, kv_dtype="int8",
                       chunked_prefill=True, prefill_chunk=128)
    timing = {"decode_s": 0.0, "chunk_s": 0.0}
    snap = {}
    decode_chunk, prefill_chunk_row = eng._decode_chunk, \
        eng._prefill_chunk_row

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed_decode_chunk():
        ready = [i for i, r in enumerate(eng._rows)
                 if r is not None and "pf_seq" not in r]
        record = not snap and max(int(eng._lens[i]) for i in ready) \
            >= 1024 and any(r is not None and "pf_seq" in r
                            for r in eng._rows)
        if record:
            snap.update(kp=eng._kp.clone(), vp=eng._vp.clone(),
                        ks=eng._kscale.clone(), vs=eng._vscale.clone(),
                        tables=eng._tables.copy(), lens=eng._lens.copy(),
                        tok=eng._tok.copy(), lanes=ready)
        t = time.perf_counter()
        toks = decode_chunk()               # ends in a fetch: synced
        timing["decode_s"] += time.perf_counter() - t
        if record:
            snap["emitted"] = [int(toks[0, i]) for i in ready]
        return toks

    def timed_prefill_chunk_row(*a):
        sync()
        t = time.perf_counter()
        prefill_chunk_row(*a)
        sync()
        timing["chunk_s"] += time.perf_counter() - t

    eng._decode_chunk = timed_decode_chunk
    eng._prefill_chunk_row = timed_prefill_chunk_row
    waves = int8_requests(cfg.vocab_size, args.seed)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reqs, mixed_steps = [], 0
    pa.launch_counts.clear()
    for wave in waves:
        reqs += [eng.submit(p, mn) for p, mn in wave]
        for _ in range(400):
            eng.admit([])
            before = eng.stats()
            eng.decode_once()
            after = eng.stats()
            mixed_steps += (after["prefill_chunks"] > before["prefill_chunks"]
                            and after["device_steps"]
                            > before["device_steps"])
            if eng.idle():
                break
        else:
            raise RuntimeError("int8 engine did not drain")
    sync()
    launches = dict(pa.launch_counts)
    st = eng.stats()
    for r in reqs:
        check(r.error is None, f"request failed: {r.error!r}")
        res = r.wait(timeout=1)
        check(res.size == r.ids.size + r.max_new
              and bool(((res >= 0) & (res < cfg.vocab_size)).all()),
              "each request returns prompt + its 16 tokens")
    expect = cfg.num_hidden_layers * st["device_steps"]
    if on_card:
        check(launches.get("paged_decode_int8", 0) == expect,
              f"paged_decode_int8 launched "
              f"{launches.get('paged_decode_int8', 0)} times, expected "
              f"layers x decode steps = {expect}")
        check(launches.get("paged_decode", 0) == 0,
              "the fp kernel did not launch on int8 pools")
    check(st["prefill_chunks"] >= 12 + 8 + 4,
          f"long prompts went in by chunks ({st['prefill_chunks']})")
    check(mixed_steps >= 1, "a step ran prefill chunks and decode lanes")
    check(st["prefix_hit_tokens"] >= 48,
          f"the shared prefix was served from the cache "
          f"({st['prefix_hit_tokens']} tokens)")
    check(bool(snap), "a long row decoded beside mid-prefill rows")
    int8_bytes = sum(a.numel() * a.element_size()
                     for a in (eng._kp, eng._vp, eng._kscale, eng._vscale))
    fp_bytes = 2 * eng._kp.numel() * model.embed_tokens.element_size()
    decode_tokens = sum(r.max_new - 1 for r in reqs)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    say("int8", requests=len(reqs), retired=st["retired"],
        decode_steps=st["device_steps"], prefill_chunks=st["prefill_chunks"],
        mixed_steps=mixed_steps, prefix_hit_tokens=st["prefix_hit_tokens"],
        launches=json.dumps(launches), decode_s=round(timing["decode_s"], 4),
        decode_tokens_per_s=round(decode_tokens / timing["decode_s"], 2),
        prefill_chunk_s=round(timing["chunk_s"], 4),
        pool_bytes_int8=int8_bytes, pool_bytes_fp=fp_bytes,
        peak_mem_gib=round(peak / 2 ** 30, 3))
    del eng
    replay_int8_step(cfg, model, snap, on_card)
    return launches


def held_argmaxes(kern, plain, what):
    """Hold the argmaxes of two steps' logits (rows of [slots, vocab])
    equal at every slot whose top-2 margin exceeds d, the largest
    |kernel - plain| logit difference of the step, in both steps: were
    the argmaxes a and b to differ there, kern[a] - kern[b] and
    plain[b] - plain[a] would each exceed d, and their sum, which is
    at most 2d, would exceed 2d. Slots of a smaller margin are counted,
    not held. Returns (d, slots held, slots)."""
    d = float((kern - plain).abs().max())
    top_k, top_p = (x.float().topk(2, dim=-1).values for x in (kern, plain))
    margin = torch.minimum(top_k[:, 0] - top_k[:, 1],
                           top_p[:, 0] - top_p[:, 1])
    held = margin > d
    same = kern.argmax(-1) == plain.argmax(-1)
    check(bool(same[held].all()),
          f"{what}: kernel and plain argmaxes equal at the "
          f"{int(held.sum())} slots whose top-2 margin exceeds the "
          f"largest logit difference {d}")
    return d, int(held.sum()), int(held.numel())


def replay_int8_step(cfg, model, snap, on_card):
    """Replay the recorded decode step on copies of its int8 pools and
    scales: every layer's kernel output is held against the plain int8
    version on the same inputs (<= INT8_TOL), and the replay's argmax
    equals the tokens the engine emitted at that step. The argmax of a
    replay through the plain version alone is held equal to it at the
    lanes whose top-2 margin exceeds the largest logit difference
    between the two replays (held_argmaxes); elsewhere bf16 rounding
    flips, which grow over 32 layers of random weights (see phase 4),
    may change it, and it is printed."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.models import llama as ll
    device = "cuda" if on_card else "cpu"
    tok = torch.as_tensor(snap["tok"], device=device).long()
    tables = torch.as_tensor(snap["tables"], device=device)
    lens = torch.as_tensor(snap["lens"], device=device)
    lanes = snap["lanes"]
    errs = []

    def kernel_checked(*a, kv_scales):
        out = pa.paged_decode_attention(*a, kv_scales=kv_scales)
        errs.append(float((out - pa.paged_attn_reference_int8(
            *a, kv_scales)).abs().max()))
        return out

    def plain(*a, kv_scales):
        return pa.paged_attn_reference_int8(*a, kv_scales)

    def step(attn):
        with torch.no_grad():
            return ll._paged_decode_step(
                cfg, *model.weights(), tok, snap["kp"].clone(),
                snap["vp"].clone(), tables, lens, snap["ks"].clone(),
                snap["vs"].clone(), attn=attn)[lanes]

    kern = step(kernel_checked)
    plain_logits = step(plain)
    got = kern.argmax(-1).tolist()
    d, held, slots = held_argmaxes(kern, plain_logits, "int8 replay")
    say("int8", replay_lanes=lanes,
        replay_lens=[int(snap["lens"][i]) for i in lanes],
        layers_checked=len(errs), attention_max_abs_err=max(errs),
        engine_tokens=snap["emitted"], replay_argmax=got,
        plain_replay_argmax=plain_logits.argmax(-1).tolist(),
        plain_logits_max_abs_diff=d,
        argmax_held_slots=f"{held}/{slots}")
    check(bool(torch.isfinite(kern).all()), "replayed logits are finite")
    check(len(errs) == cfg.num_hidden_layers and max(errs) <= INT8_TOL,
          "every layer's int8 attention agrees with the plain version")
    check(got == snap["emitted"], "engine's tokens = replay argmax")


# -- phase 6: speculative decoding --------------------------------------------

def phase_spec(on_card, model, args):
    """Speculative decoding at the main path's width: 4 requests whose
    prompts repeat a 32-token pattern four times, 32 new tokens each.
    Every request completes; verify steps are prefills, so no
    paged-decode kernel launches. (With random weights the drafter
    finds an n-gram to copy only where the model's own continuation
    repeats its context, which a vocabulary of 128256 makes rare; the
    draft and accept path is held on the CPU by the parity tests.)"""
    from paddle_tpu_torch.inference.serving import DecodeEngine
    from paddle_tpu_torch.kernels import paged_attention as pa
    cfg = model.config
    rng = np.random.RandomState(args.seed + 2)
    prompts = [np.tile(rng.randint(1, cfg.vocab_size, (32,)), 4).astype(
        np.int32) for _ in range(4)]
    eng = DecodeEngine(model, capacity=4, s_max=256, chunk=8,
                       block_size=16, kv_dtype="int8", chunked_prefill=True,
                       prefill_chunk=128, spec_decode=True,
                       spec_max_draft=4)
    pa.launch_counts.clear()
    reqs = [eng.submit(p, 32) for p in prompts]
    t = time.perf_counter()
    for _ in range(400):
        eng.admit([])
        eng.decode_once()
        if eng.idle():
            break
    else:
        raise RuntimeError("speculative engine did not drain")
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(pa.launch_counts)
    st = eng.stats()
    for r in reqs:
        check(r.error is None, f"request failed: {r.error!r}")
        check(r.wait(timeout=1).size == r.ids.size + 32,
              "each request returns prompt + 32 tokens")
    check(sum(launches.values()) == 0,
          f"verify steps are prefills: no paged-decode launch "
          f"({launches})")
    spec = st["spec"]
    check(spec["verify_steps"] == st["device_steps"],
          "every engine step was a verify step")
    say("spec", requests=len(reqs), prompt_tokens=int(prompts[0].size),
        verify_steps=spec["verify_steps"], proposed=spec["proposed"],
        accepted=spec["accepted"], accept_rate=round(spec["accept_rate"], 4),
        tokens_per_step=round(spec["tokens_per_step"], 4),
        prefill_chunks=st["prefill_chunks"], wall_s=round(wall, 4),
        tokens_per_s=round(sum(r.max_new for r in reqs) / wall, 2))


# -- phase 10: the tensor-parallel mesh engine -------------------------------

def mesh_requests(vocab, seed):
    """Phase 5's 8 requests and 2 whose prompts repeat a 32-token
    pattern four times (drafts to verify), 16 new tokens each."""
    waves = int8_requests(vocab, seed)
    rng = np.random.RandomState(seed + 3)
    rep = [(np.tile(rng.randint(1, vocab, (32,)), 4).astype(np.int32), 16)
           for _ in range(2)]
    return [waves[0] + rep, waves[1]]


def phase_mesh(on_card, model, args):
    """The mesh engine at the main path's width on a one-device tp mesh,
    with chunked prefill and speculative decoding: every engine step is
    one mixed step. The steps are timed by wrapping mixed_paged_step
    (synchronised), and the first step that holds a 128-token chunk
    beside the most decode lanes is recorded for the replay."""
    from paddle_tpu_torch.inference.serving import DecodeEngine
    from paddle_tpu_torch.inference.sharding import make_tp_mesh
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.models import llama as ll
    cfg = model.config
    device = "cuda" if on_card else "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    mesh = make_tp_mesh(1) if on_card else make_tp_mesh(1, devices=["cpu"])
    eng = DecodeEngine(model, capacity=4, s_max=1600, block_size=16,
                       mesh=mesh, chunked_prefill=True, prefill_chunk=128,
                       spec_decode=True)
    walls, snap = {}, {}
    step = ll.mixed_paged_step

    def timed_step(cfg_, st, embed, fnorm, head, ids, q_lens, kv_lens,
                   tables, kp, vp, *scales, attn):
        ql = q_lens.tolist()
        lanes = [i for i, r in enumerate(eng._rows)
                 if r is not None and "pf_seq" not in r and ql[i] > 0]
        record = 128 in ql and len(lanes) > len(snap.get("lanes", ()))
        if record:          # pools to host memory: out of the peak
            snap.update(lanes=lanes, ids=ids.clone(), q_lens=q_lens.clone(),
                        kv_lens=kv_lens.clone(), tables=tables.clone(),
                        kp=kp[0].to("cpu", copy=True),
                        vp=vp[0].to("cpu", copy=True))
        sync()
        t = time.perf_counter()
        preds = step(cfg_, st, embed, fnorm, head, ids, q_lens, kv_lens,
                     tables, kp, vp, *scales, attn=attn)
        sync()
        walls.setdefault(ids.shape[1], []).append(time.perf_counter() - t)
        if record:
            snap["preds"] = preds.clone()
        return preds

    waves = mesh_requests(cfg.vocab_size, args.seed)
    gc.collect()                # earlier phases' engines hold cycles
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ll.mixed_paged_step = timed_step
    try:
        pa.launch_counts.clear()
        pa.route_counts.clear()
        reqs, t_decode, t_admit = drive(eng, waves, on_card)
        launches = dict(pa.launch_counts)
        routes = dict(pa.route_counts)
    finally:
        ll.mixed_paged_step = step
    st = eng.stats()
    mixed_steps = sum(len(w) for w in walls.values())
    for r in reqs:
        check(r.error is None, f"request failed: {r.error!r}")
        res = r.wait(timeout=1)
        check(res.size == r.ids.size + r.max_new
              and bool(((res >= 0) & (res < cfg.vocab_size)).all()),
              "each request returns prompt + its 16 tokens")
    L = cfg.num_hidden_layers
    check(mixed_steps == st["device_steps"] > 0,
          f"every engine step was a mixed step ({mixed_steps} of "
          f"{st['device_steps']})")
    if on_card:
        check(launches.get("mixed_paged", 0) == L * mixed_steps > 0,
              f"mixed_paged launched {launches.get('mixed_paged', 0)} "
              f"times, expected layers x mixed steps = {L * mixed_steps}")
        check(launches.get("paged_decode", 0) == 0,
              "no paged-decode launch: no step left the mixed path")
        way = pa.mixed_route(model.embed_tokens.dtype)
        check(routes == {f"mixed_paged/{way}": L * mixed_steps},
              f"every mixed launch took the {way} route: {routes}")
    check(st["prefill_chunks"] >= 12 + 8 + 4,
          f"long prompts went in by chunks ({st['prefill_chunks']})")
    check(st["prefix_hit_tokens"] >= 48,
          f"the shared prefix was served from the cache "
          f"({st['prefix_hit_tokens']} tokens)")
    check(bool(snap), "a 128-token chunk ran beside a decode lane")
    decode_tokens = sum(r.max_new - 1 for r in reqs)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    med = {T: round(1e3 * float(np.median(w)), 3)
           for T, w in sorted(walls.items())}
    say("mesh", requests=len(reqs), retired=st["retired"],
        mesh_shape=json.dumps(st["mesh_shape"]).replace(" ", ""),
        mixed_steps=mixed_steps,
        steps_by_window=json.dumps({T: len(w) for T, w in
                                    sorted(walls.items())}).replace(" ", ""),
        median_step_ms_by_window=json.dumps(med).replace(" ", ""),
        device_calls=st["device_calls"], prefill_chunks=st["prefill_chunks"],
        prefix_hit_tokens=st["prefix_hit_tokens"],
        spec_proposed=st["spec"]["proposed"],
        spec_accepted=st["spec"]["accepted"],
        launches=json.dumps(launches), routes=json.dumps(routes),
        decode_s=round(t_decode, 4),
        admit_s=round(t_admit, 4),
        decode_tokens_per_s=round(decode_tokens / t_decode, 2),
        peak_mem_gib=round(peak / 2 ** 30, 3))
    del eng
    gc.collect()
    replay_mixed_step(cfg, model, snap, device)
    if args.profile:
        profile_mixed_step(cfg, model, snap, on_card)
    return launches


def replay_mixed_step(cfg, model, snap, device):
    """Replay the recorded mixed step on copies of its pools.

    In bf16, as the engine ran it: every layer's kernel output is held
    against the plain version on the same inputs (MIXED_TOL), and the
    replay's argmax equals the engine's at every valid slot. The bf16
    argmaxes of the kernel step and the plain step are held equal at
    the valid slots whose top-2 margin exceeds the step's largest logit
    difference (held_argmaxes), and counted everywhere: the kernel's
    fp32 sums (an online softmax over 64-key tiles and 256-key splits)
    differ from the plain version's by a few 1e-6 per layer, each such
    difference can flip a bf16 rounding of the attention output, and
    the flips grow over 32 layers of random weights (on an H100 with the
    kernel before its split-KV redesign, 11 of 131 slots, 1 of the 3
    emitted ones, with every layer within 4e-6; printed beside this
    run's count).
    In fp32, weights and pools upcast, every layer's kernel output is
    held within 2e-5 over the valid slots and the argmaxes are equal at
    every valid slot."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.models import llama as ll
    T = snap["ids"].shape[1]
    valid = valid_slots(snap["q_lens"], T)
    emitted = torch.zeros_like(valid)
    emitted[snap["lanes"]] = valid[snap["lanes"]]      # the decode lanes
    errs = []
    dev_snap = {k: snap[k].to(device) for k in ("kp", "vp")}

    def kernel_checked(q, kp, vp, tab, kvl, ql, kv_scales=None):
        out = pa.mixed_paged_attention(q, kp, vp, tab, kvl, ql)
        want = pa.mixed_attn_reference(q, kp, vp, tab, kvl, ql)
        errs.append(float((out - want)[valid].abs().max()))
        return out

    def plain(q, kp, vp, tab, kvl, ql, kv_scales=None):
        return pa.mixed_attn_reference(q, kp, vp, tab, kvl, ql)

    def step(weights, dtype, attn):
        with torch.no_grad():
            logits = ll.mixed_paged_logits(
                cfg, *weights, snap["ids"], snap["q_lens"], snap["kv_lens"],
                snap["tables"], dev_snap["kp"].to(dtype, copy=True),
                dev_snap["vp"].to(dtype, copy=True), attn=attn)
        return logits, logits.argmax(-1).to(torch.int32)

    w16 = model.weights()
    dt16 = w16[1].dtype
    k16_logits, k16 = step(w16, dt16, kernel_checked)
    errs16, errs[:] = list(errs), []
    p16_logits, p16 = step(w16, dt16, plain)
    engine_same = bool((k16 == snap["preds"])[valid].all())
    d, held, slots = held_argmaxes(k16_logits[valid], p16_logits[valid],
                                   "bf16 mixed replay")
    del k16_logits, p16_logits
    say("mesh", replay=str(dt16).replace("torch.", ""),
        q_lens=snap["q_lens"].tolist(), kv_lens=snap["kv_lens"].tolist(),
        layers_checked=len(errs16), attention_max_abs_err=max(errs16),
        valid_slots=int(valid.sum()), emitted_slots=int(emitted.sum()),
        argmax_equal_engine=engine_same,
        slots_differing_kernel_vs_plain=int(((k16 != p16) & valid).sum()),
        emitted_differing_kernel_vs_plain=int(((k16 != p16) & emitted)
                                              .sum()),
        before_redesign_slots_differing="11/131",
        before_redesign_emitted_differing="1/3", logits_max_abs_diff=d,
        argmax_held_slots=f"{held}/{slots}")
    check(len(errs16) == cfg.num_hidden_layers
          and max(errs16) <= MIXED_TOL.get(dt16, MIXED_TOL[torch.float32]),
          "every layer's attention agrees with the plain version")
    check(engine_same, "the engine's tokens = the kernel replay's argmax")
    st, embed, fnorm, head = w16
    w32 = ({n: w.float() for n, w in st.items()}, embed.float(),
           fnorm.float(), head.float())
    k32 = step(w32, torch.float32, kernel_checked)[1]
    p32 = step(w32, torch.float32, plain)[1]
    same32 = bool((k32 == p32)[valid].all())
    say("mesh", replay="float32", layers_checked=len(errs),
        attention_max_abs_err=max(errs), tol=MIXED_TOL[torch.float32],
        argmax_equal_kernel_plain=same32)
    check(len(errs) == cfg.num_hidden_layers
          and max(errs) <= MIXED_TOL[torch.float32],
          "every layer's fp32 attention agrees with the plain version")
    check(same32, "fp32 argmaxes equal with kernel and plain attention")
    del w32


def profile_mixed_step(cfg, model, snap, on_card):
    """The recorded mixed step under torch.profiler: host wall against
    summed device kernel time, split into the mixed kernel, cuBLAS's
    GEMMs and the rest."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.models import llama as ll
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    pools = [snap[k].to(snap["ids"].device) for k in ("kp", "vp")]

    def run():
        with torch.no_grad():
            ll.mixed_paged_step(cfg, *model.weights(), snap["ids"],
                                snap["q_lens"], snap["kv_lens"],
                                snap["tables"], pools[0].clone(),
                                pools[1].clone()).cpu()

    run()                                   # warm
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        run()
        wall = time.perf_counter() - t
    kernels, dev_us, n = device_kernels(prof)
    mixed_us = sum(e.self_device_time_total for e in kernels
                   if "mixed_paged" in e.key)
    merge_us = sum(e.self_device_time_total for e in kernels
                   if "mixed_paged_merge" in e.key)
    gemm_us = sum(e.self_device_time_total for e in kernels
                  if "nvjet" in e.key or "gemm" in e.key.lower())
    say("profile", what="mixed_step", T=int(snap["ids"].shape[1]),
        q_lens=snap["q_lens"].tolist(), wall_ms=round(wall * 1e3, 3),
        device_kernel_ms=round(dev_us / 1e3, 3), kernel_launches=n,
        device_busy_share=round(dev_us / 1e6 / max(wall, 1e-9), 4),
        mixed_kernel_ms=round(mixed_us / 1e3, 3),
        of_which_merge_ms=round(merge_us / 1e3, 3),
        gemm_kernels_ms=round(gemm_us / 1e3, 3),
        other_kernels_ms=round((dev_us - mixed_us - gemm_us) / 1e3, 3))
    for e in kernels[:8]:
        say("profile", what="mixed_step",
            kernel=e.key[:60].replace(" ", "_"), count=e.count,
            device_ms=round(e.self_device_time_total / 1e3, 3))


MESH_COUNTERS = ("device_steps", "device_calls", "prefill_chunks",
                 "prefix_hit_tokens", "prefills", "retired")


def phase_mesh_small(on_card, seed):
    """The tiny preset (8 heads, 4 kv heads of 32) in fp32 behind the
    mesh engine with chunked prefill and speculative decoding, from the
    same weights: on the card without a mesh, at tp=1 and at tp=2 (two
    ranks on one device: the kernel runs on kv-head shards, 2 kv heads
    and G=2 each), and on the CPU at tp=2. Tokens identical across all
    four; counters identical across the three mesh runs (the run
    without a mesh steps otherwise)."""
    from paddle_tpu_torch.inference.serving import DecodeEngine
    from paddle_tpu_torch.inference.sharding import make_tp_mesh
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    dev = "cuda:0" if on_card else "cpu"
    cpu_model = LlamaForCausalLM(
        "tiny", device="cpu", generator=torch.Generator().manual_seed(seed))
    card_model = copy.deepcopy(cpu_model).to(dev)
    rng = np.random.RandomState(seed + 4)
    wave = [(rng.randint(1, 1024, (n,)).astype(np.int32), mn)
            for n, mn in ((9, 16), (17, 16), (40, 12), (70, 10))]
    wave.append((np.tile(rng.randint(1, 1024, (6,)), 4).astype(np.int32),
                 16))
    kw = dict(capacity=4, s_max=128, chunk=4, block_size=8,
              chunked_prefill=True, prefill_chunk=16, spec_decode=True)
    runs = {}
    for name, model, mesh in (
            ("card_none", card_model, None),
            ("card_tp1", card_model, make_tp_mesh(1, devices=[dev])),
            ("card_tp2", card_model, make_tp_mesh(2, devices=[dev, dev])),
            ("cpu_tp2", cpu_model, make_tp_mesh(2, devices=["cpu", "cpu"]))):
        eng = DecodeEngine(model, mesh=mesh, **kw)
        pa.launch_counts.clear()
        reqs, _, _ = drive(eng, [wave], on_card and model is card_model)
        st = eng.stats()
        runs[name] = ([r.wait(timeout=1) for r in reqs],
                      {k: st[k] for k in MESH_COUNTERS}
                      | {"spec_proposed": st["spec"]["proposed"],
                         "spec_accepted": st["spec"]["accepted"]},
                      dict(pa.launch_counts))
    tokens = runs["cpu_tp2"][0]
    same_tokens = all(np.array_equal(a, b) for run in runs.values()
                      for a, b in zip(run[0], tokens))
    counters = runs["cpu_tp2"][1]
    same_counters = all(runs[n][1] == counters
                        for n in ("card_tp1", "card_tp2"))
    L = cpu_model.config.num_hidden_layers
    say("mesh_small", preset="tiny", dtype="float32", tf32=False,
        requests=len(wave), identical_tokens=same_tokens,
        identical_counters=same_counters,
        counters=json.dumps(counters).replace(" ", ""),
        device_calls_no_mesh=runs["card_none"][1]["device_calls"],
        launches_tp1=json.dumps(runs["card_tp1"][2]).replace(" ", ""),
        launches_tp2=json.dumps(runs["card_tp2"][2]).replace(" ", ""))
    check(same_tokens, "identical greedy tokens across the four runs")
    check(same_counters, "identical counters on the card at tp=1 and tp=2 "
                         "and on the CPU at tp=2")
    if on_card:
        steps = counters["device_steps"]
        for name, tp in (("card_tp1", 1), ("card_tp2", 2)):
            got = runs[name][2].get("mixed_paged", 0)
            check(got == tp * L * steps > 0,
                  f"{name}: mixed_paged launched {got} times, expected "
                  f"ranks x layers x steps = {tp * L * steps}")


# -- phase 7: FlashAttention-2 kernels against their plain versions ----------

FLASH_TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-2, torch.float32: 1e-4}
FLASH_TOL_WHY = ("max-abs error over max |plain| of each output; fp32: "
                 "sums in other orders and expf; bf16/fp16: the same plus "
                 "flips of the roundings to the input type (P, dS, the "
                 "outputs)")
# The tensor-core kernels' outputs are also held row by row: the
# largest error in a row of out, dq (a query row) or dk, dv (a key row)
# over that row's largest |plain| value, and lse's error over
# max(1, |plain|) element by element. A whole-tensor scale lets a wrong
# long causal row pass (its |out| is ~0.04 against row 0's ~3.5); a
# row's own scale does not. out, dk and dv are rounded to the input
# type, so one rounding that falls the other way moves an element by one
# unit in its last place, at most 2^-7 (bf16) or 2^-10 (fp16) of the
# row's largest value; the limit is two such units. lse is fp32 and
# differs by sums in other orders and the ex2 of the tensor-core
# kernels. The readings behind these limits are in PERF.md. dq, rounded
# to q's type like out, holds dk's limit with its rows' scale floored at
# 2^-8 of its largest |plain| (FLASH_ROW_FLOOR): a row of dq sums
# dS_ij k_j with sum_j dS_ij = 0, and query 0 of a causal dq sees one
# key, whose dS = dP - delta is 0 in exact arithmetic, so both versions
# leave fp32 rounding noise there (~1e-7) that no row scale can hold. At
# phase 7's shapes only query 0's rows of the plain dq fall below the
# floor; the next smallest rows are 2^-8 to 2^-5 of the largest and are
# held by their own scale.
FLASH_ROW_TOL = {
    torch.bfloat16: {"out": 2**-6, "lse": 1e-5, "dq": 2**-6, "dk": 2**-6,
                     "dv": 2**-6},
    torch.float16: {"out": 2**-9, "lse": 1e-5, "dq": 2**-9, "dk": 2**-9,
                    "dv": 2**-9}}
FLASH_ROW_FLOOR = {"dq": 2**-8}


def row_rel_err(got, want, by_element, floor=0.0):
    """The largest error of ``got`` against ``want`` relative to its own
    row's largest |want| (rows along the last dimension), that scale
    floored at ``floor`` times the largest |want| of all; or element by
    element relative to max(1, |want|)."""
    err, ref = (got.float() - want.float()).abs(), want.float().abs()
    if by_element:
        return float((err / ref.clamp_min(1.0)).max())
    low = max(1e-30, floor * float(ref.max()))
    return float((err.amax(-1) / ref.amax(-1).clamp_min(low)).max())


def flash_case(B, S, H, Hkv, D, dtype, device, seed):
    """q, k, v, dout ~ N(0, 1) on ``device`` from a seeded generator."""
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda h: torch.randn((B, S, h, D), generator=g,  # noqa: E731
                               device=device).to(dtype)
    return mk(H), mk(Hkv), mk(Hkv), mk(H)


def flash_cases(on_card):
    """(dtype, (B, S, H, Hkv, D), causal) of each phase-7 comparison: the
    slice's shapes (S=2048 causal and not, a ragged S=1000 causal) in
    bf16 and fp32, fp16 at S=2048 and S=1000 causal, and the other head
    dims of the tensor-core kernels (16, 32, 64) at a small ragged shape
    in bf16 and fp16. The CPU rehearsal shrinks B, S, H and D."""
    B, H, Hkv, D = (2, 32, 8, 128) if on_card else (1, 4, 2, 32)
    S2, S1, Ss = (2048, 1000, 300) if on_card else (128, 77, 40)
    bf16, fp16, fp32 = torch.bfloat16, torch.float16, torch.float32
    cases = [(dt, (B, S, H, Hkv, D), causal) for dt in (bf16, fp32)
             for S, causal in ((S2, True), (S2, False), (S1, True))]
    cases += [(fp16, (B, S, H, Hkv, D), True) for S in (S2, S1)]
    cases += [(dt, (1, Ss, 8, 2, d), True) for dt in (bf16, fp16)
              for d in (16, 32, 64)]
    return cases


def flash_bounds_ms(q, k, causal):
    """Least time for each kernel's work on this input: the larger of
    its flops at the input type's peak (score pairs of the causal
    triangle only, S(S+1)/2, when causal) and its bytes at 3.35 TB/s
    (each input read once, each output written once)."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    pairs = S * (S + 1) // 2 if causal else S * S
    elt = q.element_size()
    qb, kb, rows = B * S * H * D * elt, B * S * Hkv * D * elt, B * H * S * 4
    work = {"flash_fwd": (4 * B * H * D * pairs, 2 * qb + 2 * kb + rows),
            "flash_dq": (6 * B * H * D * pairs, 3 * qb + 2 * kb + 2 * rows),
            "flash_dkv": (8 * B * H * D * pairs, 2 * qb + 4 * kb + 2 * rows)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / H100_FLOPS[q.dtype]
        t_bytes = nbytes / H100_BYTES_PER_S
        out[name] = (1e3 * max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def phase_flash(on_card, seed):
    """Each FA2 kernel against its plain version (``flash_cases``): out
    and lse of the forward, then dq, dk and dv, within FLASH_TOL, and
    the bf16/fp16 out, lse, dq, dk and dv also within FLASH_ROW_TOL,
    with TF32 off; on the card each case also shows the route its
    launches took (tensor cores for bf16/fp16, CUDA cores for fp32). At
    B=2, S=2048, causal, D=128 two dQ and two dK/dV launches give
    bit-identical bf16 gradients (no atomics), and in each
    type every kernel is timed beside its bound, its plain version and
    SDPA (forward; backward alone, which computes dq, dk and dv
    together; forward + backward)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    device = "cuda" if on_card else "cpu"
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=device) \
        if on_card else None
    flush = (lambda: flush_buf.zero_()) if on_card else None
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    say("flash", tf32=False, tolerance=repr(FLASH_TOL_WHY),
        row_tolerance=json.dumps({str(t).replace("torch.", ""): v
                                  for t, v in FLASH_ROW_TOL.items()}),
        row_scale_floor=json.dumps(FLASH_ROW_FLOOR))
    out = {}
    for dtype, (B, S, H, Hkv, D), causal in flash_cases(on_card):
        name = str(dtype).replace("torch.", "")
        tol = FLASH_TOL[dtype]
        q, k, v, do = flash_case(B, S, H, Hkv, D, dtype, device, seed)
        fa.route_counts.clear()
        o, lse = fa._fwd(q, k, v, causal)
        dq, dk, dv = fa._bwd(q, k, v, o, lse, do, causal, None)
        sync()
        routes = dict(fa.route_counts)
        po, plse = fa.flash_fwd_reference(q, k, v, causal)
        pdq, pdk, pdv = fa.flash_bwd_reference(q, k, v, po, plse, do,
                                               causal)
        row_tol = FLASH_ROW_TOL.get(dtype, {})
        errs, row_errs = {}, {}
        for what, got, want in (("out", o, po), ("lse", lse, plse),
                                ("dq", dq, pdq), ("dk", dk, pdk),
                                ("dv", dv, pdv)):
            check(got.dtype == want.dtype and got.shape == want.shape,
                  f"{what}: type and shape of the plain version's")
            check(bool(torch.isfinite(got).all()), f"{what} is finite")
            err = float((got.float() - want.float()).abs().max())
            errs[what] = (err, max(1.0, float(want.float().abs().max())))
            if what in row_tol:
                row_errs[what] = row_rel_err(got, want, what == "lse",
                                             FLASH_ROW_FLOOR.get(what, 0.0))
        case = (f"{name} B={B} S={S} H={H} Hkv={Hkv} D={D} "
                f"causal={causal}")
        say("flash", dtype=name, B=B, S=S, H=H, Hkv=Hkv, D=D, causal=causal,
            tol=tol, routes=json.dumps(routes),
            **{f"{w}_max_abs_err": e for w, (e, _) in errs.items()},
            **{f"{w}_rel_err": e / sc for w, (e, sc) in errs.items()},
            **{f"{w}_row_rel_err": e for w, e in row_errs.items()})
        for what, (err, scale) in errs.items():
            check(err <= tol * scale, f"flash {what} {case}: max-abs {err} "
                  f"<= {tol} x {scale}")
        for what, err in row_errs.items():
            check(err <= row_tol[what], f"flash {what} {case}: "
                  f"row-relative {err} <= {row_tol[what]}")
        if on_card:
            way = fa.route("flash_fwd", dtype)
            want = {f"flash_fwd/{way}": 1, f"flash_dq/{way}": 1,
                    f"flash_dkv/{way}": 1}
            check(routes == want, f"flash routes {routes} == {want}")
        if not (on_card and S == 2048 and causal):
            continue
        delta = fa.flash_delta(o, do).contiguous()
        if dtype == torch.bfloat16:
            runs = [fa._dkv_kernel(q, k, v, do, lse, delta, True)
                    for _ in range(2)]
            same = all(torch.equal(a, b) for a, b in zip(*runs))
            same_dq = torch.equal(fa._dq_kernel(q, k, v, do, lse, delta, True),
                                  fa._dq_kernel(q, k, v, do, lse, delta, True))
            say("flash", name="flash_dkv", dtype=name, S=S,
                two_launches_bit_identical=same)
            say("flash", name="flash_dq", dtype=name, S=S,
                two_launches_bit_identical=same_dq)
            check(same, "two flash_dkv launches give bit-identical dk, dv")
            check(same_dq, "two flash_dq launches give bit-identical dq")
        calls = {
            "flash_fwd": lambda: fa._fwd(q, k, v, True),
            "flash_dq": lambda: fa._dq_kernel(q, k, v, do, lse, delta, True),
            "flash_dkv": lambda: fa._dkv_kernel(q, k, v, do, lse, delta,
                                                True)}
        plain_fwd = cuda_ms(lambda: fa.flash_fwd_reference(q, k, v, True),
                            iters=5, flush=flush)
        plain_bwd = cuda_ms(lambda: fa.flash_bwd_reference(
            q, k, v, po, plse, do, True), iters=5, flush=flush)
        lib_ms = sdpa_flash_ms(q, k, v, do, flush)
        bounds = flash_bounds_ms(q, k, True)
        main_err = {"flash_fwd": errs["out"][0], "flash_dq": errs["dq"][0],
                    "flash_dkv": max(errs["dk"][0], errs["dv"][0])}
        for kname, call in calls.items():
            ms = cuda_ms(call, flush=flush)
            bound_ms, bound_by = bounds[kname]
            plain_ms = plain_fwd if kname == "flash_fwd" else plain_bwd
            library_ms = lib_ms["fwd"] if kname == "flash_fwd" \
                else lib_ms["bwd"]
            say("flash", name=kname, dtype=name, route=fa.route(kname, dtype),
                S=S, causal=True, ms=ms, bound_ms=bound_ms,
                bound_by=bound_by, share_of_bound=bound_ms / ms,
                plain_ms=plain_ms, library_ms=library_ms,
                sdpa_fwd_bwd_ms=lib_ms["fwd_bwd"])
            out[(kname, name)] = dict(
                max_abs_err=main_err[kname], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)
    return out


def sdpa_flash_ms(q, k, v, do, flush):
    """PyTorch's scaled_dot_product_attention on the same inputs
    (causal, grouped), timed only: the forward, the backward alone
    (dq, dk and dv in one call) and the two together. The port never
    calls it."""
    F = torch.nn.functional
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    with torch.no_grad():
        fwd = cuda_ms(sdpa, flush=flush)
    o = sdpa()
    bwd = cuda_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot,
                                              retain_graph=True),
                  flush=flush)
    both = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot),
                   flush=flush)
    return {"fwd": fwd, "bwd": bwd, "fwd_bwd": both}


# -- phases 8 and 9: training -------------------------------------------------

def bench_batches(vocab, batch, seq, n, seed):
    """bench.py's batches: a noisy affine next-token process over at most
    256 ids (bench.py:1958-1966), from a numpy generator seeded with
    ``seed``."""
    rng = np.random.default_rng(seed)
    support = min(256, vocab)
    out = []
    for _ in range(n):
        toks = np.empty((batch, seq), dtype=np.int64)
        toks[:, 0] = rng.integers(0, support, batch)
        noise = rng.integers(-2, 3, size=(batch, seq - 1))
        for t in range(1, seq):
            toks[:, t] = (toks[:, t - 1] * 5 + 17 + noise[:, t - 1]) \
                % support
        out.append(toks)
    return out


TRAIN_GRAD_TOL = 1e-4
TRAIN_PARAM_TOL = 1e-3


def phase_train_small(on_card, seed):
    """The tiny preset in fp32 (4 layers, hidden 256, 8/4 heads of 32)
    on the card, through the kernels, and on the CPU, through the plain
    versions, from the same weights and batches (2 x 256 tokens; TF32
    off). The gradients of the first batch agree within TRAIN_GRAD_TOL
    = 1e-4 of each parameter's largest gradient (fp32 sums in other
    orders). Then 3 AdamW steps (lr 1e-3): the losses agree within 1e-4
    relative, and the parameters within TRAIN_PARAM_TOL = 1e-3, one
    step's lr: Adam divides m by sqrt(v), so a weight whose gradient is
    at the level of the fp32 noise moves by a part of lr that the noise
    decides (a tolerance of 1e-4 set before the first card run failed
    at 1.1e-4 while losses agreed to 7e-8)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_loss_fn
    from paddle_tpu_torch.optimizer import AdamW
    cpu_model = LlamaForCausalLM("tiny", device="cpu",
                                 generator=torch.Generator().manual_seed(seed))
    card_model = copy.deepcopy(cpu_model).to("cuda" if on_card else "cpu")
    batches = bench_batches(cpu_model.config.vocab_size, 2, 256, 3, seed)
    runs = []
    for model in (cpu_model, card_model):
        dev = model.embed_tokens.device
        b0 = torch.as_tensor(batches[0], device=dev)
        llama_loss_fn(model, b0, b0).backward()
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        step = TrainStep(model, AdamW(learning_rate=1e-3,
                                      parameters=model.named_parameters()),
                         llama_loss_fn)
        fa.launch_counts.clear()
        losses = [float(step(torch.as_tensor(b, device=dev),
                             torch.as_tensor(b, device=dev)))
                  for b in batches]
        runs.append((grads, losses, dict(fa.launch_counts)))
    (cpu_grads, cpu_losses, _), (card_grads, card_losses, launches) = runs
    gerr = {n: float((card_grads[n] - g).abs().max() / g.abs().max())
            for n, g in cpu_grads.items()}
    rel = max(abs(a - b) / abs(a) for a, b in zip(cpu_losses, card_losses))
    perr = {n: float((p.detach().cpu() - q.detach()).abs().max())
            for (n, p), q in zip(card_model.named_parameters(),
                                 cpu_model.parameters())}
    worst = max(perr, key=perr.get)
    layers = cpu_model.config.num_hidden_layers
    say("train_small", preset="tiny", dtype="float32", tf32=False,
        grad_max_rel_diff=max(gerr.values()),
        grad_worst=max(gerr, key=gerr.get), grad_tol=TRAIN_GRAD_TOL,
        card_losses=[round(x, 6) for x in card_losses],
        cpu_losses=[round(x, 6) for x in cpu_losses], loss_max_rel_diff=rel,
        param_max_abs_diff=perr[worst], param_worst=worst,
        param_tol=TRAIN_PARAM_TOL, launches=json.dumps(launches))
    check(all(np.isfinite(card_losses)), "tiny losses are finite")
    check(max(gerr.values()) <= TRAIN_GRAD_TOL,
          f"tiny first gradients agree: {gerr}")
    check(rel <= 1e-4, f"tiny losses agree: {rel} <= 1e-4 relative")
    check(perr[worst] <= TRAIN_PARAM_TOL,
          f"tiny parameters agree: {worst} {perr[worst]} <= "
          f"{TRAIN_PARAM_TOL}")
    if on_card:
        want = {"flash_fwd": layers * 3, "flash_dq": layers * 3,
                "flash_dkv": layers * 3}
        check(launches == want, f"tiny launches {launches} == {want}")


BENCH_CFG = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                 num_hidden_layers=2, num_attention_heads=32,
                 num_key_value_heads=8, max_position_embeddings=4096,
                 dtype="bfloat16", recompute=True,
                 recompute_granularity="core_attn")
TRAIN_LOSS_TOL = 2e-2


def phase_train(on_card, args):
    """bench.py's default train step (bench.py:1917-1930) through the
    port: llama3-8b layer width, 2 layers, vocab 32000, bf16 parameters,
    recompute "core_attn", batch 6 x 2048, AdamW(lr 1e-4,
    multi_precision=True), bench.py's batches from --seed. Before any
    update, the first batch's loss through the kernels is held against
    the loss through the plain attention on the same weights, within
    TRAIN_LOSS_TOL = 2e-2 absolute (bf16 activations over 2 random
    layers; the loss is about ln(32000) = 10.4). Then 1 warm-up step and
    10 timed steps with the launch counts zeroed just before: flash_fwd
    launched 2 x layers x steps times (core_attn recomputes the
    attention forward in the backward), flash_dq and flash_dkv layers x
    steps times, all three on the tensor-core route. The loss is finite
    and falls. The CPU rehearsal runs
    the debug preset's widths (batch 2 x 64, 3 steps)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import llama as ll
    from paddle_tpu_torch.optimizer import AdamW
    device = "cuda" if on_card else "cpu"
    if on_card:
        cfg = ll.LlamaConfig(**BENCH_CFG)
        batch, seq, iters = 6, 2048, 10
    else:
        cfg = ll.LlamaConfig(**{**ll.LLAMA_PRESETS["debug"],
                                "dtype": "bfloat16", "recompute": True,
                                "recompute_granularity": "core_attn"})
        batch, seq, iters = 2, 64, 3
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    model = ll.LlamaForCausalLM(
        cfg, device=device,
        generator=torch.Generator(device=device).manual_seed(args.seed))
    n_params = sum(p.numel() for p in model.parameters())
    n_embed = cfg.vocab_size * cfg.hidden_size
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                multi_precision=True)
    step = TrainStep(model, opt, ll.llama_loss_fn)
    batches = [torch.as_tensor(b, device=device) for b in bench_batches(
        cfg.vocab_size, batch, seq, iters + 1, args.seed)]
    sync()
    say("train", layers=cfg.num_hidden_layers, hidden=cfg.hidden_size,
        ff=cfg.intermediate_size, heads=cfg.num_attention_heads,
        kv_heads=cfg.num_key_value_heads, vocab=cfg.vocab_size,
        params=n_params, batch=batch, seq=seq, dtype=cfg.dtype,
        recompute=cfg.recompute_granularity,
        init_s=round(time.perf_counter() - t0, 3))

    first = batches[-1]
    plain = lambda q, k, v: fa.flash_fwd_reference(q, k, v, True)[0]  # noqa
    with torch.no_grad():
        weights = model.weights()
        lk = float(ll.cross_entropy(
            ll._llama_forward(cfg, *weights, first)[:, :-1].reshape(
                -1, cfg.vocab_size), first[:, 1:].reshape(-1)))
        lp = float(ll.cross_entropy(
            ll._llama_forward(cfg, *weights, first, attn=plain)[:, :-1]
            .reshape(-1, cfg.vocab_size), first[:, 1:].reshape(-1)))
    say("train", first_loss_kernels=lk, first_loss_plain=lp,
        abs_diff=abs(lk - lp), tol=TRAIN_LOSS_TOL)
    check(abs(lk - lp) <= TRAIN_LOSS_TOL,
          f"first loss through the kernels {lk} vs plain {lp}")
    del weights

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    loss_first = float(step(first, first))
    warm_s = time.perf_counter() - t
    fa.launch_counts.clear()
    fa.route_counts.clear()
    sync()
    t = time.perf_counter()
    for i in range(iters):
        loss = step(batches[i], batches[i])
    loss = float(loss)                        # a fetch: synced
    dt = time.perf_counter() - t
    launches = dict(fa.launch_counts)
    routes = dict(fa.route_counts)
    tokens_per_s = batch * seq * iters / dt
    mfu = 6.0 * (n_params - n_embed) * tokens_per_s / H100_FLOPS[
        torch.bfloat16]
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    say("train", steps=iters, wall_s=round(dt, 4),
        step_ms=round(1e3 * dt / iters, 3), warmup_s=round(warm_s, 3),
        tokens_per_s=round(tokens_per_s, 2), mfu=round(mfu, 4),
        loss_first=round(loss_first, 4), loss=round(loss, 4),
        peak_mem_gib=round(peak / 2 ** 30, 3), launches=json.dumps(launches),
        routes=json.dumps(routes))
    check(np.isfinite(loss_first) and np.isfinite(loss), "losses finite")
    check(loss < loss_first, f"the loss falls: {loss_first} -> {loss}")
    L = cfg.num_hidden_layers
    if on_card:
        want = {"flash_fwd": 2 * L * iters, "flash_dq": L * iters,
                "flash_dkv": L * iters}
        check(launches == want, f"training launches {launches} == {want}")
        want = {"flash_fwd/tensor_core": 2 * L * iters,
                "flash_dq/tensor_core": L * iters,
                "flash_dkv/tensor_core": L * iters}
        check(routes == want, f"training routes {routes} == {want}")
    if args.profile:
        profile_train_step(step, batches[0], on_card)
    return launches


def phase_profile(model, on_card, kv_dtype):
    """One decode_once of 4 rows (128-token prompts) with ``kv_dtype``
    pools under torch.profiler: host wall against summed device kernel
    time, the paged-decode kernels' device time and share of it (split
    pass and merge), and the kernels that take the most device time.
    Launches here come after the serving phases' counts were read."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference.serving import DecodeEngine
    eng = DecodeEngine(model, capacity=4, s_max=640, chunk=8,
                       block_size=16, kv_dtype=kv_dtype)
    rng = np.random.RandomState(1)
    for _ in range(4):
        eng.submit(rng.randint(1, model.config.vocab_size, (128,)), 24)
    eng.admit([])
    eng.decode_once()                       # warm
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        eng.decode_once()
        wall = time.perf_counter() - t
    kernels, dev_us, n = device_kernels(prof)
    paged = [e for e in kernels if "paged_decode" in e.key]
    paged_us = sum(e.self_device_time_total for e in paged)
    say("profile", kv_dtype=kv_dtype,
        decode_once_wall_ms=round(wall * 1e3, 3),
        device_kernel_ms=round(dev_us / 1e3, 3), kernel_launches=n,
        device_busy_share=round(dev_us / 1e6 / max(wall, 1e-9), 4),
        steps=eng.chunk, paged_decode_ms=round(paged_us / 1e3, 3),
        paged_decode_launches=sum(e.count for e in paged),
        paged_decode_share=round(paged_us / max(dev_us, 1e-9), 4))
    for e in kernels[:8]:
        say("profile", kv_dtype=kv_dtype, kernel=e.key[:60].replace(" ", "_"),
            count=e.count, device_ms=round(e.self_device_time_total / 1e3, 3))


def device_kernels(prof):
    """(device kernels by device time, most first; their summed device
    microseconds; their launch count) of a torch.profiler run."""
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return (kernels, sum(e.self_device_time_total for e in kernels),
            sum(e.count for e in kernels))


def profile_train_step(step, batch, on_card):
    """One train step of phase 9 under torch.profiler, after its counts
    were read: host wall against summed device kernel time, split into
    the FA2 kernels, cuBLAS's GEMMs (``nvjet``/``gemm`` kernels) and the
    rest, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        float(step(batch, batch))
        wall = time.perf_counter() - t
    kernels, dev_us, n = device_kernels(prof)
    flash_us = sum(e.self_device_time_total for e in kernels
                   if "flash_" in e.key)
    by_kernel = {n: round(sum(e.self_device_time_total for e in kernels
                              if f"{n}_" in e.key) / 1e3, 3)
                 for n in ("flash_fwd", "flash_dq", "flash_dkv")}
    gemm_us = sum(e.self_device_time_total for e in kernels
                  if "nvjet" in e.key or "gemm" in e.key.lower())
    say("profile", what="train_step", wall_ms=round(wall * 1e3, 3),
        device_kernel_ms=round(dev_us / 1e3, 3), kernel_launches=n,
        device_busy_share=round(dev_us / 1e6 / max(wall, 1e-9), 4),
        flash_kernels_ms=round(flash_us / 1e3, 3),
        flash_ms_by_kernel=json.dumps(by_kernel).replace(" ", ""),
        gemm_kernels_ms=round(gemm_us / 1e3, 3),
        other_kernels_ms=round((dev_us - flash_us - gemm_us) / 1e3, 3))
    for e in kernels[:12]:
        say("profile", what="train_step",
            kernel=e.key[:60].replace(" ", "_"), count=e.count,
            device_ms=round(e.self_device_time_total / 1e3, 3))


def ptxas_entries(log):
    """(kernel's mangled name, registers, spill bytes stored + loaded) of
    each entry function in an ``nvcc -Xptxas -v`` log."""
    out, entry, spills = [], "?", 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append((entry, int(m.group(1)), spills))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU with the plain versions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="after the serving phases, profile one "
                         "decode_once with fp and with int8 pools and "
                         "phase 10's replayed mixed step; after phase 9, "
                         "one train step")
    args = ap.parse_args()
    args.preset = "debug" if args.cpu else "llama3-8b"
    on_card = not args.cpu
    if on_card and not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs an NVIDIA card "
              "(--cpu rehearses on the CPU)", file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import _build
    if on_card:
        # fp32 products in full fp32: the plain versions and the fp32
        # training comparison hold the kernels' fp32 arithmetic
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(card_line(), flush=True)
        kind = torch.cuda.get_device_name(0)
        say("card", kind=kind, count=torch.cuda.device_count(),
            torch=torch.__version__, cuda=torch.version.cuda, tf32=False)
        names = ["paged_decode", "paged_decode_int8", "mixed_paged",
                 "flash_fwd", "flash_bwd"]
        t0 = time.perf_counter()
        _build.build_all(names)
        say("build", kernels=",".join(names),
            seconds=round(time.perf_counter() - t0, 3))
        for name in names:
            for entry, regs, spills in ptxas_entries(_build.build_log(name)):
                print(f"  ptxas {name}: {entry} registers={regs} "
                      f"spill_bytes={spills}")
                check(not (("_mma_kernel" in entry or "mixed_paged" in entry
                            or "paged_decode" in entry) and spills),
                      f"no spills in the tensor-core, mixed or "
                      f"paged-decode kernel {entry}")
    kernels = phase_kernels(on_card, args.seed)
    kernels_int8 = phase_kernels_int8(on_card, args.seed)
    kernels_mixed = phase_kernels_mixed(on_card, args.seed)
    phase_small_reference(on_card, args.seed)
    launches, model = phase_main(on_card, args)
    gc.collect()                # phase 4's engine and replay copies
    if on_card:
        torch.cuda.empty_cache()
    launches_int8 = phase_int8_chunked(on_card, model, args)
    phase_spec(on_card, model, args)
    launches_mesh = phase_mesh(on_card, model, args)
    phase_mesh_small(on_card, args.seed)
    if args.profile:
        for kv_dtype in ("fp", "int8"):
            phase_profile(model, on_card, kv_dtype)
    del model                   # the training phases need the memory
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    flash = phase_flash(on_card, args.seed)
    phase_train_small(on_card, args.seed)
    launches_train = phase_train(on_card, args)
    if not on_card:
        print("CPU rehearsal passed (plain versions; no result off the "
              "card)")
        return 0
    src = "paddle_tpu_torch/kernels/csrc/"
    lines = [dict(name="paged_decode", route="cuda",
                  source=src + "paged_decode.cu",
                  replaces="paddle_tpu/kernels/paged_attention.py:95",
                  launches=launches.get("paged_decode", 0),
                  **kernels["bfloat16"]),
             dict(name="paged_decode_int8", route="cuda",
                  source=src + "paged_decode_int8.cu",
                  replaces="paddle_tpu/kernels/paged_attention.py:186",
                  launches=launches_int8.get("paged_decode_int8", 0),
                  **kernels_int8[("bfloat16", 16)]),
             dict(name="mixed_paged", route="cuda",
                  source=src + "mixed_paged.cu",
                  replaces="paddle_tpu/kernels/paged_attention.py:468",
                  launches=launches_mesh.get("mixed_paged", 0),
                  **kernels_mixed[("bfloat16", 128)])]
    for name, source, line in (("flash_fwd", "flash_fwd.cu", 48),
                               ("flash_dq", "flash_bwd.cu", 530),
                               ("flash_dkv", "flash_bwd.cu", 1021)):
        lines.append(dict(
            name=name, route="cuda", source=src + source,
            replaces=f"paddle_tpu/kernels/flash_attention.py:{line}",
            launches=launches_train.get(name, 0),
            **flash[(name, "bfloat16")]))
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
