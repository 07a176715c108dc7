#!/usr/bin/env python3
"""Times the paged-decode kernels of this checkout beside the same
kernels built from another copy of their sources, in one process on one
NVIDIA card, at chip_smoke.py's phase-2 shapes (B=4, kvh=8, G=4,
hd=128, rows of 1, 1999, 512 and 0 keys).

    python3 paged_decode_ab.py --baseline DIR [--baseline DIR2 ...]

Each DIR holds ``paged_decode.cu`` and ``paged_decode_int8.cu`` of
another version, with the headers they include, for example extracted
with ``git show <commit>:paddle_tpu_torch/kernels/csrc/<file>``. Each is
compiled with this checkout's nvcc flags into ``build/baseline/<DIR's
name>/`` (ignored by git) and bound by its exported function's
parameters: with a ``long long`` workspace size the call gets a
workspace of this checkout's size (and, with an ``unsigned*``, zeroed
split counters), without one it gets none.

First this checkout's kernels pass chip_smoke.py's phase 2 for the
paged-decode kernels (every check, every type and block size). Then,
for each case, the versions run in mirrored turns (the baselines in
order, this checkout twice, the baselines in reverse), each turn 20
launches after a flush of the L2 cache, event-timed (median ms), then
20 more under torch.profiler: the device-only ms of the kernels whose
name holds "paged_decode", per launch and by kernel. The
plain version's and gather + SDPA's ms and the bound are taken once per
case in the same process. Last, every version again after a flush that
only reads (the L2 is evicted but left clean, where the zeroing flush
leaves it full of lines to write back) and with no flush at all. The
card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs


def build_baseline(src_dir: Path, name: str, fn_name: str):
    """Compile DIR/<name>.cu into build/baseline/<DIR's name>/ and bind
    its C entry; returns (the function, whether it takes a workspace,
    whether it takes split counters)."""
    from paddle_tpu_torch.kernels import _build
    src = src_dir / f"{name}.cu"
    text = src.read_text()
    m = re.search(rf'extern "C" int {fn_name}\(([^)]*)\)', text)
    if m is None:
        raise RuntimeError(f"{src}: no exported {fn_name}")
    params = [p.strip() for p in m.group(1).split(",")]
    takes_ws = any(p.startswith("long long") for p in params)
    takes_cnt = any(p.startswith("unsigned*") for p in params)
    out = _build.BUILD_DIR.parent / "baseline" / src_dir.name \
        / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                           "-I", str(src_dir), "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    fn = getattr(ctypes.CDLL(str(out)), fn_name)
    n_ptr = len(params) - 9 - takes_ws   # 7 ints, the scale, the stream
    fn.argtypes = [ctypes.c_void_p] * n_ptr \
        + [ctypes.c_longlong] * takes_ws + [ctypes.c_int] * 7 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, takes_ws, takes_cnt


_zeros: dict = {}


def _counters(device, n):
    """Zeroed split counters for a baseline that takes them (its launches
    leave them zero again), kept from call to call."""
    buf = _zeros.get(device)
    if buf is None or buf.numel() < n:
        buf = _zeros[device] = torch.zeros((n,), dtype=torch.int32,
                                           device=device)
    return buf


def baseline_launch(fn, takes_ws, takes_cnt, q, kp, vp, table, lens,
                    kv_scales=None):
    """One call of a baseline entry on the current stream, with a
    workspace of this checkout's size and split counters where it takes
    them."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import paged_attention as pa
    B, kvh, G, hd = q.shape
    bs, mb = kp.shape[1], table.shape[1]
    out = torch.empty((B, kvh, G, hd), dtype=torch.float32, device=q.device)
    ptrs = [q, kp, vp, *(kv_scales or ()), table, lens, out]
    ws_args = ()
    if takes_ws:
        n_ws = pa.decode_workspace_floats(B, kvh, G, hd, mb, bs)
        ptrs.append(torch.empty((n_ws,), dtype=torch.float32,
                                device=q.device))
        ws_args = (n_ws,)
    if takes_cnt:
        ptrs.append(_counters(q.device, B * kvh))
    err = fn(*(a.data_ptr() for a in ptrs), *ws_args, B, kvh, G, hd, bs, mb,
             _build.DTYPE_CODE[str(q.dtype)], 1.0 / hd ** 0.5,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"baseline launch failed: {err}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True,
                    action="append",
                    help="directory with another version's "
                         "paged_decode.cu and paged_decode_int8.cu "
                         "(repeatable)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: paged_decode_ab.py needs an NVIDIA card",
              file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import paged_attention as pa
    print(cs.card_line(), flush=True)
    _build.build_all(["paged_decode", "paged_decode_int8"])
    for name in ("paged_decode", "paged_decode_int8"):
        for entry, regs, spills in cs.ptxas_entries(_build.build_log(name)):
            print(f"  ptxas {name}: {entry} registers={regs} "
                  f"spill_bytes={spills}")
            cs.check(not spills, f"no spills in {entry}")
    cs.phase_kernels(True, args.seed)
    cs.phase_kernels_int8(True, args.seed)
    olds = {d.name: (build_baseline(d, "paged_decode",
                                    "paged_decode_attention"),
                     build_baseline(d, "paged_decode_int8",
                                    "paged_decode_int8_attention"))
            for d in args.baseline}
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    read_flush = flush_buf.max         # evicts the L2 and leaves it clean
    cases = [("paged_decode", dt, 16) for dt in
             (torch.bfloat16, torch.float16, torch.float32)]
    cases += [("paged_decode_int8", dt, bs) for bs in (16, 32)
              for dt in (torch.bfloat16, torch.float32)]
    for kernel, dtype, bs in cases:
        name = str(dtype).replace("torch.", "")
        int8 = kernel == "paged_decode_int8"
        if not int8:
            a = cs.paged_case(dtype, "cuda", args.seed)
            kv = None
            plain = lambda: pa.paged_attn_reference(*a)         # noqa: E731
            library = lambda: cs.sdpa_yardstick(*a)             # noqa: E731
            bound = cs.paged_bound_ms(a[0], a[1], a[3], a[4])
        else:
            a, kv = cs.paged_int8_case(dtype, "cuda", args.seed, bs)
            plain = lambda: pa.paged_attn_reference_int8(*a, kv)  # noqa
            library = lambda: cs.sdpa_int8_yardstick(*a, kv)    # noqa: E731
            bound = cs.paged_int8_bound_ms(a[0], a[3], a[4], bs)
        versions = {"this": lambda: pa.paged_decode_attention(
            *a, kv_scales=kv)}
        for d, built in olds.items():
            versions[d] = (lambda b=built[int8]:
                           baseline_launch(*b, *a, kv))
        want = versions["this"]()
        errs = {v: float((fn() - want).abs().max())
                for v, fn in versions.items()}
        cs.check(max(errs.values()) <= 1e-4,
                 f"{kernel} {name}: the versions agree ({errs})")
        case = dict(kernel=kernel, dtype=name, bs=bs)
        order = list(olds) + ["this", "this"] + list(reversed(olds))
        runs = {v: [] for v in versions}
        for turn, v in enumerate(order):
            ms = cs.cuda_ms(versions[v], flush=flush)
            dev_ms, by_kernel, _ = cs.device_ms(versions[v], "paged_decode",
                                                flush=flush)
            runs[v].append((ms, dev_ms))
            cs.say("ab", **case, version=v, turn=turn, ms=ms,
                   device_ms=dev_ms,
                   device_ms_by_kernel=json.dumps(by_kernel).replace(" ",
                                                                     ""))
        for mode, fl in (("read", read_flush), ("none", None)):
            for v, fn_ in versions.items():
                dev_ms, by_kernel, _ = cs.device_ms(fn_, "paged_decode",
                                                    flush=fl)
                cs.say("ab", **case, version=v, l2_flush=mode,
                       ms=cs.cuda_ms(fn_, flush=fl), device_ms=dev_ms,
                       device_ms_by_kernel=json.dumps(by_kernel).replace(
                           " ", ""))
        cs.say("ab", **case,
               ms=json.dumps({v: [r[0] for r in x] for v, x in runs.items()}
                             ).replace(" ", ""),
               device_ms=json.dumps({v: [r[1] for r in x]
                                     for v, x in runs.items()}
                                    ).replace(" ", ""),
               plain_ms=cs.cuda_ms(plain, flush=flush),
               library_ms=cs.cuda_ms(library, flush=flush),
               bound_ms=bound[0], bound_by=bound[1],
               versions_max_abs_diff=json.dumps(errs).replace(" ", ""))
    print("paged_decode_ab: done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
