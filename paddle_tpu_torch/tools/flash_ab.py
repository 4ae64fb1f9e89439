"""Time the flash-attention kernels of one checkout, for A/B comparisons
of two checkouts on one card.

Usage, on the machine with the card, from any directory::

    python3 paddle_tpu_torch/tools/flash_ab.py PATH_TO_CHECKOUT

It builds that checkout's ``flash_attention`` and ``flash_mask``
sources and prints, for each kernel of the bf16 K1/K2 entries, its
ptxas lines (registers, shared memory, spills) and its SASS counts of
``HGMMA`` (wgmma), ``UTMALDG`` (TMA loads), ``HMMA`` (mma.sync), shared
and local loads and stores (with ``cuobjdump`` from the CUDA toolkit).
Then one JSON line per row of ``chip_smoke.py``'s ``FLASH_SHAPES``
(bf16, causal) with the mean CUDA-event milliseconds of the K1 forward
and the K2 dq and dk/dv kernels, each kernel's bound (the larger of its
bytes over 3.35 TB/s and its operations over 989 TFLOP/s) and share of
it, and the forward and forward + backward of one
``scaled_dot_product_attention`` call as a yardstick; and one line with
the K8 forward at the serving 2048 bucket (h 32/8, 1900 real tokens),
the witness that K8 did not move.  The shapes come from the
``chip_smoke.py`` beside this tool, so both checkouts of an A/B run
the same rows.  Run two checkouts in turns in one call (parent,
change, change, parent): two calls may land on two cards.
"""
from __future__ import annotations

import collections
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "LDS", "STS", "LDL", "STL", "MUFU")


def cuda_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_lines(log):
    """{function: [its register, shared-memory and spill lines]}."""
    out, fn = collections.defaultdict(list), None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^' ]+)", line)
        if m:
            fn = m.group(1)
        elif fn and re.search(r"registers|spill|smem", line):
            out[fn].append(line.split(":", 1)[-1].strip())
    return out


def sass_counts(lib):
    """{function: {opcode: count}} of every kernel in ``lib``, or {}
    without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts = collections.defaultdict(collections.Counter)
    fn = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and fn:
            counts[fn][m.group(1).split(".")[0]] += 1
    return counts


def bf16_k12(name):
    """Whether a kernel name is one of the bf16 K1/K2 kernels: the sm90
    ones, or the WMMA bodies' bfloat16 instances of an older checkout."""
    return "flash_sm90" in name or "nv_bfloat16" in name


def main(root):
    tool_root = str(Path(__file__).resolve().parents[2])
    sys.path.insert(0, tool_root)
    from chip_smoke import FLASH_SHAPES, bound, visible_pairs
    sys.path.remove(tool_root)
    sys.path.insert(0, root)
    import torch
    from paddle_tpu_torch.ops import cuda_lib
    from paddle_tpu_torch.ops.pallas import flash_attention as FA
    from paddle_tpu_torch.ops.pallas import flash_mask as FM
    assert cuda_lib.__file__.startswith(root), cuda_lib.__file__

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print("checkout", root, "|", smi, flush=True)
    cuda_lib.build(("flash_attention", "flash_mask"))
    lines = ptxas_lines(cuda_lib.build_log["flash_attention"])
    sass = sass_counts(str(cuda_lib.BUILD_DIR / "libflash_attention.so"))
    for fn in sorted(set(lines) | set(sass)):
        if bf16_k12(fn):
            print("KERNEL", fn, lines.get(fn), {
                op: sass.get(fn, {}).get(op, 0) for op in SASS_OPS},
                flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    dt, d = torch.bfloat16, 128
    scale = 1 / math.sqrt(d)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def bhsd(b, s, h):
        return torch.randn(b, s, h, d, device="cuda",
                           generator=gen).to(dt).transpose(1, 2)

    for name, B, H, kvh, sq, sk in FLASH_SHAPES:
        q, k, v, do = bhsd(B, sq, H), bhsd(B, sk, kvh), bhsd(B, sk, kvh), \
            bhsd(B, sq, H)
        out, lse = FA._flash_fwd(q, k, v, True, scale)
        _, delta = FA._flash_bwd_dq(q, k, v, out, lse, do, True, scale)
        ms = {"fwd": cuda_ms(torch, lambda: FA._flash_fwd(q, k, v, True,
                                                          scale)),
              "dq": cuda_ms(torch, lambda: FA._flash_bwd_dq(
                  q, k, v, out, lse, do, True, scale)),
              "dkv": cuda_ms(torch, lambda: FA._flash_bwd_dkv(
                  q, k, v, lse, delta, do, True, scale))}
        pairs = visible_pairs(sq, sk) * B * H
        n_q, n_kv, rows = B * H * sq * d, B * kvh * sk * d, B * H * sq * 4
        bounds = {
            "fwd": bound((2 * n_q + 2 * n_kv) * 2 + rows, 4 * pairs * d),
            "dq": bound((4 * n_q + 2 * n_kv) * 2 + 2 * rows, 6 * pairs * d),
            "dkv": bound((2 * n_q + 4 * n_kv) * 2 + 2 * rows, 8 * pairs * d)}
        mask = None if sq == sk else torch.ones(
            sq, sk, dtype=torch.bool, device="cuda").tril(sk - sq)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]

        def lib_fwd_bwd():
            o = sdpa(*leaves, attn_mask=mask, is_causal=mask is None,
                     scale=scale, enable_gqa=kvh != H)
            torch.autograd.grad(o, leaves, do)

        library = {
            "fwd": cuda_ms(torch, lambda: sdpa(
                q, k, v, attn_mask=mask, is_causal=mask is None, scale=scale,
                enable_gqa=kvh != H)),
            "fwd_bwd": cuda_ms(torch, lib_fwd_bwd)}
        print(json.dumps({
            "checkout": root, "shape": name, "ms": ms,
            "bound_ms": {key: b[0] for key, b in bounds.items()},
            "bound_by": {key: b[1] for key, b in bounds.items()},
            "share_of_bound": {key: bounds[key][0] / ms[key] for key in ms},
            "sdpa_ms": library}), flush=True)
        del q, k, v, do, out, lse, delta, leaves

    qh, kh, vh = bhsd(1, 2048, 32), bhsd(1, 2048, 8), bhsd(1, 2048, 8)
    vecs = FM.padding_mask_to_intervals(
        torch.arange(2048, device="cuda")[None] < 1900, 2048)
    print(json.dumps({"checkout": root, "k8_fwd_2048": cuda_ms(
        torch, lambda: FM.flash_mha_masked(qh, kh, vh, vecs, True,
                                           scale))}), flush=True)


if __name__ == "__main__":
    main(os.path.abspath(sys.argv[1]))
