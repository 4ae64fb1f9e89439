"""Time the flash-attention kernels of one checkout, for A/B comparisons
of two checkouts on one card.

Usage, on the machine with the card, from any directory::

    python3 paddle_tpu_torch/tools/flash_ab.py PATH_TO_CHECKOUT

It builds that checkout's ``flash_attention`` and ``flash_mask``
sources, prints each kernel's ptxas register and spill lines, and one
JSON line of mean CUDA-event milliseconds: the K1 forward and the K2 dq
and dk/dv kernels at the training shape (b 8, h 16, s 2048, d 128,
bf16, causal) and the K8 forward at the serving 2048 bucket (h 32/8,
1900 real tokens).  With ``cuobjdump`` in the CUDA toolkit it also
prints the SASS opcode counts of the bf16 K2 dq kernel.  Run two
checkouts in turns in one call (parent, change, change, parent): two
calls may land on two cards.
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


def sass_counts(lib, match):
    """Opcode counts of the functions in ``lib`` whose names contain every
    string of ``match``, or {} without cuobjdump."""
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
        if m and fn and all(s in fn for s in match):
            counts[fn][m.group(1).split(".")[0]] += 1
    return {name: dict(c) for name, c in counts.items()}


def main(root):
    sys.path.insert(0, root)
    import torch
    from paddle_tpu_torch.ops import cuda_lib
    from paddle_tpu_torch.ops.pallas import flash_attention as FA
    from paddle_tpu_torch.ops.pallas import flash_mask as FM

    cuda_lib.build(("flash_attention", "flash_mask"))
    for name in ("flash_attention", "flash_mask"):
        print(name, [line.strip() for line in cuda_lib.build_log[name]
                     .splitlines() if "registers" in line or "spill" in line])
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt, d = torch.bfloat16, 128
    scale = 1 / math.sqrt(d)

    def bhsd(b, s, h):
        return torch.randn(b, s, h, d, device="cuda",
                           generator=gen).to(dt).transpose(1, 2)

    q, k, v, do = (bhsd(8, 2048, 16) for _ in range(4))
    out, lse = FA._flash_fwd(q, k, v, True, scale)
    _, delta = FA._flash_bwd_dq(q, k, v, out, lse, do, True, scale)
    res = {"checkout": root,
           "k1_fwd": cuda_ms(torch, lambda: FA._flash_fwd(q, k, v, True,
                                                          scale)),
           "k2_dq": cuda_ms(torch, lambda: FA._flash_bwd_dq(
               q, k, v, out, lse, do, True, scale)),
           "k2_dkv": cuda_ms(torch, lambda: FA._flash_bwd_dkv(
               q, k, v, lse, delta, do, True, scale))}
    qh, kh, vh = bhsd(1, 2048, 32), bhsd(1, 2048, 8), bhsd(1, 2048, 8)
    vecs = FM.padding_mask_to_intervals(
        torch.arange(2048, device="cuda")[None] < 1900, 2048)
    res["k8_fwd_2048"] = cuda_ms(torch, lambda: FM.flash_mha_masked(
        qh, kh, vh, vecs, True, scale))
    print(json.dumps(res), flush=True)
    lib = str(cuda_lib.BUILD_DIR / "libflash_attention.so")
    for name, counts in sass_counts(lib, ("dq_kernel", "bfloat16")).items():
        print("SASS", name[:60], sum(counts.values()), {
            op: counts.get(op, 0) for op in ("HMMA", "LDS", "STS", "MUFU",
                                              "LDL", "STL", "FFMA", "FSEL")})


if __name__ == "__main__":
    main(os.path.abspath(sys.argv[1]))
