"""Time the attention, GEMV, gather-LoRA and grouped-FFN kernels of one
checkout, for A/B comparisons of two checkouts on one card.

Usage, on the machine with the card, from any directory::

    python3 paddle_tpu_torch/tools/flash_ab.py PATH_TO_CHECKOUT [PARTS]

PARTS is a comma-separated subset of
``flash,k8,small,longctx,k7,dbias,decode,k3,k4,serve,k5,k9,moe``
(default: all of them); the kernel lines below are printed always.

It builds that checkout's ``flash_attention``, ``flash_mask``,
``decode_attention``, ``paged_attention``, ``quant_matmul``,
``lora_matmul`` and ``grouped_ffn`` sources and prints, for each bf16
kernel of them (K1/K2, the K8 kernels, K7, K3, K4, K5, K9), its ptxas
lines (registers, shared memory,
spills) and its SASS counts of ``HGMMA`` (wgmma), ``UTMALDG`` (TMA
loads), ``UTMASTG`` (TMA stores), ``HMMA`` (mma.sync), shared and local
loads and stores (with ``cuobjdump`` from the CUDA toolkit) and a digest
of its instructions.  Part ``k7`` prints one line per row of
``chip_smoke.py``'s ``K7_SHAPES`` (the decode attention's device ms by
``torch.profiler`` and CUDA-event ms, its bound and
``scaled_dot_product_attention``'s device ms with the bool mask; a row
the checkout's kernel does not take prints the error); part ``dbias``
the K8 dbias at ``alibi_bias`` and at 10d's shape (b 1, h 16, s 8192)
on an out, lse and delta the tool computes in f32, beside its bound and
one forward + backward of ``scaled_dot_product_attention`` with the
bias's gradient; part ``decode`` runs ``chip_smoke.py``'s 11c (llama3_8b
``generate`` at 8 x 8064 + 128, K7 on and off, paged) and a profile of
one of its decode steps with K7 on.  Part ``k3`` prints one line per row
of ``chip_smoke.py``'s ``PAGED_SHAPES`` (the paged attention's device ms
and CUDA-event ms, its bound, and K7's device ms on the same keys in a
dense cache, where K7 takes the head dim; a row the checkout's kernel
does not take prints the error); part ``k4`` one line per phase-3 K4
shape, int8 and int4 (device ms, the bound, a dense bf16
``torch.matmul`` of the same shape and ``torch._weight_int8pack_mm``);
part ``serve`` a profile of phase 4's decode step (llama3_8b, 8 slots,
pages of 64): K3's device ms per step and the device's busy share.
Part ``k5`` prints one line per ``PROJ_SHAPES`` row of phase 3's
gather-LoRA record (8 slots, rank 16, a 5-row f32 bank, bf16 x: the
kernels' device ms, their bound and the plain version's device ms);
part ``k9`` one line per ``K9_SHAPES`` row (the grouped FFN's forward
and backward device ms, their bounds and the sort path's two expert
einsums, forward and forward + backward, as the cuBLAS yardstick), then
``chip_smoke.py``'s 13b (one MoE layer, fwd + bwd device ms by dispatch
mode) on the checkout's kernels; part ``moe`` runs ``chip_smoke.py``'s
13a twice (the bench's MoE rung through the checkout's ``moe_llm``:
tokens/s and a profiled step's busy share).
Part ``flash`` prints one JSON line
per row of
``chip_smoke.py``'s
``FLASH_SHAPES`` (bf16, causal) with the mean CUDA-event milliseconds of
the K1 forward and the K2 dq and dk/dv kernels, each kernel's bound (the
larger of its bytes over 3.35 TB/s and its operations over 989 TFLOP/s)
and share of it, and the forward and forward + backward of one
``scaled_dot_product_attention`` call as a yardstick (the rows at head
dims 64 and 256 too; a row the checkout's kernels do not take prints the
error); then one line per
K8 forward row: the serving prefill buckets ``serve_2048``,
``long_decode``, ``bench_paged`` and ``tinyllama_2048`` (head_dim 64) of
``MASKED_SHAPES`` (no lse, as
serving runs it), every ``K8_SHAPES`` row but ``sft_padding``
and ``window_8192`` (with lse, as training runs it; the last beside K1
at its shape without the mask), and the K8 dq and dk/dv at every
``K8_SHAPES`` row and ``window_8192`` (the backward kernels, on an out,
lse and delta that the tool computes in f32, the same for every
checkout; beside one forward + backward of
``scaled_dot_product_attention`` with the dense mask or bias, and at
``window_8192`` beside K2's dq and dk/dv at its shape without the
mask); at the small prefills ``serve_512`` and ``bench_decode``, the
CUDA-event time of the K8 forward and of the
``scaled_dot_product_attention`` call beside their device time
(``torch.profiler``, per kernel); last, ``chip_smoke.py``'s phases
10b-10d (the long-context masked, windowed and ALiBi training calls at s
8192) on the checkout's kernels, with where each call's device time goes
per K8 kernel.  The shapes come from the ``chip_smoke.py`` beside this tool, so
both checkouts of an A/B run the same rows.  Run two checkouts in turns
in one call (parent, change, change, parent): two calls may land on two
cards.
"""
from __future__ import annotations

import collections
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG", "HMMA", "LDS", "STS", "LDL",
            "STL", "MUFU")
PARTS = ("flash", "k8", "small", "longctx", "k7", "dbias", "decode", "k3",
         "k4", "serve", "k5", "k9", "moe")


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
    """{function: {opcode: count, "sass_sha1": digest}} of every kernel
    in ``lib`` (the digest of its instructions without addresses: two
    builds of one kernel agree on it exactly when their SASS is the
    same), or {} without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts = collections.defaultdict(collections.Counter)
    digests = collections.defaultdict(hashlib.sha1)
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
            ins = re.search(r"/\*[0-9a-f]{4}\*/\s+(.*?);", line)
            digests[fn].update(" ".join(ins.group(1).split()).encode())
    for fn, digest in digests.items():
        counts[fn]["sass_sha1"] = digest.hexdigest()[:16]
    return counts


def bf16_kernel(name):
    """Whether a kernel name is a bf16 kernel of the port: a
    flash_sm90.cuh instance, K7's decode_mma_kernel, K3's
    paged_mma_kernel, K4's wo_mma_kernel, a K9 kernel of grouped_ffn.cu's
    namespace sm90, or a bfloat16 instance of the CUDA-core bodies."""
    return any(mark in name for mark in ("flash_sm90", "nv_bfloat16",
                                         "decode_mma", "paged_mma",
                                         "wo_mma", "4sm90"))


def main(root, parts=PARTS):
    tool_root = str(Path(__file__).resolve().parents[2])
    sys.path.insert(0, tool_root)
    from chip_smoke import (FLASH_SHAPES, K7_SHAPES, K8_SHAPES,
                            LONGCTX_SEQ, MASKED_SHAPES, PAGED_SHAPES,
                            WINDOW_SHAPE, alibi_bias, bias_read_bytes, bound,
                            k8_operands, phase_longctx_bias,
                            phase_longctx_masked, phase_longctx_window,
                            release, visible_pairs, window_intervals)
    sys.path.remove(tool_root)
    sys.path.insert(0, root)
    import torch
    from paddle_tpu_torch.ops import cuda_lib
    from paddle_tpu_torch.ops.pallas import decode_attention as DA
    from paddle_tpu_torch.ops.pallas import flash_attention as FA
    from paddle_tpu_torch.ops.pallas import flash_mask as FM
    assert cuda_lib.__file__.startswith(root), cuda_lib.__file__

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print("checkout", root, "|", smi, flush=True)
    srcs = ("flash_attention", "flash_mask", "decode_attention",
            "paged_attention", "quant_matmul", "lora_matmul", "grouped_ffn")
    cuda_lib.build(srcs)
    for src in srcs:
        lines = ptxas_lines(cuda_lib.build_log[src])
        sass = sass_counts(str(cuda_lib.BUILD_DIR / f"lib{src}.so"))
        for fn in sorted(set(lines) | set(sass)):
            if bf16_kernel(fn):
                print("KERNEL", src, fn, lines.get(fn), {
                    op: sass.get(fn, {}).get(op, 0)
                    for op in (*SASS_OPS, "sass_sha1")}, flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16
    scale = 1 / math.sqrt(128)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def bhsd(b, s, h, d=128):
        return torch.randn(b, s, h, d, device="cuda",
                           generator=gen).to(dt).transpose(1, 2)

    if "k5" in parts:
        k5_rows(torch, root, gen)
    if "k9" in parts:
        k9_rows(torch, root, gen, release)
    if "moe" in parts:
        moe_train(release)
    if "k7" in parts:
        k7_rows(torch, DA, root, gen, K7_SHAPES, bound)
    if "k3" in parts:
        k3_rows(torch, DA, root, gen, PAGED_SHAPES)
    if "k4" in parts:
        k4_rows(torch, root, gen)
    if "serve" in parts:
        serve_profile(torch, release)
    if "dbias" in parts:
        dbias_rows(torch, FM, root, bhsd, K8_SHAPES, LONGCTX_SEQ,
                   alibi_bias, bias_read_bytes, bound, visible_pairs, scale,
                   sdpa)
    for name, B, H, kvh, sq, sk, d in (FLASH_SHAPES if "flash" in parts
                                       else ()):
        q, k, v, do = bhsd(B, sq, H, d), bhsd(B, sk, kvh, d), \
            bhsd(B, sk, kvh, d), bhsd(B, sq, H, d)
        sm = 1 / math.sqrt(d)
        try:
            out, lse = FA._flash_fwd(q, k, v, True, sm)
            _, delta = FA._flash_bwd_dq(q, k, v, out, lse, do, True, sm)
        except (ValueError, NotImplementedError) as e:   # not built there
            print(json.dumps({"checkout": root, "shape": name,
                              "error": str(e)}), flush=True)
            continue
        ms = {"fwd": cuda_ms(torch, lambda: FA._flash_fwd(q, k, v, True,
                                                          sm)),
              "dq": cuda_ms(torch, lambda: FA._flash_bwd_dq(
                  q, k, v, out, lse, do, True, sm)),
              "dkv": cuda_ms(torch, lambda: FA._flash_bwd_dkv(
                  q, k, v, lse, delta, do, True, sm))}
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
                     scale=sm, enable_gqa=kvh != H)
            torch.autograd.grad(o, leaves, do)

        library = {
            "fwd": cuda_ms(torch, lambda: sdpa(
                q, k, v, attn_mask=mask, is_causal=mask is None, scale=sm,
                enable_gqa=kvh != H)),
            "fwd_bwd": cuda_ms(torch, lib_fwd_bwd)}
        print(json.dumps({
            "checkout": root, "shape": name, "ms": ms,
            "bound_ms": {key: b[0] for key, b in bounds.items()},
            "bound_by": {key: b[1] for key, b in bounds.items()},
            "share_of_bound": {key: bounds[key][0] / ms[key] for key in ms},
            "sdpa_ms": library}), flush=True)
        del q, k, v, do, out, lse, delta, leaves

    def k8_row(name, fn, **extra):
        try:
            row = {"ms": cuda_ms(torch, fn)}
        except (ValueError, NotImplementedError) as e:   # not built there
            row = {"error": str(e)}
        print(json.dumps({"checkout": root, "k8": name, **row, **extra}),
              flush=True)

    masked = {row[0]: row for row in MASKED_SHAPES}
    for name in (("serve_2048", "long_decode", "bench_paged",
                  "tinyllama_2048") if "k8" in parts else ()):
        _, B, H, kvh, S, lengths, _, d = masked[name]
        q, k, v = bhsd(B, S, H, d), bhsd(B, S, kvh, d), bhsd(B, S, kvh, d)
        keep = (torch.arange(S, device="cuda")[None]
                < torch.tensor(lengths, device="cuda")[:, None])
        vecs = FM.padding_mask_to_intervals(keep, S)
        k8_row(name, lambda: FM.flash_mha_masked(q, k, v, vecs, True,
                                                 1 / math.sqrt(d)))
        del q, k, v
    def k8_backward(name, q, k, v, do, vecs, bias, causal, **extra):
        """The K8 dq and dk/dv rows of one shape, on the f32-made out,
        lse and delta, with the library's forward + backward beside."""
        sm = 1 / math.sqrt(q.shape[-1])
        args = (vecs, bias, causal, sm)
        out, lse, delta = plain_forward(torch, q, k, v, do, vecs, bias,
                                        causal, sm, FM.LSE_INVALID)
        lib = sdpa_fwd_bwd_ms(torch, sdpa, FM, q, k, v, do, vecs, bias,
                              causal, sm)
        k8_row(f"{name}_dq", lambda: FM._masked_bwd_dq(
            q, k, v, out, lse, do, *args), sdpa_fwd_bwd_ms=lib, **extra)
        k8_row(f"{name}_dkv", lambda: FM._masked_bwd_dkv(
            q, k, v, lse, delta, do, *args), sdpa_fwd_bwd_ms=lib, **extra)

    for name, B, H, kvh, S, causal, kind, d in (K8_SHAPES if "k8" in parts
                                                else ()):
        q, k, v, do = bhsd(B, S, H, d), bhsd(B, S, kvh, d), \
            bhsd(B, S, kvh, d), bhsd(B, S, H, d)
        vecs, bias = k8_operands(FM, kind, B, H, S, "cuda")
        if name != "sft_padding":
            k8_row(name, lambda: FM._masked_fwd(q, k, v, vecs, bias, causal,
                                                1 / math.sqrt(d), True))
        k8_backward(name, q, k, v, do, vecs, bias, causal)
        del q, k, v, do
    if "k8" in parts:
        k8_window(torch, FA, FM, bhsd, k8_row, k8_backward, window_intervals,
                  WINDOW_SHAPE, scale)
    small_and_longctx(torch, FA, FM, root, bhsd, masked, scale, sdpa, parts,
                      release, phase_longctx_masked, phase_longctx_window,
                      phase_longctx_bias)


def k8_window(torch, FA, FM, bhsd, k8_row, k8_backward, window_intervals,
              window_shape, scale):
    """The K8 forward, dq and dk/dv at 10c's mask, beside K1/K2 unmasked."""
    name, B, H, S = window_shape
    q, k, v, do = (bhsd(B, S, H) for _ in range(4))
    vecs = window_intervals(FM, B, S, "cuda")
    k1_ms = cuda_ms(torch, lambda: FA._flash_fwd(q, k, v, True, scale))
    k8_row(name, lambda: FM._masked_fwd(q, k, v, vecs, None, True, scale,
                                        True), k1_unmasked_ms=k1_ms)
    out, lse = FA._flash_fwd(q, k, v, True, scale)
    _, delta = FA._flash_bwd_dq(q, k, v, out, lse, do, True, scale)
    k2 = {"k2_unmasked_dq_ms": cuda_ms(torch, lambda: FA._flash_bwd_dq(
              q, k, v, out, lse, do, True, scale)),
          "k2_unmasked_dkv_ms": cuda_ms(torch, lambda: FA._flash_bwd_dkv(
              q, k, v, lse, delta, do, True, scale))}
    del out, lse, delta
    k8_backward(name, q, k, v, do, vecs, None, True, **k2)
    del q, k, v, do


def small_and_longctx(torch, FA, FM, root, bhsd, masked, scale, sdpa, parts,
                      release, phase_longctx_masked, phase_longctx_window,
                      phase_longctx_bias):
    """The small prefills' event and device time, then 10b-10d."""
    for name in (("serve_512", "bench_decode") if "small" in parts
                 else ()):
        _, B, H, kvh, S, lengths, _, _ = masked[name]
        q, k, v = bhsd(B, S, H), bhsd(B, S, kvh), bhsd(B, S, kvh)
        keep = (torch.arange(S, device="cuda")[None]
                < torch.tensor(lengths, device="cuda")[:, None])
        vecs = FM.padding_mask_to_intervals(keep, S)
        dense = (torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
                 [None] & keep[:, None, :])[:, None]
        calls = {"k8": lambda: FM.flash_mha_masked(q, k, v, vecs, True,
                                                   scale),
                 "sdpa": lambda: sdpa(q, k, v, attn_mask=dense, scale=scale,
                                      enable_gqa=kvh != H)}
        print(json.dumps({"checkout": root, "small_prefill": name, **{
            key: {"event_ms": cuda_ms(torch, fn),
                  **device_ms(torch, fn)} for key, fn in calls.items()}}),
              flush=True)
        del q, k, v, dense

    if "decode" in parts:
        decode_e2e(torch, release)
    if "longctx" not in parts:
        return
    # the long-context rung on this checkout's kernels
    release()
    qkv, _ = phase_longctx_masked(FA, FM)
    release()
    phase_longctx_window(FA, FM, qkv)
    phase_longctx_bias(FA, FM, qkv)


def dense_visible(torch, vecs, S, causal, device):
    """[B|1, H|1, S, S] bool: the pairs the intervals and causality leave
    visible."""
    rows = torch.arange(S, device=device)[:, None]
    vis = torch.ones(S, S, dtype=torch.bool, device=device)
    vis = (vis.tril() if causal else vis)[None, None]
    if vecs is not None:
        for i in range(0, vecs.shape[2], 2):      # [start, end) rows masked
            vis = vis & ~((rows >= vecs[:, :, i, None]) &
                          (rows < vecs[:, :, i + 1, None]))
    return vis


def plain_forward(torch, q, k, v, do, vecs, bias, causal, scale,
                  lse_invalid):
    """(out, lse, delta) of the masked forward in f32 from dense scores,
    out in q's layout and rounded to bf16 as the kernel's: the K8
    backward's inputs, made here so that every checkout's backward
    kernels are timed on the same ones."""
    B, H, S, _ = q.shape
    vis = dense_visible(torch, vecs, S, causal, q.device)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    group = H // k.shape[1]
    for b in range(B):
        kb, vb = (t[b].float().repeat_interleave(group, 0) for t in (k, v))
        s = (q[b].float() @ kb.transpose(-1, -2)) * scale
        if bias is not None:
            s = s + bias[b % bias.shape[0]].float()
        s = s.masked_fill(~vis[b % vis.shape[0]], -math.inf)
        lb = torch.logsumexp(s, -1)
        live = torch.isfinite(lb)
        p = torch.exp(s - torch.where(live, lb, 0)[..., None])
        out[b] = (p.nan_to_num(0.0) @ vb).to(q.dtype)
        lse[b] = torch.where(live, lb, lse_invalid)
    delta = (out.float() * do.float()).sum(-1)
    return out, lse, delta


def sdpa_fwd_bwd_ms(torch, sdpa, FM, q, k, v, do, vecs, bias, causal,
                    scale):
    """Milliseconds of one forward + backward of
    ``scaled_dot_product_attention`` with the dense bool mask (or the
    bias with -inf where invisible, in q's dtype, and its gradient)."""
    vis = dense_visible(torch, vecs, q.shape[2], causal, q.device)
    mask = vis if bias is None else bias.masked_fill(
        ~vis, -math.inf).to(q.dtype).requires_grad_()
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    wrt = leaves + ([mask] if bias is not None else [])

    def run():
        o = sdpa(*leaves, attn_mask=mask, scale=scale,
                 enable_gqa=k.shape[1] != q.shape[1])
        torch.autograd.grad(o, wrt, do)

    return cuda_ms(torch, run, iters=5, warmup=1)


def device_ms(torch, fn, iters=20):
    """{"device_ms": summed kernel time per call, "kernels": {name: ms per
    call}} of ``fn`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = collections.Counter()
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name[:90]] += ev.time_range.elapsed_us() / 1e3 / iters
    return {"device_ms": sum(kernels.values()), "kernels": dict(kernels)}


def decode_e2e(torch, release):
    """11c on this checkout's kernels, and one decode step's profile."""
    import numpy as np
    from chip_smoke import (LONG_PROMPT, bench_model, phase_long_decode,
                            profile_generate_step)
    from paddle_tpu_torch.models import generation as G
    from paddle_tpu_torch.models import init_state, llama3_8b
    from paddle_tpu_torch.ops.pallas import decode_attention as DA
    from paddle_tpu_torch.ops.pallas import flash_mask as FM
    from paddle_tpu_torch.ops.pallas import lora_matmul as LM
    from paddle_tpu_torch.ops.pallas import paged_attention as PA
    from paddle_tpu_torch.ops.pallas import quant_matmul as QM
    mods = {"G": G, "DA": DA, "PA": PA, "FM": FM, "QM": QM, "LM": LM,
            "init_state": init_state}
    cfg = llama3_8b()
    release()
    phase_long_decode(mods, cfg)
    state, _ = bench_model(mods, cfg)
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (8, LONG_PROMPT))).cuda()
    profile_generate_step(mods, state, cfg, ids, "11c", "dense_k7_on")
    del state
    release()


def k7_rows(torch, DA, root, gen, shapes, bound):
    """One line per K7 shape: device ms (``torch.profiler``) and
    CUDA-event ms of the decode attention, its bound, and SDPA's device
    ms with the bool mask t <= pos; a row the checkout's kernel does not
    take prints the error."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, B, nh, kvh, T, pos, D in shapes:
        q = torch.randn(B, nh, D, device="cuda", generator=gen).bfloat16()
        k, v = (torch.randn(B, kvh, T, D, device="cuda", generator=gen)
                .bfloat16() for _ in range(2))
        pos_t = torch.tensor(pos, dtype=torch.int32, device="cuda")
        visible = int(torch.clamp(pos_t + 1, max=T).sum())
        row = {"checkout": root, "k7": name, "bound_ms": bound(
            2 * visible * kvh * D * 2 + 4 * q.numel() + 4 * B,
            4 * visible * nh * D)[0]}
        try:
            fn = lambda: DA.decode_attention(q, k, v, pos_t)  # noqa: E731
            fn()
            row.update(event_ms=cuda_ms(torch, fn, iters=50),
                       **device_ms(torch, fn))
        except (ValueError, NotImplementedError) as e:
            row["error"] = str(e)
        mask = (torch.arange(T, device="cuda")[None, :]
                <= pos_t[:, None])[:, None, None, :]
        row["sdpa_device_ms"] = device_ms(torch, lambda: sdpa(
            q[:, :, None], k, v, attn_mask=mask,
            enable_gqa=kvh != nh))["device_ms"]
        print(json.dumps(row), flush=True)
        del q, k, v


def k3_rows(torch, DA, root, gen, shapes):
    """One line per K3 shape: device ms (``torch.profiler``) and
    CUDA-event ms of the paged attention, its bound, and K7's device ms on
    the same keys gathered into a dense cache (where the checkout's K7
    takes the head dim); a row the checkout's K3 does not take prints
    the error."""
    from chip_smoke import paged_bound, paged_inputs
    from paddle_tpu_torch.ops.pallas import paged_attention as PA
    for name, nh, kvh, ps, W, lens, D in shapes:
        q, kp, vp, table, lens_t = paged_inputs(gen, len(lens), nh, kvh, ps,
                                                W, lens, D)
        row = {"checkout": root, "k3": name,
               "bound_ms": paged_bound(q, kvh, ps, lens_t)[0]}
        try:
            fn = lambda: PA.paged_attention(  # noqa: E731
                q, kp, vp, table, lens_t)
            fn()
            row.update(event_ms=cuda_ms(torch, fn, iters=50),
                       **device_ms(torch, fn))
        except (ValueError, NotImplementedError) as e:
            row["error"] = str(e)
        kd, vd = (PA.gather_kv_pages(p, table).transpose(1, 2).contiguous()
                  for p in (kp, vp))
        if DA._route(D) == "kernel":
            pos = lens_t - 1
            row["k7_dense_device_ms"] = device_ms(
                torch, lambda: DA.decode_attention(q, kd, vd, pos))[
                    "device_ms"]
        print(json.dumps(row), flush=True)
        del q, kp, vp, kd, vd


def k4_rows(torch, root, gen):
    """One line per phase-3 K4 shape (``chip_smoke.phase_quant``'s), int8
    and int4: the kernel's device ms, its bound, a dense bf16
    ``torch.matmul`` of the same shape and, for int8,
    ``torch._weight_int8pack_mm``."""
    from chip_smoke import (BENCH_PROJ_SHAPES, GEN_PROJ_SHAPES, PROJ_SHAPES,
                            bound, int8pack_ms)
    from paddle_tpu_torch.ops.pallas import quant_matmul as QM
    shapes = [(name, 8, k, n) for name, k, n in PROJ_SHAPES]
    shapes += [("gate/up", 1, 4096, 14336), ("gate/up", 64, 4096, 14336)]
    shapes += [(name, 8, k, n) for name, k, n in GEN_PROJ_SHAPES]
    for kind in ("int8", "int4"):
        bench = [(name, 8, k, n) for name, k, n in BENCH_PROJ_SHAPES]
        for name, m, k, n in shapes + (bench if kind == "int8" else []):
            top = 127 if kind == "int8" else 7
            x = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
            q = torch.randint(-top, top + 1, (k, n), device="cuda",
                              generator=gen).to(torch.int8)
            sc = torch.rand(n, device="cuda", generator=gen) * 0.02 + 1e-3
            w = (QM.QuantizedWeight(QM.pack_int4(q), sc, "int4", k)
                 if kind == "int4" else QM.QuantizedWeight(q, sc))
            dense = torch.randn(k, n, device="cuda",
                                generator=gen).bfloat16()
            nbytes = w.q.numel() + 4 * n + 2 * x.numel() + 2 * m * n
            print(json.dumps({
                "checkout": root, "k4": kind, "shape": name, "M": m,
                **device_ms(torch, lambda: QM.weight_only_matmul(x, w)),
                "bound_ms": bound(nbytes, 2 * m * k * n)[0],
                "dense_bf16_device_ms": device_ms(
                    torch, lambda: x @ dense)["device_ms"],
                "int8pack_device_ms": (int8pack_ms(x, q, sc)[0]
                                       if kind == "int8" else None)}),
                  flush=True)
            del x, q, w, dense


def k5_rows(torch, root, gen):
    """One line per ``PROJ_SHAPES`` row at phase 3's K5 operands: the
    gather-LoRA's device ms (``torch.profiler``: both kernels of a call),
    its bound and the plain version's device ms."""
    from chip_smoke import (LORA_IDX, LORA_RANK, PROJ_SHAPES, bound,
                            device_ms as smoke_device_ms)
    from paddle_tpu_torch.ops.pallas import lora_matmul as LM
    idx = torch.tensor(LORA_IDX, dtype=torch.int32, device="cuda")
    s, rows = len(LORA_IDX), 5
    for name, k, m in PROJ_SHAPES:
        x = torch.randn(s, k, device="cuda", generator=gen).bfloat16()
        a = torch.randn(rows, LORA_RANK, k, device="cuda", generator=gen)
        b = torch.randn(rows, LORA_RANK, m, device="cuda", generator=gen)
        sc = torch.rand(rows, device="cuda", generator=gen) + 0.5
        nbytes = (len(set(LORA_IDX)) * LORA_RANK * (k + m) * 4
                  + 2 * x.numel() + 2 * s * m + 4 * s + 4 * rows)
        print(json.dumps({
            "checkout": root, "k5": name, "K": k, "M": m,
            **device_ms(torch, lambda: LM.lora_gather_matmul(x, a, b, sc,
                                                             idx), iters=50),
            "bound_ms": bound(nbytes, 2 * s * LORA_RANK * (k + m))[0],
            "plain_device_ms": smoke_device_ms(
                lambda: LM._xla_gather_matmul(x, a, b, sc, idx),
                iters=10)}), flush=True)
        del x, a, b


def k9_rows(torch, root, gen, release):
    """One line per ``K9_SHAPES`` row at phase 3's K9 operands (routing
    from a seeded gate): the grouped FFN's forward and backward device ms
    (``torch.profiler``), their bounds and the sort path's expert einsums
    as the yardstick; then 13b on the checkout's kernels."""
    from chip_smoke import (K9_SHAPES, MOE_LAYER_SHAPES, device_ms as dms,
                            k9_bounds, k9_operands, k9_yardstick,
                            moe_routing, phase_moe_layer)
    from paddle_tpu_torch.distributed import moe as TM
    from paddle_tpu_torch.ops.pallas import grouped_ffn as GF
    for name, tokens, E, k, D, F, gated, routing in K9_SHAPES:
        bdt = torch.float32 if gated else torch.bfloat16
        x, idx, gv = moe_routing(TM, gen, tokens, E, k, D, routing)
        args, emap, dy, n, _ = k9_operands(TM, gen, x, idx, gv, E, F, gated,
                                           bdt)
        x_buf, w1, b1, w2, b2 = args
        ms = {"fwd": dms(lambda: GF._kernel_fwd(*args, emap, gated)),
              "bwd": dms(lambda: GF._kernel_bwd(x_buf, dy, w1, b1, w2, b2,
                                                emap, gated))}
        bounds = k9_bounds(args, emap, dy, n, F)
        _, yard = k9_yardstick(TM, gen, tokens, E, k, F, gated, args)
        print(json.dumps({"checkout": root, "k9": name, "ms": ms,
                          "bound_ms": {p: b[0] for p, b in bounds.items()},
                          "einsums_ms": yard}), flush=True)
        del x, args, dy, x_buf, w1, b1, w2, b2
        release()
    for shape in MOE_LAYER_SHAPES:
        phase_moe_layer(TM, GF, gen, *shape)
        release()


def moe_train(release):
    """``chip_smoke.py``'s 13a, twice, on the checkout's modules."""
    from chip_smoke import phase_moe_train
    from paddle_tpu_torch.models import moe_llm as M
    from paddle_tpu_torch.ops.pallas import flash_attention as FA
    from paddle_tpu_torch.ops.pallas import grouped_ffn as GF
    from paddle_tpu_torch.ops.pallas import rms_norm as RN
    for _ in range(2):
        phase_moe_train(M, FA, GF, RN)
        release()


def serve_profile(torch, release):
    """Phase 4's decode step on this checkout's kernels: llama3_8b with
    random bf16 weights from seed 0, the engine of ``phase_serve`` (8
    slots, pages of 64, 8192 tokens a row), a warm-up request, then
    ``profile_decode`` over 8 decode steps of phase 4's 8 prompt lengths
    (K3's device ms per step and the busy share)."""
    import numpy as np
    from chip_smoke import profile_decode
    from paddle_tpu_torch.models import (GenerationConfig, init_state,
                                         llama3_8b)
    from paddle_tpu_torch.serving import create_engine
    cfg = llama3_8b()
    release()
    state = init_state(cfg, torch.Generator(device="cuda").manual_seed(0),
                       device="cuda")
    engine = create_engine(cfg, state, max_slots=8, page_size=64,
                           max_model_len=8192, enable_prefix_cache=True,
                           sync_interval=8)
    rng = np.random.default_rng(0)
    engine.submit(rng.integers(0, cfg.vocab_size, 100),
                  GenerationConfig(max_new_tokens=8)).result()
    lens = [128, 2048, 700, 1500, 333, 1524, 1324, 1900]
    profile_decode(engine, [rng.integers(0, cfg.vocab_size, n)
                            for n in lens], GenerationConfig, phase="serve")
    del engine, state
    release()


def dbias_rows(torch, FM, root, bhsd, k8_shapes, longctx_seq, alibi_bias,
               bias_read_bytes, bound, visible_pairs, scale, sdpa):
    """The K8 dbias at ``alibi_bias`` (b 2, h 16, s 2048: two members per
    CTA) and at 10d's shape (b 1, h 16, s 8192), on an f32-made out, lse
    and delta, beside its bound and SDPA's forward + backward with the
    bias's gradient."""
    shapes = [row for row in k8_shapes if row[0] == "alibi_bias"]
    shapes.append(("alibi_8192", 1, 16, 16, longctx_seq, True, "alibi", 128))
    for name, B, H, kvh, S, causal, _, _ in shapes:
        q, k, v, do = bhsd(B, S, H), bhsd(B, S, kvh), bhsd(B, S, kvh), \
            bhsd(B, S, H)
        bias = alibi_bias(H, S, "cuda")
        out, lse, delta = plain_forward(torch, q, k, v, do, None, bias,
                                        causal, scale, FM.LSE_INVALID)
        fn = lambda: FM._masked_bwd_dbias(  # noqa: E731
            q, k, v, lse, delta, do, None, bias, causal, scale)
        n_q = B * H * S * 128
        b_ms = bound(4 * n_q * 2 + 2 * B * H * S * 4
                     + bias_read_bytes(FM, None, bias, S, S, causal, "cuda")
                     + bias.numel() * 4, 4 * visible_pairs(S, S) * B * H
                     * 128)[0]
        ms = cuda_ms(torch, fn, iters=10, warmup=2)
        del out
        lib = sdpa_fwd_bwd_ms(torch, sdpa, FM, q, k, v, do, None, bias,
                              causal, scale)
        print(json.dumps({"checkout": root, "dbias": name, "ms": ms,
                          "bound_ms": b_ms, "sdpa_fwd_bwd_ms": lib}),
              flush=True)
        del q, k, v, do, bias, lse, delta


if __name__ == "__main__":
    main(os.path.abspath(sys.argv[1]),
         tuple(sys.argv[2].split(",")) if len(sys.argv) > 2 else PARTS)
