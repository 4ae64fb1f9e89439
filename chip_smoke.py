#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``) on one H100.

Run from the repository root on a machine with the card and the CUDA
toolkit::

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. print the card's name and power limit; require compute capability 9.0;
2. build the CUDA kernels from ``paddle_tpu_torch/csrc`` (one nvcc per
   source, in parallel) and print the build seconds;
3. hold each kernel against its plain PyTorch version on the card, in
   bf16 at llama3_8b widths (32 q heads, 8 kv heads, head_dim 128), per
   output row (||out - ref|| / ||ref|| <= 2^-6), and show that the check
   fails on a planted fault (every row loses its last 64 keys); time
   kernel, plain version, the least time the card could take, and (for
   prefill) ``torch.nn.functional.scaled_dot_product_attention`` as a
   yardstick the port never calls;
4. serve 8 requests through ``create_engine`` -> ``Engine.submit`` ->
   prefill-on-admit -> lockstep paged decode with llama3_8b at full
   width and depth (random bf16 weights from a seed), prefix cache on,
   ``sync_interval=8``; the kernels' launch counters are zeroed just
   before and read just after, and must both be > 0;
5. run a 2-layer llama3_8b-width engine in float32 twice from one state,
   on the card (kernels) and with ``device="cpu"`` (plain versions): the
   first 16 greedy tokens of 4 prompts must be identical;
6. train: ``setup`` -> ``build_train_step(remat=True)`` -> 1 warm-up and
   10 timed steps of the bench's Llama (~0.95 B params: hidden 2048, 16
   layers, 16 heads, FFN 5632, vocab 32000; bf16 params, f32 AdamW) on
   one [8, 2049] batch; the loss must be finite and fall, and the
   flash-attention counters (zeroed just before, read just after) must
   show 2 K1 forwards (remat) and one K2 dq and dk/dv per layer per step;
   tokens/s, MFU, peak memory and a profile of one step;
7. one training step in float32 at 2 layers of the same width, card
   (kernels) vs CPU (plain versions) from one set of params: loss, every
   grad and every param after the step agree by relative norm.

Phase 3 also holds the flash-attention kernels (K1 forward, K2 dq and
dk/dv) to their plain versions in bf16 at four shapes (the training
shape, llama3_8b widths, a ragged sq > sk case and seq 8192), per row of
out, dq, dk and dv, with the same kind of planted fault (the kernels
told 64 keys fewer than there are).

Prints a ``{"kernels": [...]}`` line before the last, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when no CUDA card is present.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak
# bf16 kernel vs plain version, per output row (one query head of one
# token, over head_dim): ||out - ref|| / ||ref||.  Both sides round to
# bf16 in a few places (2^-9 relative each); a row over n keys has
# |o| ~ n^-1/2, so an absolute limit would be loose on the long rows,
# which a per-row relative limit holds as tightly as the short ones.
ROW_TOL = 2 ** -6
FAULT_KEYS = 64               # planted fault: each row loses its last 64 keys
# flash attention (K1/K2) in phase 3: the training shape first (the one
# the kernels line reports), then llama3_8b widths, a ragged cross-length
# case whose first 300 rows see no key, and a long sequence
FLASH_SHAPES = (  # name, B, H, kvH, Sq, Sk
    ("train", 8, 16, 16, 2048, 2048),
    ("llama3_8b", 1, 32, 8, 2048, 2048),
    ("ragged", 2, 16, 4, 1000, 700),
    ("long", 1, 16, 16, 8192, 8192),
)
FAULT_SHARE = 0.99            # gradient rows the planted fault must fail
TRAIN_STEPS = 10
# phase 7, card (f32 kernels, no TF32) vs CPU, ||card - cpu|| / ||cpu||
PARITY_TOL = 1e-4


def require(cond, what):
    """Fail the smoke test (a check that ``python -O`` keeps)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device milliseconds per call, CUDA events around a loop."""
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


def release():
    """Free what an earlier phase left (engines hold reference cycles, so
    a collection comes first) before the next phase measures memory."""
    gc.collect()
    torch.cuda.empty_cache()


def emit(obj):
    print(json.dumps(obj), flush=True)


def row_rel_err(out, ref, floor=0.0):
    """Per-row ||out - ref|| / max(||ref||, floor) over the last dim; with
    no floor, a row whose reference is all zero (no visible key) must be
    exactly zero."""
    o, r = out.float(), ref.float()
    diff = (o - r).norm(dim=-1)
    norm = r.norm(dim=-1).clamp_min(floor)
    return torch.where(norm > 0, diff / norm.clamp_min(1e-30),
                       torch.where(diff > 0, math.inf, 0.0))


def grad_row_err(g, ref):
    """The per-row check for gradients.  A row's true gradient can be 0
    where its output is not (dq of a query that sees one key: ds = p (dp
    - delta) with delta = dp), so the denominator has a floor of 2^-6 x
    the RMS row norm of ``ref``: such a row is held to an absolute
    ||g|| <= 2^-12 x that RMS instead of an undefined ratio."""
    rms = ref.float().norm(dim=-1).square().mean().sqrt().item()
    return row_rel_err(g, ref, floor=2 ** -6 * rms)


def visible_pairs(sq, sk):
    """(query, key) pairs a causal, bottom-right aligned row set sees."""
    return int(np.clip(np.arange(sq) + (sk - sq) + 1, 0, sk).sum())


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    bf16 operations over the tensor-core peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_paged(PA, gen):
    """K3 at the decode shape of phase 4: 8 slots, page 64, ragged lens
    1..8192 (table width 128, one pool row per page + the dump page)."""
    dev, dt = "cuda", torch.bfloat16
    B, nh, kvh, D, ps, W = 8, 32, 8, 128, 64, 128
    lens = torch.tensor([1, 64, 65, 300, 1000, 2047, 4096, 8192],
                        dtype=torch.int32, device=dev)
    P = B * W + 1
    dump = P - 1
    q = torch.randn(B, nh, D, device=dev, generator=gen).to(dt)
    kp = torch.randn(P, kvh, ps, D, device=dev, generator=gen).to(dt)
    vp = torch.randn(P, kvh, ps, D, device=dev, generator=gen).to(dt)
    perm = torch.randperm(B * W, device=dev, generator=gen).reshape(B, W)
    need = (lens + ps - 1) // ps
    table = torch.where(torch.arange(W, device=dev)[None] < need[:, None],
                        perm, dump).to(torch.int32).contiguous()
    out = PA.paged_attention(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    ref = PA.paged_attention_xla(q, kp, vp, table, lens)
    err = (out.float() - ref.float()).abs().max().item()
    rows = row_rel_err(out, ref)                         # [B, nh]
    row_err = rows.max().item()
    worst_lens = int(lens[rows.amax(dim=1).argmax()])
    require(row_err <= ROW_TOL,
            f"paged_attention kernel vs plain: row error {row_err} > "
            f"{ROW_TOL} (worst row: lens {worst_lens})")
    # the check must catch a kernel that skips each row's last page
    short = torch.clamp(lens - FAULT_KEYS, min=1).to(torch.int32)
    fault = row_rel_err(PA.paged_attention(q, kp, vp, table, short),
                        ref)[lens > FAULT_KEYS]
    require(bool((fault > ROW_TOL).all()),
            f"planted fault (last {FAULT_KEYS} keys dropped) passed the "
            f"paged_attention check: min row error {fault.min().item()}")
    ms = cuda_ms(lambda: PA.paged_attention(q, kp, vp, table, lens))
    plain_ms = cuda_ms(lambda: PA.paged_attention_xla(q, kp, vp, table, lens))
    toks = int(lens.sum())
    item = q.element_size()
    nbytes = (2 * q.numel() * item + 2 * toks * kvh * D * item
              + 4 * (table.numel() + lens.numel()))
    bound_ms, bound_by = bound(nbytes, 4 * toks * D * nh)
    shape = {"kernel": "paged_attention", "dtype": "bfloat16", "B": B,
             "nh": nh, "kvh": kvh, "D": D, "page_size": ps, "W": W,
             "lens": lens.tolist(), "max_abs_err": err,
             "max_row_rel_err": row_err, "row_tol": ROW_TOL,
             "worst_row_lens": worst_lens,
             "fault_min_row_rel_err": fault.min().item(),
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None}
    emit({"phase": 3, **shape})
    return shape


def phase_masked(FM, gen, bucket, plen):
    """K8 forward at a full-prefill shape of phase 4: one prompt padded
    to ``bucket`` with ``plen`` real tokens, causal + key padding, q/k/v
    as the transposed [B, S, H, D] views the dispatcher passes."""
    dev, dt = "cuda", torch.bfloat16
    H, kvh, D = 32, 8, 128
    q = torch.randn(1, bucket, H, D, device=dev, generator=gen).to(dt)
    k = torch.randn(1, bucket, kvh, D, device=dev, generator=gen).to(dt)
    v = torch.randn(1, bucket, kvh, D, device=dev, generator=gen).to(dt)
    keep = torch.arange(bucket, device=dev)[None] < plen
    vecs = FM.padding_mask_to_intervals(keep, bucket)
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    scale = 1.0 / math.sqrt(D)
    out = FM.flash_mha_masked(qh, kh, vh, vecs, True, scale)
    torch.cuda.synchronize()
    ref = FM.flash_mha_masked_xla(qh, kh, vh, vecs, True, scale)
    err = (out.float() - ref.float()).abs().max().item()
    rows = row_rel_err(out, ref)                         # [1, H, bucket]
    row_err = rows.max().item()
    # query row i sees keys <= i that are real
    worst_keys = min(int(rows[0].amax(dim=0).argmax()) + 1, plen)
    require(row_err <= ROW_TOL,
            f"flash_mha_masked kernel vs plain at bucket {bucket}: row "
            f"error {row_err} > {ROW_TOL} (worst row sees {worst_keys} "
            "keys)")
    # the check must catch a kernel that drops the last K block: the
    # prompt's last 64 real keys, lost by every row from plen - 1 on
    keep_short = torch.arange(bucket, device=dev)[None] < plen - FAULT_KEYS
    fault = row_rel_err(FM.flash_mha_masked(
        qh, kh, vh, FM.padding_mask_to_intervals(keep_short, bucket), True,
        scale), ref)[:, :, plen - 1:]
    del ref
    require(bool((fault > ROW_TOL).all()),
            f"planted fault (last {FAULT_KEYS} keys dropped) passed the "
            f"flash_mha_masked check at bucket {bucket}: min row error "
            f"{fault.min().item()}")
    ms = cuda_ms(lambda: FM.flash_mha_masked(qh, kh, vh, vecs, True, scale))
    plain_ms = cuda_ms(
        lambda: FM.flash_mha_masked_xla(qh, kh, vh, vecs, True, scale),
        iters=3, warmup=1)
    dense = (torch.ones(bucket, bucket, dtype=torch.bool, device=dev).tril()
             & keep[0][None, :])[None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(qh, kh, vh, attn_mask=dense,
                                      scale=scale, enable_gqa=True))
    # visible (query, key) pairs: row i sees keys <= i that are real
    pairs = int(np.minimum(np.arange(bucket) + 1, plen).sum())
    item = q.element_size()
    bound_ms, bound_by = bound(
        (2 * q.numel() + k.numel() + v.numel()) * item + vecs.numel() * 4,
        4 * pairs * D * H)
    shape = {"kernel": "flash_mha_masked", "dtype": "bfloat16", "B": 1,
             "H": H, "kvh": kvh, "D": D, "bucket": bucket, "plen": plen,
             "max_abs_err": err, "max_row_rel_err": row_err,
             "row_tol": ROW_TOL, "worst_row_keys": worst_keys,
             "fault_min_row_rel_err": fault.min().item(), "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": library_ms}
    emit({"phase": 3, **shape})
    return shape


def phase_flash(FA, gen, name, B, H, kvh, sq, sk):
    """K1 forward and the K2 dq and dk/dv kernels against their plain
    versions in bf16, causal, on [B, S, H, D] tensors passed as the
    transposed views ``sdpa`` hands over.  The backward kernels and
    their plain versions take the same (q, k, v, out, lse, dout): the
    kernel forward's out and lse."""
    dev, dt, D = "cuda", torch.bfloat16, 128
    scale = 1.0 / math.sqrt(D)
    q, k, v, do = (torch.randn(B, s, n, D, device=dev, generator=gen)
                   .to(dt).transpose(1, 2)
                   for s, n in ((sq, H), (sk, kvh), (sk, kvh), (sq, H)))
    out, lse = FA._flash_fwd(q, k, v, True, scale)
    dq, delta = FA._flash_bwd_dq(q, k, v, out, lse, do, True, scale)
    dk, dv = FA._flash_bwd_dkv(q, k, v, lse, delta, do, True, scale)
    torch.cuda.synchronize()
    errs, rows = {}, {}
    ref, ref_lse = FA._flash_fwd_xla(q, k, v, True, scale)
    live = ref_lse != FA.LSE_INVALID                 # rows that see a key
    require(bool((lse[~live] == FA.LSE_INVALID).all()),
            f"flash fwd {name}: rows with no key must get LSE_INVALID")
    rows["out"] = row_rel_err(out, ref)
    errs["out"] = (out.float() - ref.float()).abs().max().item()
    ref_dq = FA._flash_bwd_dq_xla(q, k, v, out, lse, do, True, scale)
    rows["dq"] = grad_row_err(dq, ref_dq)
    errs["dq"] = (dq.float() - ref_dq.float()).abs().max().item()
    ref_dk, ref_dv = FA._flash_bwd_dkv_xla(q, k, v, out, lse, do, True,
                                           scale)
    for key, got, want in (("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        rows[key] = grad_row_err(got, want)
        errs[key] = (got.float() - want.float()).abs().max().item()
    row_err = {key: r.max().item() for key, r in rows.items()}
    for key, err in row_err.items():
        require(err <= ROW_TOL, f"flash {key} kernel vs plain at {name}: "
                f"row error {err} > {ROW_TOL}")
    # planted fault: every kernel told 64 keys fewer than there are
    kf, vf = k[:, :, :-FAULT_KEYS], v[:, :, :-FAULT_KEYS]
    f_out, _ = FA._flash_fwd(q, kf, vf, True, scale)
    f_dq, f_delta = FA._flash_bwd_dq(q, kf, vf, out, lse, do, True, scale)
    f_dk, f_dv = FA._flash_bwd_dkv(q, kf, vf, lse, f_delta, do, True, scale)
    # a row that sees one key has dq = 0 (ds = p (dp - delta), delta =
    # dp): the dq check covers the rows that see two or more
    multi = (torch.arange(sq, device=dev) + (sk - sq) >= 1)[None, None]
    fault_rows = {
        "out": row_rel_err(f_out, ref)[live],
        "dq": grad_row_err(f_dq, ref_dq)[live & multi],
        "dk": grad_row_err(f_dk, ref_dk[:, :, :-FAULT_KEYS]),
        "dv": grad_row_err(f_dv, ref_dv[:, :, :-FAULT_KEYS])}
    fault = {key: r.min().item() for key, r in fault_rows.items()}
    caught = {key: (r > ROW_TOL).float().mean().item()
              for key, r in fault_rows.items()}
    del ref, ref_dq, ref_dk, ref_dv, f_out, f_dq, f_dk, f_dv, fault_rows
    # every output row must see the fault; a gradient row sums over all
    # the rows (or keys) it meets, so losing 64 of ~8000 terms moves a
    # few rows in 10^5 by less than the limit: 99 % of them must fail
    require(caught["out"] == 1.0, f"planted fault ({FAULT_KEYS} keys "
            f"dropped) passed the flash out check at {name} on some rows: "
            f"min row error {fault['out']}")
    for key in ("dq", "dk", "dv"):
        require(caught[key] >= FAULT_SHARE, f"planted fault ({FAULT_KEYS} "
                f"keys dropped) failed the flash {key} check at {name} on "
                f"only {caught[key]:.4f} of the rows (< {FAULT_SHARE})")

    ms = {"fwd": cuda_ms(lambda: FA._flash_fwd(q, k, v, True, scale)),
          "dq": cuda_ms(lambda: FA._flash_bwd_dq(q, k, v, out, lse, do, True,
                                                 scale)),
          "dkv": cuda_ms(lambda: FA._flash_bwd_dkv(q, k, v, lse, delta, do,
                                                   True, scale))}
    plain = {"fwd": cuda_ms(lambda: FA._flash_fwd_xla(q, k, v, True, scale),
                            iters=3, warmup=1),
             "dq": cuda_ms(lambda: FA._flash_bwd_dq_xla(
                 q, k, v, out, lse, do, True, scale), iters=3, warmup=1),
             "dkv": cuda_ms(lambda: FA._flash_bwd_dkv_xla(
                 q, k, v, out, lse, do, True, scale), iters=3, warmup=1)}
    # yardstick: one scaled_dot_product_attention call (never on the
    # port's path), bottom-right causal; forward, and forward + backward
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = None if sq == sk else torch.ones(
        sq, sk, dtype=torch.bool, device=dev).tril(sk - sq)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def lib_fwd():
        return sdpa(q, k, v, attn_mask=mask, is_causal=mask is None,
                    scale=scale, enable_gqa=kvh != H)

    def lib_fwd_bwd():
        o = sdpa(*leaves, attn_mask=mask, is_causal=mask is None,
                 scale=scale, enable_gqa=kvh != H)
        torch.autograd.grad(o, leaves, do)

    library = {"fwd": cuda_ms(lib_fwd), "fwd_bwd": cuda_ms(lib_fwd_bwd)}
    pairs = visible_pairs(sq, sk) * B * H
    item = 2
    n_q, n_kv = B * H * sq * D, B * kvh * sk * D
    rows_f32 = B * H * sq * 4                            # lse or delta
    bounds = {
        "fwd": bound((2 * n_q + 2 * n_kv) * item + rows_f32, 4 * pairs * D),
        "dq": bound((4 * n_q + 2 * n_kv) * item + 2 * rows_f32,
                    6 * pairs * D),
        "dkv": bound((2 * n_q + 4 * n_kv) * item + 2 * rows_f32,
                     8 * pairs * D)}
    shape = {"kernel": "flash_attention", "shape": name, "dtype": "bfloat16",
             "B": B, "H": H, "kvh": kvh, "D": D, "sq": sq, "sk": sk,
             "causal": True, "dead_rows": int((~live).sum()),
             "max_abs_err": errs, "max_row_rel_err": row_err,
             "row_tol": ROW_TOL, "fault_min_row_rel_err": fault,
             "fault_rows_caught": caught, "ms": ms,
             "plain_ms": plain, "library_ms": library,
             "bound_ms": {key: b[0] for key, b in bounds.items()},
             "bound_by": {key: b[1] for key, b in bounds.items()}}
    emit({"phase": 3, **shape})
    return shape


def phase_serve(cfg, PA, FM, create_engine, init_state, GenerationConfig):
    """The main path at llama3_8b width and depth."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    state = init_state(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    emit({"phase": 4, "layers": cfg.num_hidden_layers,
          "init_state_s": time.perf_counter() - t0,
          "weight_bytes": sum(t.numel() * t.element_size()
                              for t in state.values())})
    engine = create_engine(cfg, state, max_slots=8, page_size=64,
                           max_model_len=8192, enable_prefix_cache=True,
                           sync_interval=8)
    rng = np.random.default_rng(0)
    # warm-up (cuBLAS handles, allocator): one short request
    engine.submit(rng.integers(0, cfg.vocab_size, 100),
                  GenerationConfig(max_new_tokens=8)).result()
    torch.cuda.synchronize()

    shared = rng.integers(0, cfg.vocab_size, 1024)
    lens = [128, 2048, 700, 1500, 333, 1024 + 500, 1024 + 300, 1900]
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    prompts[5] = np.concatenate([shared, prompts[5][1024:]])
    prompts[6] = np.concatenate([shared, prompts[6][1024:]])
    timings0 = dict(engine.timings)
    # counters over the engine's life; the window's are the differences
    stats0 = engine.stats()
    PA.paged_attention.launches = 0
    FM.flash_mha_masked.launches = 0
    t0 = time.perf_counter()
    reqs = [engine.submit(p, GenerationConfig(max_new_tokens=64))
            for p in prompts]
    engine.run_until_complete()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention": PA.paged_attention.launches,
                "flash_mha_masked": FM.flash_mha_masked.launches}
    stats = engine.stats()
    pool = engine.blocks.pool_accounting()
    for r in reqs:
        require(r.finish_reason == "length", (r, r.finish_reason))
        require(len(r.output_tokens) == 64, (r, len(r.output_tokens)))
        require(all(0 <= t < cfg.vocab_size for t in r.output_tokens),
                f"request {r.id}: token outside the vocabulary")
    require(launches["paged_attention"] > 0
            and launches["flash_mha_masked"] > 0, launches)
    require(stats["decode_traces"] == 1, stats["decode_traces"])
    require(pool["leak"] == 0 and stats["pages_in_use"] == 0, pool)
    require(stats["prefix_hits"] > stats0["prefix_hits"],
            "shared-prefix requests missed")
    ttft = [r.first_token_at - r.arrival_time for r in reqs]
    decode_s = (engine.timings["decode_s"] - timings0["decode_s"]
                + engine.timings["host_sync_s"] - timings0["host_sync_s"])
    decode_tokens = sum(len(r.output_tokens) - 1 for r in reqs)
    emit({"phase": 4, "requests": len(reqs), "prompt_lens": lens,
          "max_new_tokens": 64, "finished_by_length": len(reqs),
          "wall_s": wall, "ttft_s_mean": float(np.mean(ttft)),
          "ttft_s_max": float(np.max(ttft)),
          "prefill_s": engine.timings["prefill_s"] - timings0["prefill_s"],
          "decode_s": decode_s, "decode_tokens": decode_tokens,
          "decode_tokens_per_s": decode_tokens / decode_s,
          **{k: stats[k] - stats0[k] for k in (
              "decode_steps", "host_syncs", "prefix_hits",
              "cached_tokens")},
          "decode_traces": stats["decode_traces"], "pool": pool,
          "launches": launches,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    profile_decode(engine, [rng.integers(0, cfg.vocab_size, n) for n in lens],
                   GenerationConfig)
    return launches


def profile_decode(engine, prompts, GenerationConfig, steps=8):
    """Where the decode time goes: ``torch.profiler`` over ``steps``
    lockstep decode steps of 8 fresh requests (their prefill runs before
    the window).  Device time is summed per kernel and grouped; the idle
    share is 1 - device busy time / the window's wall time."""
    from torch.profiler import ProfilerActivity, profile
    for p in prompts:
        engine.submit(p, GenerationConfig(max_new_tokens=2 * steps + 2))
    engine.step()                       # admission + prefill of all 8
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    engine.run_until_complete()
    per_kernel: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[ev.name] = (per_kernel.get(ev.name, 0.0)
                                   + ev.time_range.elapsed_us() / 1e3)
    groups = {"paged_attention": 0.0, "flash_mha_masked": 0.0,
              "matmul": 0.0, "other": 0.0}
    for name, ms in per_kernel.items():
        low = name.lower()
        if "paged_attention" in low:
            groups["paged_attention"] += ms
        elif "masked_fwd" in low:
            groups["flash_mha_masked"] += ms
        elif any(s in low for s in ("gemm", "gemv", "cutlass", "xmma",
                                    "sm90", "cublas", "nvjet")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": 4, "profile": "decode", "steps": steps,
          "wall_ms_per_step": wall * 1e3 / steps,
          "device_ms_per_step": {k: v / steps for k, v in groups.items()},
          "device_busy_share": busy / (wall * 1e3) if wall else None,
          "kernels_seen": len(per_kernel),
          "top_kernels_ms_per_step": [[n[:80], ms / steps] for n, ms in top]})


def phase_parity(cfg8b, create_engine, init_state, GenerationConfig):
    """2 layers at llama3_8b widths, f32, card vs CPU from one state."""
    cfg = dataclasses.replace(cfg8b, num_hidden_layers=2, dtype="float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    state_cpu = init_state(cfg, torch.Generator().manual_seed(1),
                           device="cpu")
    state_gpu = {k: v.to("cuda") for k, v in state_cpu.items()}
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab_size, 96)
    prompts = [rng.integers(0, cfg.vocab_size, 37),
               np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 60)]),
               rng.integers(0, cfg.vocab_size, 200),
               np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 9)])]
    outs = {}
    for device, state in (("cuda", state_gpu), ("cpu", state_cpu)):
        engine = create_engine(cfg, state, device=device, max_slots=4,
                               page_size=64, max_model_len=512,
                               enable_prefix_cache=True, sync_interval=4)
        reqs = [engine.submit(p, GenerationConfig(max_new_tokens=16))
                for p in prompts]
        engine.run_until_complete()
        outs[device] = [r.output_tokens for r in reqs]
    same = outs["cuda"] == outs["cpu"]
    emit({"phase": 5, "layers": 2, "dtype": "float32",
          "prompt_lens": [len(p) for p in prompts], "new_tokens": 16,
          "tokens_identical": same})
    require(same, outs)


def bench_config(LlamaConfig, **kw):
    """The reference bench's one-chip training rung (bench.py:148-153)."""
    cfg = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
               num_hidden_layers=16, num_attention_heads=16,
               num_key_value_heads=16, max_position_embeddings=2048,
               dtype="bfloat16")
    cfg.update(kw)
    return LlamaConfig(**cfg)


def phase_train(cfg, TH, FA, batch=8, seq=2048):
    """The training path at full width and depth: setup -> step, as
    bench.py's _llama_throughput drives the reference (one warm-up step,
    then timed steps on one batch)."""
    t0 = time.perf_counter()
    params, opt = TH.setup(cfg, seed=0, dtype=torch.bfloat16)
    step = TH.build_train_step(cfg, remat=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq + 1), device="cuda",
                        generator=gen)
    n_params = sum(t.numel() for t in TH.tree_leaves(params))
    loss, params, opt = step(params, opt, ids)                 # warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()   # params + AdamW state
    FA.flash_mha.fwd_launches = 0
    FA.flash_mha.dq_launches = 0
    FA.flash_mha.dkv_launches = 0
    t0 = time.perf_counter()
    losses = []
    for _ in range(TRAIN_STEPS):
        loss, params, opt = step(params, opt, ids)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": FA.flash_mha.fwd_launches,
                "flash_attention_bwd_dq": FA.flash_mha.dq_launches,
                "flash_attention_bwd_dkv": FA.flash_mha.dkv_launches}
    losses = [float(x) for x in losses]
    layers = cfg.num_hidden_layers
    require(all(math.isfinite(x) for x in losses), f"loss {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    want = {"flash_attention_fwd": 2 * layers * TRAIN_STEPS,
            "flash_attention_bwd_dq": layers * TRAIN_STEPS,
            "flash_attention_bwd_dkv": layers * TRAIN_STEPS}
    require(launches == want, f"flash launches {launches} != {want}")
    tps = batch * seq * TRAIN_STEPS / wall
    attn_flops = 12 * layers * cfg.hidden_size * seq
    mfu = tps * (6 * n_params + attn_flops) / BF16_FLOPS_PER_S
    emit({"phase": 6, "params": n_params, "batch": batch, "seq": seq,
          "steps": TRAIN_STEPS, "remat": True, "setup_and_warmup_s": setup_s,
          "wall_s": wall, "s_per_step": wall / TRAIN_STEPS,
          "tokens_per_s": tps, "mfu": mfu, "loss_first": losses[0],
          "loss_last": losses[-1], "losses": losses, "launches": launches,
          "resident_bytes": resident,
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    profile_train(step, params, opt, ids)
    return launches


def profile_train(step, params, opt, ids):
    """Where one training step's time goes: ``torch.profiler`` over one
    step, device time per kernel grouped, idle share = 1 - device busy
    time / the step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, ids)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[ev.name] = (per_kernel.get(ev.name, 0.0)
                                   + ev.time_range.elapsed_us() / 1e3)
    groups = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
              "matmul": 0.0, "other": 0.0}
    for name, ms in per_kernel.items():
        low = name.lower()
        for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            if key + "_kernel" in low:
                groups[key] += ms
                break
        else:
            if any(m in low for m in ("gemm", "gemv", "cutlass", "xmma",
                                      "sm90", "cublas", "nvjet")):
                groups["matmul"] += ms
            else:
                groups["other"] += ms
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    emit({"phase": 6, "profile": "train_step", "wall_ms": wall * 1e3,
          "device_ms": groups, "device_busy_ms": busy,
          "device_idle_share": 1 - busy / (wall * 1e3),
          "kernels_seen": len(per_kernel),
          "top_kernels_ms": [[n[:80], ms] for n, ms in top]})


def rel_norm(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return ((a - b).norm() / b.norm().clamp_min(1e-300)).item()


def phase_train_parity(cfg, TH, seq=256):
    """One f32 training step, card (kernels) vs CPU (plain versions),
    from one set of params: loss, every grad, every param after it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    params_cpu, _ = TH.setup(cfg, seed=1, dtype=torch.float32, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, seq + 1)).astype(np.int64))
    res = {}
    for device in ("cuda", "cpu"):
        params = TH.tree_map(lambda t: t.to(device, copy=True), params_cpu)
        t0 = time.perf_counter()
        loss, grads = TH.value_and_grad(params, ids.to(device), cfg,
                                        remat=True)
        step = TH.build_train_step(cfg, remat=True, device=device)
        _, params, _ = step(params, TH.init_adamw(params), ids)
        if device == "cuda":
            torch.cuda.synchronize()
        res[device] = (loss, TH.tree_leaves(grads), TH.tree_leaves(params),
                       time.perf_counter() - t0)
    (gl, gg, gp, gs), (cl, cg, cp, cs) = res["cuda"], res["cpu"]
    errs = {"loss": rel_norm(gl, cl),
            "grads": max(rel_norm(a, b) for a, b in zip(gg, cg)),
            "params": max(rel_norm(a, b) for a, b in zip(gp, cp))}
    emit({"phase": 7, "layers": cfg.num_hidden_layers, "dtype": "float32",
          "seq": seq, "loss_cuda": float(gl), "loss_cpu": float(cl),
          "rel_err": errs, "tol": PARITY_TOL, "cuda_s": gs, "cpu_s": cs})
    for key, err in errs.items():
        require(err <= PARITY_TOL, f"training parity {key}: {err} > "
                f"{PARITY_TOL}")


def flash_entries(flash, launches):
    """The K1 / K2 entries of the kernels line: times at the training
    shape (flash[0], the main path's), errors over all phase-3 shapes.
    The K2 entries' library time is one forward + backward of
    scaled_dot_product_attention (it computes dq, dk and dv together)."""
    train = flash[0]
    src = "paddle_tpu_torch/csrc/flash_attention.cu"
    ref = "paddle_tpu/ops/pallas/flash_attention.py"
    out = []
    for name, part, line, errs, lib in (
            ("flash_attention_fwd", "fwd", 576, ("out",), "fwd"),
            ("flash_attention_bwd_dq", "dq", 1036, ("dq",), "fwd_bwd"),
            ("flash_attention_bwd_dkv", "dkv", 1053, ("dk", "dv"),
             "fwd_bwd")):
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"{ref}:{line}", "launches": launches[name],
            "max_abs_err": max(f["max_abs_err"][e] for f in flash
                               for e in errs),
            "max_row_rel_err": max(f["max_row_rel_err"][e] for f in flash
                                   for e in errs),
            "ms": train["ms"][part], "plain_ms": train["plain_ms"][part],
            "bound_ms": train["bound_ms"][part],
            "bound_by": train["bound_by"][part],
            "library_ms": train["library_ms"][lib]})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the "
              "card", file=sys.stderr)
        return 1
    from paddle_tpu_torch.models import (GenerationConfig, LlamaConfig,
                                         init_state, llama3_8b)
    from paddle_tpu_torch.models import llama_hybrid as TH
    from paddle_tpu_torch.ops import cuda_lib
    from paddle_tpu_torch.ops.pallas import flash_attention as FA
    from paddle_tpu_torch.ops.pallas import flash_mask as FM
    from paddle_tpu_torch.ops.pallas import paged_attention as PA
    from paddle_tpu_torch.serving import create_engine

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cap = torch.cuda.get_device_capability(0)
    require(cap == (9, 0),
            f"need compute capability 9.0 (Hopper), got {cap}")
    emit({"phase": 1, "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "capability": list(cap)})

    # phase 2: build
    build_s = cuda_lib.build()
    emit({"phase": 2, "build_s": build_s, "ptxas": {
        name: [line.strip() for line in log.splitlines()
               if "registers" in line or "spill" in line]
        for name, log in cuda_lib.build_log.items()}})

    # phase 3: kernels vs plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    paged = phase_paged(PA, gen)
    masked = [phase_masked(FM, gen, bucket, plen)
              for bucket, plen in ((512, 448), (2048, 1900), (6144, 5000))]
    flash = [phase_flash(FA, gen, *shape) for shape in FLASH_SHAPES]
    release()

    # phase 4: the main path at full width and depth
    launches = phase_serve(llama3_8b(), PA, FM, create_engine, init_state,
                           GenerationConfig)
    release()

    # phase 5: end-to-end parity, card vs CPU
    phase_parity(llama3_8b(), create_engine, init_state, GenerationConfig)
    release()

    # phase 6: the training path at full width and depth
    launches.update(phase_train(bench_config(LlamaConfig), TH, FA))
    release()

    # phase 7: training parity, card vs CPU
    phase_train_parity(bench_config(LlamaConfig, num_hidden_layers=2,
                                    dtype="float32"), TH)

    rep = masked[1]     # the 2048 bucket: the longest prompts of phase 4
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [
        {"name": "paged_attention", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/paged_attention.cu",
         "replaces": "paddle_tpu/ops/pallas/paged_attention.py:123",
         "launches": launches["paged_attention"],
         "max_abs_err": paged["max_abs_err"],
         "max_row_rel_err": paged["max_row_rel_err"],
         **{k: paged[k] for k in keys}},
        {"name": "flash_mha_masked", "route": "cuda",
         "source": "paddle_tpu_torch/csrc/flash_mask.cu",
         "replaces": "paddle_tpu/ops/pallas/flash_mask.py:193",
         "launches": launches["flash_mha_masked"],
         "max_abs_err": max(m["max_abs_err"] for m in masked),
         "max_row_rel_err": max(m["max_row_rel_err"] for m in masked),
         **{k: rep[k] for k in keys}},
        *flash_entries(flash, launches)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
