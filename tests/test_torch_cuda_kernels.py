"""paddle_tpu_torch CUDA kernels against their plain PyTorch versions, on
the card.  These need an NVIDIA Hopper card and the CUDA toolkit; they
skip elsewhere.  Run them on the machine with the card with::

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the repository's conftest imports jax, which that
machine does not have; this file imports only torch and the port.)

Tolerances: float32 1e-5 absolute (summation order only; for the
flash backward's gradients, which sum hundreds of O(1) terms, 1e-5
relative to the largest reference entry).  bf16 is held per output row
(one query head of one token, over head_dim): ||out - ref|| / ||ref||
<= 2^-6; gradients the same with a floor on ||ref|| (``_grad_row_err``:
a query that sees one key has dq = 0).  The K3/K8 kernels round the
unnormalised probabilities to bf16 before P.V while their plain
versions round the normalised ones (the K1/K2 plain versions round like
the kernels), and each output is rounded to bf16: a few 2^-9 relative
roundings per element.  A row that attends over n keys has |o| ~
n^-1/2, so an absolute limit would be loose exactly on the long rows;
the per-row relative limit is as tight there as on short rows
(:func:`test_bf16_check_catches_a_dropped_page` holds it to that).
"""
import math

import pytest
import torch

from paddle_tpu_torch.ops.pallas import flash_attention as FA
from paddle_tpu_torch.ops.pallas import flash_mask as FM
from paddle_tpu_torch.ops.pallas import paged_attention as PA

pytestmark = pytest.mark.cuda
F32_TOL = 1e-5
BF16_ROW_TOL = 2 ** -6


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _row_rel_err(out, ref, floor=0.0):
    """Per-row ||out - ref|| / max(||ref||, floor) over the last dim; with
    no floor, a row whose reference is all zero (no visible key) must be
    exactly zero."""
    o, r = out.float(), ref.float()
    diff = (o - r).norm(dim=-1)
    norm = r.norm(dim=-1).clamp_min(floor)
    return torch.where(norm > 0, diff / norm.clamp_min(1e-30),
                       torch.where(diff > 0, math.inf, 0.0))


def _grad_row_err(g, ref):
    """The per-row check for gradients.  A row's true gradient can be 0
    where its output is not (dq of a query that sees one key: ds = p (dp
    - delta) with delta = dp), so the denominator has a floor of 2^-6 x
    the RMS row norm of ``ref``: such a row is held to an absolute
    ||g|| <= 2^-12 x that RMS instead of an undefined ratio."""
    rms = ref.float().norm(dim=-1).square().mean().sqrt().item()
    return _row_rel_err(g, ref, floor=2 ** -6 * rms)


def _close(out, ref, dt):
    if dt == torch.float32:
        return (out - ref).abs().max().item() <= F32_TOL
    return _row_rel_err(out, ref).max().item() <= BF16_ROW_TOL


def _paged_inputs(gen, dt, b, nh, kvh, d, ps, lens):
    w = max((n + ps - 1) // ps for n in lens) + 1
    n_pool = b * w + 1
    q = torch.randn(b, nh, d, device="cuda", generator=gen).to(dt)
    kp = torch.randn(n_pool, kvh, ps, d, device="cuda", generator=gen).to(dt)
    vp = torch.randn(n_pool, kvh, ps, d, device="cuda", generator=gen).to(dt)
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    perm = torch.randperm(b * w, device="cuda", generator=gen).reshape(b, w)
    need = (lens_t + ps - 1) // ps
    table = torch.where(torch.arange(w, device="cuda")[None] < need[:, None],
                        perm, n_pool - 1).to(torch.int32).contiguous()
    return q, kp, vp, table, lens_t


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,kvh,d,ps", [(32, 8, 128, 64), (8, 8, 128, 16),
                                         (4, 1, 128, 8)])
def test_paged_kernel_matches_plain(gen, dt, nh, kvh, d, ps):
    args = _paged_inputs(gen, dt, 4, nh, kvh, d, ps, [1, ps, 3 * ps + 5, 700])
    before = PA.paged_attention.launches
    out = PA.paged_attention(*args)
    torch.cuda.synchronize()
    assert PA.paged_attention.launches == before + 1
    ref = PA.paged_attention_xla(*args)
    assert _close(out, ref, dt)


def test_bf16_check_catches_a_dropped_page(gen):
    """A kernel that skipped each row's last page (64 of 8192 keys, an
    absolute change of ~1e-3 on outputs of ~1e-2) must fail the bf16
    check on every head of every slot that loses keys."""
    lens = [1, 64, 65, 1000, 4096, 8192]
    q, kp, vp, table, lens_t = _paged_inputs(gen, torch.bfloat16, 6, 32, 8,
                                             128, 64, lens)
    ref = PA.paged_attention_xla(q, kp, vp, table, lens_t)
    assert _close(PA.paged_attention(q, kp, vp, table, lens_t), ref,
                  torch.bfloat16)
    short = torch.clamp(lens_t - 64, min=1).to(torch.int32)
    err = _row_rel_err(PA.paged_attention(q, kp, vp, table, short), ref)
    assert bool((err[lens_t > 64] > BF16_ROW_TOL).all())


def test_paged_kernel_zero_length_rows_are_zero(gen):
    args = _paged_inputs(gen, torch.float32, 2, 8, 2, 128, 16, [0, 20])
    out = PA.paged_attention(*args)
    torch.cuda.synchronize()
    assert torch.count_nonzero(out[0]) == 0
    ref = PA.paged_attention_xla(*args)
    assert (out[1] - ref[1]).abs().max().item() <= 1e-5


def test_paged_wrapper_rejects(gen):
    q, kp, vp, table, lens = _paged_inputs(gen, torch.float32, 2, 8, 2, 128,
                                           16, [5, 20])
    with pytest.raises(TypeError):
        PA.paged_attention(q.half(), kp.half(), vp.half(), table, lens)
    with pytest.raises(TypeError):
        PA.paged_attention(q, kp, vp, table.long(), lens)
    with pytest.raises(ValueError):
        PA.paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                           kp, vp, table, lens)
    with pytest.raises(ValueError):
        PA.paged_attention(q[..., :64].contiguous(), kp[..., :64].contiguous(),
                           vp[..., :64].contiguous(), table, lens)


def _masked(gen, dt, b, h, kvh, sq, sk, d, causal, real=None, nvec4=False):
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dt)
    k = torch.randn(b, sk, kvh, d, device="cuda", generator=gen).to(dt)
    v = torch.randn(b, sk, kvh, d, device="cuda", generator=gen).to(dt)
    if nvec4:
        seg = (torch.arange(sk, device="cuda") // 37)[None].expand(b, sk)
        vecs = FM.segment_intervals(seg, causal=False)
    else:
        real = torch.tensor(real, device="cuda")
        keep = torch.arange(sk, device="cuda")[None] < real[:, None]
        vecs = FM.padding_mask_to_intervals(keep, sq)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), vecs


CASES = [  # b, h, kvh, sq, sk, d, causal, real, nvec4
    (1, 32, 8, 300, 300, 128, True, (260,), False),
    (2, 8, 2, 130, 130, 128, True, (130, 33), False),
    (1, 4, 4, 100, 333, 128, True, (300,), False),
    (1, 4, 2, 333, 100, 128, True, (100,), False),   # rows with no key
    (2, 4, 2, 257, 257, 128, False, (257, 0), False),  # empty batch
    (1, 4, 4, 200, 200, 128, False, None, True),
]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_masked_kernel_matches_plain(gen, dt, case):
    b, h, kvh, sq, sk, d, causal, real, nvec4 = case
    q, k, v, vecs = _masked(gen, dt, b, h, kvh, sq, sk, d, causal, real,
                            nvec4)
    scale = 1.0 / math.sqrt(d)
    before = FM.flash_mha_masked.launches
    out = FM.flash_mha_masked(q, k, v, vecs, causal, scale)
    torch.cuda.synchronize()
    assert FM.flash_mha_masked.launches == before + 1
    ref = FM.flash_mha_masked_xla(q, k, v, vecs, causal, scale)
    assert _close(out, ref, dt)
    dead = ref.float().abs().sum(-1) == 0
    assert torch.count_nonzero(out.float().abs().sum(-1)[dead]) == 0


def test_bf16_check_catches_dropped_prefill_keys(gen):
    """A masked forward that lost the last 64 real keys (one K block's
    worth) must fail the bf16 check on every row that sees them all."""
    plen, s = 1000, 1100
    q, k, v, vecs = _masked(gen, torch.bfloat16, 1, 32, 8, s, s, 128, True,
                            (plen,))
    scale = 1.0 / math.sqrt(128)
    ref = FM.flash_mha_masked_xla(q, k, v, vecs, True, scale)
    assert _close(FM.flash_mha_masked(q, k, v, vecs, True, scale), ref,
                  torch.bfloat16)
    keep = torch.arange(s, device="cuda")[None] < plen - 64
    short = FM.padding_mask_to_intervals(keep, s)
    err = _row_rel_err(FM.flash_mha_masked(q, k, v, short, True, scale), ref)
    assert bool((err[:, :, plen - 1:] > BF16_ROW_TOL).all())


def test_masked_wrapper_rejects(gen):
    q, k, v, vecs = _masked(gen, torch.float32, 1, 4, 2, 64, 64, 128, True,
                            (64,))
    with pytest.raises(NotImplementedError, match="backward"):
        FM.flash_mha_masked(q.clone().requires_grad_(), k, v, vecs, True, 0.1)
    with pytest.raises(ValueError):
        FM.flash_mha_masked(q, k, v, vecs.long().int()[..., :10], True, 0.1)
    with pytest.raises(ValueError):
        FM.flash_mha_masked(q[..., :64], k[..., :64], v[..., :64], vecs,
                            True, 0.1)


# ----------------------------------------------------------- K1 / K2
FLASH_CASES = [  # b, h, kvh, sq, sk, causal
    (1, 4, 4, 256, 256, True),
    (2, 4, 2, 200, 200, False),      # ragged edge, no causal mask
    (1, 32, 8, 300, 300, True),      # llama3_8b heads: GQA group 4
    (1, 4, 2, 150, 300, True),       # sq < sk
    (1, 4, 2, 300, 150, True),       # sq > sk: rows with no visible key
    (1, 2, 1, 70, 1000, True),
]


def _flash_inputs(gen, dt, b, h, kvh, sq, sk, d=128):
    """q/k/v as the transposed [B, S, H, D] views sdpa passes, and a
    random cotangent."""
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dt)
    k = torch.randn(b, sk, kvh, d, device="cuda", generator=gen).to(dt)
    v = torch.randn(b, sk, kvh, d, device="cuda", generator=gen).to(dt)
    do = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dt)
    return (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            do.transpose(1, 2))


def _grad_close(out, ref, dt):
    if dt == torch.float32:
        scale = max(1.0, ref.abs().max().item())
        return (out - ref).abs().max().item() <= F32_TOL * scale
    return _grad_row_err(out, ref).max().item() <= BF16_ROW_TOL


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels_match_plain(gen, dt, case):
    b, h, kvh, sq, sk, causal = case
    q, k, v, do = _flash_inputs(gen, dt, b, h, kvh, sq, sk)
    scale = 1.0 / math.sqrt(128)
    n0 = (FA.flash_mha.fwd_launches, FA.flash_mha.dq_launches,
          FA.flash_mha.dkv_launches)
    out, lse = FA._flash_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    ref, ref_lse = FA._flash_fwd_xla(q, k, v, causal, scale)
    assert _close(out, ref, dt)
    dead = ref_lse == FA.LSE_INVALID
    assert bool((lse[dead] == FA.LSE_INVALID).all())
    assert torch.count_nonzero(out.float().abs().sum(-1)[dead]) == 0
    assert (lse[~dead] - ref_lse[~dead]).abs().max().item() <= 1e-3
    grads = FA._flash_bwd(q, k, v, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    refs = FA._flash_bwd_xla(q, k, v, out, lse, do, causal, scale)
    for g, r in zip(grads, refs):
        assert g.shape == r.shape and g.dtype == r.dtype
        assert _grad_close(g, r, dt)
    assert torch.count_nonzero(grads[0].float().abs().sum(-1)[dead]) == 0
    assert (FA.flash_mha.fwd_launches, FA.flash_mha.dq_launches,
            FA.flash_mha.dkv_launches) == (n0[0] + 1, n0[1] + 1, n0[2] + 1)


def test_flash_autograd_and_sdpa_route(gen):
    """sdpa's unmasked route runs K1 forward and the K2 backward through
    the autograd Function."""
    q, k, v, do = _flash_inputs(gen, torch.float32, 2, 8, 2, 130, 130)
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    n0 = (FA.flash_mha.fwd_launches, FA.flash_mha.dq_launches,
          FA.flash_mha.dkv_launches)
    out = FA.sdpa(qs, ks, vs, is_causal=True)
    out.backward(do.transpose(1, 2))
    torch.cuda.synchronize()
    assert (FA.flash_mha.fwd_launches, FA.flash_mha.dq_launches,
            FA.flash_mha.dkv_launches) == (n0[0] + 1, n0[1] + 1, n0[2] + 1)
    scale = 1.0 / math.sqrt(128)
    ref, lse = FA._flash_fwd_xla(q, k, v, True, scale)
    assert _close(out.transpose(1, 2), ref, torch.float32)
    refs = FA._flash_bwd_xla(q, k, v, ref, lse, do, True, scale)
    for g, r in zip((qs.grad, ks.grad, vs.grad), refs):
        assert _grad_close(g.transpose(1, 2), r, torch.float32)


def test_bf16_check_catches_dropped_flash_keys(gen):
    """K1/K2 told 64 keys fewer than there are must fail the bf16 check
    on every live row of out and dq, and on every key row of dk/dv."""
    q, k, v, do = _flash_inputs(gen, torch.bfloat16, 1, 8, 2, 1000, 700)
    scale = 1.0 / math.sqrt(128)
    out, lse = FA._flash_fwd(q, k, v, True, scale)
    ref, _ = FA._flash_fwd_xla(q, k, v, True, scale)
    assert _close(out, ref, torch.bfloat16)
    live = ref.float().abs().sum(-1) > 0
    short = FA._flash_fwd(q, k[:, :, :-64], v[:, :, :-64], True, scale)[0]
    assert bool((_row_rel_err(short, ref)[live] > BF16_ROW_TOL).all())
    refs = FA._flash_bwd_xla(q, k, v, out, lse, do, True, scale)
    bad = FA._flash_bwd(q, k[:, :, :-64], v[:, :, :-64], out, lse, do,
                        True, scale)
    # a row that sees a single key has dq = 0 exactly (delta = dp)
    multi = torch.arange(1000, device="cuda") - 300 >= 1
    assert bool((_grad_row_err(bad[0], refs[0])[live & multi]
                 > BF16_ROW_TOL).all())
    for g, r in zip(bad[1:], refs[1:]):
        assert bool((_grad_row_err(g, r[:, :, :-64]) > BF16_ROW_TOL).all())


def test_flash_wrapper_rejects(gen):
    q, k, v, _ = _flash_inputs(gen, torch.float32, 1, 4, 2, 64, 64)
    with pytest.raises(TypeError):
        FA._flash_fwd(q.half(), k.half(), v.half(), True, 0.1)
    with pytest.raises(ValueError):
        FA._flash_fwd(q[..., :64], k[..., :64], v[..., :64], True, 0.1)
    with pytest.raises(ValueError):
        FA._flash_fwd(q, k[:, :1].expand(1, 3, 64, 128), v[:, :1].expand(
            1, 3, 64, 128), True, 0.1)
