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

The flash kernels K1/K2 are held in float32 and bf16 over cases at the
edges of the bf16 (sm90 wgmma + TMA) kernels' tiles: one query row, one
key, fewer keys than a tile, lengths one past a tile, a GQA group of 8,
a long non-causal row, rows with no visible key.  Two bf16 backward runs
must agree bit for bit (the kernels use no float atomics).

The weight-only GEMV (K4) and the gather-LoRA matmul (K5) are held per
output row (one token over N): float32 1e-5 relative (summation order
over K up to 14336), bf16 2^-7 (the plain versions round once, at the
output, as the kernels do; the limit leaves room for summation order).
Each has a planted fault that must fail every row it touches.

The K8 backward and bias kernels (forward with lse, dq, dk/dv, dbias)
are held to their plain versions the same way, float32 and bf16 (a bf16
bias in the bf16 cases, so the dbias kernel's f32 accumulator for a
broadcast bias runs too), over ragged lengths, GQA, nvec 2 and 4 and
every bias broadcast shape, with their launch counters.  The bf16
forward, dq and dk/dv (flash_sm90.cuh: the tiles the intervals hide are
skipped) are also held at the edges of their tiles, with per-q-head
intervals under GQA, a key block hidden from one consumer warpgroup
only, rows with no visible key, biases of every broadcast shape and
dtype, unaligned and stride-0 bias rows and an -inf bias row, and must
repeat bit for bit.

The grouped expert FFN (K9, forward and backward) is held to its plain
versions in float32 (1e-5 relative to each output's largest entry: f32
sums over D, F or an expert's rows in another order) and bf16 per row
(2^-7: both sides round h and ds to bf16 from f32 sums taken in another
order, which flips a last bit now and then, and round each output
once), plain and gated, with an expert that owns no tile, trailing
padding tiles and float32 biases beside bf16 weights; a tile pointed at
the next expert must fail the check.  RMSNorm (K6) is held to its plain
version per row (float32 1e-5 absolute on O(1) entries, bf16 and fp16
2^-7: one rounding of the output each) with a planted fault (the weight
read one column off).

The dense-cache decode attention (K7) is held to its plain version the
same way as K3 (float32 1e-5 absolute, bf16 2^-6 per row) at the bench's
decode shape, the reference's own K7 measurement shape at T 8192,
head_dim 64 (TinyLlama-1.1B's 32/4 heads) and 256, groups of 20 and 32,
one split and many, and a row with no key, with a planted fault (every
row told 64 keys fewer), bit-equal reruns and the wrapper's rejections.

The head-dim routes: d outside {64, 128, 256} runs the plain versions on
the card (K7 here, K1/K2 and K8 through ``sdpa`` in the CPU tests); K3
runs a kernel at every head dim: its ``mma.sync`` instances at the
multiples of 16 up to 256, its CUDA-core body at every other head dim.  The K1/K2 and K8 cases (kernel vs plain in f32
and bf16, planted faults, bit-equal reruns) run at each of the head
dims 64, 128 and 256 that the kernels are built for.  The bf16 K8 dbias
(flash_sm90.cuh) is held through the K8 backward cases (every bias
broadcast shape and dtype, Sk 1001, intervals with a bias) and a planted
fault (64 keys dropped).

The paged attention (K3) is held at head dims 32, 64, 128 and 256,
groups of 1, 4 and 32 and pages of 8, 16, 24, 64 and 128 tokens, and at
the padded head dims (the other multiples of 16 up to 256) at groups 1
and 32 and pages of 24 and 128, each with a planted fault, with
rows of 0 and 1 keys, a page edge and a full table, and a dropped page
must fail the bf16 check at each head dim; its reruns (several key
splits merged by ticket) repeat bit for bit.  The CUDA-core body is held
at head dims 8, 24, 40, 72, 100 and 320, groups 1 and 32, in float32 and
bf16, with a planted fault and bit-equal reruns.  K4 is also held at M 1,
8, 17 and 64 in both kinds, one split and many, and repeats bit for
bit.
"""
import math

import pytest
import torch

from paddle_tpu_torch.ops import cuda_lib
from paddle_tpu_torch.ops.pallas import decode_attention as DA
from paddle_tpu_torch.ops.pallas import flash_attention as FA
from paddle_tpu_torch.ops.pallas import flash_mask as FM
from paddle_tpu_torch.ops.pallas import grouped_ffn as GF
from paddle_tpu_torch.ops.pallas import lora_matmul as LM
from paddle_tpu_torch.ops.pallas import paged_attention as PA
from paddle_tpu_torch.ops.pallas import quant_matmul as QM
from paddle_tpu_torch.ops.pallas import rms_norm as RN

pytestmark = pytest.mark.cuda
F32_TOL = 1e-5
BF16_ROW_TOL = 2 ** -6
# the head dims of the K1/K2 and K8 kernels (the reference's sdpa sends
# these to its Pallas kernels)
FLASH_DIMS = (64, 128, 256)


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


K3_DIMS = (32, 64, 128, 256)
K3_GROUPS = ((8, 8), (16, 4), (32, 1))   # nh, kvh: groups 1, 4 and 32
K3_PAGES = (8, 16, 24, 64, 128)
# the instances whose shared-memory rows are padded (D / 8 + 1 chunks)
# instead of XOR-swizzled: every multiple of 16 up to 256 besides K3_DIMS
K3_PADDED_DIMS = tuple(d for d in range(16, 257, 16) if d not in K3_DIMS)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps", K3_PAGES)
@pytest.mark.parametrize("nh,kvh", K3_GROUPS)
@pytest.mark.parametrize("d", K3_DIMS)
def test_paged_kernel_matches_plain(gen, dt, d, nh, kvh, ps):
    """Rows of 0 and 1 keys, a page edge, a ragged row and a full table
    (one page of padding past the longest row, which the kernel must not
    read); a row with no key is zero (the plain version gives NaN)."""
    full = 8 * ps + 64
    lens = [0, 1, ps, 3 * ps + 7, -(-full // ps) * ps]
    args = _paged_inputs(gen, dt, 5, nh, kvh, d, ps, lens)
    before = PA.paged_attention.launches
    out = PA.paged_attention(*args)
    torch.cuda.synchronize()
    assert PA.paged_attention.launches == before + 1
    assert out.shape == args[0].shape and out.dtype == dt
    assert torch.count_nonzero(out[0]) == 0
    ref = PA.paged_attention_xla(*args)
    assert _close(out[1:], ref[1:], dt)


@pytest.mark.parametrize("d,nh,kvh,ps,lens", [
    (128, 32, 8, 64, [1, 64, 65, 1000, 4096, 8192]),
    (32, 4, 2, 24, [64, 65, 1000, 2048]),
    (64, 32, 4, 24, [64, 65, 1000, 2048]),
    (256, 16, 4, 24, [64, 65, 1000, 2048]),
    (128, 32, 1, 24, [64, 65, 1000, 2048])])
def test_bf16_check_catches_a_dropped_page(gen, d, nh, kvh, ps, lens):
    """A kernel that skipped each row's last page (64 of 8192 keys, an
    absolute change of ~1e-3 on outputs of ~1e-2) must fail the bf16
    check on every head of every slot that loses keys, at each head dim
    and a group of 32."""
    q, kp, vp, table, lens_t = _paged_inputs(gen, torch.bfloat16, len(lens),
                                             nh, kvh, d, ps, lens)
    ref = PA.paged_attention_xla(q, kp, vp, table, lens_t)
    assert _close(PA.paged_attention(q, kp, vp, table, lens_t), ref,
                  torch.bfloat16)
    short = torch.clamp(lens_t - 64, min=1).to(torch.int32)
    err = _row_rel_err(PA.paged_attention(q, kp, vp, table, short), ref)
    assert bool((err[lens_t > 64] > BF16_ROW_TOL).all())


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,kvh", ((8, 8), (32, 1)))
@pytest.mark.parametrize("d", K3_PADDED_DIMS)
def test_paged_padded_dims_match_plain(gen, dt, d, nh, kvh):
    """Each padded instance at groups 1 and 32, pages of 24 (a tile spans
    pages) and 128 (a page spans tiles), against the plain version: rows
    of 0 and 1 keys, a page edge, ragged rows and a long one (several key
    splits merged by ticket); a bf16 call repeats bit for bit, and a
    planted fault (each long row told 64 keys fewer) fails the bf16
    check on every row that loses keys."""
    for ps in (24, 128):
        lens = [0, 1, ps, 3 * ps + 7, 1000, 4096]
        args = _paged_inputs(gen, dt, len(lens), nh, kvh, d, ps, lens)
        before = PA.paged_attention.launches
        out = PA.paged_attention(*args)
        torch.cuda.synchronize()
        assert PA.paged_attention.launches == before + 1
        assert torch.count_nonzero(out[0]) == 0
        ref = PA.paged_attention_xla(*args)
        assert _close(out[1:], ref[1:], dt)
        if dt == torch.float32:
            continue
        assert torch.equal(out, PA.paged_attention(*args))
        q, kp, vp, table, lens_t = args
        short = torch.clamp(lens_t - 64, min=1).to(torch.int32)
        err = _row_rel_err(PA.paged_attention(q, kp, vp, table, short), ref)
        assert bool((err[lens_t > 64] > BF16_ROW_TOL).all())


# head dims that no mma.sync instance serves: the CUDA-core body
K3_ANY_DIMS = (8, 24, 40, 72, 100, 320)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nh,kvh", ((8, 8), (32, 1)))
@pytest.mark.parametrize("d", K3_ANY_DIMS)
def test_paged_any_dims_match_plain(gen, dt, d, nh, kvh):
    """The CUDA-core body at groups 1 and 32, pages of 24 and 128,
    against the plain version: rows of 0 and 1 keys, a page edge, ragged
    rows and a long one (several 256-key chunks merged in order); two
    calls give the same bits, and a planted fault (each long row told 64
    keys fewer) fails the check on every row that loses keys."""
    assert PA._body(d) == "any"
    for ps in (24, 128):
        lens = [0, 1, ps, 3 * ps + 7, 1000, 4096]
        args = _paged_inputs(gen, dt, len(lens), nh, kvh, d, ps, lens)
        before = PA.paged_attention.launches
        out = PA.paged_attention(*args)
        torch.cuda.synchronize()
        assert PA.paged_attention.launches == before + 1
        assert out.shape == args[0].shape and out.dtype == dt
        assert torch.count_nonzero(out[0]) == 0
        ref = PA.paged_attention_xla(*args)
        assert _close(out[1:], ref[1:], dt)
        assert torch.equal(out, PA.paged_attention(*args))
        q, kp, vp, table, lens_t = args
        short = torch.clamp(lens_t - 64, min=1).to(torch.int32)
        bad = PA.paged_attention(q, kp, vp, table, short)
        hit = lens_t > 64
        if dt == torch.bfloat16:
            err = _row_rel_err(bad, ref)
            assert bool((err[hit] > BF16_ROW_TOL).all())
        else:
            err = (bad - ref).abs().amax(dim=-1)
            assert bool((err[hit] > F32_TOL).all())


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
    wide = 20000        # no key and query head fit a block's shared memory
    with pytest.raises(ValueError, match="shared memory"):
        PA.paged_attention(q[..., :1].expand(2, 8, wide).contiguous(),
                           kp[..., :1].expand(-1, -1, -1, wide).contiguous(),
                           vp[..., :1].expand(-1, -1, -1, wide).contiguous(),
                           table, lens)


def test_paged_kernel_is_deterministic(gen):
    """The last split's CTA merges the splits in split order: two calls
    give the same bits, and the ticket counters are left at zero."""
    for d, nh, kvh, ps, lens in ((128, 32, 8, 64, [8192, 100, 0, 4096]),
                                 (32, 32, 1, 24, [5000, 24, 1, 777]),
                                 (256, 16, 4, 16, [2048, 2047, 3, 900])):
        args = _paged_inputs(gen, torch.bfloat16, len(lens), nh, kvh, d, ps,
                             lens)
        first = PA.paged_attention(*args)
        second = PA.paged_attention(*args)
        torch.cuda.synchronize()
        assert torch.equal(first, second)
        live = args[4] > 0
        assert _close(first[live], PA.paged_attention_xla(*args)[live],
                      torch.bfloat16)
    tickets = [buf for key, buf in cuda_lib._scratch.items()
               if key[0] == "paged_attention.tickets"]
    assert tickets and all(torch.count_nonzero(buf) == 0 for buf in tickets)


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
    """Bad inputs raise; an input that requires grad no longer does: it
    takes the autograd Function, whose forward writes lse."""
    q, k, v, vecs = _masked(gen, torch.float32, 1, 4, 2, 64, 64, 128, True,
                            (64,))
    n0 = (FM.flash_mha_masked.launches, FM.flash_mha_masked.lse_launches)
    out = FM.flash_mha_masked(q.clone().requires_grad_(), k, v, vecs, True,
                              0.1)
    assert out.requires_grad
    assert (FM.flash_mha_masked.launches,
            FM.flash_mha_masked.lse_launches) == (n0[0] + 1, n0[1] + 1)
    bias = torch.zeros(1, 4, 64, 64, device="cuda")
    with pytest.raises(TypeError):
        FM.flash_mha_biased(q, k, v, bias.double(), True, 0.1)
    with pytest.raises(ValueError):
        FM.flash_mha_biased(q, k, v, bias[:, :, :32], True, 0.1)
    with pytest.raises(ValueError):
        FM.flash_mha_masked(q, k, v, vecs.long().int()[..., :10], True, 0.1)
    with pytest.raises(ValueError, match="head_dim"):
        FM.flash_mha_masked(q[..., :64], k, v, vecs, True, 0.1)


# ------------------------------------------- K8 backward and the bias
K8_CASES = [  # b, h, kvh, sq, sk, causal, intervals, bias (Bb, Hb)
    (2, 8, 2, 300, 300, True, "pad", None),      # ragged lengths, GQA
    (2, 4, 2, 200, 200, True, "seg2", None),     # nvec 2
    (1, 4, 4, 256, 256, False, "seg4", None),    # nvec 4
    (1, 4, 2, 150, 300, True, "pad", None),      # sq < sk
    (1, 4, 2, 300, 150, True, "pad", None),      # sq > sk: rows with no key
    (2, 4, 4, 257, 257, True, None, (1, 4)),     # every bias broadcast shape
    (2, 4, 4, 200, 200, True, None, (2, 1)),
    (2, 4, 4, 200, 200, False, None, (1, 1)),
    (2, 4, 2, 130, 130, True, None, (2, 4)),     # bias under GQA
    (2, 4, 2, 200, 200, True, "pad", (1, 4)),    # intervals and bias
]


def _k8_operands(gen, dt, b, h, sq, sk, kind, bshape):
    vecs = bias = None
    if kind == "pad":
        real = torch.tensor([sk, sk // 3][:b], device="cuda")
        vecs = FM.padding_mask_to_intervals(
            torch.arange(sk, device="cuda")[None] < real[:, None], sq)
    elif kind is not None:
        seg = (torch.arange(sk, device="cuda") // 37)[None].expand(b, sk)
        vecs = FM.segment_intervals(seg, causal=kind == "seg2")
    if bshape is not None:
        bias = (torch.randn(*bshape, sq, sk, device="cuda", generator=gen)
                * 0.5).to(dt)
    return vecs, bias


def _k8_counts():
    return (FM.flash_mha_masked.launches, FM.flash_mha_biased.launches,
            FM.flash_mha_masked.lse_launches, FM.flash_mha_masked.dq_launches,
            FM.flash_mha_masked.dkv_launches,
            FM.flash_mha_masked.dbias_launches)


@pytest.mark.parametrize("d", FLASH_DIMS)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", K8_CASES)
def test_k8_kernels_match_plain(gen, dt, case, d):
    """The K8 forward (with lse), dq, dk/dv and dbias kernels against
    their plain versions, and one launch of each (no dbias without a
    bias), at each head dim."""
    b, h, kvh, sq, sk, causal, kind, bshape = case
    q, k, v, do = _flash_inputs(gen, dt, b, h, kvh, sq, sk, d)
    vecs, bias = _k8_operands(gen, dt, b, h, sq, sk, kind, bshape)
    scale = 1.0 / math.sqrt(d)
    n0 = _k8_counts()
    out, lse = FM._masked_fwd(q, k, v, vecs, bias, causal, scale, True)
    torch.cuda.synchronize()
    ref, ref_lse = FM._masked_fwd_xla(q, k, v, vecs, bias, causal, scale)
    assert _close(out, ref, dt)
    dead = ref_lse == FA.LSE_INVALID
    assert bool((lse[dead] == FA.LSE_INVALID).all())
    assert torch.count_nonzero(out.float().abs().sum(-1)[dead]) == 0
    assert (lse[~dead] - ref_lse[~dead]).abs().max().item() <= 1e-3
    grads = FM._masked_bwd(q, k, v, out, lse, do, vecs, bias, causal, scale,
                           need_dbias=bias is not None)
    torch.cuda.synchronize()
    args = (q, k, v, out, lse, do, vecs, bias, causal, scale)
    refs = (FM._masked_bwd_dq_xla(*args), *FM._masked_bwd_dkv_xla(*args),
            FM._masked_bwd_dbias_xla(*args) if bias is not None else None)
    for g, r in zip(grads, refs):
        if r is None:
            assert g is None
            continue
        assert g.shape == r.shape and g.dtype == r.dtype
        assert _grad_close(g, r, dt)
    assert torch.count_nonzero(grads[0].float().abs().sum(-1)[dead]) == 0
    masked, biased = (0, 1) if bias is not None else (1, 0)
    assert _k8_counts() == (n0[0] + masked, n0[1] + biased, n0[2] + 1,
                            n0[3] + 1, n0[4] + 1, n0[5] + biased)


def test_k8_autograd_routes(gen):
    """sdpa's flashmask and float-mask routes run the K8 Function: one
    forward with lse, one dq and one dk/dv per backward, and the dbias
    kernel only when the bias requires grad."""
    q, k, v, do = _flash_inputs(gen, torch.bfloat16, 2, 8, 2, 200, 200)
    vecs, bias = _k8_operands(gen, torch.float32, 2, 8, 200, 200, "seg2",
                              (1, 2))           # a bias per kv head
    scale = 1.0 / math.sqrt(128)
    for bias_grad in (False, True):
        leaves = [t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v)]
        b_leaf = bias.clone().requires_grad_(bias_grad)
        n0 = _k8_counts()
        out = FA.sdpa(*leaves, flashmask=vecs, is_causal=True)
        out.backward(do.transpose(1, 2))
        out_b = FA.sdpa(*leaves, attn_mask=b_leaf, is_causal=True)
        out_b.backward(do.transpose(1, 2))
        torch.cuda.synchronize()
        assert _k8_counts() == (n0[0] + 1, n0[1] + 1, n0[2] + 2, n0[3] + 2,
                                n0[4] + 2, n0[5] + int(bias_grad))
        assert (b_leaf.grad is not None) == bias_grad
        if bias_grad:
            rep = b_leaf.detach().repeat_interleave(4, dim=1)
            ref, lse = FM._masked_fwd_xla(q, k, v, None, rep, True, scale)
            want = FM._masked_bwd_dbias_xla(q, k, v, ref, lse, do, None, rep,
                                            True, scale)
            want = want.view(1, 2, 4, 200, 200).sum(dim=2)
            assert _grad_row_err(b_leaf.grad, want).max().item() \
                <= BF16_ROW_TOL
    with torch.no_grad():
        n0 = _k8_counts()
        FA.sdpa(*leaves, flashmask=vecs, is_causal=True)
        assert _k8_counts()[2] == n0[2]          # no lse without grad


# ------------------------------------- the bf16 K8 forward (flash_sm90)
TILE_EDGES = (0, 1, 63, 64, 127)    # offsets within a 128-key tile
F16 = torch.float16
K8_FWD_CASES = [  # name, b, h, kvh, sq, sk, causal, intervals, bias
    *[(f"docs2_edge{o}", 1, 4, 2, 640, 640, True, ("docs", 2, o), None)
      for o in TILE_EDGES],
    *[(f"docs4_edge{o}", 1, 4, 4, 640, 640, False, ("docs", 4, o), None)
      for o in TILE_EDGES],
    *[(f"pad_edge{o}", 2, 4, 2, 512, 512, True, ("pad", (512, 256 + o)),
       None) for o in TILE_EDGES],
    ("hidden_tile", 1, 4, 4, 512, 512, True, "hole", None),
    ("hidden_from_some_rows", 1, 4, 4, 512, 512, True, "rows", None),
    ("dead_rows", 1, 4, 4, 512, 512, True, "dead", None),
    ("per_head", 2, 4, 4, 700, 700, True, "heads", None),
    ("head_broadcast", 2, 4, 4, 700, 700, True, ("pad", (700, 300)), None),
    ("window_batch_stride0", 2, 4, 4, 2048, 2048, True, "window", None),
    ("gqa4", 1, 8, 2, 600, 600, True, ("pad", (450,)), None),
    ("sq_lt_sk", 1, 4, 2, 300, 700, True, ("pad", (650,)), None),
    ("sq_gt_sk", 1, 4, 2, 700, 300, True, ("pad", (250,)), None),
    ("ragged_1000x700", 2, 4, 2, 1000, 700, True, ("docs", 2, 5), None),
    ("ragged_333", 1, 4, 4, 333, 333, False, ("docs", 4, 7), None),
    *[(f"bias_{str(dt)[6:]}_{bb}x{hb}", 2, 4, 4, 300, 300, True, None,
       (bb, hb, dt))
      for dt in (torch.float32, torch.bfloat16, F16)
      for bb, hb in ((2, 4), (1, 4), (2, 1), (1, 1))],
    ("bias_sk1001_f32", 1, 4, 2, 300, 1001, True, None,
     (1, 4, torch.float32)),
    ("bias_sk1001_bf16", 1, 4, 2, 300, 1001, True, None,
     (1, 4, torch.bfloat16)),
    ("bias_inf_row", 1, 4, 4, 300, 300, True, None, "inf_row"),
    ("bias_and_docs", 2, 4, 2, 640, 640, True, ("docs", 2, 63),
     (1, 4, torch.float32)),
    ("bias_and_padding", 2, 4, 4, 333, 333, False, ("pad", (333, 100)),
     (2, 1, torch.bfloat16)),
]


def _fwd_intervals(spec, b, h, sq, sk):
    """mask_vecs of one K8_FWD_CASES interval spec, or None."""
    cols = torch.arange(sk, device="cuda")
    full = torch.full((sk,), sq, dtype=torch.int32, device="cuda")
    if spec is None:
        return None
    if spec == "window":            # [B, 1, 2, Sk], batch stride 0
        return FM.sliding_window_intervals(sk, 300, b, device="cuda")
    if spec == "heads":             # [1, H, 2, Sk]: a window per head
        return torch.cat([FM.sliding_window_intervals(
            sk, 100 + 150 * i, 1, device="cuda") for i in range(h)], dim=1)
    if spec in ("hole", "rows", "dead"):
        inside = (cols >= 128) & (cols < 256)
        start = {"hole": torch.where(inside, 0, full),
                 "rows": torch.where(inside, 0, full),
                 "dead": torch.full_like(full, 100)}[spec]
        end = {"hole": full, "rows": torch.where(inside, 192, full),
               "dead": torch.full_like(full, 200)}[spec]
        return torch.stack([start, end]).to(torch.int32)[None, None]
    if spec[0] == "pad":
        real = torch.tensor(spec[1], device="cuda")
        return FM.padding_mask_to_intervals(cols[None] < real[:, None], sq)
    _, nvec, off = spec             # three documents, cut at 128 + off
    seg = (cols >= 128 + off).int() + (cols >= 384 + off).int()
    return FM.segment_intervals(seg[None].expand(b, sk), causal=nvec == 2)


def _fwd_bias(gen, spec, h, sq, sk):
    if spec is None:
        return None
    if spec == "inf_row":           # two rows of head 0 see only -inf
        bias = torch.randn(1, h, sq, sk, device="cuda", generator=gen)
        bias[0, 0, 7] = bias[0, 0, 200] = -math.inf
        return bias
    bb, hb, dt = spec
    return (torch.randn(bb, hb, sq, sk, device="cuda", generator=gen)
            * 0.5).to(dt)


def _check_k8_fwd(q, k, v, vecs, bias, causal, need_lse=True):
    """The bf16 K8 forward against its plain version: per row, dead rows
    zero with lse = LSE_INVALID, live lse to 1e-3, one launch counted.
    Returns (out, dead rows)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    n0 = _k8_counts()
    out, lse = FM._masked_fwd(q, k, v, vecs, bias, causal, scale, need_lse)
    torch.cuda.synchronize()
    ref, ref_lse = FM._masked_fwd_xla(q, k, v, vecs, bias, causal, scale)
    assert _close(out, ref, torch.bfloat16)
    dead = ref_lse == FA.LSE_INVALID
    assert torch.count_nonzero(out.float().abs().sum(-1)[dead]) == 0
    if need_lse:
        assert bool((lse[dead] == FA.LSE_INVALID).all())
        if bool((~dead).any()):
            assert (lse[~dead] - ref_lse[~dead]).abs().max().item() <= 1e-3
    else:
        assert lse is None
    masked, biased = (0, 1) if bias is not None else (1, 0)
    assert _k8_counts() == (n0[0] + masked, n0[1] + biased,
                            n0[2] + int(need_lse), *n0[3:])
    return out, dead


@pytest.mark.parametrize("d", FLASH_DIMS)
@pytest.mark.parametrize("case", K8_FWD_CASES, ids=[c[0] for c in
                                                    K8_FWD_CASES])
def test_k8_bf16_forward_matches_plain(gen, case, d):
    """The bf16 K8 forward (flash_sm90.cuh: tiles skipped, clean or
    partial by the tile table) at the edges of its tiles and its mask
    and bias operands, at each head dim."""
    name, b, h, kvh, sq, sk, causal, ivl, bspec = case
    q, k, v, _ = _flash_inputs(gen, torch.bfloat16, b, h, kvh, sq, sk, d)
    vecs = _fwd_intervals(ivl, b, h, sq, sk)
    bias = _fwd_bias(gen, bspec, h, sq, sk)
    _, dead = _check_k8_fwd(q, k, v, vecs, bias, causal)
    if name in ("dead_rows", "sq_gt_sk", "bias_inf_row"):
        assert bool(dead.any())


def test_k8_bf16_forward_without_lse(gen):
    q, k, v, _ = _flash_inputs(gen, torch.bfloat16, 2, 8, 2, 640, 640)
    _check_k8_fwd(q, k, v, _fwd_intervals(("docs", 2, 1), 2, 8, 640, 640),
                  None, True, need_lse=False)
    _check_k8_fwd(q, k, v, None, _fwd_bias(gen, (1, 8, torch.float32), 8,
                                           640, 640), True, need_lse=False)


def test_k8_bf16_forward_takes_other_layouts(gen):
    """Contiguous [B, H, S, D] q/k/v, and a bias whose rows are a slice
    of wider rows (row stride Sk + 3: neither 16-byte nor pair aligned)."""
    q, k, v = (torch.randn(2, n, 333, 128, device="cuda", generator=gen)
               .to(torch.bfloat16) for n in (8, 2, 2))
    wide = torch.randn(1, 8, 333, 336, device="cuda", generator=gen)
    bias = wide[..., :333]
    assert bias.stride(2) == 336 and bias.stride(3) == 1
    _check_k8_fwd(q, k, v, _fwd_intervals(("pad", (333, 120)), 2, 8, 333,
                                          333), None, True)
    _check_k8_fwd(q, k, v, None, bias, True)
    _check_k8_fwd(q, k, v, None, bias.to(torch.bfloat16), False)


@pytest.mark.parametrize("d", FLASH_DIMS)
def test_k8_bf16_forward_is_deterministic(gen, d):
    """Two runs of the bf16 forward give the same bits (out and lse)."""
    q, k, v, _ = _flash_inputs(gen, torch.bfloat16, 2, 8, 2, 1000, 1000, d)
    vecs = _fwd_intervals(("docs", 4, 63), 2, 8, 1000, 1000)
    bias = _fwd_bias(gen, (1, 8, torch.float32), 8, 1000, 1000)
    scale = 1.0 / math.sqrt(d)
    for ivl, b_ in ((vecs, None), (None, bias), (vecs, bias)):
        first = FM._masked_fwd(q, k, v, ivl, b_, False, scale, True)
        second = FM._masked_fwd(q, k, v, ivl, b_, False, scale, True)
        torch.cuda.synchronize()
        for x, y in zip(first, second):
            assert torch.equal(x, y)


@pytest.mark.parametrize("spec", [("pad", (333, 100)), ("docs", 2, 64),
                                  ("docs", 4, 1), "heads", "dead"],
                         ids=["pad", "docs2", "docs4", "per_head", "dead"])
def test_k8_tile_table_matches_plain(gen, spec):
    """The tile-table kernel the bf16 forward runs first, alone, against
    _tile_table_xla: bit for bit (a ragged last 64-key block at Sk 333)."""
    vecs = _fwd_intervals(spec, 2, 4, 333, 333)
    before = FM._tile_table.launches
    tbl = FM._tile_table(vecs)
    torch.cuda.synchronize()
    assert FM._tile_table.launches == before + 1
    assert torch.equal(tbl.cpu(), FM._tile_table_xla(vecs.cpu(), 333))


# ----------------------------------- the bf16 K8 backward (flash_sm90)
K8_BWD_CASES = [  # name, b, h, kvh, sq, sk, causal, intervals, bias
    *[(f"docs2_edge{o}", 1, 4, 2, 640, 640, True, ("docs", 2, o), None)
      for o in TILE_EDGES],
    *[(f"docs4_edge{o}", 1, 4, 4, 640, 640, False, ("docs", 4, o), None)
      for o in TILE_EDGES],
    ("pad_333", 2, 4, 2, 333, 333, True, ("pad", (333, 100)), None),
    ("pad_129", 1, 4, 4, 129, 129, True, ("pad", (100,)), None),
    ("sq_lt_sk", 1, 4, 2, 300, 700, True, ("pad", (650,)), None),
    ("sq_gt_sk", 1, 4, 2, 700, 300, True, ("pad", (250,)), None),
    ("ragged_1000x700", 2, 4, 2, 1000, 700, True, ("docs", 2, 5), None),
    ("ragged_333_nvec4", 1, 4, 4, 333, 333, False, ("docs", 4, 7), None),
    ("per_head_gqa4", 2, 8, 2, 700, 700, True, "heads", None),
    ("per_head_gqa8", 1, 8, 1, 512, 512, False, "heads", None),
    ("hidden_tile", 1, 4, 4, 512, 512, True, "hole", None),
    ("hidden_from_one_warpgroup", 1, 4, 2, 512, 512, True, "hole64", None),
    ("hidden_from_some_rows", 1, 4, 4, 512, 512, True, "rows", None),
    ("dead_rows", 1, 4, 4, 512, 512, True, "dead", None),
    ("window_batch_stride0", 2, 4, 4, 2048, 2048, True, "window", None),
    *[(f"bias_{str(dt)[6:]}_{bb}x{hb}", 2, 4, 4, 300, 300, True, None,
       (bb, hb, dt))
      for dt in (torch.float32, torch.bfloat16, F16)
      for bb, hb in ((2, 4), (1, 4), (2, 1), (1, 1))],
    ("bias_gqa", 2, 8, 2, 333, 333, False, None, (1, 8, torch.float32)),
    ("bias_sk1001_f16", 1, 4, 2, 300, 1001, True, None, (1, 4, F16)),
    ("bias_inf_row", 1, 4, 4, 300, 300, True, None, "inf_row"),
    ("bias_and_docs", 2, 4, 2, 640, 640, True, ("docs", 2, 63),
     (1, 4, torch.float32)),
    ("bias_and_padding", 2, 4, 4, 333, 333, False, ("pad", (333, 100)),
     (2, 1, torch.bfloat16)),
    ("bias_and_per_head_gqa", 1, 8, 2, 512, 512, True, "heads",
     (1, 8, F16)),
]


def _bwd_intervals(spec, b, h, sq, sk):
    """The backward cases' intervals: _fwd_intervals', and a hole of 64
    key columns (128..191, hidden from every row), which hides the first
    64-key block of the second dk/dv CTA and not its second."""
    if spec != "hole64":
        return _fwd_intervals(spec, b, h, sq, sk)
    cols = torch.arange(sk, device="cuda")
    full = torch.full((sk,), sq, dtype=torch.int32, device="cuda")
    inside = (cols >= 128) & (cols < 192)
    return torch.stack([torch.where(inside, 0, full),
                        full]).to(torch.int32)[None, None]


def _check_k8_bwd(q, k, v, do, vecs, bias, causal):
    """The bf16 K8 dq, dk/dv (and, with a bias, dbias on their delta)
    against their plain versions per row, dq zero on rows with no visible
    key, one launch of each counted.  Returns (dq, dk, dv, dbias)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = FM._masked_fwd(q, k, v, vecs, bias, causal, scale, True)
    n0 = _k8_counts()
    grads = FM._masked_bwd(q, k, v, out, lse, do, vecs, bias, causal, scale,
                           need_dbias=bias is not None)
    torch.cuda.synchronize()
    args = (q, k, v, out, lse, do, vecs, bias, causal, scale)
    refs = (FM._masked_bwd_dq_xla(*args), *FM._masked_bwd_dkv_xla(*args),
            FM._masked_bwd_dbias_xla(*args) if bias is not None else None)
    for g, r in zip(grads, refs):
        if r is None:
            assert g is None
            continue
        assert g.shape == r.shape and g.dtype == r.dtype
        assert _grad_close(g, r, torch.bfloat16)
    dead = lse == FA.LSE_INVALID
    assert torch.count_nonzero(grads[0].float().abs().sum(-1)[dead]) == 0
    assert _k8_counts() == (*n0[:3], n0[3] + 1, n0[4] + 1,
                            n0[5] + int(bias is not None))
    return grads


@pytest.mark.parametrize("d", FLASH_DIMS)
@pytest.mark.parametrize("case", K8_BWD_CASES, ids=[c[0] for c in
                                                    K8_BWD_CASES])
def test_k8_bf16_backward_matches_plain(gen, case, d):
    """The bf16 K8 dq and dk/dv (flash_sm90.cuh: tiles skipped, clean or
    partial by the tile table, the bias added in log2 units) at the edges
    of their tiles and their mask and bias operands, at each head dim;
    per-q-head intervals under GQA index the table by q head."""
    name, b, h, kvh, sq, sk, causal, ivl, bspec = case
    q, k, v, do = _flash_inputs(gen, torch.bfloat16, b, h, kvh, sq, sk, d)
    vecs = _bwd_intervals(ivl, b, h, sq, sk)
    bias = _fwd_bias(gen, bspec, h, sq, sk)
    _check_k8_bwd(q, k, v, do, vecs, bias, causal)


def test_k8_bf16_backward_takes_unaligned_bias_rows(gen):
    """Biases the dk/dv kernel cannot stage by TMA (its producer warp
    copies them): an f32 row stride of Sk + 2 (not 16-byte aligned), a
    contiguous bf16 bias at Sk 333, and rows of stride 0 (one bias row
    broadcast over the queries)."""
    q, k, v, do = _flash_inputs(gen, torch.bfloat16, 2, 8, 2, 333, 333)
    wide = torch.randn(1, 8, 333, 335, device="cuda", generator=gen)
    bias = wide[..., :333]
    assert bias.stride(2) * 4 % 16 != 0
    _check_k8_bwd(q, k, v, do, None, bias, True)
    _check_k8_bwd(q, k, v, do, _fwd_intervals(("pad", (333, 120)), 2, 8,
                                              333, 333),
                  bias.to(torch.bfloat16).contiguous(), False)
    row = torch.randn(2, 1, 1, 333, device="cuda", generator=gen)
    _check_k8_bwd(q, k, v, do, None, row.expand(2, 1, 333, 333), True)


@pytest.mark.parametrize("d", FLASH_DIMS)
def test_k8_bf16_backward_is_deterministic(gen, d):
    """No float atomics: two runs of the bf16 K8 backward give the same
    bits in dq, dk, dv and dbias (GQA, intervals, bias, both together)."""
    q, k, v, do = _flash_inputs(gen, torch.bfloat16, 2, 8, 2, 1000, 1000, d)
    vecs = _fwd_intervals(("docs", 4, 63), 2, 8, 1000, 1000)
    bias = _fwd_bias(gen, (1, 8, torch.float32), 8, 1000, 1000)
    scale = 1.0 / math.sqrt(d)
    for ivl, b_ in ((vecs, None), (None, bias), (vecs, bias)):
        out, lse = FM._masked_fwd(q, k, v, ivl, b_, False, scale, True)
        first = FM._masked_bwd(q, k, v, out, lse, do, ivl, b_, False, scale,
                               need_dbias=b_ is not None)
        second = FM._masked_bwd(q, k, v, out, lse, do, ivl, b_, False,
                                scale, need_dbias=b_ is not None)
        torch.cuda.synchronize()
        for x, y in zip(first, second):
            assert (x is None and y is None) or torch.equal(x, y)


DBIAS_FAULT_CASES = [  # name, b, h, kvh, s, causal, intervals, bias
    ("bias_11_f32", 2, 4, 4, 300, True, None, (1, 1, torch.float32)),
    ("bias_1x4_bf16", 2, 4, 4, 300, True, None, (1, 4, torch.bfloat16)),
    ("bias_and_docs", 2, 4, 2, 640, False, ("docs", 2, 63),
     (1, 4, torch.float32)),
]


@pytest.mark.parametrize("d", FLASH_DIMS)
@pytest.mark.parametrize("case", DBIAS_FAULT_CASES,
                         ids=[c[0] for c in DBIAS_FAULT_CASES])
def test_k8_bf16_dbias_check_catches_dropped_keys(gen, case, d):
    """The bf16 dbias (flash_sm90.cuh) at a bias broadcast over batch and
    head, a bf16 bias summed over the batch (its f32 accumulator) and
    intervals with a bias: the kernels run on inputs that lost their
    last 64 keys (k, v, the bias and the intervals cut) must fail the
    per-row check against the full reference on >= 99 % of its rows."""
    name, b, h, kvh, s, causal, ivl, bspec = case
    q, k, v, do = _flash_inputs(gen, torch.bfloat16, b, h, kvh, s, s, d)
    vecs = _bwd_intervals(ivl, b, h, s, s)
    bias = _fwd_bias(gen, bspec, h, s, s)
    ref = _check_k8_bwd(q, k, v, do, vecs, bias, causal)[3]
    n = s - 64
    cut = vecs[..., :n] if vecs is not None else None
    scale = 1.0 / math.sqrt(d)
    out, lse = FM._masked_fwd(q, k[:, :, :n], v[:, :, :n], cut,
                              bias[..., :n], causal, scale, True)
    bad = FM._masked_bwd(q, k[:, :, :n], v[:, :, :n], out, lse, do, cut,
                         bias[..., :n], causal, scale, need_dbias=True)[3]
    want = ref[..., :n]
    err = _grad_row_err(bad, want)
    norm = want.float().norm(dim=-1)
    live = norm > 2 ** -6 * norm.square().mean().sqrt()
    assert (err[live] > BF16_ROW_TOL).float().mean().item() >= 0.99


# ----------------------------------------------------------- K1 / K2
FLASH_CASES = [  # b, h, kvh, sq, sk, causal
    (1, 4, 4, 256, 256, True),
    (2, 4, 2, 200, 200, False),      # ragged edge, no causal mask
    (1, 32, 8, 300, 300, True),      # llama3_8b heads: GQA group 4
    (1, 4, 2, 150, 300, True),       # sq < sk
    (1, 4, 2, 300, 150, True),       # sq > sk: rows with no visible key
    (1, 2, 1, 70, 1000, True),
    # the edges of the sm90 bf16 tiles (128-row query blocks, 128- and
    # 64-key tiles): one query row, one key, fewer keys than a tile,
    # lengths one past a tile, a GQA group of 8, a long non-causal row
    (1, 8, 8, 1, 300, True),
    (1, 4, 2, 200, 1, True),         # sq > sk = 1: all rows but the last dead
    (1, 4, 2, 200, 1, False),
    (2, 4, 2, 100, 40, False),       # sk < 64
    (1, 4, 2, 129, 4097, True),
    (1, 8, 1, 256, 256, True),       # GQA group 8
    (1, 4, 4, 4096, 4096, False),
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


@pytest.mark.parametrize("d", FLASH_DIMS)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels_match_plain(gen, dt, case, d):
    b, h, kvh, sq, sk, causal = case
    q, k, v, do = _flash_inputs(gen, dt, b, h, kvh, sq, sk, d)
    scale = 1.0 / math.sqrt(d)
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
    if sk == 1:
        # one key: p = 1 and delta = dp, so dq and dk are zero up to
        # rounding on both sides; hold them to 2^-12 of dv's RMS row norm
        # (grad_row_err's floor for a zero row) and dv to its reference
        rms = refs[2].float().norm(dim=-1).square().mean().sqrt().item()
        for g in grads[:2]:
            assert g.float().norm(dim=-1).max().item() <= 2 ** -12 * rms
        assert _grad_close(grads[2], refs[2], dt)
    else:
        for g, r in zip(grads, refs):
            assert _grad_close(g, r, dt)
    assert torch.count_nonzero(grads[0].float().abs().sum(-1)[dead]) == 0
    assert (FA.flash_mha.fwd_launches, FA.flash_mha.dq_launches,
            FA.flash_mha.dkv_launches) == (n0[0] + 1, n0[1] + 1, n0[2] + 1)


@pytest.mark.parametrize("d", FLASH_DIMS)
def test_flash_bf16_backward_is_deterministic(gen, d):
    """No float atomics: two bf16 backward runs on the same inputs give
    the same bits in dq, dk and dv (GQA, ragged edges, causal)."""
    q, k, v, do = _flash_inputs(gen, torch.bfloat16, 2, 8, 2, 1000, 1000, d)
    scale = 1.0 / math.sqrt(d)
    out, lse = FA._flash_fwd(q, k, v, True, scale)
    first = FA._flash_bwd(q, k, v, out, lse, do, True, scale)
    second = FA._flash_bwd(q, k, v, out, lse, do, True, scale)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_kernels_take_other_layouts(gen, dt):
    """Contiguous [B, H, S, D] q/k/v and a cotangent broadcast over the
    batch (stride 0, as the gradient of a sum over the batch arrives):
    the bf16 kernels read both through TMA tensor maps."""
    q, k, v = (torch.randn(2, h, 300, 128, device="cuda", generator=gen)
               .to(dt) for h in (8, 2, 2))
    do = torch.randn(300, 8, 128, device="cuda", generator=gen).to(dt)
    do = do.expand(2, 300, 8, 128).transpose(1, 2)
    assert do.stride(0) == 0
    scale = 1.0 / math.sqrt(128)
    out, lse = FA._flash_fwd(q, k, v, True, scale)
    torch.cuda.synchronize()
    ref, _ = FA._flash_fwd_xla(q, k, v, True, scale)
    assert _close(out, ref, dt)
    grads = FA._flash_bwd(q, k, v, out, lse, do, True, scale)
    torch.cuda.synchronize()
    refs = FA._flash_bwd_xla(q, k, v, out, lse, do, True, scale)
    for g, r in zip(grads, refs):
        assert _grad_close(g, r, dt)


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


@pytest.mark.parametrize("d", FLASH_DIMS)
def test_bf16_check_catches_dropped_flash_keys(gen, d):
    """K1/K2 told 64 keys fewer than there are must fail the bf16 check
    on every live row of out and dq, and on every key row of dk/dv."""
    q, k, v, do = _flash_inputs(gen, torch.bfloat16, 1, 8, 2, 1000, 700, d)
    scale = 1.0 / math.sqrt(d)
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
    with pytest.raises(ValueError, match="head_dim"):
        FA._check(q[..., :64], k, v)          # k/v's head dim is not q's
    with pytest.raises(ValueError, match="head_dim"):
        FA._check(q[..., :96], k[..., :96], v[..., :96])
    with pytest.raises(ValueError):
        FA._flash_fwd(q, k[:, :1].expand(1, 3, 64, 128), v[:, :1].expand(
            1, 3, 64, 128), True, 0.1)


# ------------------------------------------------ K4: weight-only GEMV
QUANT_ROW_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


def _quant_inputs(gen, dt, m, k, n, kind):
    bound = 127 if kind == "int8" else 7
    x = torch.randn(m, k, device="cuda", generator=gen).to(dt)
    q = torch.randint(-bound, bound + 1, (k, n), device="cuda",
                      generator=gen).to(torch.int8)
    s = torch.rand(n, device="cuda", generator=gen) * 0.02 + 1e-3
    if kind == "int4":
        return x, QM.QuantizedWeight(QM.pack_int4(q), s, "int4", k)
    return x, QM.QuantizedWeight(q, s, "int8", k)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("m,k,n", [(8, 4096, 1024), (1, 4096, 14336),
                                   (64, 14336, 256), (3, 999, 384),
                                   (1, 4096, 1024), (17, 4096, 1024),
                                   (64, 4096, 1024), (1, 2048, 2816),
                                   (8, 2048, 2816), (17, 2048, 2816),
                                   (64, 2048, 2816)])
def test_quant_kernel_matches_plain(gen, dt, kind, m, k, n):
    """M 1, 8, 17 and 64 reach each x-row instance of the bf16 kernel (8,
    8, 32 and 64 rows), N 1024 many K splits and N 2816 few."""
    if kind == "int4" and k % 2:
        pytest.skip("int4 takes an even K (the route sends odd K to the "
                    "matmul)")
    x, w = _quant_inputs(gen, dt, m, k, n, kind)
    attr = f"{kind}_launches"
    before = getattr(QM.weight_only_matmul, attr)
    out = QM.weight_only_matmul(x, w)
    torch.cuda.synchronize()
    assert getattr(QM.weight_only_matmul, attr) == before + 1
    assert out.dtype == dt and out.shape == (m, n)
    ref = QM._xla_fallback(x, w)
    assert _row_rel_err(out, ref).max().item() <= QUANT_ROW_TOL[dt]


def test_quant_kernel_is_deterministic(gen):
    """The last split of a column block sums the splits in split order:
    two calls give the same bits, the counters are left at zero, and an
    x that is not a whole number of 16-byte rows is padded, not read
    past its end."""
    for kind, m, k, n in (("int8", 8, 4096, 1024), ("int4", 17, 14336, 4096),
                          ("int8", 5, 4100, 384)):
        x, w = _quant_inputs(gen, torch.bfloat16, m, k, n, kind)
        first = QM.weight_only_matmul(x, w)
        second = QM.weight_only_matmul(x, w)
        torch.cuda.synchronize()
        assert torch.equal(first, second)
        assert _row_rel_err(first, QM._xla_fallback(x, w)).max().item() \
            <= QUANT_ROW_TOL[torch.bfloat16]
    tickets = [buf for key, buf in cuda_lib._scratch.items()
               if key[0] == "quant_matmul.tickets"]
    assert tickets and all(torch.count_nonzero(buf) == 0 for buf in tickets)


def test_quant_check_catches_planted_faults(gen):
    """int8 with the last 64 K rows of q zeroed, int4 with its nibbles
    swapped: every output row must fail the bf16 check."""
    x, w = _quant_inputs(gen, torch.bfloat16, 8, 4096, 1024, "int8")
    ref = QM._xla_fallback(x, w)
    bad_q = w.q.clone()
    bad_q[-64:] = 0
    bad = QM.weight_only_matmul(x, QM.QuantizedWeight(bad_q, w.scale))
    assert bool((_row_rel_err(bad, ref) > BF16_ROW_TOL).all())
    x, w = _quant_inputs(gen, torch.bfloat16, 8, 4096, 1024, "int4")
    ref = QM._xla_fallback(x, w)
    u = w.q.view(torch.uint8)
    swapped = ((u >> 4) | (u << 4)).view(torch.int8)
    bad = QM.weight_only_matmul(
        x, QM.QuantizedWeight(swapped, w.scale, "int4", w.k))
    assert bool((_row_rel_err(bad, ref) > BF16_ROW_TOL).all())


def test_quant_routes(gen):
    """M > 64 (or N not a multiple of 128) takes the dequant matmul, not
    the kernel; bad inputs on the kernel route raise."""
    x, w = _quant_inputs(gen, torch.bfloat16, 65, 256, 256, "int8")
    launches = QM.weight_only_matmul.int8_launches
    calls = QM.weight_only_matmul.matmul_calls
    out = QM.weight_only_matmul(x, w)
    assert QM.weight_only_matmul.int8_launches == launches
    assert QM.weight_only_matmul.matmul_calls == calls + 1
    assert _row_rel_err(out, QM._xla_fallback(x, w)).max().item() \
        <= 2 ** -6
    with pytest.raises(TypeError):
        QM.weight_only_matmul(x[:8].half(), w)
    with pytest.raises(ValueError):
        QM.weight_only_matmul(x[:8], QM.QuantizedWeight(
            w.q[:, ::2].contiguous()[:, :128], w.scale))


# --------------------------------------------- K5: gather-LoRA matmul
LORA_IDX = [0, 1, 2, 3, 4, 1, 0, 2]


def _lora_inputs(gen, xdt, bdt, k, m, rank=16, rows=5):
    x = torch.randn(len(LORA_IDX), k, device="cuda", generator=gen).to(xdt)
    a = (torch.randn(rows, rank, k, device="cuda", generator=gen)
         / k ** 0.5).to(bdt)
    b = (torch.randn(rows, rank, m, device="cuda", generator=gen)
         / rank ** 0.5).to(bdt)
    a[0] = 0
    b[0] = 0
    scale = torch.rand(rows, device="cuda", generator=gen) + 0.5
    idx = torch.tensor(LORA_IDX, dtype=torch.int32, device="cuda")
    return x, a, b, scale, idx


@pytest.mark.parametrize("xdt,bdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("k,m", [(4096, 1024), (14336, 4096), (4096, 300)])
def test_lora_kernel_matches_plain(gen, xdt, bdt, k, m):
    args = _lora_inputs(gen, xdt, bdt, k, m)
    before = LM.lora_gather_matmul.launches
    out = LM.lora_gather_matmul(*args)
    torch.cuda.synchronize()
    assert LM.lora_gather_matmul.launches == before + 1
    ref = LM._xla_gather_matmul(*args)
    zero = args[-1] == 0
    assert torch.count_nonzero(out[zero]) == 0
    # a bf16 bank rounds h to bf16 in the kernel (the Pallas body), not
    # in the plain version: one 2^-9 rounding per h element
    tol = QUANT_ROW_TOL[xdt] if bdt == torch.float32 else 2 ** -7
    assert _row_rel_err(out[~zero], ref[~zero]).max().item() <= tol


def test_lora_check_catches_planted_fault(gen):
    """Every non-zero idx reading the next adapter must fail every
    non-zero row."""
    x, a, b, scale, idx = _lora_inputs(gen, torch.bfloat16, torch.float32,
                                       4096, 1024)
    ref = LM._xla_gather_matmul(x, a, b, scale, idx)
    nxt = torch.where(idx > 0, idx % 4 + 1, idx).to(torch.int32)
    bad = LM.lora_gather_matmul(x, a, b, scale, nxt)
    live = idx > 0
    assert bool((_row_rel_err(bad[live], ref[live]) > BF16_ROW_TOL).all())


# (S, bank rows, rank, K, M, idx, x dtype, bank dtype): 64 slots over 64
# distinct adapters at rank 64; one adapter for all 64 slots (several
# slot groups per pass); a bf16 bank; K 14336 (the down projection, many
# splits); every row idx 0; K and M off the 4-element vectors
LORA_CASES = {
    "distinct64": (64, 65, 64, 4096, 1024, list(range(1, 65)),
                   torch.bfloat16, torch.float32),
    "shared64": (64, 3, 16, 4096, 1024, [2] * 64, torch.bfloat16,
                 torch.float32),
    "bf16_bank": (8, 5, 16, 4096, 4096, LORA_IDX, torch.bfloat16,
                  torch.bfloat16),
    "k14336": (8, 5, 16, 14336, 4096, LORA_IDX, torch.bfloat16,
               torch.float32),
    "all_idx0": (8, 5, 16, 4096, 14336, [0] * 8, torch.bfloat16,
                 torch.float32),
    "unaligned": (5, 4, 12, 1001, 301, [3, 0, 1, 3, 2], torch.float32,
                  torch.float32),
}


@pytest.mark.parametrize("case", sorted(LORA_CASES))
def test_lora_kernel_cases(gen, case):
    """Each case against the plain version per row (f32 1e-5, else 2^-7),
    rows with idx 0 exactly zero, two runs bit-equal, and every slot
    pointed at another bank row must fail the check (idx 0 rows: must
    come out non-zero)."""
    s, rows, r, k, m, idx, xdt, bdt = LORA_CASES[case]
    x = torch.randn(s, k, device="cuda", generator=gen).to(xdt)
    a = (torch.randn(rows, r, k, device="cuda", generator=gen)
         / k ** 0.5).to(bdt)
    b = (torch.randn(rows, r, m, device="cuda", generator=gen)
         / r ** 0.5).to(bdt)
    a[0] = 0
    b[0] = 0
    scale = torch.rand(rows, device="cuda", generator=gen) + 0.5
    idx_t = torch.tensor(idx, dtype=torch.int32, device="cuda")
    out = LM.lora_gather_matmul(x, a, b, scale, idx_t)
    again = LM.lora_gather_matmul(x, a, b, scale, idx_t)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    ref = LM._xla_gather_matmul(x, a, b, scale, idx_t)
    zero = idx_t == 0
    assert torch.count_nonzero(out[zero]) == 0
    tol = 1e-5 if xdt == bdt == torch.float32 else 2 ** -7
    if bool((~zero).any()):
        assert _row_rel_err(out[~zero], ref[~zero]).max().item() <= tol
    other = (idx_t % (rows - 1) + 1).to(torch.int32)
    bad = LM.lora_gather_matmul(x, a, b, scale, other)
    if bool((~zero).any()):
        assert bool((_row_rel_err(bad[~zero], ref[~zero]) > tol).all())
    assert bool((bad[zero].float().abs().amax(dim=-1) > 0).all())


# ------------------------------------------------ K7: dense-cache decode
K7_SHAPES = {  # name: B, nh, kvh, T, pos, D
    "bench_decode": (8, 16, 16, 256, [128, 255, 140, 200, 173, 129, 254,
                                      191], 128),
    "reference_8k": (8, 32, 8, 8192, [8191, 8191, 100, 0, 4095, 4096,
                                      8000, 257], 128),
    # TinyLlama-1.1B's heads (32 q / 4 kv, head_dim 64)
    "tinyllama_d64": (8, 32, 4, 2048, [2047, 1000, 0, 63, 64, 1500, 2046,
                                       777], 64),
    "d256": (4, 16, 4, 2048, [2047, 100, 1024, 5], 256),
    # a group of 32 (two CTAs of 16 heads per kv head), T unaligned
    "group32": (4, 32, 1, 1000, [999, 0, 500, 64], 128),
    "group20_d64": (2, 20, 1, 300, [299, 17], 64),
    # one kv head row over many key splits (the merge by ticket)
    "splits_8k": (1, 8, 8, 8192, [8191], 128),
    "dead_row": (2, 8, 2, 512, [-1, 300], 128),
}


def _k7_inputs(gen, dt, b, nh, kvh, t, pos, d=128):
    q = torch.randn(b, nh, d, device="cuda", generator=gen).to(dt)
    k = torch.randn(b, kvh, t, d, device="cuda", generator=gen).to(dt)
    v = torch.randn(b, kvh, t, d, device="cuda", generator=gen).to(dt)
    return q, k, v, torch.tensor(pos, dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(K7_SHAPES))
def test_decode_kernel_matches_plain(gen, dt, shape):
    """K7 at head dims 64/128/256, groups of 1 to 32, one split and many;
    a row with pos < 0 is zero (the plain version gives NaN there)."""
    args = _k7_inputs(gen, dt, *K7_SHAPES[shape])
    before = DA.decode_attention.launches
    out = DA.decode_attention(*args)
    torch.cuda.synchronize()
    assert DA.decode_attention.launches == before + 1
    live = args[3] >= 0
    assert torch.count_nonzero(out[~live]) == 0
    assert _close(out[live], DA._xla_decode(*args)[live], dt)


def test_decode_kernel_is_deterministic(gen):
    """The last split's CTA merges the splits in split order: two calls
    give the same bits, and the ticket counters are left at zero."""
    for shape in ("reference_8k", "group32", "splits_8k"):
        args = _k7_inputs(gen, torch.bfloat16, *K7_SHAPES[shape])
        first = DA.decode_attention(*args)
        second = DA.decode_attention(*args)
        torch.cuda.synchronize()
        assert torch.equal(first, second)
    tickets = [buf for key, buf in cuda_lib._scratch.items()
               if key[0] == "decode_attention.tickets"]
    assert tickets and all(torch.count_nonzero(buf) == 0 for buf in tickets)


def test_decode_kernel_off_runs_the_plain_version(gen, monkeypatch):
    args = _k7_inputs(gen, torch.bfloat16, *K7_SHAPES["bench_decode"])
    monkeypatch.setattr(DA, "PALLAS_DECODE", False)
    before = DA.decode_attention.launches
    out = DA.decode_attention(*args)
    assert DA.decode_attention.launches == before
    torch.testing.assert_close(out, DA._xla_decode(*args), atol=0, rtol=0)


def test_decode_head_dim_32_runs_the_plain_version(gen):
    """d outside {64, 128, 256} takes the reference's XLA route: the
    plain version on the card, no launch."""
    args = _k7_inputs(gen, torch.bfloat16, 2, 8, 2, 300, [5, 299], d=32)
    before = DA.decode_attention.launches
    out = DA.decode_attention(*args)
    assert DA.decode_attention.launches == before
    torch.testing.assert_close(out, DA._xla_decode(*args), atol=0, rtol=0)


def test_bf16_check_catches_dropped_decode_keys(gen):
    """The kernel told pos - 64 (every long row loses its last 64 keys)
    must fail the bf16 check on every head of every such row, at each
    head dim."""
    for shape in ("reference_8k", "tinyllama_d64", "d256", "group32"):
        q, k, v, pos = _k7_inputs(gen, torch.bfloat16, *K7_SHAPES[shape])
        ref = DA._xla_decode(q, k, v, pos)
        short = torch.clamp(pos - 64, min=0).to(torch.int32)
        err = _row_rel_err(DA.decode_attention(q, k, v, short), ref)
        assert bool((err[pos >= 64] > BF16_ROW_TOL).all())


def test_decode_wrapper_rejects(gen):
    q, k, v, pos = _k7_inputs(gen, torch.float32, 2, 8, 2, 300, [5, 299])
    with pytest.raises(TypeError):
        DA.decode_attention(q.bfloat16(), k, v, pos)
    with pytest.raises(TypeError):
        DA.decode_attention(q, k, v, pos.long())
    with pytest.raises(ValueError, match="group"):
        DA.decode_attention(torch.randn(2, 9, 128, device="cuda"), k, v, pos)
    with pytest.raises(ValueError, match="contiguous"):
        DA.decode_attention(q, k.transpose(2, 3).contiguous()
                            .transpose(2, 3), v, pos)


# ------------------------------------------------------- K9 grouped FFN
GFFN_ROW_TOL = 2 ** -7


def _gffn_inputs(gen, dt, bdt, e, d, f, dout, emap, gated):
    r = len(emap) * GF.TILE
    f2 = 2 * f if gated else f

    def rnd(*shape, dtype=dt, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dtype)

    return (rnd(r, d), rnd(e, d, f2, scale=d ** -0.5), rnd(e, f2, dtype=bdt),
            rnd(e, f, dout, scale=f ** -0.5), rnd(e, dout, dtype=bdt),
            torch.tensor(emap, dtype=torch.int32, device="cuda"),
            rnd(r, dout))


def _gffn_run(x, w1, b1, w2, b2, emap, dy, gated):
    """(out, dx, dw1, db1, dw2, db2) through the kernels (autograd)."""
    leaves = [t.detach().requires_grad_() for t in (x, w1, b1, w2, b2)]
    out = GF.grouped_ffn(*leaves[:3], *leaves[3:], emap, gated)
    grads = torch.autograd.grad(out, leaves, dy)
    return (out.detach(), *grads)


def _gffn_plain(x, w1, b1, w2, b2, emap, dy, gated):
    out = GF.grouped_ffn_xla(x, w1, b1, w2, b2, emap, gated)
    return (out, *GF._plain_bwd(x, dy, w1, b1, w2, b2.dtype, emap, gated))


def _gffn_errs(got, want, dt):
    """Per-output errors: f32, max |diff| / max |want|; bf16, per row."""
    out = []
    for g, w in zip(got, want):
        if dt == torch.float32:
            scale = max(w.abs().max().item(), 1e-30)
            out.append((g.float() - w.float()).abs().max().item() / scale)
        else:
            g2, w2 = g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])
            out.append(_grad_row_err(g2, w2).max().item())
    return out


# (E, D, F, D', emap): an expert that owns no tile (2), trailing padding
# tiles clipped to E - 1, ragged column blocks (F 200, D' 136)
GFFN_CASES = {
    "ragged": (4, 128, 200, 136, [0, 0, 1, 3, 3, 3]),
    "bench_width": (8, 1024, 1408, 1024, [0, 1, 1, 2, 4, 5, 6, 7, 7]),
}


@pytest.mark.parametrize("dt,bdt", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("case", sorted(GFFN_CASES))
def test_grouped_ffn_kernels_match_plain(gen, dt, bdt, gated, case):
    e, d, f, dout, emap = GFFN_CASES[case]
    args = _gffn_inputs(gen, dt, bdt, e, d, f, dout, emap, gated)
    fwd0, bwd0 = GF.grouped_ffn.fwd_launches, GF.grouped_ffn.bwd_launches
    got = _gffn_run(*args, gated)
    torch.cuda.synchronize()
    assert (GF.grouped_ffn.fwd_launches, GF.grouped_ffn.bwd_launches) == (
        fwd0 + 1, bwd0 + 1)
    want = _gffn_plain(*args, gated)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    tol = 1e-5 if dt == torch.float32 else GFFN_ROW_TOL
    errs = _gffn_errs(got, want, dt)
    assert max(errs) <= tol, errs
    # the expert with no tile gets exact zeros
    if case == "ragged":
        for g in got[2:]:
            assert not g[2].float().abs().any()


def test_grouped_ffn_check_catches_a_misrouted_tile(gen):
    """Tile 3 pointed at the next expert: its rows of out and dx, and the
    gradient rows of both experts, must fail the bf16 check."""
    e, d, f, dout, emap = GFFN_CASES["bench_width"]
    x, w1, b1, w2, b2, em, dy = _gffn_inputs(
        gen, torch.bfloat16, torch.bfloat16, e, d, f, dout, emap, False)
    want = _gffn_plain(x, w1, b1, w2, b2, em, dy, False)
    bad = em.clone()
    bad[3] += 1          # expert 2's only tile computed as expert 3's
    got = _gffn_run(x, w1, b1, w2, b2, bad, dy, False)
    rows = slice(3 * GF.TILE, 4 * GF.TILE)
    for g, w in zip(got[:2], want[:2]):
        assert bool((_row_rel_err(g[rows], w[rows]) > GFFN_ROW_TOL).all())
    for g, w in zip(got[2:], want[2:]):
        for ex in (2, 3):
            err = _grad_row_err(g[ex].reshape(-1, g.shape[-1]),
                                w[ex].reshape(-1, w.shape[-1]))
            assert bool((err > GFFN_ROW_TOL).all())


def test_grouped_ffn_wrapper_rejects(gen):
    x, w1, b1, w2, b2, em, _ = _gffn_inputs(
        gen, torch.float32, torch.float32, 2, 64, 64, 64, [0, 1], False)
    with pytest.raises(ValueError, match="multiple of 128"):
        GF.grouped_ffn(x[:200].contiguous(), w1, b1, w2, b2, em)
    with pytest.raises(TypeError, match="int32"):
        GF.grouped_ffn(x, w1, b1, w2, b2, em.long())
    with pytest.raises(TypeError):
        GF.grouped_ffn(x.bfloat16(), w1, b1, w2, b2, em)
    with pytest.raises(ValueError, match="shapes"):
        GF.grouped_ffn(x, w1, b1, w2, b2, em, True)
    with pytest.raises(ValueError, match="contiguous"):
        GF.grouped_ffn(x, w1.transpose(1, 2).contiguous().transpose(1, 2),
                       b1, w2, b2, em)
    with pytest.raises(ValueError, match="multiples of 8"):
        GF.grouped_ffn(x[:, :60].contiguous(), w1[:, :60].contiguous(), b1,
                       w2, b2, em)


def _e64_emap():
    """64 experts with ragged runs of 0-3 tiles (a top-6 routing's
    skew), experts 5 and 40 owning none, and two trailing padding tiles
    clipped to expert 63."""
    tiles = [(e * 7 + 3) % 4 for e in range(64)]
    tiles[5] = tiles[40] = 0
    tiles[63] = max(tiles[63], 1)
    emap = [e for e in range(64) for _ in range(tiles[e])]
    return emap + [63, 63]


GFFN_E64 = (64, 256, 200, 264, _e64_emap())


@pytest.mark.parametrize("bdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gated", [False, True])
def test_grouped_ffn_e64_ragged(gen, bdt, gated):
    """bf16 at 64 experts with ragged runs, experts with no tile and
    trailing padding: every output per row within 2^-7 of the plain
    versions, zeros for the experts with no tile, two runs bit-equal,
    and tile 0 computed as the next expert's must fail its rows."""
    e, d, f, dout, emap = GFFN_E64
    args = _gffn_inputs(gen, torch.bfloat16, bdt, e, d, f, dout, emap, gated)
    got = _gffn_run(*args, gated)
    again = _gffn_run(*args, gated)
    torch.cuda.synchronize()
    for g, h in zip(got, again):
        assert torch.equal(g, h)
    want = _gffn_plain(*args, gated)
    errs = _gffn_errs(got, want, torch.bfloat16)
    assert max(errs) <= GFFN_ROW_TOL, errs
    for g in got[2:]:
        for ex in (5, 40):
            assert not g[ex].float().abs().any()
    x, w1, b1, w2, b2, em, dy = args
    bad = em.clone()
    bad[0] += 1
    wrong = _gffn_run(x, w1, b1, w2, b2, bad, dy, gated)
    rows = slice(0, GF.TILE)
    for g, w in zip(wrong[:2], want[:2]):
        assert bool((_row_rel_err(g[rows], w[rows]) > GFFN_ROW_TOL).all())


def test_grouped_dispatch_matches_undropped_sort(gen):
    """moe_dispatch_combine: the grouped mode (K9) against the sort mode
    at capacity_factor E / top_k (nothing dropped), float32, with grads."""
    from paddle_tpu_torch.distributed.moe import moe_dispatch_combine
    s, m, f, e = 300, 128, 256, 8
    x = torch.randn(s, m, device="cuda", generator=gen)
    ws = [torch.randn(*shape, device="cuda", generator=gen) * sc
          for shape, sc in (((m, e), 1.0), ((e, m, f), m ** -0.5),
                            ((e, f), 0.1), ((e, f, m), f ** -0.5),
                            ((e, m), 0.1))]
    outs = {}
    for mode in ("sort", "grouped"):
        leaves = [t.clone().requires_grad_() for t in (x, *ws)]
        y, aux = moe_dispatch_combine(
            *leaves, top_k=2, capacity_factor=e / 2,
            activation=torch.nn.functional.silu, dispatch_mode=mode)
        grads = torch.autograd.grad((y.square().sum() + aux), leaves)
        outs[mode] = (y.detach(), *grads)
    for g, w in zip(outs["grouped"], outs["sort"]):
        scale = w.abs().max().item()
        assert (g - w).abs().max().item() <= 1e-5 * scale


# ------------------------------------------------------------ K6 RMSNorm
@pytest.mark.parametrize("dt,wdt", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32),
                                    (torch.float16, torch.float16)])
@pytest.mark.parametrize("n,d", [(384, 4096), (5, 128), (64, 2048)])
def test_rms_norm_kernel_matches_plain(gen, dt, wdt, n, d):
    x = torch.randn(n, d, device="cuda", generator=gen).to(dt)
    w = (1 + 0.1 * torch.randn(d, device="cuda", generator=gen)).to(wdt)
    before = RN.rms_norm.launches
    out = RN.rms_norm(x, w)
    torch.cuda.synchronize()
    assert RN.rms_norm.launches == before + 1
    ref = RN._plain_rms(x, w, 1e-6)
    assert out.dtype == dt
    if dt == torch.float32:
        assert (out - ref).abs().max().item() <= 1e-5
    else:
        assert _row_rel_err(out, ref).max().item() <= 2 ** -7


def test_rms_norm_check_catches_a_shifted_weight(gen):
    x = torch.randn(384, 4096, device="cuda", generator=gen).bfloat16()
    w = (1 + 0.5 * torch.randn(4096, device="cuda", generator=gen)).bfloat16()
    ref = RN._plain_rms(x, w, 1e-6)
    out = RN.rms_norm(x, torch.roll(w, 1))
    assert bool((_row_rel_err(out, ref) > 2 ** -7).all())


def test_rms_norm_routes_and_rejects(gen):
    x = torch.randn(8, 96, device="cuda", generator=gen).bfloat16()
    w = torch.ones(96, device="cuda", dtype=torch.float32)
    before = RN.rms_norm.launches
    out = RN.rms_norm(x, w)       # d % 128: the reference's plain body
    assert RN.rms_norm.launches == before
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, RN._xla_rms(x, w, 1e-6), atol=0, rtol=0)
    with pytest.raises(ValueError, match="weight"):
        RN._kernel(torch.randn(4, 128, device="cuda"),
                   torch.ones(64, device="cuda"), 1e-6)
    with pytest.raises(TypeError):
        RN._kernel(torch.randn(4, 128, device="cuda").double(),
                   torch.ones(128, device="cuda"), 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        RN._kernel(torch.randn(128, 4, device="cuda").T,
                   torch.ones(128, device="cuda"), 1e-6)
