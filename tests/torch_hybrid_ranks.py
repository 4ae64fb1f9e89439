"""Gloo ranks for the port's multi-rank CPU tests (not a test module).

A :class:`RankPool` starts ``world`` processes (spawned, so the test
process's JAX is not in them), joins them into one gloo world through a
``FileStore`` in a temporary directory, one torch thread each, and gives
them jobs over queues: the name of a function of this module and its
keyword arguments.  Every rank runs the job and sends back its result
(numpy, so nothing rides on shared memory); a rank that raises sends its
traceback, and :meth:`RankPool.collect` raises it.  Gloo's timeout is
short, so a rank stuck in a collective whose peers failed errors out
instead of hanging the test.

The job functions import only torch, numpy and ``paddle_tpu_torch``.
"""
from __future__ import annotations

import importlib
import multiprocessing
import os
import queue
import threading
import traceback

import numpy as np

TIMEOUT_S = 120


def _worker(rank, world, store_path, jobs, results):
    os.environ["OMP_NUM_THREADS"] = "1"
    # the test process's reference run is the slower side: let it have
    # the cores first
    os.nice(10)
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        from paddle_tpu_torch.distributed import init_parallel_env
        init_parallel_env("cpu", rank=rank, world_size=world,
                          store=dist.FileStore(store_path, world),
                          timeout_s=TIMEOUT_S // 2)
    except BaseException:                      # noqa: BLE001 - reported
        results.put((rank, False, traceback.format_exc()))
        return
    while True:
        name, kwargs = jobs.get()
        try:
            results.put((rank, True, globals()[name](**kwargs)))
        except BaseException:                   # noqa: BLE001 - reported
            results.put((rank, False, traceback.format_exc()))


class RankPool:
    """``world`` gloo ranks, started once, running jobs in lockstep."""

    def __init__(self, world, tmp_dir):
        ctx = multiprocessing.get_context("spawn")
        self.world = world
        self.results = ctx.Queue()
        self.jobs = [ctx.Queue() for _ in range(world)]
        os.makedirs(str(tmp_dir), exist_ok=True)
        store = os.path.join(str(tmp_dir), "gloo_store")
        self.procs = [ctx.Process(target=_worker, daemon=True,
                                  args=(r, world, store, self.jobs[r],
                                        self.results))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        # the test process gathers the ranks' trees with the port's
        # converters: import them while the reference computes
        self._imports = threading.Thread(
            target=importlib.import_module, args=("paddle_tpu_torch.models",),
            daemon=True)
        self._imports.start()

    def submit(self, name, **kwargs):
        """Send every rank the job (``kwargs`` may be a callable of the
        rank, giving each its own arguments)."""
        for r, q in enumerate(self.jobs):
            q.put((name, kwargs(r) if callable(kwargs) else kwargs))

    def collect(self):
        """Every rank's result, in rank order."""
        self._imports.join()
        out = [None] * self.world
        errors = []
        for _ in range(self.world):
            try:
                rank, ok, res = self.results.get(timeout=TIMEOUT_S)
            except queue.Empty:
                raise RuntimeError("a rank gave no result within "
                                   f"{TIMEOUT_S} s") from None
            if ok:
                out[rank] = res
            else:
                errors.append(f"rank {rank}:\n{res}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return out

    def run(self, name, **kwargs):
        self.submit(name, **kwargs)
        return self.collect()

    def close(self):
        """Stop every rank: its results are in, and its process group
        goes with its process."""
        for p in self.procs:
            p.kill()
            p.join()


# ------------------------------------------------------------------ jobs
def _np_tree(tree):
    from paddle_tpu_torch.models import llama_hybrid as TH
    return TH.tree_map(lambda t: t.detach().float().numpy().copy(), tree)


def _counters(ops=("all_reduce", "all_gather", "reduce_scatter",
                   "broadcast", "isend", "irecv")):
    from paddle_tpu_torch import observability as obs
    return {op: (obs.metric_value("collective_calls_total", {"op": op}),
                 obs.metric_value("collective_bytes_total", {"op": op}))
            for op in ops}


def hybrid_step(cfg_kw, dims, np_params, ids, step_kw, n_virtual=1,
                zero1=False, steps=1):
    """One rank of a hybrid training run: its shard of ``np_params`` (the
    reference's tree), ``steps`` steps on the global batch ``ids``;
    returns every step's loss, its params, m and v after the first step
    (numpy trees of its shards), the first step's collective counters'
    growth and the pipeline's in-flight peak over the steps."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import pipeline_schedules as PS
    from paddle_tpu_torch.models import hybrid_params_from_numpy, llama_tiny
    from paddle_tpu_torch.models import llama_hybrid as TH
    cfg = llama_tiny(**cfg_kw)
    pp, dp, tp = dims
    mesh = TH.build_mesh(pp * dp * tp, pp=pp, dp=dp, tp=tp)
    rank = dist.get_rank()
    params = hybrid_params_from_numpy(np_params, device="cpu", rank=rank,
                                      mesh=mesh, n_virtual=n_virtual)
    opt = TH.init_adamw(params, mesh, zero1)
    step = TH.build_train_step(cfg, mesh, device="cpu", n_virtual=n_virtual,
                               zero1=zero1, **step_kw)
    losses, peak = [], 0
    for i in range(steps):
        before = _counters()
        loss, params, opt = step(params, opt, torch.from_numpy(ids))
        losses.append(float(loss))
        peak = max(peak, PS.last_stats["max_in_flight"])
        if i == 0:
            after = _counters()
            out = {"params": _np_tree(params), "m": _np_tree(opt.m),
                   "v": _np_tree(opt.v),
                   "counters": {op: (after[op][0] - before[op][0],
                                     after[op][1] - before[op][1])
                                for op in after}}
    return {**out, "losses": losses, "max_in_flight": peak}


def hybrid_steps(runs):
    """:func:`hybrid_step` for each keyword dict of ``runs``, in order."""
    return [hybrid_step(**kw) for kw in runs]


def gathered(results, key, dims, n_virtual=1):
    """The ranks' ``key`` trees gathered into the reference's layout."""
    import torch
    from paddle_tpu_torch.models import hybrid_params_to_numpy
    from paddle_tpu_torch.models import llama_hybrid as TH

    def tensors(tree):
        return TH.tree_map(torch.from_numpy, tree)
    like = None if key == "params" else \
        [tensors(r["params"]) for r in results]
    return hybrid_params_to_numpy(
        [tensors(r[key]) for r in results],
        mesh=dict(zip(("pp", "dp", "tp"), dims)), n_virtual=n_virtual,
        like=like)


def flat(tree):
    """A tree's numpy leaves by name, in a fixed order."""
    out = {}

    def walk(prefix, t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(f"{prefix}/{k}", t[k])
        elif isinstance(t, list):
            for i, x in enumerate(t):
                walk(f"{prefix}/{i}", x)
        else:
            out[prefix] = np.asarray(t, np.float32)
    walk("", tree)
    return out


# the parity tolerances of the hybrid tests, float32: the loss within
# LOSS_RTOL relative, and every leaf of the params and of the AdamW m and
# v within LEAF_TOL relative by norm, ||port - ref|| / ||ref||.  Sums run
# in another order on each side (per rank, per microbatch, per tp shard
# and over the reductions): the loss moves by <= 3e-7, a leaf by
# <= 3e-6.  Not by element: after an AdamW step an element whose
# gradient is near 0 moves by up to lr whichever way its m / sqrt(v)
# rounds
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4


def assert_matches_reference(results, ref_loss, ref_trees, dims,
                             n_virtual=1):
    """Every rank's loss against the reference's, and the gathered
    params, m and v against the reference's trees (numpy, the reference's
    layout) leaf by leaf."""
    for r in results:
        np.testing.assert_allclose(r["losses"][0], ref_loss, rtol=LOSS_RTOL)
    for key, ref in ref_trees.items():
        got, want = flat(gathered(results, key, dims, n_virtual)), flat(ref)
        assert got.keys() == want.keys(), (key, got.keys(), want.keys())
        for name in want:
            assert got[name].shape == want[name].shape, (key, name)
            err = np.linalg.norm(got[name] - want[name]) / max(
                np.linalg.norm(want[name]), 1e-30)
            assert err <= LEAF_TOL, (key, name, err)


def reference_tree(tree):
    """A JAX tree as float32 numpy (the tests pass it in, so this module
    imports no JAX)."""
    return {k: reference_tree(v) if isinstance(v, dict)
            else np.asarray(v, np.float32) for k, v in tree.items()}


def mlp_setup(S, v, m, mb=3, H=16, V=29, seed=0):
    """The reference schedule tests' toy pipeline (``tests/
    test_pipeline_schedules.py:_mlp_setup``) in numpy: 2·S·v layers of
    tanh(x @ w), an embedding in front and a CE head behind, m
    microbatches of mb x 5 tokens."""
    rng = np.random.default_rng(seed)
    L = S * v * 2
    layers = [(rng.standard_normal((H, H)) * 0.3).astype(np.float32)
              for _ in range(L)]
    embed = (rng.standard_normal((V, H)) * 0.5).astype(np.float32)
    head = (rng.standard_normal((H, V)) * 0.5).astype(np.float32)
    ids = rng.integers(0, V, (m, mb, 5))
    lab = rng.integers(0, V, (m, mb, 5))
    return layers, embed, head, ids, lab


def mlp_fns():
    import torch

    def stage_fn(cp, x):
        for w in cp:
            x = torch.tanh(x @ w["w"])
        return x

    def first_fn(fp, aux):
        return fp["embed"][aux[0]]

    def last_fn(lp, y, aux):
        logits = (y @ lp["head"]).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, aux[1][..., None])[..., 0]
        return (lse - tgt).sum() / aux[1].numel()
    return stage_fn, first_fn, last_fn


def mlp_pipeline(S, v, m, schedule):
    """One pipelined pass of :func:`mlp_setup`'s model on this rank's
    stage (a ('pp', 'dp') mesh over the world; every dp row runs the
    same problem): the loss, this stage's chunk grads in layer order,
    the first and last grads and the in-flight peak."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import ProcessMesh
    from paddle_tpu_torch.distributed import pipeline_schedules as PS
    world = dist.get_world_size()
    mesh = ProcessMesh(np.arange(world).reshape(S, world // S),
                       ["pp", "dp"])
    group = mesh.group("pp")
    layers, embed, head, ids, lab = mlp_setup(S, v, m)
    chunks = PS.stack_stage_params(
        [{"w": torch.from_numpy(w).requires_grad_()} for w in layers],
        S, v)[group.rank]
    fp = {"embed": torch.from_numpy(embed).requires_grad_()}
    lp = {"head": torch.from_numpy(head).requires_grad_()}
    aux = [(torch.from_numpy(ids[j]), torch.from_numpy(lab[j]))
           for j in range(m)]
    stage_fn, first_fn, last_fn = mlp_fns()
    loss, d_stage, d_first, d_last = PS.pipeline_1f1b(
        stage_fn, first_fn, last_fn, chunks, fp, lp, aux, group,
        (3, 5, 16), torch.float32, n_virtual=v, schedule=schedule)
    return {"loss": float(loss),
            "d_stage": [[w["w"].numpy() for w in c] for c in d_stage],
            "d_embed": d_first["embed"].numpy(),
            "d_head": d_last["head"].numpy(),
            "stats": dict(PS.last_stats)}


COLLECTIVE_OPS = ("all_reduce", "all_gather", "reduce_scatter",
                  "broadcast", "barrier", "all_to_all", "scatter", "reduce",
                  "send", "recv", "all_gather_object")


def collectives(X, Y, Z):
    """Every collective of ``distributed.collective`` once on this rank
    of a 4-rank world: rank r holds row r of X, rows 4r .. 4r+3 of Y and
    of Z.  Returns the results and the counters' growth per op, first
    over the calls the reference test makes eagerly (``"counters"``),
    then over the rest (``"more_counters"``)."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch import distributed as D
    from paddle_tpu_torch import observability as obs
    r, n = dist.get_rank(), dist.get_world_size()
    mesh = D.ProcessMesh(np.arange(n), ["x"])
    g = mesh.group("x")

    def count():
        return {op: (obs.metric_value("collective_calls_total", {"op": op}),
                     obs.metric_value("collective_bytes_total", {"op": op}))
                for op in COLLECTIVE_OPS}

    def growth(before, after):
        return {op: (after[op][0] - before[op][0],
                     after[op][1] - before[op][1]) for op in COLLECTIVE_OPS}
    t0 = count()
    x = torch.from_numpy(X[r:r + 1].copy())
    y = torch.from_numpy(Y[4 * r:4 * r + 4].copy())
    out = {}
    for op in ("sum", "max", "min", "prod", "avg"):
        out[f"all_reduce_{op}"] = D.all_reduce(x.clone(), op=op,
                                               group=g).numpy()
    out["all_gather"] = D.all_gather(None, x, group=g).numpy()
    out["reduce_scatter"] = D.reduce_scatter(None, y, group=g).numpy()
    out["broadcast"] = D.broadcast(x.clone(), src=0, group=g).numpy()
    D.barrier(g)
    t1 = count()
    pieces = D.all_gather([], x, group=g)
    out["all_gather_list"] = np.stack([p.numpy() for p in pieces])
    out["reduce_scatter_axis1"] = D.reduce_scatter(
        None, y.t().contiguous(), group=g, axis=1).numpy()
    z = torch.from_numpy(Z[4 * r:4 * r + 4].copy())
    got = D.all_to_all([], list(z.split(1)), group=g)
    out["all_to_all"] = torch.cat(got).numpy()
    out["reduce"] = D.reduce(x.clone(), dst=1, group=g).numpy()
    out["scatter"] = D.scatter(torch.empty(1, X.shape[1]),
                               list(torch.from_numpy(X).split(1))
                               if r == 2 else None, src=2, group=g).numpy()
    # a ring of send / recv
    buf = torch.empty_like(x)
    if r % 2 == 0:
        D.send(x, dst=(r + 1) % n, group=g)
        D.recv(buf, src=(r - 1) % n, group=g)
    else:
        D.recv(buf, src=(r - 1) % n, group=g)
        D.send(x, dst=(r + 1) % n, group=g)
    out["ring"] = buf.numpy()
    out["objects"] = D.all_gather_object([], {"rank": r}, group=g)
    # a group of one rank is the identity and counts nothing
    one = D.Group([r])
    out["identity"] = D.all_reduce(x.clone(), group=one).numpy()
    t2 = count()
    out["counters"] = growth(t0, t1)
    out["more_counters"] = growth(t1, t2)
    out["group"] = (g.ranks, g.nranks, g.rank, D.get_world_size_group(g))
    return out


# ----------------------------------------- expert and context parallelism
def ep_mesh(dims):
    """The mesh of an expert-parallel job on this 8-rank world: ``(dp,
    ep)`` over all 8 ranks, or ``("ep", n)``: a 1-D ep mesh of n ranks,
    one per group of n consecutive ranks (each group runs the same
    problem), of which this rank's is returned."""
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import ProcessMesh
    if dims[0] == "ep":
        n, world = dims[1], dist.get_world_size()
        meshes = [ProcessMesh(np.arange(s, s + n), ["ep"])
                  for s in range(0, world, n)]
        return meshes[dist.get_rank() // n]
    return ProcessMesh(np.arange(8).reshape(dims), ["dp", "ep"])


def moe_ep(dims, cases, x, gate_w, w1, b1, w2, b2):
    """``moe_dispatch_combine`` on this rank of the mesh ``ep_mesh(dims)``
    for each (mode, top_k, capacity_factor) of ``cases``: the rank's dp
    row of x and its experts of the weights, the objective sum(y ** 2) +
    aux; returns y, aux and the gradients of x (the row's), gate_w, w1,
    b1, w2 and b2 (the rank's experts), each summed over dp."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.distributed import all_reduce
    from paddle_tpu_torch.distributed import moe as TM
    mesh = ep_mesh(dims)
    _, lay = TM.ep_layout(mesh)
    rows = x.shape[0] // lay.dp
    el = w1.shape[0] // lay.ep
    mine = [x[lay.d * rows:(lay.d + 1) * rows], gate_w] + [
        a[lay.j * el:(lay.j + 1) * el] for a in (w1, b1, w2, b2)]
    out = []
    for mode, top_k, cf in cases:
        args = [torch.from_numpy(a.copy()).requires_grad_() for a in mine]
        y, aux = TM.moe_dispatch_combine(
            *args, top_k=top_k, capacity_factor=cf, mesh=mesh, train=False,
            dispatch_mode=mode)
        grads = torch.autograd.grad((y ** 2).sum() + aux, args)
        grads = [grads[0]] + [all_reduce(g.contiguous(), group=lay.dp_group)
                              for g in grads[1:]]
        out.append({"y": y.detach().numpy(), "aux": float(aux),
                    "grads": [g.numpy() for g in grads]})
    try:
        TM.moe_dispatch_combine(*(torch.from_numpy(a) for a in mine),
                                activation=F.silu, mesh=mesh,
                                dispatch_mode="grouped")
        grouped = None
    except NotImplementedError as e:
        grouped = str(e)
    return {"cases": out, "grouped": grouped, "dp": lay.dp, "ep": lay.ep,
            "d": lay.d, "j": lay.j}


def moe_llm_ep(cfg_kw, dims, np_params, ids, steps, lr):
    """``steps`` SGD steps of ``moe_llm`` on this rank of a (dp, ep) mesh
    from its shard of the reference's tree ``np_params``; returns every
    step's loss, ``loss_fn`` of the starting params, the rank's params
    after the steps (numpy tree) and the shapes of its shard's first
    layer as it started."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.models import (moe_params_from_numpy,
                                         moe_params_to_numpy)
    from paddle_tpu_torch.models import moe_llm as TM
    cfg = TM.moe_tiny(**cfg_kw)
    mesh = TM.build_mesh(8, *dims)
    params = moe_params_from_numpy(np_params, device="cpu",
                                   rank=dist.get_rank(), mesh=mesh)
    shapes = {k: tuple(t.shape) for k, t in params["layers"][0].items()}
    shapes.update({k: tuple(params[k].shape)
                   for k in ("embed", "norm", "head")})
    first = float(TM.loss_fn(params, torch.from_numpy(ids), cfg, mesh))
    step = TM.build_train_step(cfg, mesh, lr=lr, device="cpu")
    losses = []
    for _ in range(steps):
        loss, params = step(params, torch.from_numpy(ids))
        losses.append(float(loss))
    return {"losses": losses, "loss_fn": first, "shapes": shapes,
            "params": moe_params_to_numpy(params)}


def moe_llm_ep_runs(runs):
    """:func:`moe_llm_ep` for each keyword dict of ``runs``, in order."""
    return [moe_llm_ep(**kw) for kw in runs]


def ring(q, k, v, ct, qu, ku, vu, ctu):
    """Ring attention (causal and not) and Ulysses (causal) on this
    rank's sequence chunk of the 8-rank ``sep`` axis: each output chunk
    and the gradients of sum(out * ct) w.r.t. the chunks of q, k, v; and
    the messages of the calls that must raise."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import ProcessMesh
    from paddle_tpu_torch.ops.ring_attention import (ring_attention,
                                                     ulysses_attention)
    n, r = dist.get_world_size(), dist.get_rank()
    mesh = ProcessMesh(np.arange(n), ["sep"])

    def chunk(a):
        s = a.shape[1] // n
        return torch.from_numpy(a[:, r * s:(r + 1) * s].copy())

    def run(fn, arrays, cot, **kw):
        ts = [chunk(a).requires_grad_() for a in arrays]
        out = fn(*ts, mesh, **kw)
        grads = torch.autograd.grad((out * chunk(cot)).sum(), ts)
        return [out.detach().numpy()] + [g.numpy() for g in grads]

    res = {"ring_causal": run(ring_attention, (q, k, v), ct, is_causal=True),
           "ring_full": run(ring_attention, (q, k, v), ct, is_causal=False),
           "ulysses": run(ulysses_attention, (qu, ku, vu), ctu,
                          is_causal=True)}
    errors = {}
    for name, fn, a in (("ring_gqa", ring_attention,
                         (q, k[:, :, :2], v[:, :, :2])),
                        ("ulysses_heads", ulysses_attention, (q, k, v))):
        try:
            fn(*(chunk(x) for x in a), mesh)
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    res["errors"] = errors
    return res
