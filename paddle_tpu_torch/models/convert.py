"""Model state for the port: carried over from the JAX package, or random.

A serving state is a flat dict of tensors with the reference's
``functional_state()`` keys (``llama.embed_tokens.weight``,
``llama.layers.{i}.self_attn.q_proj.weight``, ..., ``llama.norm.weight``,
``lm_head.weight``) and its ``[in, out]`` weight layout.  A training
param tree (``models/llama_hybrid.py``) is ``{"embed", "stages",
"norm", "head"}`` with one dict of tensors per layer in ``stages``;
:func:`hybrid_params_from_numpy` and :func:`hybrid_params_to_numpy`
carry it to and from the reference's stage-stacked tree.  A quantized
serving leaf is a :class:`~paddle_tpu_torch.ops.pallas.quant_matmul.
QuantizedWeight`; :func:`adapter_from_numpy` carries the reference's
LoRA adapter dicts over.  An MoE param tree (``models/moe_llm.py``) is
``{"embed", "layers", "norm", "head"}`` with one dict per layer in
``layers``; :func:`moe_params_from_numpy` and :func:`moe_params_to_numpy`
carry it to and from the reference's ``[L, ...]``-stacked tree.
:func:`shard_serving_state` cuts a serving state into one tensor-parallel
rank's shard, and :func:`shard_serving_adapter` an adapter into that
rank's bank rows (the reference's ``serving/parallel/runner.py`` rule).
:func:`layer_state_from_numpy` loads a reference ``Layer.state_dict()``
(as numpy) into a port ``nn.Layer`` with the same keys.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops.pallas.quant_matmul import QuantizedWeight
from .llama import LlamaConfig

__all__ = ["adapter_from_numpy", "check_serving_shardable",
           "hybrid_params_from_numpy", "hybrid_params_to_numpy",
           "init_state", "layer_state_from_numpy", "moe_params_from_numpy", "moe_params_to_numpy",
           "serving_shard_axis", "shard_serving_adapter",
           "shard_serving_leaf", "shard_serving_state", "state_from_numpy"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)                      # an owned, writable C-order copy
    if a.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16 (what a JAX bf16 array becomes in numpy):
        # same bits as torch.bfloat16, so reinterpret through int16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def state_from_numpy(np_state: dict, device=None, dtype=None) -> dict:
    """``{key: numpy array}`` (e.g. the JAX package's
    ``{k: np.asarray(v) for k, v in model.functional_state().items()}``)
    -> ``{key: tensor}`` on ``device`` (default CUDA), optionally cast to
    ``dtype``.  bf16 arrays keep their exact bits.  A quantized leaf is
    given as ``(q, scale, kind, k)`` — numpy int8 values, f32 scales,
    ``"int8"``/``"int4"`` and the logical K, e.g. from the reference's
    ``QuantizedWeight`` — and becomes a :class:`QuantizedWeight` (never
    cast)."""
    dev = resolve_device(device)
    out = {}
    for k, a in np_state.items():
        if isinstance(a, tuple):
            q, scale, kind, logical_k = a
            out[k] = QuantizedWeight(_to_tensor(q).to(dev),
                                     _to_tensor(scale).to(dev), kind=kind,
                                     k=logical_k)
            continue
        t = _to_tensor(a)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[k] = t.to(dev)
    return out


def layer_state_from_numpy(model, np_state: dict, strict=True):
    """Load ``np_state`` — a reference ``Layer.state_dict()`` as numpy,
    e.g. ``{k: np.asarray(v._data) for k, v in
    ref_model.state_dict().items()}`` — into the port Layer ``model``:
    every entry is cast to its parameter's dtype and put on its device
    (bf16 arrays keep their bits).  ``strict`` raises KeyError when the
    keys differ; otherwise returns ``(missing, unexpected)``."""
    own = model.state_dict()
    missing = [k for k in own if k not in np_state]
    unexpected = [k for k in np_state if k not in own]
    if strict and (missing or unexpected):
        raise KeyError(f"state keys differ: missing {missing}, "
                       f"unexpected {unexpected}")
    for k, t in own.items():
        if k in np_state:
            a = np_state[k]
            if list(np.shape(a)) != t.shape:
                raise ValueError(f"shape mismatch for {k}: "
                                 f"{list(np.shape(a))} vs {t.shape}")
            t.set_value(_to_tensor(a))
    return missing, unexpected


def adapter_from_numpy(weights: dict) -> dict:
    """The reference's LoRA adapter dict ``{key: (A [L, r, in],
    B [L, r, out])}`` of numpy arrays -> the port's, the same pairs as
    float32 CPU tensors (what ``serving.lora.AdapterStore.register``
    parks on the host)."""
    return {key: (torch.from_numpy(np.asarray(a, np.float32).copy()),
                  torch.from_numpy(np.asarray(b, np.float32).copy()))
            for key, (a, b) in weights.items()}


def init_state(config: LlamaConfig, generator: torch.Generator,
               device=None, dtype=None) -> dict:
    """A random state with the reference's keys, made directly on
    ``device`` (default CUDA) from ``generator`` (which must live on that
    device's type).  Matrices are N(0, 0.02^2), norms are ones; no
    weights are downloaded.  ``dtype`` defaults to ``config.dtype``."""
    dev = resolve_device(device)
    dtype = _DTYPES[config.dtype] if dtype is None else dtype
    h, i, v = (config.hidden_size, config.intermediate_size,
               config.vocab_size)
    nh, kvh, hd = (config.num_attention_heads,
                   config.num_key_value_heads, config.head_dim)

    def normal(*shape):
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        w.normal_(0.0, 0.02, generator=generator)
        return w.to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=dev)

    state = {"llama.embed_tokens.weight": normal(v, h)}
    for li in range(config.num_hidden_layers):
        p = f"llama.layers.{li}."
        state.update({
            p + "self_attn.q_proj.weight": normal(h, nh * hd),
            p + "self_attn.k_proj.weight": normal(h, kvh * hd),
            p + "self_attn.v_proj.weight": normal(h, kvh * hd),
            p + "self_attn.o_proj.weight": normal(nh * hd, h),
            p + "mlp.gate_proj.weight": normal(h, i),
            p + "mlp.up_proj.weight": normal(h, i),
            p + "mlp.down_proj.weight": normal(i, h),
            p + "input_layernorm.weight": ones(h),
            p + "post_attention_layernorm.weight": ones(h),
        })
    state["llama.norm.weight"] = ones(h)
    if not config.tie_word_embeddings:
        state["lm_head.weight"] = normal(h, v)
    return state


def _mesh_dims(mesh, axes=("pp", "dp", "tp")):
    """The sizes of ``axes`` (1 where an axis is missing) of a
    :class:`~..distributed.mesh.ProcessMesh` or of a mapping of axis
    sizes; all 1 for None."""
    if mesh is None:
        return (1,) * len(axes)
    if hasattr(mesh, "get_dim_size"):
        return tuple(mesh.get_dim_size(a) if a in mesh.dim_names else 1
                     for a in axes)
    return tuple(int(mesh.get(a, 1)) for a in axes)


def _coords(rank, dims, mesh=None):
    """(p, d, t) of ``rank``: from ``mesh`` where it is a ProcessMesh,
    else on a ('pp', 'dp', 'tp') grid of ``dims`` with rank = (p·dp +
    d)·tp + t, as ``llama_hybrid.build_mesh`` lays it."""
    if hasattr(mesh, "coords"):
        at = mesh.coords(rank)
        return at["pp"], at["dp"], at["tp"]
    _, dp, tp = dims
    return rank // (dp * tp), rank // tp % dp, rank % tp


def _global_layers(stages: dict) -> list:
    """The reference's stage leaves ``[pp, lps, ...]`` or, interleaved,
    ``[pp, v, lps, ...]`` (device p holds virtual stages c·pp + p) -> one
    dict of numpy arrays per layer, in model order."""
    stages = {k: np.asarray(a) for k, a in stages.items()}
    q = stages["q"]                     # [pp, (v), lps, in, out]
    if q.ndim == 4:
        stages = {k: a[:, None] for k, a in stages.items()}
        q = stages["q"]
    pp, v, lps = q.shape[:3]
    layers = [None] * (pp * v * lps)
    for p in range(pp):
        for c in range(v):
            for i in range(lps):
                layers[(c * pp + p) * lps + i] = {
                    k: a[p, c, i] for k, a in stages.items()}
    return layers


def hybrid_params_from_numpy(np_tree: dict, device=None, dtype=None, *,
                             rank=None, mesh=None, n_virtual=1,
                             zero1=False) -> dict:
    """The reference ``llama_hybrid.init_params`` tree as numpy (stage
    leaves ``[pp, lps, ...]`` or ``[pp, v, lps, ...]``, any pp and v)
    -> the port's tree, with one owned tensor per layer weight, on
    ``device`` (default CUDA), optionally cast to ``dtype``.  Also takes
    AdamW m/v trees.

    Without ``mesh``, the whole model (one device).  With ``mesh`` (a
    ``ProcessMesh`` or a mapping of the pp, dp and tp sizes) and
    ``rank``, that rank's shard: its pipeline stage's layers, chunk by
    chunk for ``n_virtual`` (``llama_hybrid.rank_layers``), each leaf cut
    by the tp rule (``llama_hybrid.TP_DIM``).  ``zero1`` marks an AdamW
    m or v tree of a ZeRO-1 run: a leaf that dp divides becomes the
    rank's flat 1/dp of its elements (``llama_hybrid.zero1_shardings``)."""
    from .llama_hybrid import rank_layers, shard, zero1_sharded
    dev = resolve_device(device)
    dims = _mesh_dims(mesh)
    p, d, t = (0, 0, 0) if mesh is None else _coords(rank, dims, mesh)

    def conv(a, key):
        x = shard(_to_tensor(a), key, dims[2], t)
        if zero1 and zero1_sharded(x.numel(), dims[1]):
            n = x.numel() // dims[1]
            x = x.reshape(-1)[d * n:(d + 1) * n].clone()
        if dtype is not None and x.is_floating_point():
            x = x.to(dtype)
        return x.to(dev)

    layers = _global_layers(np_tree["stages"])
    mine = rank_layers(len(layers), dims[0], p, n_virtual) \
        if mesh is not None else range(len(layers))
    return {"embed": conv(np_tree["embed"], "embed"),
            "stages": [{k: conv(a, k) for k, a in layers[li].items()}
                       for li in mine],
            "norm": conv(np_tree["norm"], "norm"),
            "head": conv(np_tree["head"], "head")}


def _np(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def hybrid_params_to_numpy(tree, *, mesh=None, n_virtual=1,
                           like=None) -> dict:
    """The inverse of :func:`hybrid_params_from_numpy`: numpy arrays in
    the reference's layout (bf16 tensors come out as float32, which
    holds them exactly).

    ``tree``: one device's tree (stage leaves stacked to ``[1, L,
    ...]``), or, with ``mesh``, the list of every rank's tree in rank
    order, gathered into stage leaves ``[pp, lps, ...]`` (``[pp, v, lps,
    ...]`` for ``n_virtual`` > 1).  ``like``: the ranks' param trees,
    when ``tree`` holds ZeRO-1 AdamW state whose dp parts are put back
    together first.  Also takes grads trees."""
    from .llama_hybrid import TP_DIM, rank_layers
    if mesh is None:
        keys = tree["stages"][0].keys()
        return {"embed": _np(tree["embed"]),
                "stages": {k: np.stack([_np(lp[k])
                                        for lp in tree["stages"]])[None]
                           for k in keys},
                "norm": _np(tree["norm"]), "head": _np(tree["head"])}
    pp, dp, tp = dims = _mesh_dims(mesh)
    if len(tree) != pp * dp * tp:
        raise ValueError(f"{len(tree)} trees for a mesh of {pp * dp * tp}")

    def rank_of(p, d, t):
        return (p * dp + d) * tp + t

    def leaf(r, get):
        """Rank r's leaf, its ZeRO-1 dp parts put back together."""
        x = _np(get(tree[r]))
        if like is None:
            return x
        shape = tuple(get(like[r]).shape)
        if x.shape == shape:
            return x
        p, _, t = _coords(r, dims)
        return np.concatenate([_np(get(tree[rank_of(p, d, t)]))
                               for d in range(dp)]).reshape(shape)

    def whole(p, key, get):
        """The leaf of stage p, its tp parts concatenated."""
        parts = [leaf(rank_of(p, 0, t), get) for t in range(tp)]
        dim = TP_DIM[key]
        return parts[0] if dim is None else np.concatenate(parts, axis=dim)

    n_local = len(tree[0]["stages"])
    n_layers = n_local * pp
    layers = [None] * n_layers
    for p in range(pp):
        for i, li in enumerate(rank_layers(n_layers, pp, p, n_virtual)):
            layers[li] = {k: whole(p, k, lambda tr, i=i, k=k:
                                   tr["stages"][i][k])
                          for k in tree[0]["stages"][0]}
    lps = n_layers // (pp * n_virtual)
    stages = {}
    for k in layers[0]:
        rows = [[np.stack([layers[(c * pp + p) * lps + i][k]
                           for i in range(lps)])
                 for c in range(n_virtual)] for p in range(pp)]
        stages[k] = np.stack([np.stack(r) if n_virtual > 1 else r[0]
                              for r in rows])
    return {"embed": whole(0, "embed", lambda tr: tr["embed"]),
            "stages": stages,
            "norm": whole(pp - 1, "norm", lambda tr: tr["norm"]),
            "head": whole(pp - 1, "head", lambda tr: tr["head"])}


def moe_params_from_numpy(np_tree: dict, device=None, dtype=None, *,
                          rank=None, mesh=None) -> dict:
    """The reference ``moe_llm.init_params`` tree as numpy (layer leaves
    stacked ``[L, ...]``) -> the port's tree, one owned tensor per layer
    weight, on ``device`` (default CUDA).  ``dtype`` casts every float
    leaf but the router ``gate``, which stays float32 as in the
    reference.  With ``mesh`` (a ('dp', 'ep') ``ProcessMesh`` or a
    mapping of the dp and ep sizes) and ``rank`` (= d·ep + j), that
    rank's shard: experts [j·E/ep, (j+1)·E/ep) and 1/ep of the shared
    experts' inner dim (``moe_llm.EP_DIM``), every other leaf whole."""
    from .moe_llm import shard
    dev = resolve_device(device)
    ep = _mesh_dims(mesh, ("dp", "ep"))[1]
    j = 0 if mesh is None else rank % ep

    def conv(a, key=None):
        t = shard(_to_tensor(a), key, ep, j)
        if dtype is not None and t.is_floating_point() and key != "gate":
            t = t.to(dtype)
        return t.to(dev)

    layers = {k: np.asarray(a) for k, a in np_tree["layers"].items()}
    n_layers = next(iter(layers.values())).shape[0]
    return {"embed": conv(np_tree["embed"]),
            "layers": [{k: conv(a[i], k) for k, a in layers.items()}
                       for i in range(n_layers)],
            "norm": conv(np_tree["norm"]), "head": conv(np_tree["head"])}


def moe_params_to_numpy(tree, *, mesh=None) -> dict:
    """The inverse of :func:`moe_params_from_numpy`: numpy arrays with
    layer leaves stacked to ``[L, ...]`` (bf16 tensors come out as
    float32, which holds them exactly).  Also takes a grads tree.  With
    ``mesh``, ``tree`` is the list of every rank's tree in rank order,
    and the ep shards of dp row 0 are put back together."""
    from .moe_llm import EP_DIM
    if mesh is None:
        tree, ep = [tree], 1
    else:
        dp, ep = _mesh_dims(mesh, ("dp", "ep"))
        if len(tree) != dp * ep:
            raise ValueError(f"{len(tree)} trees for a mesh of {dp * ep}")

    def whole(key, get):
        parts = [_np(get(tree[j])) for j in range(ep)]
        dim = EP_DIM.get(key)
        return parts[0] if dim is None else np.concatenate(parts, axis=dim)

    layers = tree[0]["layers"]
    return {"embed": whole("embed", lambda tr: tr["embed"]),
            "layers": {k: np.stack([whole(k, lambda tr, i=i, k=k:
                                          tr["layers"][i][k])
                                    for i in range(len(layers))])
                       for k in layers[0]},
            "norm": whole("norm", lambda tr: tr["norm"]),
            "head": whole("head", lambda tr: tr["head"])}


# ------------------------------------------- serving tensor parallelism
# The reference's rule (serving/parallel/runner.py:73-85): the
# input-side projections split their output columns (each rank owns
# nh/tp query heads, kvh/tp KV heads, I/tp FFN columns), the output-side
# projections split their input rows (their partial products are the
# layer's two all-reduces); embeddings, norms and lm_head replicate.
_COL_SHARDED = ("self_attn.q_proj.weight", "self_attn.k_proj.weight",
                "self_attn.v_proj.weight", "mlp.gate_proj.weight",
                "mlp.up_proj.weight")
_ROW_SHARDED = ("self_attn.o_proj.weight", "mlp.down_proj.weight")
_FUSED_KEYS = ("self_attn.qkv_fused.weight", "mlp.gateup_fused.weight")
# adapter keys whose base weight splits rows: A (which contracts the
# split input) splits with it and B replicates; every other key splits
# B's output columns and replicates A
_LORA_ROW_KEYS = ("o", "down")


def serving_shard_axis(key: str):
    """The dim of ``key``'s ``[in, out]`` weight that tp splits: 1 for
    the column-sharded projections, 0 for the row-sharded ones, None for
    the replicated leaves."""
    if key.endswith(_COL_SHARDED):
        return 1
    if key.endswith(_ROW_SHARDED):
        return 0
    return None


def check_serving_shardable(state: dict, tp: int):
    """The reference's ``_check_state_shardable`` (``runner.py:328-356``):
    a tp > 1 state holds per-projection tensors or
    :class:`QuantizedWeight` leaves whose split dim tp divides (int4's
    packed K/2 rows for the row-sharded ones), never a fused weight."""
    for k, v in state.items():
        if k.endswith(_FUSED_KEYS):
            raise ValueError(
                f"state has fused weight {k!r}: fused serving states are "
                "single-device only (tp=1); the tp>1 runner shards the "
                "per-projection q/k/v and gate/up weights individually")
        if isinstance(v, QuantizedWeight):
            axis = serving_shard_axis(k)
            if axis == 0 and v.q.shape[0] % tp:
                raise ValueError(
                    f"state[{k!r}]: quantized K rows {v.q.shape[0]} not "
                    f"divisible by tp={tp}" + (
                        " (int4 packs two K rows per int8 byte: K/2 must "
                        "divide)" if v.kind == "int4" else ""))
            if axis == 1 and v.q.shape[1] % tp:
                raise ValueError(
                    f"state[{k!r}]: quantized N columns {v.q.shape[1]} not "
                    f"divisible by tp={tp}")
            continue
        if not torch.is_tensor(v):
            raise ValueError(
                f"state[{k!r}] is {type(v).__name__}, not an array or "
                "QuantizedWeight: cannot be head-sharded")


def _cut(t, axis, tp, rank):
    n = t.shape[axis] // tp
    return t.narrow(axis, rank * n, n).contiguous()


def shard_serving_leaf(key: str, v, tp: int, rank: int):
    """Rank ``rank``'s piece of one serving leaf (the reference's
    ``_place`` with ``_spec_for`` / ``_quant_specs``).  A column-sharded
    :class:`QuantizedWeight` splits its values and per-column scales
    along N and keeps the logical K; a row-sharded one splits its
    (packed) value rows, keeps every scale (they multiply partial
    products before the all-reduce, which is linear) and carries the
    local K = K / tp.  Replicated leaves come back as they are."""
    axis = serving_shard_axis(key)
    if axis is None or tp == 1:
        return v
    if isinstance(v, QuantizedWeight):
        if axis == 1:
            return QuantizedWeight(_cut(v.q, 1, tp, rank),
                                   _cut(v.scale, 0, tp, rank), kind=v.kind,
                                   k=v.k)
        return QuantizedWeight(_cut(v.q, 0, tp, rank), v.scale, kind=v.kind,
                               k=v.k // tp)
    return _cut(v, axis, tp, rank)


def shard_serving_state(state: dict, tp: int, rank: int) -> dict:
    """A full serving state (e.g. from :func:`state_from_numpy`) -> rank
    ``rank``'s shard of a ``tp``-way serving mesh, on the state's own
    device (see :func:`shard_serving_leaf`)."""
    if tp > 1:
        check_serving_shardable(state, tp)
    return {k: shard_serving_leaf(k, v, tp, rank) for k, v in state.items()}


def shard_serving_adapter(a: dict, b: dict, tp: int, rank: int):
    """An adapter's ``a`` ``{key: [L, r, in]}`` and ``b`` ``{key: [L, r,
    out]}`` -> rank ``rank``'s bank rows (the reference's
    ``_lora_pspecs``): A split on its input for o and down, B split on
    its output for the other projections."""
    a_out, b_out = dict(a), dict(b)
    if tp > 1:
        for k in a:
            if k in _LORA_ROW_KEYS:
                a_out[k] = _cut(torch.as_tensor(a[k]), -1, tp, rank)
            else:
                b_out[k] = _cut(torch.as_tensor(b[k]), -1, tp, rank)
    return a_out, b_out
