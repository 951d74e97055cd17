"""Pipeline parallelism (pp) on PyTorch: layers split across a mesh axis.

The counterpart of the JAX package's ``workloads/pipeline.py``, with its
function names.  The transformer's stacked layer params are cut over
the ``pp`` axis on their leading (layer) dimension (stage i holds layers
[i·L/P, (i+1)·L/P) as the ``model.Sharded`` block of its rank) and the
microbatches stream through the stages GPipe-style.  One process holds
the ranks as a ``model.Mesh`` (a device may repeat, so stages share a
card when there are fewer cards than ranks):

- the schedule is JAX's: ``m + P - 1`` ticks; at tick t stage i runs
  microbatch t - i, stage 0 reading the embedding, a later stage what
  its predecessor made at tick t - 1, moved onto its device by ``.to()``
  (JAX's ``lax.ppermute`` one hop down the ring);
- a bubble slot (t - i outside [0, m)) is masked out in JAX and changes
  no output; here it does not run, so a step runs ``m·P`` stage
  forwards, not ``(m + P - 1)·P`` (the loss's ``counts``);
- autograd through the ``.to()`` hops derives the backward pipeline, as
  AD does through ``ppermute``; ``remat`` runs each tick's stage forward
  under ``torch.utils.checkpoint`` (non-reentrant), JAX's
  ``jax.checkpoint`` of the stage, so the backward stores only the
  inter-stage carries and recomputes the blocks;
- the loss is the full-logits mean NLL over the ``m·mb`` rows on the
  last stage (``cfg.ce_chunk`` is not read, as in JAX); a MoE model adds
  its router losses, each stage's layer mean summed over its real
  microbatches and divided by ``m·P``.  Each stage routes its
  microbatch's rows, and ``model.moe_ffn`` routes (and counts capacity)
  row by row, so a microbatch of whole rows routes as the unpipelined
  batch does: the MoE loss equals the unpipelined one at every m, up to
  the summation order of the router losses.

dp×pp×tp (``make_pipeline_mesh``: axes (data, pp, model)) runs the same
schedule once per data row on its block of the batch, each stage's
block Megatron-cut over ``model`` (``model._tp_attention`` /
``model._tp_ffn``, K1/K2 per (data row, stage, model rank) shard on its
h/tp heads).  It trains the split-weight tree (``wq``/``wk``/``wv`` in
place of the packed ``qkv``; ``split_qkv_weights``) so that a model
rank's contiguous block holds whole heads; checkpoints keep the merged
one-device layout (``gather_pipeline_state`` / ``shard_pipeline_state``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from tpu_autoscaler_torch.workloads.attention import (
    make_sharded_flash_attention,
)
from tpu_autoscaler_torch.workloads.model import (
    _PRODUCTS,
    Mesh,
    ModelConfig,
    P,
    TrainConfig,
    _block,
    _device,
    _mesh_attend,
    _rmsnorm,
    _rope,
    _shard_state,
    _shard_tree,
    _sharded_step,
    _state_specs,
    _tp_attention,
    _tp_ffn,
    gather_params,
    init_params,
    make_optimizer,
)


def _stage_forward(blocks: dict, x: torch.Tensor, cfg: ModelConfig):
    """Run one stage's layer stack (leading dim = local layers) over x.

    Returns (x, aux) with aux meaned over the local layers (MoE router
    losses; zeros for dense blocks)."""
    auxs = []
    for i in range(blocks["ln1"].shape[0]):
        x, aux = _block(x, {name: w[i] for name, w in blocks.items()}, cfg)
        auxs.append(aux)
    return x, {name: torch.stack([a[name] for a in auxs]).mean()
               for name in auxs[0]}


def _each_tree(fn, tree: dict) -> dict:
    """``fn`` over a params tree, or over each tree of an optimizer
    state (its counts pass through)."""
    if "blocks" in tree:
        return fn(tree)
    return {k: fn(v) if isinstance(v, dict) else v for k, v in tree.items()}


def split_qkv_weights(params: dict, cfg: ModelConfig) -> dict:
    """Standard tree -> the 3-axis pipeline's split-weight tree.

    blocks.qkv [L, d, d + 2·hkv·hd] splits at the q|k|v packing
    boundaries into wq [L, d, h·hd], wk/wv [L, d, hkv·hd], so each
    weight's output dim is pure heads and a contiguous ``model`` block
    holds whole GQA groups.  A pure split, inverted bit for bit by
    :func:`merge_qkv_weights`.  Given an optimizer state it splits each
    moment tree the same way."""
    d, hkv, hd = cfg.d_model, cfg.kv_heads, cfg.head_dim

    def split(tree):
        blocks = dict(tree["blocks"])
        wq, wk, wv = torch.split(blocks.pop("qkv"), [d, hkv * hd, hkv * hd],
                                 dim=-1)
        blocks.update(wq=wq.contiguous(), wk=wk.contiguous(),
                      wv=wv.contiguous())
        return {**tree, "blocks": blocks}

    return _each_tree(split, params)


def merge_qkv_weights(params3d: dict, cfg: ModelConfig) -> dict:
    """Inverse of :func:`split_qkv_weights`: repack wq|wk|wv into
    blocks.qkv (of a params tree, or of each moment tree of a state)."""
    def merge(tree):
        blocks = dict(tree["blocks"])
        blocks["qkv"] = torch.cat(
            [blocks.pop("wq"), blocks.pop("wk"), blocks.pop("wv")], dim=-1)
        return {**tree, "blocks": blocks}

    return _each_tree(merge, params3d)


def pipeline3d_param_specs(cfg: ModelConfig, pp_axis: str = "pp",
                           model_axis: str = "model") -> dict:
    """Partition specs for the SPLIT-WEIGHT tree under pp×tp: blocks cut
    over ``pp_axis`` on the layer dim and over ``model_axis``
    Megatron-style (wq/wk/wv/w1 column-parallel, attn_out/w2
    row-parallel); embed/unembed/ln replicate."""
    return {
        "embed": P(None, None),
        "blocks": {
            "wq": P(pp_axis, None, model_axis),
            "wk": P(pp_axis, None, model_axis),
            "wv": P(pp_axis, None, model_axis),
            "attn_out": P(pp_axis, model_axis, None),
            "w1": P(pp_axis, None, model_axis),
            "w2": P(pp_axis, model_axis, None),
            "ln1": P(pp_axis, None),
            "ln2": P(pp_axis, None),
        },
        "ln_f": P(None),
        "unembed": P(None, None),
    }


def pipeline_param_specs(cfg: ModelConfig, pp_axis: str = "pp") -> dict:
    """Partition specs for the standard tree under pp: blocks cut over
    ``pp_axis`` on the layer dim, embed/unembed/ln_f replicated (stage 0
    reads the embedding, the last stage the unembedding)."""
    if cfg.moe_experts is None:
        ffn = {"w1": P(pp_axis, None, None), "w2": P(pp_axis, None, None)}
    else:
        ffn = {"router": P(pp_axis, None, None),
               "w1": P(pp_axis, None, None, None),
               "w2": P(pp_axis, None, None, None)}
    block_specs = {
        "qkv": P(pp_axis, None, None), "attn_out": P(pp_axis, None, None),
        **ffn,
        "ln1": P(pp_axis, None), "ln2": P(pp_axis, None),
    }
    return {"embed": P(None, None), "blocks": block_specs,
            "ln_f": P(None), "unembed": P(None, None)}


def make_pipeline_mesh(devices=None, pp: int = 2, tp: int = 1) -> Mesh:
    """(data, pp, model) mesh: batch over ``data``, stages over ``pp``,
    Megatron TP over ``model``; dp takes the rest of the devices
    (default: every visible CUDA card; a device may repeat)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices=['cpu'] "
                               "(--platform cpu) to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(dev) for dev in devices]
    n = len(devices)
    if n % (pp * tp):
        raise ValueError(f"{n} devices not divisible by pp*tp = {pp * tp}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(n // (pp * tp), pp, tp),
                ("data", "pp", "model"))


def _rank_grid(mesh: Mesh, axes: tuple) -> np.ndarray:
    """The mesh's rank numbers with ``axes`` leading, in that order (the
    rest of the axes after them)."""
    ranks = np.arange(mesh.size).reshape(mesh.devices.shape)
    lead = [mesh.axis_names.index(a) for a in axes]
    return np.moveaxis(ranks, lead, list(range(len(lead))))


def _held(leaf, rank: int) -> torch.Tensor:
    """Rank ``rank``'s own block of ``leaf``, on its device."""
    return leaf.blocks[rank]


def _nll_mean(outs: list, ln_f, unembed, targets, cfg: ModelConfig):
    """The mean next-token NLL of the last stage's microbatch outputs
    (concatenated in microbatch order, the rows of ``targets``): final
    norm, full logits in f32, log-softmax."""
    h = _rmsnorm(torch.cat(outs), ln_f)
    logits = (h @ unembed.to(cfg.dtype)).float()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None].long()).mean()


def _run_schedule(n_stages: int, m: int, ingest, stage_fwd, hop, remat: bool,
                  counts: dict):
    """GPipe over ``m + n_stages - 1`` ticks: at tick t stage i runs
    microbatch t - i on ``ingest(t)`` (stage 0) or on what stage i - 1
    made at tick t - 1 after ``hop(y, i - 1)``; bubble slots do not run.
    Returns (the last stage's outputs in microbatch order, each run's
    aux)."""
    outs, auxs = [None] * m, []
    carry = [None] * n_stages
    for t in range(m + n_stages - 1):
        made = [None] * n_stages
        for i in range(n_stages):
            if not 0 <= t - i < m:
                continue
            x_in = ingest(t) if i == 0 else carry[i - 1]
            fn = functools.partial(stage_fwd, i)
            y, aux = (checkpoint(fn, x_in, use_reentrant=False) if remat
                      else fn(x_in))
            counts["stage_forwards"] += 1
            auxs.append(aux)
            if i == n_stages - 1:
                outs[t - i] = y
            else:
                made[i] = hop(y, i)
        carry = made
    return outs, auxs


def make_pipeline_loss(mesh: Mesh, cfg: ModelConfig, num_microbatches: int,
                       pp_axis: str = "pp", remat: bool = False):
    """Build ``loss(params, tokens)`` pipelined over ``mesh``'s pp axis.

    params: the standard tree of :class:`model.Sharded` leaves at
    :func:`pipeline_param_specs` (``init_fn`` of
    :func:`make_pipeline_train_step`, or ``shard_pipeline_state``).
    tokens: [batch, seq + 1] int, batch divisible by num_microbatches,
    replicated over the stages.  The loss lies on the last stage's
    device.  ``remat``: checkpoint each tick's stage forward (the module
    docstring).  MoE configs fold the router balance/z losses in as
    ``model.loss_and_metrics`` does.  Bubble slots do not run:
    ``loss.counts["stage_forwards"]`` adds ``m·P`` a call."""
    cfg.require_uniform("the pipeline")
    n_stages = mesh.shape[pp_axis]
    if cfg.n_layers % n_stages:
        raise ValueError(
            f"{cfg.n_layers} layers not divisible by {n_stages} stages")
    stage_ranks = [int(r) for r in
                   _rank_grid(mesh, (pp_axis,)).reshape(n_stages, -1)[:, 0]]
    devs = [mesh.ranks[r] for r in stage_ranks]
    m = num_microbatches
    counts = {"stage_forwards": 0}

    def loss(params: dict, tokens):
        tokens = torch.as_tensor(tokens)
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        b, s = inputs.shape
        if b % m:
            raise ValueError(f"batch {b} not divisible by {m} microbatches")
        mb = b // m
        stages = [{name: _held(leaf, r)
                   for name, leaf in params["blocks"].items()}
                  for r in stage_ranks]
        embedded = _held(params["embed"], stage_ranks[0]).to(cfg.dtype)[
            inputs.to(devs[0]).reshape(m, mb, s)]

        def stage_fwd(i, x):
            return _stage_forward(stages[i], x, cfg)

        outs, auxs = _run_schedule(
            n_stages, m, lambda t: embedded[t], stage_fwd,
            lambda y, i: y.to(devs[i + 1]), remat, counts)
        last = stage_ranks[-1]
        value = _nll_mean(outs, _held(params["ln_f"], last),
                          _held(params["unembed"], last),
                          targets.to(devs[-1]), cfg)
        if cfg.moe_experts is not None:
            # Each run's aux is its stage's local-layer mean; their sum
            # over the m·P runs, / (m·P), is the all-layer,
            # all-microbatch mean model.loss_and_metrics reports.
            aux = {name: sum(a[name].to(devs[-1]) for a in auxs)
                   / (m * n_stages) for name in auxs[0]}
            value = (value + cfg.moe_balance_weight * aux["balance_loss"]
                     + cfg.moe_z_weight * aux["z_loss"])
        return value

    loss.counts = counts
    return loss


def make_pipeline3d_loss(mesh: Mesh, cfg: ModelConfig, num_microbatches: int,
                         pp_axis: str = "pp", data_axis: str = "data",
                         model_axis: str = "model", remat: bool = False):
    """Build ``loss(params3d, tokens)`` pipelined over ``pp_axis`` with
    the batch cut over ``data_axis`` and the stage weights
    Megatron-cut over ``model_axis``: the dp×pp×tp composition.

    params3d: the SPLIT-WEIGHT tree of :class:`model.Sharded` leaves at
    :func:`pipeline3d_param_specs`.  tokens: [batch, seq + 1] int, batch
    divisible by dp·num_microbatches.  Each data row runs the GPipe
    schedule on its block of the batch; each (data row, stage) runs the
    Megatron block over its model ranks (the partial products summed on
    the row's first rank), K1/K2 per shard on h/tp heads.  The loss, the
    mean of the data rows' last-stage means, lies on the first rank's
    device.  Dense blocks only.  ``loss.counts`` as in
    :func:`make_pipeline_loss`, one stage forward being one stage over
    every data row."""
    cfg.require_uniform("the pipeline")
    n_stages = mesh.shape[pp_axis]
    tp = mesh.shape[model_axis]
    dp = mesh.shape[data_axis]
    if cfg.n_layers % n_stages:
        raise ValueError(
            f"{cfg.n_layers} layers not divisible by {n_stages} stages")
    if cfg.n_heads % tp or cfg.kv_heads % tp:
        raise ValueError(
            f"heads ({cfg.n_heads} q / {cfg.kv_heads} kv) must divide by "
            f"the {model_axis} axis ({tp})")
    if cfg.d_ff % tp:
        raise ValueError(
            f"d_ff ({cfg.d_ff}) must divide by the {model_axis} axis "
            f"({tp})")
    if cfg.moe_experts is not None:
        raise ValueError(
            "MoE blocks are not supported in the tp-composed pipeline; "
            "use the pp-only pipeline or the dp/ep step")
    grid = _rank_grid(mesh, (data_axis, pp_axis, model_axis)).reshape(
        dp, n_stages, tp)
    # rows[i][d][j]: stage i's data row d, model rank j.
    rows = [[[mesh.ranks[grid[d, i, j]] for j in range(tp)]
             for d in range(dp)] for i in range(n_stages)]
    # K1/K2 per (data row, model rank) shard of each stage.
    attends = [_mesh_attend(cfg, rows[i], make_sharded_flash_attention(
        Mesh(np.array(rows[i], dtype=object), ("data", "model")),
        causal=True, window=cfg.attention_window))
        for i in range(n_stages)]
    rope = (lambda t, i: _rope(t, cfg.rope_theta)) if cfg.rope else None
    m = num_microbatches
    first = mesh.ranks[0]
    counts = {"stage_forwards": 0}

    def weights(blocks: dict, i: int, layer: int):
        """``w(name, d, j, dev)`` of stage i's layer ``layer``: data row
        d's model rank j's own block (qkv: ``cat(wq_j, wk_j, wv_j)``,
        the head-aligned columns ``model._split_qkv`` reads), products in
        the compute dtype."""
        views: dict = {}

        def block(name, d, j):
            return blocks[name].blocks[int(grid[d, i, j])][layer]

        def w(name, d, j, dev):
            if (name, d, j) not in views:
                t = (torch.cat([block(n, d, j) for n in ("wq", "wk", "wv")],
                               dim=-1) if name == "qkv"
                     else block(name, d, j))
                t = t.to(dev)
                views[name, d, j] = t.to(cfg.dtype) if name in _PRODUCTS \
                    else t
            return views[name, d, j]
        return w

    def loss(params3d: dict, tokens):
        tokens = torch.as_tensor(tokens)
        b = tokens.shape[0]
        if b % dp:
            raise ValueError(f"global batch {b} is not divisible by the "
                             f"{dp}-way data parallelism")
        b_loc = b // dp
        if b_loc % m:
            raise ValueError(
                f"per-data-shard batch {b_loc} not divisible by "
                f"{m} microbatches")
        mb = b_loc // m
        s = tokens.shape[1] - 1
        blocks = params3d["blocks"]
        per_stage = cfg.n_layers // n_stages
        embedded = []
        for d in range(dp):
            head = rows[0][d][0]
            rows_d = tokens[d * b_loc:(d + 1) * b_loc, :-1].to(head)
            embedded.append(_held(params3d["embed"], int(grid[d, 0, 0])).to(
                cfg.dtype)[rows_d.reshape(m, mb, s)])

        def stage_fwd(i, xs):
            for layer in range(per_stage):
                w = weights(blocks, i, layer)
                xs = _tp_ffn(_tp_attention(xs, w, rows[i], cfg, rope,
                                           attends[i]), w, rows[i], cfg)[0]
            return xs, None

        outs, _ = _run_schedule(
            n_stages, m, lambda t: [e[t] for e in embedded], stage_fwd,
            lambda ys, i: [y.to(rows[i + 1][d][0]) for d, y in enumerate(ys)],
            remat, counts)
        total = 0
        for d in range(dp):
            last = int(grid[d, -1, 0])
            head = rows[-1][d][0]
            value = _nll_mean(
                [o[d] for o in outs], _held(params3d["ln_f"], last),
                _held(params3d["unembed"], last),
                tokens[d * b_loc:(d + 1) * b_loc, 1:].to(head), cfg)
            total = total + value.to(first)
        return total / dp

    loss.counts = counts
    return loss


def _place(mesh: Mesh, cfg: ModelConfig, params: dict, p_specs: dict,
           state: dict):
    """A one-device params tree and its optimizer state at ``p_specs``
    (the moments take their params' specs): trees of Sharded leaves."""
    return (_shard_tree(mesh, cfg, params, p_specs),
            _shard_state(mesh, cfg, state,
                         _state_specs(state, p_specs, mesh, False)))


def shard_pipeline_state(mesh: Mesh, cfg: ModelConfig, state: dict,
                         pp_axis: str = "pp") -> dict:
    """A one-device trainer state ``{"params", "opt"}`` (a checkpoint:
    the standard tree, qkv packed) at the pipeline step's specs: split
    into wq/wk/wv first (params and moments) on a 3-axis mesh.
    :func:`gather_pipeline_state` is the inverse."""
    params, opt = state["params"], state["opt"]
    if len(mesh.axis_names) > 1:
        params, opt = (split_qkv_weights(params, cfg),
                       split_qkv_weights(opt, cfg))
    specs = (pipeline3d_param_specs(cfg, pp_axis) if len(mesh.axis_names) > 1
             else pipeline_param_specs(cfg, pp_axis))
    params, opt = _place(mesh, cfg, params, specs, opt)
    return {"params": params, "opt": opt}


def gather_pipeline_state(mesh: Mesh, cfg: ModelConfig, state: dict) -> dict:
    """The pipeline step's state ``{"params", "opt"}`` in the one-device
    layout on the first rank (``model.gather_params``), qkv merged back
    on a 3-axis mesh: what ``serve`` and ``generate`` read."""
    out = gather_params(mesh, state)
    if len(mesh.axis_names) > 1:
        out = {"params": merge_qkv_weights(out["params"], cfg),
               "opt": merge_qkv_weights(out["opt"], cfg)}
    return out


def make_pipeline3d_train_step(mesh: Mesh, cfg: ModelConfig,
                               num_microbatches: int, pp_axis: str = "pp",
                               data_axis: str = "data",
                               model_axis: str = "model",
                               learning_rate: float = 1e-3,
                               train: TrainConfig | None = None,
                               remat: bool = True):
    """(init_fn, step_fn) for dp×pp×tp training: GPipe over
    ``pp_axis``, batch over ``data_axis``, Megatron TP over
    ``model_axis``.

    ``init_fn(generator) -> (params3d, opt_state)``: ``init_params``'
    model (the same generator gives the one-device step's), split
    (:func:`split_qkv_weights`) and placed at
    :func:`pipeline3d_param_specs`, its AdamW moments at the same specs.
    ``step_fn(params3d, opt_state, tokens) -> (params3d, opt_state,
    loss)``: the gradient of :func:`make_pipeline3d_loss` by
    ``torch.autograd.grad`` with respect to every block, then the
    trainer's optimizer recipe per block (``model._sharded_update``: the
    clip's global norm counts each element once).  ``step_fn.counts``
    is the loss's."""
    if train is None:
        train = TrainConfig(learning_rate=learning_rate)
    optimizer = make_optimizer(train)
    loss_fn = make_pipeline3d_loss(mesh, cfg, num_microbatches, pp_axis,
                                   data_axis, model_axis, remat=remat)
    p_specs = pipeline3d_param_specs(cfg, pp_axis, model_axis)

    def init_fn(generator: torch.Generator):
        params = split_qkv_weights(init_params(generator, cfg, mesh.ranks[0]),
                                   cfg)
        return _place(mesh, cfg, params, p_specs, optimizer.init(params))

    step_fn = _sharded_step(optimizer, loss_fn)
    step_fn.counts = loss_fn.counts
    return init_fn, step_fn


def make_pipeline_train_step(mesh: Mesh, cfg: ModelConfig,
                             num_microbatches: int, pp_axis: str = "pp",
                             learning_rate: float = 1e-3,
                             train: TrainConfig | None = None,
                             remat: bool = True):
    """(init_fn, step_fn) for GPipe training over ``mesh``'s pp axis:
    grads and the AdamW moments live at the pipeline specs, so each
    stage updates only the layer block it holds (plus its own copy of
    the small replicated embed/unembed/ln_f leaves).

    ``init_fn(generator) -> (params, opt_state)``: ``init_params``'
    model (the same generator gives the one-device step's) placed at
    :func:`pipeline_param_specs`.  ``step_fn(params, opt_state, tokens)
    -> (params, opt_state, loss)``: the gradient of
    :func:`make_pipeline_loss` by ``torch.autograd.grad`` with respect
    to every block, then the optimizer recipe (``train``, default bare
    adamw(``learning_rate``)) per block (``model._sharded_update``: the
    clip's global norm counts each element once).  ``remat`` defaults
    True, as in JAX.  ``step_fn.counts`` is the loss's.

    A mesh carrying ``data``/``model`` axes alongside ``pp`` routes to
    :func:`make_pipeline3d_train_step`, whose trees are the split-weight
    ones."""
    if len(mesh.axis_names) > 1:
        others = [a for a in mesh.axis_names if a != pp_axis]
        if pp_axis not in mesh.axis_names or len(others) != 2:
            raise ValueError(
                f"pipeline meshes are either ({pp_axis!r},) or 3-axis "
                f"(data, {pp_axis!r}, model); got {mesh.axis_names} "
                "(make_pipeline_mesh builds the 3-axis form)")
        model_axis = "model" if "model" in others else others[-1]
        others.remove(model_axis)
        return make_pipeline3d_train_step(
            mesh, cfg, num_microbatches, pp_axis,
            data_axis=others[0], model_axis=model_axis,
            learning_rate=learning_rate, train=train, remat=remat)
    if train is None:
        train = TrainConfig(learning_rate=learning_rate)
    optimizer = make_optimizer(train)
    loss_fn = make_pipeline_loss(mesh, cfg, num_microbatches, pp_axis,
                                 remat=remat)
    p_specs = pipeline_param_specs(cfg, pp_axis)

    def init_fn(generator: torch.Generator):
        params = init_params(generator, cfg, mesh.ranks[0])
        return _place(mesh, cfg, params, p_specs, optimizer.init(params))

    step_fn = _sharded_step(optimizer, loss_fn)
    step_fn.counts = loss_fn.counts
    return init_fn, step_fn
