"""The port's Mellum2 block on the CPU at a tiny size: mixed layer kinds
(three window layers, then a YaRN full layer), a head_dim other than
d_model / n_heads, and dropless top-k SwiGLU experts on grouped
products, held to the benchmark's plain reference
(``perfbench/reference/mellum.py``); and the StarCoder2 block, which
must build and launch what it did before these were added."""

from __future__ import annotations

import collections
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from perfbench.reference import mellum as ref
from tpu_autoscaler_torch.obs.trace import Tracer
from tpu_autoscaler_torch.workloads import model, moe, paged, serving
from tpu_autoscaler_torch.workloads.serving import Request

REPO = Path(__file__).resolve().parents[1]

#: Mellum2's published keys at a tiny size: layer kinds s, s, s, f; a
#: window of 8 that prompts of ~30 tokens pass; head_dim 16 against
#: d_model / heads = 12; 16 experts, top 4; YaRN over an original
#: context of 16, which the positions pass.
TINY = {
    "vocab_size": 97, "hidden_size": 48, "num_hidden_layers": 4,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "hidden_act": "silu", "rms_norm_eps": 1e-06,
    "layer_types": ["sliding_attention"] * 3 + ["full_attention"],
    "sliding_window": 8,
    "rope_parameters": {
        "full_attention": {"rope_type": "yarn", "rope_theta": 500000,
                           "factor": 4, "original_max_position_embeddings": 16,
                           "beta_fast": 32, "beta_slow": 1,
                           "attention_factor": 1.1386294361119890},
        "sliding_attention": {"rope_type": "default", "rope_theta": 500000}},
    "num_experts": 16, "num_experts_per_tok": 4, "norm_topk_prob": True,
    "moe_intermediate_size": 24, "intermediate_size": 96,
    "mlp_layer_types": ["sparse"] * 4, "tie_word_embeddings": False,
    "attention_bias": False, "max_position_embeddings": 128,
}

#: f32 on both sides: what differs is the order of summation (grouped
#: products and one batched combine against a loop over experts, the
#: paged einsum against blocked attention) and the rope angles, f32 in
#: the program against f64 frequencies in the reference.  Measured
#: below 2e-5; a wrong window, rope kind or dropped token moves logits
#: by 1e-2 or more.
LOGIT_ATOL = 1e-4


def _cfg(**fields):
    return model.ModelConfig.from_published(
        TINY, seq_len=64, dtype=torch.float32, **fields)


def _params(cfg, seed=0):
    """Seeded f32 weights; the router scaled up so that routing is far
    from ties (init_params' 0.02 leaves 16 experts nearly uniform)."""
    p = model.init_params(torch.Generator().manual_seed(seed), cfg, "cpu")
    p["blocks"]["router"] = p["blocks"]["router"] * 50
    return p


def _served_logits(engine) -> list:
    """Wrap the engine's step functions: every logits row it computes
    for a request, with the position of the token it was computed at."""
    seen, lanes_now = [], []
    choose, prefill, decode = (engine._choose_lanes, engine._prefill,
                               engine._decode)

    def choose_lanes():
        lanes_now[:] = choose()
        return list(lanes_now)

    def fill(params, cache, tables, tokens, offsets, n_valid):
        logits, cache = prefill(params, cache, tables, tokens, offsets,
                                n_valid)
        for lane, i in enumerate(lanes_now):
            seen.append((engine._slots[i].request,
                         int(offsets[lane] + n_valid[lane]) - 1,
                         logits[lane]))
        return logits, cache

    def step(params, cache, tables, tokens, active):
        at = cache.lengths.clone()
        logits, cache = decode(params, cache, tables, tokens, active)
        for i in np.flatnonzero(active.numpy()):
            seen.append((engine._slots[i].request, int(at[i]), logits[i]))
        return logits, cache

    engine._choose_lanes, engine._prefill, engine._decode = (
        choose_lanes, fill, step)
    return seen


def test_paged_prefill_then_decode_equal_the_reference_forward():
    cfg = _cfg()
    params = _params(cfg)
    engine = paged.PagedBatcher(params, cfg, slots=3, max_len=64,
                                block_size=8, chunk=16, prefill_lanes=2,
                                device="cpu")
    seen = _served_logits(engine)
    rng = np.random.default_rng(3)
    reqs = [Request(prompt=rng.integers(0, 97, n).astype(np.int64),
                    max_new_tokens=m) for n, m in ((29, 9), (17, 12), (40, 6))]
    for r in reqs:
        engine.submit(r)
    for _ in range(60):
        engine.tick()
    assert all(r.done for r in reqs)
    config = {**TINY}
    checked = 0
    for r in reqs:
        tokens = torch.tensor(list(r.prompt) + list(r.generated))
        want = ref.logits_at(params, tokens, config,
                             torch.arange(len(tokens)))
        rows = [(p, row) for req, p, row in seen if req is r]
        # Every chunk's last row and every decode step of the request.
        assert len(rows) >= len(r.generated)
        for p, row in rows:
            np.testing.assert_allclose(row.numpy(), want[p].numpy(),
                                       atol=LOGIT_ATOL, rtol=0)
            checked += 1
        # The positions pass both the window and YaRN's original context.
        assert len(tokens) > TINY["sliding_window"] + 16
    assert checked >= 30


def _layer(cfg, seed=1):
    p = _params(cfg, seed)
    return {name: p["blocks"][name][0] for name in ("router", "w1", "w2")}


def _loop_reference(y2d, layer, cfg):
    shape = ref.Shape(TINY)
    return ref.expert_ffn(y2d, layer["router"], layer["w1"], layer["w2"],
                          shape)


def test_dropless_grouped_route_equals_the_per_expert_loop():
    cfg = _cfg()
    layer = _layer(cfg)
    y = torch.randn(3, 10, 48, generator=torch.Generator().manual_seed(5))
    counter = Tracer().counter("serve.moe")
    out, aux = moe.dropless_ffn(y, layer, cfg, counter=counter)
    want = _loop_reference(y.reshape(-1, 48), layer, cfg)
    np.testing.assert_allclose(out.reshape(-1, 48).numpy(), want.numpy(),
                               atol=1e-5, rtol=0)
    assert counter.read()[0][-1] == 30 * 4
    assert np.isfinite(float(aux["balance_loss"]))
    # The CPU loop over experts and torch's grouped product agree on the
    # groups: rows [ends[e-1], ends[e]) times expert e.
    a = torch.randn(23, 32, dtype=torch.bfloat16)
    w = torch.randn(5, 32, 16, dtype=torch.bfloat16)
    ends = torch.tensor([4, 4, 11, 20, 20], dtype=torch.int32)
    np.testing.assert_array_equal(
        moe.grouped_mm(a, w, ends)[:20].float().numpy(),
        torch._grouped_mm(a, w, offs=ends)[:20].float().numpy())


def test_a_router_that_sends_every_token_to_one_expert_drops_none():
    cfg = _cfg()
    layer = _layer(cfg)
    # Every token leans along u, and expert 0's router column is u: its
    # logit (~12) leads every token's, the others' stay near 0.
    u = torch.ones(48) / 48 ** 0.5
    y = torch.randn(2, 32, 48, generator=torch.Generator().manual_seed(6)) \
        + 4 * u
    router = layer["router"] * 0.02
    router[:, 0] = 3 * u
    layer = {**layer, "router": router}
    expert, _ = moe.route_dropless(y.reshape(-1, 48) @ router, 4)
    assert bool((expert[:, 0] == 0).all())
    counter = Tracer().counter("serve.moe")
    out, _ = moe.dropless_ffn(y, layer, cfg, counter=counter)
    # All 64 tokens reach expert 0, where the capacity route would keep
    # 1.25 * 32 * 4 / 16 = 10 a row; each token's 4 choices count.
    [ends] = counter.read()
    assert ends[0] == 64 and ends[-1] == 64 * 4
    assert np.count_nonzero(np.diff([0, *ends])) == len(expert.unique())
    np.testing.assert_allclose(
        out.reshape(-1, 48).numpy(),
        _loop_reference(y.reshape(-1, 48), layer, cfg).numpy(),
        atol=1e-5, rtol=0)


def test_padding_rows_are_not_routed():
    cfg = _cfg()
    layer = _layer(cfg)
    y = torch.randn(2, 12, 48, generator=torch.Generator().manual_seed(7))
    n_valid = torch.tensor([12, 5])
    valid = torch.arange(12)[None, :] < n_valid[:, None]
    counter = Tracer().counter("serve.moe")
    out, _ = moe.dropless_ffn(y, layer, cfg, valid=valid, counter=counter)
    assert counter.read()[0][-1] == 17 * 4
    assert float(out[1, 5:].abs().max()) == 0.0
    alone, _ = moe.dropless_ffn(y[1:, :5], layer, cfg)
    np.testing.assert_allclose(out[1, :5].numpy(), alone[0].numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        out[0].numpy(), _loop_reference(y[0], layer, cfg).numpy(),
        atol=1e-5, rtol=0)


def test_yarn_tables_at_the_published_parameters():
    yarn = model.Yarn(factor=16, original_max_position_embeddings=8192,
                      beta_fast=32, beta_slow=1,
                      attention_factor=1.2772588722239782)
    assert model.yarn_range(128, 500000.0, yarn) == (18, 35)
    freqs = model.rope_frequencies(128, 500000.0, yarn, "cpu")
    base = model.rope_frequencies(128, 500000.0, None, "cpu")
    np.testing.assert_array_equal(freqs[:18].numpy(), base[:18].numpy())
    np.testing.assert_allclose(freqs[35:].numpy(), (base[35:] / 16).numpy(),
                               rtol=1e-6)
    assert bool((freqs[19:35] < base[19:35]).all())
    pos = torch.arange(2048, dtype=torch.float32)
    cos, sin = model._rope_tables(pos, 128, 500000.0, torch.float32, yarn)
    assert float(cos[0, 0]) == pytest.approx(1.2772588722239782, rel=1e-7)
    assert float(sin[0].abs().max()) == 0.0
    rope = {"rope_type": "yarn", "rope_theta": 500000, "factor": 16,
            "original_max_position_embeddings": 8192, "beta_fast": 32,
            "beta_slow": 1, "attention_factor": 1.2772588722239782}
    want_cos, want_sin = ref.rope_tables(pos, 128, rope)
    # f32 angles p * w round by up to ~p * 2^-24 rad (scaled by 1.28):
    # 1.6e-4 at p = 2047.
    np.testing.assert_allclose(cos.numpy(), want_cos.numpy(), atol=2e-4)
    np.testing.assert_allclose(sin.numpy(), want_sin.numpy(), atol=2e-4)


def test_the_published_mellum_config_reads_as_run():
    config = json.loads((REPO / "perfbench/configs/mellum2-12b-a2.5b.json")
                        .read_text())
    from perfbench.drivers.serve_moe import published

    cfg = model.ModelConfig.from_published(published(config), seq_len=16384)
    assert (cfg.head_dim, cfg.q_width, cfg.d_ff) == (128, 4096, 896)
    assert (cfg.moe_experts, cfg.moe_top_k) == (64, 8)
    assert cfg.moe_capacity_factor is None and cfg.moe_dropless
    kinds, of_layer = model.layer_kinds(cfg)
    assert [kc.attention_window for kc, _ in kinds] == [1024, None]
    assert of_layer == [0, 0, 0, 1] * 7
    assert kinds[0][1] is None and kinds[1][1].factor == 16
    shapes = model.param_shapes(cfg)["blocks"]
    assert shapes["qkv"] == (28, 2304, 4096 + 2 * 512)
    assert shapes["attn_out"] == (28, 4096, 2304)
    assert shapes["w1"] == (28, 64, 2304, 1792)
    with pytest.raises(ValueError, match="not modelled"):
        model.ModelConfig.from_published({**TINY, "logit_softcap": 30.0})
    with pytest.raises(ValueError, match="SwiGLU"):
        model.ModelConfig.from_published({**TINY, "hidden_act": "gelu"})
    with pytest.raises(ValueError, match="renormalises"):
        model.ModelConfig.from_published({**TINY, "norm_topk_prob": False})


def test_paths_of_the_in_tree_block_refuse_mixed_kinds():
    cfg = _cfg()
    with pytest.raises(ValueError, match="in-tree block"):
        serving.make_slot_decode_step(cfg)
    with pytest.raises(ValueError, match="in-tree block"):
        paged.make_paged_decode_step(cfg, 64, mesh=model.make_mesh(
            ["cpu"] * 2, tp=2))


def test_a_traced_engine_spans_and_counts_the_expert_half():
    cfg = _cfg()
    spans = []

    class Sink:
        def record_span(self, span):
            spans.append(span)

    tracer = Tracer(recorder=Sink())
    engine = paged.PagedBatcher(_params(cfg), cfg, slots=2, max_len=64,
                                block_size=8, chunk=16, prefill_lanes=2,
                                device="cpu", tracer=tracer)
    engine.submit(Request(prompt=np.arange(20) % 97, max_new_tokens=3))
    for _ in range(4):
        engine.tick()
    moe_spans = [s for s in spans if s.name == "serve.moe"]
    # Two prefill calls (16 + 4 tokens), then two decode steps of one row.
    assert [s.attrs["tokens"] for s in moe_spans] == \
        [16] * 4 + [4] * 4 + [1] * 4 + [1] * 4
    assert [s.attrs["layer"] for s in moe_spans] == [0, 1, 2, 3] * 4
    rows = tracer.counters["serve.moe"].read()
    assert [r[-1] for r in rows] == [64] * 4 + [16] * 4 + [8] * 8


#: What the StarCoder2-shaped block's steps ran before layer kinds and
#: the dropless route were added: the aten ops of one paged prefill
#: call and one decode step on the CPU (the config below), and the sums
#: of its seeded params.  Since the decode step writes each layer's new
#: k/v through ``paged_token_write`` (on the CPU its plain version),
#: every layer, not once a step, works out where its rows write: one
#: more layer's index arithmetic (2 ``_to_copy``, ``arange``, 2
#: ``bitwise_and``, ``clamp``, ``floor_divide``, ``ge``, 4 ``index``,
#: ``lt``, ``remainder``: 14 ops) than the counts read before it.
_BEFORE_PREFILL = {
    "aten._softmax": 2, "aten._to_copy": 10, "aten._unsafe_view": 14,
    "aten.add": 16, "aten.arange": 6, "aten.bitwise_and": 2,
    "aten.bitwise_and_": 1, "aten.bmm": 4, "aten.cat": 4, "aten.clamp": 5,
    "aten.clamp_min": 1, "aten.clone": 6, "aten.cos": 1, "aten.div": 1,
    "aten.floor_divide": 1, "aten.gather": 1, "aten.ge": 1, "aten.gelu": 2,
    "aten.gt": 1, "aten.index": 12, "aten.index_put_": 4, "aten.le": 1,
    "aten.lift_fresh": 2, "aten.lt": 2, "aten.mean": 5, "aten.mm": 9,
    "aten.mul": 29, "aten.neg": 1, "aten.nonzero": 1, "aten.permute": 24,
    "aten.pow": 6, "aten.remainder": 1, "aten.rsqrt": 5,
    "aten.scalar_tensor": 2, "aten.select": 16, "aten.sin": 1,
    "aten.slice": 8, "aten.split_with_sizes": 2, "aten.sub": 6,
    "aten.transpose": 8, "aten.unbind": 1, "aten.unsqueeze": 32,
    "aten.view": 34, "aten.where": 2}
_BEFORE_DECODE = {
    "aten._softmax": 2, "aten._to_copy": 10, "aten._unsafe_view": 13,
    "aten.add": 15, "aten.add_": 1, "aten.arange": 6, "aten.bitwise_and": 4,
    "aten.bitwise_and_": 2, "aten.bmm": 4, "aten.cat": 4, "aten.clamp": 6,
    "aten.clone": 4, "aten.cos": 1, "aten.div": 1, "aten.floor_divide": 2,
    "aten.ge": 2, "aten.gelu": 2, "aten.gt": 2, "aten.index": 17,
    "aten.index_put_": 4, "aten.le": 2, "aten.lift_fresh": 2, "aten.lt": 2,
    "aten.mean": 5, "aten.mm": 9, "aten.mul": 29, "aten.neg": 1,
    "aten.permute": 24, "aten.pow": 6, "aten.remainder": 2, "aten.rsqrt": 5,
    "aten.scalar_tensor": 2, "aten.select": 21, "aten.sin": 1,
    "aten.slice": 8, "aten.split_with_sizes": 2, "aten.sub": 8,
    "aten.transpose": 8, "aten.unsqueeze": 30, "aten.view": 37,
    "aten.where": 2}
_BEFORE_SUMS = {
    "blocks/attn_out": 5.051198113607825, "blocks/ln1": 64.0,
    "blocks/ln2": 64.0, "blocks/qkv": -21.752986440682434,
    "blocks/w1": -15.485776509944117, "blocks/w2": 3.854259487357922,
    "embed": 0.5426717898599236, "ln_f": 32.0,
    "unembed": -12.882386913814116}
#: Op totals of the capacity-routed MoE block's prefill and decode (the
#: decode with the same 14 more ops).
_BEFORE_MOE = (473, 484)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def _step_ops(cfg):
    p = model.cast_params(
        model.init_params(torch.Generator().manual_seed(0), cfg, "cpu"),
        cfg.dtype, "cpu")
    cache = paged.PagedKVCache.zeros(cfg, 16, 8, 2, "cpu")
    tables = torch.tensor([[0, 1, 2, 3, -1, -1, -1, -1],
                           [4, 5, 6, -1, -1, -1, -1, -1]], dtype=torch.int32)
    fill = paged.make_paged_prefill(cfg, 16, 2, 64)
    step = paged.make_paged_decode_step(cfg, 64)
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    with _Ops() as prefill_ops:
        fill(p, cache, tables, toks, torch.tensor([0, 0], dtype=torch.int32),
             torch.tensor([16, 9], dtype=torch.int32))
    cache.lengths += torch.tensor([16, 9], dtype=torch.int32)
    with _Ops() as decode_ops:
        step(p, cache, tables, torch.tensor([3, 4]),
             torch.tensor([True, True]))
    return dict(prefill_ops.ops), dict(decode_ops.ops)


def test_a_starcoder2_config_builds_and_launches_as_before():
    cfg = model.ModelConfig(vocab=64, d_model=32, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=64, seq_len=64,
                            attention_window=12, dtype=torch.float32)
    shapes = model.param_shapes(cfg)
    assert shapes["blocks"]["qkv"] == (2, 32, 32 + 2 * 2 * 8)
    assert shapes["blocks"]["attn_out"] == (2, 32, 32)
    p = model.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    sums = {k: float(v.double().sum()) for k, v in model._flatten(p)}
    assert sums == pytest.approx(_BEFORE_SUMS, rel=1e-12)
    assert _step_ops(cfg) == (_BEFORE_PREFILL, _BEFORE_DECODE)
    # One layer kind given explicitly builds the same steps.
    kind = model.LayerKind(window=12, rope_theta=10000.0)
    assert model.layer_kinds(dataclasses.replace(
        cfg, layer_kinds=(kind, kind)))[1] == [0, 0]
    moe_cfg = dataclasses.replace(cfg, attention_window=None, moe_experts=4)
    assert tuple(sum(ops.values()) for ops in _step_ops(moe_cfg)) \
        == _BEFORE_MOE
