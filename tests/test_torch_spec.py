"""The port's speculative decoding against the JAX package's, on the CPU.

The same weights (JAX ``init_params``, carried across with
``params_from_jax``) and the same numpy-made prompts go through both
packages in f32, at the JAX tests' tiny config (vocab 64, d_model 32, 4
layers; the draft is layer 0).  Greedy speculative tokens, rounds and
accept rates equal the JAX package's exactly, and equal the port's own
plain ``generate`` / ``PagedBatcher``; the paged engines agree tick by
tick.  Sampled speculative decoding draws from a ``torch.Generator``,
whose stream differs from ``jax.random``, so its exactness is tested by
marginal total variation against the port's plain sampling (the JAX
package's own oracle).  The engine's host-side accept math draws from
``np.random.default_rng(seed)`` in both packages, so sampled engine
tokens equal the JAX engine's too.

The JAX ``decode_step`` and ``extend_step`` run under ``jax.jit`` here:
the same functions, compiled once instead of dispatched op by op (15-20
s a call otherwise).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch
from click.testing import CliRunner

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_autoscaler.workloads import decode as jax_decode  # noqa: E402
from tpu_autoscaler.workloads import model as jax_model  # noqa: E402
from tpu_autoscaler.workloads import serve as jax_serve  # noqa: E402
from tpu_autoscaler.workloads import spec_serving as jax_spec  # noqa: E402
from tpu_autoscaler_torch.serving.drain import DrainReceipt  # noqa: E402
from tpu_autoscaler_torch.workloads import (  # noqa: E402
    decode,
    model,
    paged,
    serve,
    spec_serving,
)

# tests/test_spec_serving.py's CFG; the draft is the first layer.
ARCH = dict(vocab=64, d_model=32, n_layers=4, n_heads=4, d_ff=64,
            seq_len=64)
TV_MAX = 0.08      # tests/test_decode.py's marginal bound at n = 4000


def _draft(jp, tp, layers):
    return ({**jp, "blocks": jax.tree.map(lambda x: x[:layers],
                                          jp["blocks"])},
            {**tp, "blocks": {n: w[:layers]
                              for n, w in tp["blocks"].items()}})


@pytest.fixture(scope="module")
def models():
    jcfg = jax_model.ModelConfig(**ARCH, dtype=jnp.float32)
    tcfg = model.ModelConfig(**ARCH, dtype=torch.float32)
    jp = jax_model.init_params(jax.random.PRNGKey(0), jcfg)
    tp = model.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    drafts = {n: _draft(jp, tp, n) for n in (1, 3)}
    drafts[4] = (jp, tp)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, drafts=drafts)


@pytest.fixture(scope="module")
def jitted_jax_steps():
    saved = jax_decode.decode_step, jax_decode.extend_step
    jax_decode.decode_step = jax.jit(saved[0], static_argnums=(3, 4))
    jax_decode.extend_step = jax.jit(saved[1], static_argnums=(3, 4))
    yield
    jax_decode.decode_step, jax_decode.extend_step = saved


# ---- speculative_generate ----------------------------------------------

GREEDY_CASES = {
    # name: (batch, prompt length, steps, k, draft layers)
    "k4": (1, 7, 12, 4, 1),
    "k3": (1, 9, 10, 3, 1),
    "k1": (1, 5, 6, 1, 1),
    "k-over-steps": (1, 4, 3, 8, 1),
    "batch-2-shared-minimum": (2, 6, 8, 3, 1),
    "three-layer-draft": (1, 7, 14, 3, 3),
    "self-draft": (1, 7, 12, 4, 4),
    # Many full-accept rounds, each replaying one token into the draft
    # cache: a wrong replay shows as a draft that stops agreeing.
    "self-draft-long": (2, 7, 40, 4, 4),
}


@pytest.mark.parametrize("case", list(GREEDY_CASES))
def test_speculative_generate_matches_jax(models, jitted_jax_steps, case):
    """Tokens equal JAX's ``speculative_generate`` and the port's own
    ``generate``; rounds and accept_rate equal JAX's.  A self-draft
    accepts everything: ceil(11 / (k+1)) = 3 rounds for 12 tokens."""
    b, s, steps, k, layers = GREEDY_CASES[case]
    prompt = np.random.default_rng(s + b).integers(0, 64, (b, s)).astype(
        np.int32)
    jdp, tdp = models["drafts"][layers]
    jcfg, tcfg = models["jcfg"], models["tcfg"]
    jdcfg = dataclasses.replace(jcfg, n_layers=layers)
    tdcfg = dataclasses.replace(tcfg, n_layers=layers)
    want, wstats = jax_decode.speculative_generate(
        models["jp"], jdp, jnp.asarray(prompt), jcfg, steps,
        draft_cfg=jdcfg, k=k)
    got, stats = decode.speculative_generate(
        models["tp"], tdp, torch.from_numpy(prompt), tcfg, steps,
        draft_cfg=tdcfg, k=k, device="cpu")
    plain = decode.generate(models["tp"], torch.from_numpy(prompt), tcfg,
                            steps, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert stats["rounds"] == wstats["rounds"] >= 1
    assert stats["accept_rate"] == wstats["accept_rate"]
    if layers == 4:
        assert stats["accept_rate"] == 1.0
        assert stats["rounds"] == -(-(steps - 1) // (k + 1))


@pytest.mark.parametrize("kw,message", [
    (dict(steps=0), "steps must be"),
    (dict(steps=4, k=0), "k must be"),
    (dict(steps=8, max_len=10), "exceeds max_len"),
])
def test_speculative_generate_validation(models, kw, message):
    tdcfg = dataclasses.replace(models["tcfg"], n_layers=1)
    prompt = torch.zeros((1, 4), dtype=torch.int32)
    steps = kw.pop("steps")
    with pytest.raises(ValueError, match=message):
        decode.speculative_generate(
            models["tp"], models["drafts"][1][1], prompt, models["tcfg"],
            steps, draft_cfg=tdcfg, device="cpu", **kw)


# ---- speculative_sample_generate ---------------------------------------

SAMPLE_ARCH = dict(vocab=16, d_model=16, n_layers=1, n_heads=2, d_ff=32,
                   seq_len=16, dtype=torch.float32)


@pytest.fixture(scope="module")
def sample_models():
    cfg = model.ModelConfig(**SAMPLE_ARCH)
    # A DIFFERENT model as draft: q differs from p, so acceptance is
    # partial and the residual path runs.
    return (cfg, model.init_params(torch.Generator().manual_seed(0), cfg,
                                   "cpu"),
            model.init_params(torch.Generator().manual_seed(9), cfg, "cpu"))


def _hist(tokens):
    return np.bincount(tokens, minlength=16) / len(tokens)


def _tv(p, q):
    return 0.5 * np.abs(p - q).sum()


@pytest.mark.parametrize("warp", [dict(temperature=1.0),
                                  dict(temperature=0.8, top_k=6)])
def test_sampled_marginals_match_plain_sampling(sample_models, warp):
    """4000 rows of one prompt: every generated position's marginal
    under speculative sampling matches the port's plain sampling within
    TV 0.08, despite a mismatched draft; position 0 also matches the
    exact (warped) softmax of the prompt's last logits."""
    cfg, params, dparams = sample_models
    n, steps = 4000, 3
    prompt = torch.from_numpy(np.tile(np.random.default_rng(2).integers(
        0, 16, (1, 3)).astype(np.int32), (n, 1)))
    plain = decode.generate(params, prompt, cfg, steps, device="cpu",
                            generator=torch.Generator().manual_seed(11),
                            **warp)[:, 3:].numpy()
    spec, stats = decode.speculative_sample_generate(
        params, dparams, prompt, cfg, steps, k=2, device="cpu",
        generator=torch.Generator().manual_seed(22), **warp)
    spec = spec[:, 3:].numpy()
    assert 0.0 < stats["accept_rate"] < 1.0       # the draft really differs
    for pos in range(steps):
        assert _tv(_hist(spec[:, pos]), _hist(plain[:, pos])) < TV_MAX, pos
    logits, _ = decode.prefill(params, prompt[:1], cfg, 3)
    exact = torch.softmax(decode._warp_logits(
        logits[0, -1], warp["temperature"], warp.get("top_k"), None),
        dim=-1).numpy()
    assert _tv(_hist(spec[:, 0]), exact) < TV_MAX
    if "top_k" in warp:
        assert len(np.unique(spec[:, 0])) <= 6


def test_sampled_self_draft_accepts_everything(sample_models):
    """p == q: min(1, p/q) = 1, so acceptance is (numerically) total."""
    cfg, params, _ = sample_models
    prompt = torch.from_numpy(np.random.default_rng(7).integers(
        0, 16, (8, 4)).astype(np.int32))
    _, stats = decode.speculative_sample_generate(
        params, params, prompt, cfg, 12, k=4, device="cpu",
        generator=torch.Generator().manual_seed(1))
    assert stats["accept_rate"] > 0.99


def test_sampled_temperature_zero_and_seed(sample_models):
    """Temperature 0 is the greedy path; top-k/top-p there raise, as
    does sampling without a generator; one seed gives one stream."""
    cfg, params, dparams = sample_models
    prompt = torch.from_numpy(np.random.default_rng(8).integers(
        0, 16, (2, 5)).astype(np.int32))
    want, _ = decode.speculative_generate(params, dparams, prompt, cfg, 6,
                                          k=3, device="cpu")
    got, _ = decode.speculative_sample_generate(
        params, dparams, prompt, cfg, 6, temperature=0.0, k=3,
        device="cpu")
    assert torch.equal(got, want)
    for knob in (dict(top_k=4), dict(top_p=0.9)):
        with pytest.raises(ValueError, match="require temperature > 0"):
            decode.speculative_sample_generate(
                params, dparams, prompt, cfg, 6, temperature=0.0,
                device="cpu", **knob)
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        decode.speculative_sample_generate(params, dparams, prompt, cfg, 6,
                                           device="cpu")
    a, b = (decode.speculative_sample_generate(
        params, dparams, prompt, cfg, 5, temperature=0.9, k=2,
        device="cpu", generator=torch.Generator().manual_seed(42))[0]
        for _ in range(2))
    assert torch.equal(a, b)


# ---- the host warping ---------------------------------------------------

@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, None, None), (0.7, 5, None), (1.3, None, 0.9), (0.8, 10, 0.5)])
def test_np_warp_and_probs_match_jax(temperature, top_k, top_p):
    logits = np.random.default_rng(int(temperature * 10)).standard_normal(
        64).astype(np.float32) * 3
    np.testing.assert_array_equal(
        spec_serving._np_warp(logits, temperature, top_k, top_p),
        jax_spec._np_warp(logits, temperature, top_k, top_p))
    got = spec_serving._np_probs(logits, temperature, top_k, top_p)
    np.testing.assert_array_equal(
        got, jax_spec._np_probs(logits, temperature, top_k, top_p))
    # And the device warping's distribution, in f32.
    want = torch.softmax(decode._warp_logits(
        torch.from_numpy(logits), temperature, top_k, top_p), -1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


# ---- SpeculativePagedBatcher --------------------------------------------

KW = dict(max_len=64, block_size=8, chunk=8)
ENGINE_CASES = {
    # tests/test_spec_serving.py's scenarios: (draft layers, k, engine
    # geometry, prompt lengths, new tokens, sampling temperatures)
    "mixed-lengths": (1, 3, dict(slots=3), (5, 17, 9, 26), (8, 6, 10, 5),
                      None),
    "self-draft": (4, 4, dict(slots=2), (6, 11), (9, 9), None),
    "replay-at-block-boundary": (4, 4, dict(slots=1), (4,), (16,), None),
    "eos-in-accepted-block": (1, 3, dict(slots=1), (7, 5), (10, 4), None),
    "budget-cap": (1, 4, dict(slots=1), (6, 9, 5), (1, 2, 3), None),
    "pool-pressure": (1, 3, dict(slots=3, num_blocks=10), (30, 30, 30),
                      (6, 6, 6), None),
    "sampled-self-draft": (4, 3, dict(slots=2), (6, 10), (8, 8), (1.0, 1.0)),
    "mixed-greedy-and-sampled": (1, 3, dict(slots=2), (8, 6), (7, 7),
                                 (0.0, 0.9)),
}


def _prompts(case, lengths):
    if case == "replay-at-block-boundary":
        # Length 4 + k 4: the replay position 8 starts a new block.
        return [(np.arange(4, dtype=np.int32) * 7) % 64]
    rng = np.random.default_rng(len(case))
    return [rng.integers(0, 64, (n,)).astype(np.int32) for n in lengths]


def _host_seed_sampler(rng):
    """Seed-token sampling shared by both packages' engines: a sampled
    request's first token comes from the engine's device sampler, whose
    random stream differs between jax.random and torch; this draws it
    from numpy over the same warped probabilities instead."""
    def sample(logits, req):
        if req.temperature == 0.0:
            return int(np.argmax(np.asarray(logits)))
        p = spec_serving._np_probs(np.asarray(logits, np.float32),
                                   req.temperature, req.top_k, req.top_p)
        return int(rng.choice(len(p), p=p))
    return sample


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_matches_jax_engine_tick_by_tick(models, case):
    """The port's SpeculativePagedBatcher and the JAX one run the same
    requests in lockstep: after every tick the target and draft lengths
    and tables, verify passes, drafted, accepted and decode tokens,
    preemptions and generated tokens agree, and both accountings hold.
    Greedy output equals the port's plain PagedBatcher."""
    layers, k, geo, lengths, new, temps = ENGINE_CASES[case]
    jdp, tdp = models["drafts"][layers]
    jcfg, tcfg = models["jcfg"], models["tcfg"]
    kw = dict(KW, **geo)
    prompts = _prompts(case, lengths)
    temps = temps or (0.0,) * len(prompts)
    eos = [None] * len(prompts)
    if case == "eos-in-accepted-block":
        ref = _plain(models, prompts[:1], new[:1], kw)[0]
        cut = next(i for i in range(1, len(ref)) if ref[i] not in ref[:i])
        eos[0] = int(ref[cut])
    jeng = jax_spec.SpeculativePagedBatcher(
        models["jp"], jcfg, jdp, dataclasses.replace(jcfg, n_layers=layers),
        k=k, **kw)
    teng = spec_serving.SpeculativePagedBatcher(
        models["tp"], tcfg, tdp, dataclasses.replace(tcfg, n_layers=layers),
        k=k, device="cpu", **kw)
    if any(temps):
        jeng._sample_host = _host_seed_sampler(np.random.default_rng(5))
        teng._sample_host = _host_seed_sampler(np.random.default_rng(5))
    jreqs, treqs = ([mod.Request(prompt=p, max_new_tokens=n, temperature=t,
                                 eos_id=e)
                     for p, n, t, e in zip(prompts, new, temps, eos)]
                    for mod in (jax_spec, spec_serving))
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    for _ in range(1000):
        if jeng.idle and teng.idle:
            break
        jeng.tick()
        teng.tick()
        for mine, theirs in ((teng.cache, jeng.cache),
                             (teng.d_cache, jeng.d_cache)):
            np.testing.assert_array_equal(mine.lengths.numpy(),
                                          np.asarray(theirs.lengths))
        np.testing.assert_array_equal(teng.tables, jeng.tables)
        np.testing.assert_array_equal(teng.d_tables, jeng.d_tables)
        for name in ("verify_passes", "drafted_tokens", "accepted_tokens",
                     "decode_tokens", "ticks", "preemptions"):
            assert getattr(teng, name) == getattr(jeng, name), name
        assert [r.generated for r in treqs] \
            == [list(map(int, r.generated)) for r in jreqs]
        teng.check_accounting()
        jeng.check_accounting()
    assert jeng.idle and teng.idle
    assert all(r.done for r in treqs)
    assert teng.allocator.used_blocks == teng.d_allocator.used_blocks == 0
    assert (teng.preemptions > 0) == (case == "pool-pressure")
    assert teng.accepted_tokens <= teng.decode_tokens
    assert teng.stats().as_dict() | {"epoch": 0} \
        == jeng.stats().as_dict() | {"epoch": 0}
    greedy = [i for i, t in enumerate(temps) if t == 0.0]
    if greedy:
        want = _plain(models, [prompts[i] for i in greedy],
                      [new[i] for i in greedy], kw, [eos[i] for i in greedy])
        assert [treqs[i].generated for i in greedy] == want
    if layers == 4:
        assert teng.accept_rate > (0.99 if any(temps) else 0.999)
    if case == "mixed-lengths":
        assert 0.0 < teng.target_pass_ratio < 1.0
    if case == "budget-cap":
        assert [len(r.generated) for r in treqs] == list(new)
    if case == "eos-in-accepted-block":
        assert treqs[0].generated[-1] == eos[0]


def _plain(models, prompts, new, kw, eos=None):
    eng = paged.PagedBatcher(models["tp"], models["tcfg"], device="cpu",
                             **kw)
    reqs = [paged.Request(prompt=p, max_new_tokens=n, eos_id=e)
            for p, n, e in zip(prompts, new, eos or [None] * len(new))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.generated for r in reqs]


def test_engine_validation(models):
    tdp = models["drafts"][1][1]
    tcfg = models["tcfg"]
    dcfg = dataclasses.replace(tcfg, n_layers=1)
    with pytest.raises(ValueError, match="k must be"):
        spec_serving.SpeculativePagedBatcher(models["tp"], tcfg, tdp, dcfg,
                                             k=0, device="cpu")
    with pytest.raises(ValueError, match="must be < chunk"):
        spec_serving.SpeculativePagedBatcher(models["tp"], tcfg, tdp, dcfg,
                                             k=8, chunk=8, device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        spec_serving.SpeculativePagedBatcher(
            models["tp"], tcfg, tdp, dataclasses.replace(dcfg, vocab=32),
            device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            spec_serving.SpeculativePagedBatcher(models["tp"], tcfg, tdp,
                                                 dcfg)


# ---- the CLI --------------------------------------------------------------

def _checkpoint(tmp_path):
    params = model.init_params(torch.Generator().manual_seed(0),
                               model.ModelConfig(vocab=64, d_model=32,
                                                 n_layers=2, seq_len=16),
                               "cpu")
    model.save_params(str(tmp_path / "ckpt"), 1, params)
    return ["--checkpoint-dir", str(tmp_path / "ckpt"), "--vocab", "64",
            "--d-model", "32", "--n-layers", "2", "--seq-len", "16",
            "--annotations-file", str(tmp_path / "none")]


@pytest.mark.parametrize("flags", [
    ["--spec-k", "2"],
    ["--paged", "--spec-k", "2", "--draft-layers", "2"],
    ["--paged", "--spec-k", "2", "--draft-layers", "0"],
    ["--paged", "--spec-k", "8", "--chunk", "8"],
    ["--paged", "--spec-k", "2", "--moe-experts", "4"],
])
def test_serve_cli_spec_usage_errors_match_jax(tmp_path, flags):
    """Each --spec-k usage error exits 2 with the JAX serve CLI's
    message (both refuse before loading a checkpoint)."""
    base = _checkpoint(tmp_path) + ["--random", "2", "--max-len", "64",
                                    "--chunk", "8"]
    mine = CliRunner().invoke(serve.main, base + ["--platform", "cpu"]
                              + flags)
    theirs = CliRunner().invoke(jax_serve.main, base + flags)
    assert mine.exit_code == theirs.exit_code == 2
    error = [line for line in theirs.output.splitlines()
             if line.startswith("Error:")]
    assert error and error[0] in mine.output.splitlines()


def test_serve_cli_spec_gives_the_plain_paged_tokens(tmp_path):
    """``--paged --spec-k 2 --draft-layers 1`` serves every request with
    the plain ``--paged`` run's tokens."""
    base = _checkpoint(tmp_path) + [
        "--platform", "cpu", "--random", "6", "--slots", "2", "--max-len",
        "64", "--chunk", "8", "--paged", "--block-size", "8",
        "--max-new-tokens", "20"]
    plain = CliRunner().invoke(serve.main, base)
    spec = CliRunner().invoke(serve.main, base + ["--spec-k", "2",
                                                  "--draft-layers", "1"])
    assert plain.exit_code == spec.exit_code == 0, spec.output
    lines = [s.stdout.strip().splitlines() for s in (plain, spec)]
    assert lines[1][:-1] == lines[0][:-1]
    receipt = DrainReceipt.parse_line(lines[1][-1])
    assert receipt.served == 6 and receipt.unserved == 0
    assert "trace" not in json.loads(lines[1][-1])
