"""The port's fixed-batch inference path against the JAX package's, on
the CPU: the flash_attention plain version, ``KVCache`` with
``prefill``/``decode_step``/``extend_step``/``_rewind``, ``generate``,
the inference ``forward`` and the ``generate`` CLI.

The same weights (JAX ``init_params``, carried across with
``params_from_jax``) and the same numpy-made inputs go through both
packages in f32.  Attention agrees within 2e-5 (the JAX package's
kernel-vs-einsum tolerance), logits within 2e-4 and caches within 2e-5
after each call; greedy tokens agree exactly.  The JAX side runs its
Pallas kernels in interpret mode (``attention="pallas"``) or its einsum
path.  The port's kernel route is taken on the CPU by making
``ModelConfig.resolved_attention`` answer "kernel": the path then runs
through the ``flash_attention`` and ``flash_decode`` wrappers, which run
their plain versions on CPU tensors.  The CUDA kernels themselves are
held against those plain versions on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from click.testing import CliRunner

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpu_autoscaler.workloads import attention as jax_attention  # noqa: E402
from tpu_autoscaler.workloads import decode as jax_decode  # noqa: E402
from tpu_autoscaler.workloads import model as jax_model  # noqa: E402
from tpu_autoscaler_torch.workloads import attention  # noqa: E402
from tpu_autoscaler_torch.workloads import decode, model  # noqa: E402

# The CLI module: the package re-exports decode's ``generate`` function
# under the same name, as the JAX package does.
generate_cli = importlib.import_module(
    "tpu_autoscaler_torch.workloads.generate")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
            seq_len=64)
TOL = 2e-5
LOGITS_TOL = 2e-4
#: The four configurations generate is held to, as (name, fields).
CONFIGS = {"mha": {}, "gqa2": {"n_kv_heads": 2},
           "window4": {"n_kv_heads": 2, "attention_window": 4},
           "no-rope": {"n_kv_heads": 2, "rope": False}}


def _cfgs(impl="einsum", **kw):
    """The same config in both packages, f32; impl "kernel" is the
    port's kernel route (see kernel_route) against JAX's Pallas one."""
    return (jax_model.ModelConfig(**ARCH, dtype=jnp.float32,
                                  attention="pallas" if impl == "kernel"
                                  else "einsum", **kw),
            model.ModelConfig(**ARCH, dtype=torch.float32, **kw))


def _params(jcfg, seed=0):
    jp = jax_model.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, model.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _prompt(b=2, s=5, seed=1):
    return np.random.default_rng(seed).integers(0, ARCH["vocab"],
                                                (b, s)).astype(np.int32)


@pytest.fixture
def kernel_route(monkeypatch):
    """Send the port down its kernel route on the CPU, and count the
    calls of the two kernel wrappers on the decode path."""
    monkeypatch.setattr(model.ModelConfig, "resolved_attention",
                        lambda self, device: "kernel")
    calls = {"flash_attention": 0, "flash_decode": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    for name in calls:
        monkeypatch.setattr(decode, name, spy(name, getattr(decode, name)))
    return calls


def _route(request, impl):
    return request.getfixturevalue("kernel_route") if impl == "kernel" \
        else None


# -- flash_attention: the plain version against the JAX kernel ----------


def _qkv(b, h, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32))


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (4, 1)],
                         ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 5)],
                         ids=["causal", "full", "window5"])
@pytest.mark.parametrize("s,block", [(37, None), (32, 8)],
                         ids=["s37-one-tile", "s32-blocks8"])
def test_reference_matches_jax_kernel_and_einsum(h, hkv, causal, window, s,
                                                 block):
    """Out and lse against JAX ``_forward_pallas`` (interpret), out
    against JAX ``reference_attention``; s 37 at the default blocks is
    one tile, s 32 at blocks of 8 is 4 x 4 tiles (the carry merges)."""
    q, k, v = _qkv(2, h, hkv, s, 8, seed=h * 10 + hkv + s)
    out, lse = attention.flash_attention_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jout, jlse = jax_attention._forward_pallas(
        jq, jk, jv, causal, window, block or 512, block or 1024, True)
    _close(out, jout, TOL)
    _close(lse, jlse, TOL)
    assert lse.shape == (2, h, s, 1) and lse.dtype == torch.float32
    _close(out, jax_attention.reference_attention(
        jq, jk, jv, causal=causal, window=window), TOL)
    _close(attention.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window), jout, TOL)


@pytest.mark.parametrize("s,window", [(6, None), (6, 2), (1, 1), (9, 20)])
def test_causal_band_mask_matches_jax(s, window):
    np.testing.assert_array_equal(
        _np(attention.causal_band_mask(s, window)),
        np.asarray(jax_attention.causal_band_mask(s, window)))


def _bad(q, k, v, **kw):
    return torch.zeros(q), torch.zeros(k), torch.zeros(v), kw


@pytest.mark.parametrize("args,match", [
    (_bad((1, 3, 8, 4), (1, 2, 8, 4), (1, 2, 8, 4)), "multiple of kv heads"),
    (_bad((1, 4, 8, 4), (1, 2, 8, 4), (1, 1, 8, 4)), "k/v shape mismatch"),
    (_bad((1, 4, 8, 4), (1, 2, 8, 4), (1, 2, 8, 4), causal=False,
          window=3), "requires causal"),
    (_bad((1, 4, 8, 4), (1, 2, 8, 4), (1, 2, 8, 4), window=0),
     "window >= 1"),
    (_bad((2, 4, 8, 4), (1, 2, 8, 4), (1, 2, 8, 4)), "share batch"),
    (_bad((1, 4, 8, 4), (1, 2, 4, 4), (1, 2, 4, 4)), "share batch"),
    (_bad((1, 4, 8, 4), (1, 2, 8, 2), (1, 2, 8, 2)), "share batch"),
], ids=["heads", "kv-shape", "window-not-causal", "window-0", "batch",
        "seq", "head-dim"])
def test_flash_attention_rejections_match_jax(args, match):
    """Every error of ``_validate_attention_args``, raised alike by the
    port's wrapper, its plain version and the JAX entry point."""
    q, k, v, kw = args
    for fn in (attention.flash_attention, attention.flash_attention_forward,
               attention.flash_attention_reference):
        with pytest.raises(ValueError, match=match):
            fn(q, k, v, **kw)
    with pytest.raises(ValueError, match=match):
        jax_attention.flash_attention(*(jnp.asarray(_np(t)) for t in
                                        (q, k, v)), interpret=True, **kw)


def test_flash_attention_refuses_grad_and_other_devices():
    """Inputs that require grad are taken (the gradient flows through the
    autograd.Function: the plain backward on CPU tensors); other devices
    and the kernel route off CUDA are refused."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 2, 4, 8)).astype(
        np.float32)).requires_grad_()
    kv = torch.from_numpy(rng.standard_normal((1, 2, 4, 8)).astype(
        np.float32))
    out = attention.flash_attention(q, kv, kv)
    (dq,) = torch.autograd.grad(out.sum(), (q,))
    o, lse = attention.flash_attention_forward(q.detach(), kv, kv)
    want = attention.flash_attention_backward_reference(
        q.detach(), kv, kv, o, lse, torch.ones_like(o))[0]
    assert torch.allclose(dq, want, rtol=0, atol=1e-6)
    meta = torch.zeros((1, 2, 4, 8), device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        attention.flash_attention(meta, meta, meta)
    cfg = model.ModelConfig(**ARCH, dtype=torch.float32, attention="kernel")
    with pytest.raises(ValueError, match="needs CUDA"):
        decode.prefill(model.init_params(torch.Generator().manual_seed(0),
                                         dataclasses.replace(
                                             cfg, attention="einsum"),
                                         "cpu"),
                       torch.zeros((1, 3), dtype=torch.int32), cfg, 8)


# -- KVCache, prefill, decode_step, extend_step, _rewind ------------------


def _compare_cache(tcache, jcache, tol=TOL):
    _close(tcache.k, jcache.k, tol)
    _close(tcache.v, jcache.v, tol)
    assert tcache.length == int(jcache.length)


@pytest.mark.parametrize("impl", ["einsum", "kernel"])
@pytest.mark.parametrize("name", ["gqa2", "window4"])
def test_cached_steps_match_jax(request, impl, name):
    """prefill (5), two decode steps, extend_step by 3, a rewind by 2
    and a decode step over the rewound slot, then extend_step by 1 (the
    decode kernel's route): logits and the whole caches after each
    call.  The kernel route takes K1 only in prefill and K3 only for
    one-token blocks, as the JAX package routes them."""
    calls = _route(request, impl)
    jcfg, tcfg = _cfgs(impl, **CONFIGS[name])
    jp, tp = _params(jcfg, seed=2)
    rng = np.random.default_rng(3)
    prompt = _prompt()
    jl, jcache = jax_decode.prefill(jp, jnp.asarray(prompt), jcfg, 12)
    tl, tcache = decode.prefill(tp, torch.from_numpy(prompt), tcfg, 12)
    _close(tl, jl, LOGITS_TOL)
    _compare_cache(tcache, jcache)
    for step in ("decode", "decode", "extend3", "rewind2", "decode",
                 "extend1"):
        if step == "rewind2":
            jcache = jax_decode._rewind(jcache, int(jcache.length) - 2)
            tcache = decode._rewind(tcache, tcache.length - 2)
            assert tcache.length == int(jcache.length)
            continue
        n = 1 if step == "decode" else int(step[-1])
        toks = rng.integers(0, ARCH["vocab"], (2, n)).astype(np.int32)
        if step == "decode":
            jl, jcache = jax_decode.decode_step(jp, jcache,
                                                jnp.asarray(toks[:, 0]), jcfg)
            tl, tcache = decode.decode_step(tp, tcache,
                                            torch.from_numpy(toks[:, 0]),
                                            tcfg)
        else:
            jl, jcache = jax_decode.extend_step(jp, jcache,
                                                jnp.asarray(toks), jcfg)
            tl, tcache = decode.extend_step(tp, tcache,
                                            torch.from_numpy(toks), tcfg)
        _close(tl, jl, LOGITS_TOL)
        _compare_cache(tcache, jcache)
    if calls is not None:
        # prefill: one K1 call per layer; 3 decode steps and extend_step
        # by 1: one K3 call per layer each; extend_step by 3: neither.
        assert calls == {"flash_attention": 2, "flash_decode": 8}


def test_cache_layout_and_overflow_checks():
    _, tcfg = _cfgs(n_kv_heads=2)
    cache = decode.KVCache.zeros(tcfg, 2, 8, "cpu")
    assert cache.k.shape == (2, 2, 2, 8, 8) and cache.max_len == 8
    assert cache.length == 0 and cache.k.dtype == torch.float32
    params = model.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    with pytest.raises(ValueError, match="exceeds max_len"):
        decode.prefill(params, torch.zeros((2, 9), dtype=torch.int32), tcfg,
                       8)
    _, cache = decode.prefill(params, torch.zeros((2, 7), dtype=torch.int32),
                              tcfg, 8)
    tok = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="KV cache overflow"):
        decode.extend_step(params, cache, torch.zeros((2, 2),
                                                      dtype=torch.int32),
                           tcfg)
    _, cache = decode.decode_step(params, cache, tok, tcfg)   # fills slot 7
    with pytest.raises(ValueError, match="KV cache full"):
        decode.decode_step(params, cache, tok, tcfg)


# -- generate -------------------------------------------------------------


@pytest.mark.parametrize("impl", ["einsum", "kernel"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_generate_greedy_equals_jax(request, impl, name):
    """Greedy tokens token for token, prompt 5 + 6 steps; the kernel
    route against JAX's Pallas route, launching K1 once per layer and
    K3 once per layer for each of the steps - 1 decode steps."""
    calls = _route(request, impl)
    jcfg, tcfg = _cfgs(impl, **CONFIGS[name])
    jp, tp = _params(jcfg, seed=4)
    prompt = _prompt()
    want = np.asarray(jax_decode.generate(jp, jnp.asarray(prompt), jcfg, 6))
    got = decode.generate(tp, torch.from_numpy(prompt), tcfg, 6,
                          device="cpu")
    np.testing.assert_array_equal(_np(got), want)
    assert got.dtype == torch.int32
    if calls is not None:
        assert calls == {"flash_attention": 2, "flash_decode": 5 * 2}


def test_generate_equals_manual_decode_and_samples_validly():
    jcfg, tcfg = _cfgs(n_kv_heads=2)
    _, tp = _params(jcfg)
    prompt = torch.from_numpy(_prompt())
    out = decode.generate(tp, prompt, tcfg, 4, device="cpu")
    logits, cache = decode.prefill(tp, prompt, tcfg, 9)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    manual = [tok]
    for _ in range(3):
        step_logits, cache = decode.decode_step(tp, cache, tok, tcfg)
        tok = torch.argmax(step_logits, -1).to(torch.int32)
        manual.append(tok)
    assert torch.equal(out[:, 5:], torch.stack(manual, dim=1))
    g = torch.Generator().manual_seed(0)
    hot = decode.generate(tp, prompt, tcfg, 4, generator=g, temperature=0.8,
                          top_p=0.9, device="cpu")
    assert hot.shape == (2, 9) and torch.equal(hot[:, :5], prompt)
    assert int(hot.min()) >= 0 and int(hot.max()) < ARCH["vocab"]
    # top_k=1 sampling is greedy whatever the temperature.
    assert torch.equal(decode.generate(tp, prompt, tcfg, 4, generator=g,
                                       temperature=2.0, top_k=1,
                                       device="cpu"), out)


GENERATE_ERRORS = [
    (dict(steps=0), "steps must be"),
    (dict(steps=4, max_len=6), "exceeds max_len"),
    (dict(steps=2, top_k=5), "temperature > 0"),
    (dict(steps=2, top_p=0.9), "temperature > 0"),
    (dict(steps=2, temperature=0.8, top_k=ARCH["vocab"] + 1),
     "top_k must be"),
    (dict(steps=2, temperature=0.8, top_p=0.0), "top_p must be"),
]


@pytest.mark.parametrize("kw,match", GENERATE_ERRORS,
                         ids=["steps", "max-len", "greedy-top-k",
                              "greedy-top-p", "top-k-range", "top-p-range"])
def test_generate_validation_matches_jax(kw, match):
    """Every check JAX generate makes, with its error, raised by the
    port before any work."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    prompt = _prompt()
    jkw = dict(kw, key=jax.random.PRNGKey(0)) if "temperature" in kw else kw
    with pytest.raises(ValueError, match=match):
        jax_decode.generate(jp, jnp.asarray(prompt), jcfg, **jkw)
    gkw = dict(kw, generator=torch.Generator()) if "temperature" in kw \
        else kw
    with pytest.raises(ValueError, match=match):
        decode.generate(tp, torch.from_numpy(prompt), tcfg, device="cpu",
                        **gkw)


def test_sampling_needs_a_generator_and_cuda_is_the_default():
    jcfg, tcfg = _cfgs()
    _, tp = _params(jcfg)
    prompt = torch.from_numpy(_prompt())
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        decode.generate(tp, prompt, tcfg, 2, temperature=0.5, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            decode.generate(tp, prompt, tcfg, 2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            decode.KVCache.zeros(tcfg, 1, 4)


# -- the inference forward -------------------------------------------------


@pytest.mark.parametrize("impl", ["einsum", "kernel"])
@pytest.mark.parametrize("name", ["gqa2", "window4"])
def test_forward_matches_jax_and_teacher_forces_the_cache(request, impl,
                                                          name):
    """forward against JAX forward; prefill's logits equal forward's,
    and each decode step's logits equal forward's last position over
    the grown sequence (JAX's cache-vs-teacher-forcing check)."""
    _route(request, impl)
    jcfg, tcfg = _cfgs(impl, **CONFIGS[name])
    jp, tp = _params(jcfg, seed=5)
    prompt = _prompt(s=6)
    seq = torch.from_numpy(prompt)
    fwd = model.forward(tp, seq, tcfg)
    _close(fwd, jax_model.forward(jp, jnp.asarray(prompt), jcfg), LOGITS_TOL)
    feats, aux = model.features_with_aux(tp, seq, tcfg)
    assert torch.equal(model.features(tp, seq, tcfg), feats)
    assert {k: float(v) for k, v in aux.items()} == {"balance_loss": 0.0,
                                                     "z_loss": 0.0}
    logits, cache = decode.prefill(tp, seq, tcfg, 11)
    _close(logits, _np(fwd), LOGITS_TOL)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    for _ in range(5):
        seq = torch.cat([seq, tok[:, None]], dim=1)
        step_logits, cache = decode.decode_step(tp, cache, tok, tcfg)
        _close(step_logits, _np(model.forward(tp, seq, tcfg)[:, -1]), 5e-4)
        tok = torch.argmax(step_logits, -1).to(torch.int32)


def test_forward_refuses_moe():
    """A MoE config's forward: over its own params it equals JAX's
    forward within 2e-5; over a dense params tree (no router) it raises
    rather than run the dense MLP."""
    jcfg, tcfg = _cfgs(moe_experts=4)
    jp, tp = _params(jcfg, seed=3)
    tokens = _prompt(b=2, s=9)
    want = jax_model.forward(jp, jnp.asarray(tokens), jcfg)
    _close(model.forward(tp, torch.from_numpy(tokens), tcfg), want, 2e-5)
    _, dense = _params(_cfgs()[0])
    with pytest.raises(KeyError, match="router"):
        model.forward(dense, torch.from_numpy(tokens), tcfg)


# -- the generate CLI --------------------------------------------------------

CLI_ARCH = ["--vocab", "64", "--d-model", "32", "--n-layers", "2",
            "--seq-len", "16"]


@pytest.fixture
def cli_checkpoint(tmp_path):
    """A checkpoint at the CLI's architecture flags (bf16 config, MHA,
    d_ff 512), written by save_params from JAX-made params."""
    jcfg = jax_model.ModelConfig(vocab=64, d_model=32, n_layers=2,
                                 seq_len=16)
    jp = jax_model.init_params(jax.random.PRNGKey(6), jcfg)
    model.save_params(str(tmp_path / "ckpt"), 2, model.params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu"))
    return str(tmp_path / "ckpt")


def test_generate_cli_prints_in_process_tokens(cli_checkpoint):
    cmd = [sys.executable, "-m", "tpu_autoscaler_torch.workloads.generate",
           "--checkpoint-dir", cli_checkpoint, "--prompt", "1,2,3",
           "--batch", "2", "--steps", "5", *CLI_ARCH, "--platform", "cpu"]
    res = subprocess.run(cmd, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": REPO}, cwd=REPO,
                         timeout=240)
    assert res.returncode == 0, res.stderr
    cfg = model.ModelConfig(vocab=64, d_model=32, n_layers=2, seq_len=16)
    params = model.load_params(cli_checkpoint, 2, "cpu")
    want = decode.generate(params, torch.tensor([[1, 2, 3]] * 2), cfg, 5,
                           device="cpu").tolist()
    assert res.stdout.strip().splitlines() == [
        f"1,2,3 | {','.join(map(str, row[3:]))}" for row in want]


@pytest.mark.parametrize("flags,match", [
    (["--n-layers", "3"], "does not match the model flags"),
    (["--n-kv-heads", "2"], "does not match the model flags"),
    (["--prompt", "1,x"], "comma-separated ints"),
    (["--prompt", "1,64"], r"must be in \[0, 64\)"),
    (["--temperature", "0.5", "--top-k", "65"], "exceeds the vocab size"),
    (["--top-k", "3"], "need --temperature > 0"),
], ids=["layers", "kv-heads", "bad-prompt", "prompt-range", "top-k-vocab",
        "top-k-greedy"])
def test_generate_cli_usage_errors(cli_checkpoint, flags, match):
    args = ["--checkpoint-dir", cli_checkpoint, "--steps", "2", *CLI_ARCH,
            "--platform", "cpu"]
    # Later flags win, so each case's flags override the defaults above.
    res = CliRunner().invoke(generate_cli.main, args + flags)
    assert res.exit_code == 2, res.output
    assert re.search(match, res.output), res.output


def test_generate_cli_needs_a_checkpoint(tmp_path):
    res = CliRunner().invoke(generate_cli.main, [
        "--checkpoint-dir", str(tmp_path / "none"), *CLI_ARCH,
        "--platform", "cpu"])
    assert res.exit_code == 2 and "no checkpoint found" in res.output
