"""The paged prefill kernel (K7, ``attention.paged_flash_prefill``) and
its route in ``paged.make_paged_prefill``.

On the CPU: the kernel's plain version against the einsum route it
replaces (``paged._lanes_attend`` over ``paged._lanes_visible``), padding
rows included, and against a key-by-key oracle for the table semantics
the einsum does not have (a dead page hidden from the real rows, which
never reach past their lane's end); the wrapper's rejections; the route
(the CPU prefill is the einsum's, bit for bit; a config that resolves to
the kernel calls it once a layer and gives the einsum's logits, an MoE
model's too, whose padding tokens take expert capacity).  On a CUDA
device (marker ``cuda``, skipped without one) the kernel against its
plain version at the serving cells' shapes, and whole prefill calls
(an MoE model's among them) against the einsum route.  No JAX here, so the
card tests run on a GPU machine as they are:

    python -m pytest tests/test_torch_paged_prefill.py -m cuda -q
"""

from __future__ import annotations

import dataclasses
import math

import pytest
import torch

from tpu_autoscaler_torch.workloads import attention, model, paged
from tpu_autoscaler_torch.workloads.serving import _layer, _row_rope_tables

BS, TPR, CHUNK, D = 4, 10, 8, 16
# Lanes as (offset, n_valid): from the first token, and resumed mid-page
# and several pages in, with full, partial and empty chunks.
LANE_SETS = {"fresh": [(0, 8), (0, 5), (0, 0)],
             "resumed": [(5, 8), (23, 3), (16, 8)]}
ATTN_TOL = 2e-5   # f32 both ways: only the summation order differs


def _inputs(lanes, group, seed=0, nb=40, dtype=torch.float32):
    """q [lanes, h, CHUNK, D] and pools [nb, 2, BS, D] from ``seed``, and
    tables giving each lane its own scrambled blocks."""
    g = torch.Generator().manual_seed(seed)
    hkv = 2
    h = hkv * group
    q = torch.randn((len(lanes), h, CHUNK, D), generator=g).to(dtype)
    k = torch.randn((nb, hkv, BS, D), generator=g).to(dtype)
    v = torch.randn((nb, hkv, BS, D), generator=g).to(dtype)
    tables = torch.randperm(nb, generator=g)[:len(lanes) * TPR].reshape(
        len(lanes), TPR).to(torch.int32)
    offsets = torch.tensor([o for o, _ in lanes], dtype=torch.int32)
    n_valid = torch.tensor([n for _, n in lanes], dtype=torch.int32)
    return q, k, v, tables, offsets, n_valid


def _cfg(h, hkv, window, dtype=torch.float32, **kw):
    return model.ModelConfig(vocab=64, d_model=h * D, n_layers=2, n_heads=h,
                             n_kv_heads=hkv, d_ff=64, seq_len=BS * TPR,
                             attention_window=window, dtype=dtype, **kw)


def _oracle(q, k, v, tables, offsets, n_valid, window):
    """Key by key in f64: row i of lane b sees the keys j <= p within the
    window, a real row (i < n_valid) only those in a live page, a
    padding row a dead page's as block 0 (the gathered einsum's)."""
    lanes, h, chunk, d = q.shape
    hkv, bs = k.shape[1], k.shape[2]
    out = torch.zeros(q.shape, dtype=torch.float64)
    for b in range(lanes):
        for i in range(chunk):
            p = int(offsets[b]) + i
            real = i < int(n_valid[b])
            keys = [j for j in range(tables.shape[1] * bs)
                    if j <= p and (window is None or j > p - window)
                    and (not real or int(tables[b, j // bs]) >= 0)]
            if not keys:
                continue
            blocks = [min(max(int(tables[b, j // bs]), 0), k.shape[0] - 1)
                      for j in keys]
            for head in range(h):
                n = head // (h // hkv)
                kr = torch.stack([k[blk, n, j % bs] for blk, j in
                                  zip(blocks, keys)]).double()
                vr = torch.stack([v[blk, n, j % bs] for blk, j in
                                  zip(blocks, keys)]).double()
                w = torch.softmax(kr @ q[b, head, i].double() / math.sqrt(d),
                                  dim=0)
                out[b, head, i] = w @ vr
    return out


# ---- the plain version ------------------------------------------------

@pytest.mark.parametrize("group", [1, 4, 12])
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("lane_set", sorted(LANE_SETS))
def test_plain_version_matches_the_einsum_route(lane_set, window, group):
    """On every row, the padding rows' too (all pages live), the plain
    version is the einsum route's attention: _lanes_attend over the
    gathered tables under _lanes_visible."""
    lanes = LANE_SETS[lane_set]
    q, k, v, tables, offsets, n_valid = _inputs(lanes, group)
    cfg = _cfg(q.shape[1], 2, window)
    got = attention.paged_flash_prefill_reference(
        q, k, v, tables, offsets, n_valid, window=window)
    want = paged._lanes_attend(
        q, attention.gather_pool_rows(k, tables),
        attention.gather_pool_rows(v, tables),
        paged._lanes_visible(offsets, CHUNK, BS * TPR, cfg), cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=ATTN_TOL)


@pytest.mark.parametrize("past_end", [-1, 10_000])
def test_dead_pages_and_entries_past_the_end(past_end):
    """A -1 entry below a lane's end hides its page's keys from the real
    rows; entries past the lane's last valid page (-1, or past the pool)
    reach no real row (their pages refilled with 2.0, which the oracle
    would not see); the padding rows and the empty lane read
    them as the einsum route does (clamped).  Against the key-by-key
    oracle, and the padding rows against _lanes_attend."""
    lanes = LANE_SETS["resumed"] + [(0, 0)]
    q, k, v, tables, offsets, n_valid = _inputs(lanes, 4, seed=3)
    tables[0, 1] = -1          # a dead page inside lane 0's window
    tables[2, 2] = 10_000      # past the pool: clamped to its last block
    for b, (off, nv) in enumerate(lanes):
        for j in range(-(-(off + nv) // BS), TPR):
            blk = int(tables[b, j])
            if 0 < blk < k.shape[0] - 1:
                k[blk], v[blk] = 2.0, 2.0
            tables[b, j] = past_end
    got = attention.paged_flash_prefill_reference(
        q, k, v, tables, offsets, n_valid, window=None)
    torch.testing.assert_close(
        got.double(), _oracle(q, k, v, tables, offsets, n_valid, None),
        rtol=0, atol=ATTN_TOL)
    cfg = _cfg(q.shape[1], 2, None)
    want = paged._lanes_attend(
        q, attention.gather_pool_rows(k, tables),
        attention.gather_pool_rows(v, tables),
        paged._lanes_visible(offsets, CHUNK, BS * TPR, cfg), cfg)
    for b, (_, nv) in enumerate(lanes):
        torch.testing.assert_close(got[b, :, nv:], want[b, :, nv:],
                                   rtol=0, atol=ATTN_TOL)


def test_a_row_that_sees_no_key_is_zeros():
    """Its own page dead and no window reaching back: the real row sees
    no key and comes out zeros (the einsum would average the table);
    the padding rows read that page as block 0, as the einsum does."""
    q, k, v, tables, offsets, n_valid = _inputs([(12, 2)], 1, seed=4)
    tables[0, 3] = -1
    got = attention.paged_flash_prefill_reference(
        q, k, v, tables, offsets, n_valid, window=1)
    assert torch.count_nonzero(got[:, :, :2]) == 0
    assert torch.count_nonzero(got[:, :, 2:]) == got[:, :, 2:].numel()
    torch.testing.assert_close(
        got.double(), _oracle(q, k, v, tables, offsets, n_valid, 1),
        rtol=0, atol=ATTN_TOL)


def test_bf16_plain_version_rounds_like_the_kernel():
    """bf16 in, bf16 out: the oracle within 2^-5 of each row's largest
    |out| (chip_smoke.TOL_REASON: both round P and out to bf16)."""
    lanes = LANE_SETS["resumed"]
    q, k, v, tables, offsets, n_valid = _inputs(lanes, 12, seed=5,
                                                dtype=torch.bfloat16)
    got = attention.paged_flash_prefill_reference(
        q, k, v, tables, offsets, n_valid, window=7)
    assert got.dtype == torch.bfloat16
    want = _oracle(q, k, v, tables, offsets, n_valid, 7)
    tol = 2.0 ** -5 * want.abs().amax(dim=-1, keepdim=True)
    assert ((got.double() - want).abs() <= tol).all()


# ---- the wrapper's checks -------------------------------------------

def _bad_calls():
    q, k, v, tables, offsets, n_valid = _inputs(LANE_SETS["fresh"], 2)
    ok = dict(q=q, k_pool=k, v_pool=v, tables=tables, offsets=offsets,
              n_valid=n_valid)
    return {
        "q-rank": (dict(ok, q=q[0]), "lanes, h, chunk"),
        "pool-width": (dict(ok, k_pool=k[..., :8], v_pool=v[..., :8]),
                       "does not fit"),
        "kv-mismatch": (dict(ok, v_pool=v[:-1]), "mismatch"),
        "tables-lanes": (dict(ok, tables=tables[:2]), "do not fit"),
        "offsets-length": (dict(ok, offsets=offsets[:2]), "offsets"),
        "n_valid-length": (dict(ok, n_valid=n_valid[:1]), "n_valid"),
        "n_valid-over-chunk": (dict(ok, n_valid=n_valid + CHUNK),
                               r"\[0, chunk"),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrapper_rejects(case):
    kw, match = _bad_calls()[case]
    with pytest.raises(ValueError, match=match):
        attention.paged_flash_prefill(**kw)


def test_wrapper_rejects_a_zero_window():
    q, k, v, tables, offsets, n_valid = _inputs(LANE_SETS["fresh"], 2)
    with pytest.raises(ValueError, match="window"):
        attention.paged_flash_prefill(q, k, v, tables, offsets, n_valid,
                                      window=0)


def _kernel_bad():
    q, k, v, tables, _, _ = _inputs(LANE_SETS["fresh"], 2)
    bf = torch.bfloat16
    return {
        "dtype-mismatch": ((q, k.to(bf), v.to(bf), tables), "is torch"),
        "dtype-f16": ((q.half(), k.half(), v.half(), tables),
                      "bf16 or f32"),
        "non-contiguous-pool": ((q, k.transpose(2, 3).contiguous()
                                 .transpose(2, 3), v, tables),
                                "contiguous k_pool"),
        "bf16-block-4": ((q.to(bf), k.to(bf), v.to(bf), tables),
                         "block size"),
        "bf16-row-bytes": ((q[..., :12].to(bf).contiguous(),
                            k[..., :12].to(bf).contiguous(),
                            v[..., :12].to(bf).contiguous(), tables),
                           "16-byte"),
    }


@pytest.mark.parametrize("case", sorted(_kernel_bad()))
def test_kernel_checks_reject(case):
    """What only the kernel refuses (on CUDA tensors; run here on CPU
    tensors through the same check the wrapper makes before a launch)."""
    args, match = _kernel_bad()[case]
    with pytest.raises(ValueError, match=match):
        attention._check_prefill_kernel(*args)


def test_kernel_checks_take_the_serving_shapes():
    for bs, d in ((16, 128), (8, 64), (64, 128), (16, 256), (32, 256),
                  (16, 96)):
        q = torch.zeros((1, 4, 5, d), dtype=torch.bfloat16)
        pool = torch.zeros((4, 2, bs, d), dtype=torch.bfloat16)
        attention._check_prefill_kernel(q, pool, pool,
                                        torch.zeros((1, 4), dtype=torch.int32))


# ---- the route ------------------------------------------------------

def _engine_inputs(cfg, lanes, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = model.init_params(g, cfg, "cpu")
    cache = paged.PagedKVCache.zeros(cfg, 40, BS, len(lanes), "cpu")
    cache.k.normal_(generator=g)
    cache.v.normal_(generator=g)
    tables = torch.randperm(40, generator=g)[:len(lanes) * TPR].reshape(
        len(lanes), TPR).to(torch.int32)
    tokens = torch.randint(0, cfg.vocab, (len(lanes), CHUNK), generator=g)
    offsets = torch.tensor([o for o, _ in lanes], dtype=torch.int32)
    n_valid = torch.tensor([n for _, n in lanes], dtype=torch.int32)
    return params, cache, tables, tokens, offsets, n_valid


def _einsum_fill(cfg, params, cache, tables, tokens, offsets, n_valid):
    """The prefill as it was before the kernel: every layer's attention
    the masked einsum over the gathered tables (all rows' logits)."""
    writes = paged._chunk_writes(tables, offsets, n_valid, CHUNK,
                                 cache.num_blocks, BS)
    visible = paged._lanes_visible(offsets, CHUNK, BS * TPR, cfg)
    rope = _row_rope_tables(offsets, CHUNK, cfg.head_dim, cfg.rope_theta,
                            cfg.dtype)
    x = params["embed"].to(cfg.dtype)[tokens]
    b, s, d = x.shape
    for i in range(cfg.n_layers):
        layer = _layer(params, i)
        y = model._rmsnorm(x, layer["ln1"])
        q, k, v = model._split_qkv(y, layer["qkv"], cfg)
        q, k = model._rotate(q, *rope), model._rotate(k, *rope)
        paged._scatter_chunk(cache.k[i], k, writes)
        paged._scatter_chunk(cache.v[i], v, writes)
        attn = paged._lanes_attend(
            q, attention.gather_pool_rows(cache.k[i], tables),
            attention.gather_pool_rows(cache.v[i], tables), visible, cfg)
        x = x + attn.transpose(1, 2).reshape(b, s, d) \
            @ layer["attn_out"].to(cfg.dtype)
        x = model._ffn_residual(x, model._rmsnorm(x, layer["ln2"]), layer,
                                cfg)
    x = model._rmsnorm(x, params["ln_f"])
    return (x @ params["unembed"].to(cfg.dtype)).float()


@pytest.mark.parametrize("impl", ["auto", "einsum"])
def test_cpu_prefill_is_the_einsum_bit_for_bit(impl, monkeypatch):
    """CPU tensors (and attention='einsum') take _lanes_attend, never
    the kernel, and give the einsum prefill's logits and pool bit for
    bit."""
    def refuse(*a, **kw):
        raise AssertionError("the CPU prefill called the kernel")

    monkeypatch.setattr(paged, "paged_flash_prefill", refuse)
    lanes = LANE_SETS["resumed"]
    cfg = _cfg(8, 2, 7, attention=impl)
    params, cache, tables, tokens, offsets, n_valid = _engine_inputs(
        cfg, lanes)
    twin = dataclasses.replace(cache, k=cache.k.clone(), v=cache.v.clone())
    fill = paged.make_paged_prefill(cfg, CHUNK, len(lanes), BS * TPR,
                                    return_all_logits=True)
    got, cache = fill(params, cache, tables, tokens, offsets, n_valid)
    want = _einsum_fill(cfg, params, twin, tables, tokens, offsets, n_valid)
    assert torch.equal(got, want)
    assert torch.equal(cache.k, twin.k) and torch.equal(cache.v, twin.v)


def _kernel_route_against_einsum(monkeypatch, cfg, seed, pad_rows=None):
    """One prefill call of ``cfg`` on the einsum route, then on the
    kernel route with the plain version standing in for the kernel
    (``pad_rows``, if given, rewrites its output); (einsum logits,
    kernel logits, einsum cache, kernel cache, the stand-in's windows)."""
    calls = []

    def spy(q, k_pool, v_pool, tables, offsets, n_valid, *, window):
        calls.append(window)
        out = attention.paged_flash_prefill_reference(
            q, k_pool, v_pool, tables, offsets, n_valid, window=window)
        return out if pad_rows is None else pad_rows(out, n_valid)

    lanes = LANE_SETS["resumed"] + [(0, 0)]
    params, cache, tables, tokens, offsets, n_valid = _engine_inputs(
        cfg, lanes, seed=seed)
    twin = dataclasses.replace(cache, k=cache.k.clone(), v=cache.v.clone())
    fill = paged.make_paged_prefill(cfg, CHUNK, len(lanes), BS * TPR,
                                    return_all_logits=True)
    want, twin = fill(params, twin, tables, tokens, offsets, n_valid)
    monkeypatch.setattr(paged, "paged_flash_prefill", spy)
    monkeypatch.setattr(model.ModelConfig, "resolved_attention",
                        lambda self, device: "kernel")
    got, cache = fill(params, cache, tables, tokens, offsets, n_valid)
    return want, got, twin, cache, calls


def test_a_kernel_config_calls_the_kernel_once_a_layer(monkeypatch):
    """Where the config resolves to the kernel, every layer's attention
    is one paged_flash_prefill call on the pool's tables, offsets and
    n_valid; with the plain version standing in for the kernel, every
    row, padding included, gives the einsum route's logits."""
    cfg = _cfg(8, 2, 7)
    want, got, twin, cache, calls = _kernel_route_against_einsum(
        monkeypatch, cfg, seed=1)
    assert calls == [7] * cfg.n_layers
    # Layer 0 writes the same k/v; the next layers' differ by rounding.
    assert torch.equal(cache.k[0], twin.k[0])
    torch.testing.assert_close(cache.v, twin.v, rtol=0, atol=1e-4)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


MOE = dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=0.5)


def test_an_moe_kernel_prefill_gives_the_einsums_real_tokens(monkeypatch):
    """An MoE model at a capacity that drops tokens: the padding tokens
    take expert capacity in their lane (their first choices before the
    real tokens' second), so the kernel route gives the einsum's logits
    on the real rows only because its padding rows are the einsum's."""
    cfg = _cfg(8, 2, None, **MOE)
    want, got, _, _, calls = _kernel_route_against_einsum(
        monkeypatch, cfg, seed=2)
    assert calls == [None] * cfg.n_layers
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_moe_padding_rows_reach_the_real_tokens(monkeypatch):
    """Why the kernel attends the padding rows: with them written as
    zeros instead, the same MoE prefill's real rows move."""
    def zero_pad_rows(out, n_valid):
        rows = torch.arange(out.shape[2])[None, None, :, None]
        return torch.where(rows < n_valid.long()[:, None, None, None], out,
                           0)

    cfg = _cfg(8, 2, None, **MOE)
    want, got, _, _, _ = _kernel_route_against_einsum(
        monkeypatch, cfg, seed=2, pad_rows=zero_pad_rows)
    lanes = LANE_SETS["resumed"] + [(0, 0)]
    gap = max((got[b, :nv] - want[b, :nv]).abs().max().item()
              for b, (_, nv) in enumerate(lanes) if nv)
    assert gap > 1e-2, gap


# ---- on the card ----------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


# (lanes as (offset, n_valid), chunk, h, hkv, d, block size, tpr, window)
# Complete's call: a lane mid-prompt, one finishing, one fresh, one unused
# (prompts ~2,560 in chunks of 512, tokens_per_row 4,096, the 4,096
# window); chat's (2 x 256, tokens_per_row 3,072); the speculative
# verify's (k + 1 = 5 rows a slot, every slot a lane); a window shorter
# than the context; f32 on the CUDA cores; pages longer than a key tile
# (bs 128, and bs 64 at d 256, whose tiles are 32 keys); head_dims the
# kernel reads at a wider build (96 at 128, 32 at 64).
CARD_CASES = {
    "complete": ([(1536, 512), (2048, 385), (0, 512), (0, 0)], 512, 24, 2,
                 128, 16, 256, 4096),
    "chat": ([(256, 256), (0, 171)], 256, 24, 2, 128, 16, 192, 4096),
    "spec-verify": ([(37, 5), (200, 5), (0, 0), (511, 5), (64, 3)], 5, 16,
                    2, 64, 16, 64, None),
    "window-300": ([(900, 128), (17, 128), (0, 100)], 128, 8, 1, 128, 8,
                   256, 300),
    "f32-d64": ([(70, 64), (0, 33), (0, 0)], 64, 8, 2, 64, 16, 16, None),
    "bs128": ([(300, 100), (0, 64)], 128, 8, 2, 128, 128, 4, None),
    "bs64-d256": ([(100, 64), (0, 17)], 64, 4, 1, 256, 64, 4, 90),
    "d96": ([(40, 33), (0, 64)], 64, 6, 3, 96, 16, 8, None),
    "d32-bs8": ([(19, 40), (3, 64)], 64, 4, 2, 32, 8, 16, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_paged_prefill_kernel_matches_plain_version(case):
    """K7 against its plain version on the card, scrambled pages, a dead
    entry past each lane's end: bf16 within 2^-5 of each (row, head)'s
    largest |out| (chip_smoke.TOL_REASON: both round P and out to bf16,
    the kernel P at the running max, the plain version at the final
    max, each about one ulp), f32 within 2e-5; on every row, padding
    included (read through the dead entries as block 0)."""
    _need_cuda()
    from chip_smoke import err_over_tol
    lanes, chunk, h, hkv, d, bs, tpr, window = CARD_CASES[case]
    dtype = torch.float32 if case.startswith("f32") else torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(7)
    nb = len(lanes) * tpr + 8
    q = torch.randn((len(lanes), h, chunk, d), generator=g,
                    device="cuda").to(dtype)
    k = torch.randn((nb, hkv, bs, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((nb, hkv, bs, d), generator=g, device="cuda").to(dtype)
    tables = torch.randperm(nb, generator=g, device="cuda")[
        :len(lanes) * tpr].reshape(len(lanes), tpr).to(torch.int32)
    for b, (off, nv) in enumerate(lanes):
        tables[b, -(-(off + nv) // bs):] = -1
    offsets = torch.tensor([o for o, _ in lanes], dtype=torch.int32,
                           device="cuda")
    n_valid = torch.tensor([n for _, n in lanes], dtype=torch.int32,
                           device="cuda")
    attention.reset_launch_counts()
    got = attention.paged_flash_prefill(q, k, v, tables, offsets, n_valid,
                                        window=window)
    want = attention.paged_flash_prefill_reference(
        q, k, v, tables, offsets, n_valid, window=window)
    torch.cuda.synchronize()
    assert attention.LAUNCHES["paged_flash_prefill"] == 1
    _, share = err_over_tol(torch, got, want)
    assert share <= 1.0, (case, share)


@pytest.mark.cuda
def test_prefill_call_on_cuda_against_the_einsum_route():
    """A whole bf16 prefill call on the card (the kernel route) against
    the same call with attention='einsum': each lane's last-row logits
    within 0.05 of the einsum's largest |logit| (the einsum rounds its
    scores to bf16, the kernel does not; through 2 layers that moves a
    logit by a few bf16 ulps), layer 0's pool written alike, and K7
    launched once a layer."""
    _need_cuda()
    lanes = [(48, 64), (0, 64), (100, 17), (0, 0)]
    cfg = model.ModelConfig(vocab=512, d_model=512, n_layers=2, n_heads=8,
                            n_kv_heads=2, d_ff=1024, seq_len=256,
                            dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(3)
    params = model.init_params(g, cfg, "cuda")
    bs, tpr, chunk = 16, 16, 64
    cache = paged.PagedKVCache.zeros(cfg, 80, bs, len(lanes), "cuda")
    cache.k.normal_(generator=g)
    cache.v.normal_(generator=g)
    twin = dataclasses.replace(cache, k=cache.k.clone(), v=cache.v.clone())
    tables = torch.randperm(80, generator=g, device="cuda")[
        :len(lanes) * tpr].reshape(len(lanes), tpr).to(torch.int32).cpu()
    tokens = torch.randint(0, cfg.vocab, (len(lanes), chunk))
    offsets = torch.tensor([o for o, _ in lanes], dtype=torch.int32)
    n_valid = torch.tensor([n for _, n in lanes], dtype=torch.int32)
    attention.reset_launch_counts()
    fill = paged.make_paged_prefill(cfg, chunk, len(lanes), bs * tpr)
    got, cache = fill(params, cache, tables, tokens, offsets, n_valid)
    assert attention.LAUNCHES["paged_flash_prefill"] == cfg.n_layers
    efill = paged.make_paged_prefill(
        dataclasses.replace(cfg, attention="einsum"), chunk, len(lanes),
        bs * tpr)
    want, twin = efill(params, twin, tables, tokens, offsets, n_valid)
    torch.cuda.synchronize()
    assert torch.equal(cache.k[0], twin.k[0])   # before any attention
    live = n_valid > 0
    gap = (got[live] - want[live]).abs().max().item()
    assert gap <= 0.05 * want[live].abs().max().item(), gap


@pytest.mark.cuda
def test_moe_prefill_call_on_cuda_against_the_einsum_route():
    """An f32 MoE prefill call on the card at a capacity that drops
    tokens, with -1 past each lane's end as the engine's tables have:
    every row's logits, padding included, within 1e-3 of the einsum
    route's largest |logit| (f32 both ways; the kernel's padding rows
    read the dead entries as block 0, as the einsum does, so the
    padding tokens take the same capacity)."""
    _need_cuda()
    lanes = [(48, 64), (0, 64), (100, 17), (0, 0)]
    cfg = model.ModelConfig(vocab=512, d_model=256, n_layers=2, n_heads=8,
                            n_kv_heads=2, d_ff=512, seq_len=256,
                            dtype=torch.float32, **MOE)
    g = torch.Generator(device="cuda").manual_seed(4)
    params = model.init_params(g, cfg, "cuda")
    bs, tpr, chunk = 16, 16, 64
    cache = paged.PagedKVCache.zeros(cfg, 80, bs, len(lanes), "cuda")
    cache.k.normal_(generator=g)
    cache.v.normal_(generator=g)
    twin = dataclasses.replace(cache, k=cache.k.clone(), v=cache.v.clone())
    tables = torch.randperm(80, generator=g, device="cuda")[
        :len(lanes) * tpr].reshape(len(lanes), tpr).to(torch.int32).cpu()
    for b, (off, nv) in enumerate(lanes):
        tables[b, -(-(off + nv) // bs):] = -1
    tokens = torch.randint(0, cfg.vocab, (len(lanes), chunk))
    offsets = torch.tensor([o for o, _ in lanes], dtype=torch.int32)
    n_valid = torch.tensor([n for _, n in lanes], dtype=torch.int32)
    attention.reset_launch_counts()
    fill = paged.make_paged_prefill(cfg, chunk, len(lanes), bs * tpr,
                                    return_all_logits=True)
    got, cache = fill(params, cache, tables, tokens, offsets, n_valid)
    assert attention.LAUNCHES["paged_flash_prefill"] == cfg.n_layers
    efill = paged.make_paged_prefill(
        dataclasses.replace(cfg, attention="einsum"), chunk, len(lanes),
        bs * tpr, return_all_logits=True)
    want, twin = efill(params, twin, tables, tokens, offsets, n_valid)
    torch.cuda.synchronize()
    gap = (got - want).abs().max().item()
    assert gap <= 1e-3 * want.abs().max().item(), gap
