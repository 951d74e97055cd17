"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, drives the port's
paths through their public entry points at the full width of
``bench_tpu.py``: the continuous-batching server with the linear cache
(its serving phase), the paged-KV server (its paged phase, whose pool
is small enough to preempt) and the same traffic through the
speculative paged engine (the target's first layer drafting 4 tokens a
round, then the whole target drafting for itself, so that rounds
accept), ``decode.generate`` (its decode phase, GQA and MHA, and a long
prompt) and ``decode.speculative_generate`` on the GQA shape, the
trainer's step (its step phase, and the long-sequence remat recipe of
its step_large phase), the sequence-parallel train step (its
long-context step, the sequence cut over 4 ranks: the kernel ring,
against one device, the einsum ring and Ulysses) and the speculative
economics cell (its spec phase: a 6-layer target and a 1-layer draft
trained by the port's trainer on a bigram shard), and runs the
``serve`` CLI with each cache, speculatively and with request tracing,
the ``generate`` CLI and the ``train`` CLI (train, resume, drain; on one
device and with ``--sp 2``).  Each phase prints one JSON line; a failed
phase raises and the script exits non-zero.  The last lines are the
card's ``nvidia-smi`` name and power limit, the ``kernels`` summary, and
``{"ok": true, "device": {...}}``.

Needs one CUDA device; without one it exits non-zero before printing
any result.  Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
F32_TOL = 2e-5                   # the JAX package's kernel-vs-einsum bound
BF16_RTOL = 2.0 ** -5            # of each (row, head)'s largest |out|
GRAD_F32_RTOL = 1e-4             # of an f32 gradient's largest |value|
TOL_REASON = {
    "torch.bfloat16": "per (row, head): 2^-5 of that row's largest |out|, "
                      "4-8 bf16 ulps there (ulp is 2^-8..2^-7 of the "
                      "value).  Both versions round the output to bf16 "
                      "and P to bf16 (the kernel at the running max, the "
                      "plain version at the final max), each worth about "
                      "one ulp; a mis-merged tile moves a row by the "
                      "size of the row itself",
    "torch.float32": "2e-5 absolute: f32 throughout, only the summation "
                     "order differs (the JAX package's kernel-vs-einsum "
                     "tolerance)",
}


def err_over_tol(torch, got, want) -> tuple[float, float]:
    """(max |got - want|, the worst error as a share of its tolerance):
    a share <= 1 passes.  Tolerances as in TOL_REASON; a row with no
    visible key must come out exactly zero in bf16."""
    diff = (got.float() - want.float()).abs()
    if want.dtype == torch.float32:
        tol = diff.new_full((), F32_TOL)
    else:
        tol = BF16_RTOL * want.float().abs().amax(dim=-1, keepdim=True)
    over = torch.where(diff > 0, diff / tol, diff.new_zeros(()))
    return diff.max().item(), over.max().item()


def grad_err_over_tol(torch, got, want, dtype=None) -> tuple[float, float]:
    """err_over_tol for a gradient tensor computed from ``dtype`` inputs
    (default: the gradient's own dtype): bf16 within 2^-5 of each
    row's largest |value|, f32 within GRAD_F32_RTOL of the tensor's
    largest |value| (a gradient sums thousands of products whose sum
    cancels toward zero: dS sums to 0 over a row's keys), both floored
    at d * 2^-20 absolute.  The floor is the f32 rounding noise of
    dP - delta (two d-term f32 sums, |error| up to ~d * 2^-23 * |do| *
    |v|, times |k| or |q|) that both versions carry where the exact
    gradient cancels to zero: the first query row sees only its own key,
    and a window of 1 every row, so there dS is 0 in exact arithmetic.
    The inputs are N(0, 1), so the floor (6e-5 at d 64) is far below
    the gradients' own scale."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs()
    floor = want.shape[-1] * 2.0 ** -20
    if (dtype or want.dtype) == torch.float32:
        tol = torch.clamp_min(GRAD_F32_RTOL * mag.max(), floor)
    else:
        tol = torch.clamp_min(BF16_RTOL * mag.amax(dim=-1, keepdim=True),
                              floor)
    return diff.max().item(), (diff / tol).max().item()


def hop_err_over_tol(torch, got, want, dtype) -> tuple[float, float]:
    """err_over_tol for a ring hop's f32 carry (m, l or acc) computed
    from ``dtype`` inputs.  The carry is not normalised (l and acc grow
    with every key merged), so each row's tolerance scales with that
    row's largest |value|, at least 1: f32 inputs F32_TOL of it (f32
    throughout, summation order only), bf16 inputs BF16_RTOL of it (P is
    rounded to bf16 at the running max in the kernel and at the hop's
    max in the plain version, about one bf16 ulp of each term)."""
    diff = (got - want).abs()
    mag = want.abs().amax(dim=-1, keepdim=True).clamp_min(1.0)
    rate = F32_TOL if dtype == torch.float32 else BF16_RTOL
    return diff.max().item(), (diff / (rate * mag)).max().item()


# Full serving width: bench_tpu.py's serving phase.
FULL = dict(vocab=32768, d_model=1024, n_layers=8, n_heads=16,
            n_kv_heads=2, d_ff=4096, seq_len=1024)
PROMPT_LENS = (64, 384, 896, 128, 640, 256, 512, 96)
NEW_TOKENS, SLOTS, MAX_LEN, CHUNK = 128, 4, 1024, 128
# The paged path: bench_tpu.py's paged phase (bench_tpu.py:624-647).
# 16 requests hold 5952 prompt tokens (8000 with their generations)
# against a 4096-token pool (the linear engine's 4 x 1024 budget), and
# all 16 are admitted at once, so the pool must preempt.
PAGED_SLOTS, BLOCK_SIZE, PREFILL_LANES = 16, 16, 4
NUM_BLOCKS = 4 * MAX_LEN // BLOCK_SIZE
PAGED_PROMPT_LENS = PROMPT_LENS * 2
COMPARE_TICKS = 16
# Kernel route vs einsum route on identical inputs: bf16 attention
# outputs differ by about one bf16 ulp, which moves N(0, 1) logits by a
# few hundredths; 0.25 is several times what such rounding gives.
DLOGITS_MAX = 0.25
PROFILE_TICKS = 40
# The generate path: bench_tpu.py's decode phase (bench_tpu.py:450-453),
# the serving model as GQA and as MHA, then a long prompt (the longest
# of the serving traffic) that fills the config's seq_len.
GEN_BATCH, GEN_PROMPT, GEN_STEPS = 8, 128, 256
GEN_SHAPES = (("gqa", dict(FULL), GEN_PROMPT, GEN_STEPS),
              ("mha", dict(FULL, n_kv_heads=None), GEN_PROMPT, GEN_STEPS),
              ("long-prompt", dict(FULL), max(PROMPT_LENS), 128))
GEN_REPS = 3
LSE_TOL = 1e-4   # f32 in both versions; only the summation order differs
SPIN_CYCLES = 400_000            # ~0.2 ms of device spin at ~1.98 GHz
# The training path: bench_tpu.py's step phase (bench_tpu.py:171-173),
# MHA at head_dim 64, the default TrainConfig, one fixed batch; then its
# step_large phase (bench_tpu.py:238-240), head_dim 128 with remat and
# the chunked cross-entropy.
TRAIN_FULL = dict(vocab=32768, d_model=1024, n_layers=8, n_heads=16,
                  d_ff=4096, seq_len=1024)
TRAIN_BATCH, TRAIN_WARM, TRAIN_STEPS = 16, 2, 10
TRAIN_LARGE = dict(vocab=32768, d_model=1536, n_layers=20, n_heads=12,
                   d_ff=6144, seq_len=2048, remat=True, ce_chunk=256)
LARGE_BATCH, LARGE_WARM, LARGE_STEPS = 8, 1, 3
PROFILE_STEPS = 3
# Kernel route vs einsum route at the first step, same params and batch:
# both compute in bf16 and differ by attention-output rounding (~one
# bf16 ulp), which moves a ~10.4 mean cross-entropy by ~1e-3 and the
# gradient (dominated by the embedding and unembedding) by well under
# a percent; the bounds are several times that.
TRAIN_LOSS_GAP = 0.02
TRAIN_GRAD_NORM_RTOL = 0.02
SMALL_TRAIN_LOSS_GAP = 1e-4      # f32: summation order only, 5 steps
# The sequence-parallel path: bench_tpu.py's long-context train step
# (bench_tpu.py:406-407), batch 2 with remat, the sequence cut over 4
# ranks of 2048 tokens; 1 warm and 3 timed steps of one fixed batch.
SP_FULL = dict(vocab=32768, d_model=1024, n_layers=4, n_heads=8, d_ff=4096,
               seq_len=8192, remat=True)
SP_RANKS, SP_BATCH, SP_WARM, SP_STEPS = 4, 2, 1, 3
# The kernel ring against one device (K1/K2 at s 8192), the einsum ring
# and Ulysses on the same params and batch, first step: all compute in
# bf16, and attention-output rounding moves the ~10.4 loss by ~1e-4 and
# the gradient norm by ~0.01 %; the bounds are tens of times that.
SP_LOSS_GAP = 0.005
SP_GRAD_NORM_RTOL = 0.005
# Small f32 models, 5 steps, kernel ring vs einsum ring: f32 summation
# order only; the params after them within 1e-3 of each leaf's largest
# |value| (JAX's own sp-parity bound: Adam moves a param by ~LR whatever
# its gradient, so f32 noise in a near-zero gradient can flip a step;
# the plain versions on the CPU differ by 1.2e-4 at 4 ranks).
SMALL_SP_PARAM_RTOL = 1e-3
RING_KERNELS = ("ring_flash_step", "ring_flash_bwd_dq", "ring_flash_bwd_dkv")
# The speculative paths: the paged cell's traffic through the speculative
# engine, speculative_generate on the GQA generate shape, both with the
# target's first layer as the draft and k 4; then the reference's
# economics cell (bench_tpu.py:695 _impl_spec) at its full size: a
# 6-layer target and a 1-layer draft trained on bench_tpu.py:676-692's
# bigram shard.
SPEC_K, DRAFT_LAYERS = 4, 1
# A speculative token is the argmax of einsum verify logits, a plain one
# of K3/K4 decode logits.  At a sequence's first divergence both routes
# have seen the same tokens, so the two logit rows that chose the token
# are captured and compared: the argmaxes can differ only if the verify
# top-2 gap is at most twice the rows' largest |dlogits|, and that must
# be rounding (at most DLOGITS_MAX).  Such a divergence is a near tie;
# any other is a fault.
SPEC_VOCAB, SPEC_TOKENS, SPEC_TRAIN_STEPS = 4096, 2_000_000, 600
SPEC_D_MODEL, SPEC_SEQ, SPEC_T_LAYERS, SPEC_D_LAYERS = 512, 256, 6, 1
SPEC_GEN_STEPS, SPEC_TEMPS = 128, (0.3, 0.7, 1.0)
# What each kernel runs its bf16 products on (the kernels line's design).
SPLIT_DESIGN = "split-kv cluster + mma.sync (f32: cuda-core fma)"
TC_DESIGN = "wgmma+tma"


def decode_split(rows: int, h: int, hkv: int) -> tuple[int, int]:
    """(splits, CTAs) of one K3 or K4 launch over ``rows`` rows of h
    query heads on hkv KV heads: a cluster of kSplits CTAs for each (row,
    KV head, chunk of up to kMaxGroup query heads), read from the header
    the kernels are built from."""
    text = (ROOT / "tpu_autoscaler_torch" / "csrc" /
            "decode_common.cuh").read_text()
    const = {name: int(value) for name, value in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}
    chunks = -(-(h // hkv) // const["kMaxGroup"])
    return const["kSplits"], rows * hkv * chunks * const["kSplits"]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _time_ms(torch, fn, flush, iters: int = 30) -> float:
    """Median device time of one call, L2 flushed before each (the main
    path finds each layer's cache cold).  A device-side spin after the
    flush keeps the card busy while the host enqueues the call, so the
    events time the call's own kernels, not the host's launch gap."""
    for _ in range(3):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in ev:
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def _live_keys(lengths, max_len: int, window, ring: bool) -> list[int]:
    """Keys each row can see: what the kernel must read."""
    out = []
    for n in lengths:
        if n <= 0:
            out.append(0)
            continue
        live = min(n, max_len)
        if window is not None:
            live = min(live, window)
        out.append(live)
    return out


def _bound_ms(b, h, hkv, d, elem, live, dtype_name,
              extra_bytes: int = 0) -> tuple[float, str]:
    """Least time for the work: each live K/V row, q, out, lengths (and
    ``extra_bytes``, e.g. a block table) moved once, against ~4*d flops
    per (query head, live key)."""
    moved = sum(live) * hkv * d * elem * 2 + 2 * b * h * d * elem + 4 * b \
        + extra_bytes
    ops = 4 * d * (h // hkv) * hkv * sum(live)
    peak = BF16_OPS_PER_S if dtype_name == "torch.bfloat16" \
        else F32_OPS_PER_S
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_device(torch) -> tuple[str, str]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = _smi()
    emit("device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         allow_tf32={"matmul": False, "cudnn": False})
    return name, smi


def phase_launch_floor(torch, flush) -> float:
    """The time of an empty kernel (torch.cuda._sleep(0): one launch that
    spins no cycles) under _time_ms: the floor K3's and K4's times sit
    on."""
    ms = _time_ms(torch, lambda: torch.cuda._sleep(0), flush)
    emit("launch_floor", kernel="torch.cuda._sleep(0)", ms=ms)
    return ms


def phase_build(attention) -> None:
    t0 = time.perf_counter()
    report = attention.build_kernels()
    ptxas = {name: [ln.strip() for ln in r["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, r in report.items()}
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         per_kernel={n: round(r["seconds"], 3) for n, r in report.items()},
         ptxas=ptxas)


def _visible_mask(torch, lengths, max_len, window, ring):
    """[b, 1, 1, max_len] bool visibility (for the library yardstick)."""
    qpos = (lengths.long() - 1)[:, None]
    slot = torch.arange(max_len, device=lengths.device)[None, :]
    k_pos = qpos - torch.remainder(qpos - slot, max_len) if ring else slot
    vis = (k_pos >= 0) & (k_pos <= qpos)
    if window is not None:
        vis &= k_pos > qpos - window
    return vis[:, None, None, :]


def check_case(torch, F, attention, flush, *, label, b, h, hkv, max_len,
               d, dtype, lengths, window=None, ring=False, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q = rnd(b, h, 1, d)
    k, v = rnd(b, hkv, max_len, d), rnd(b, hkv, max_len, d)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kw = dict(window=window, ring=ring)
    got = attention.flash_decode(q, k, v, ln, **kw)
    again = attention.flash_decode(q, k, v, ln, **kw)
    want = attention.flash_decode_reference(q, k, v, ln, **kw)
    torch.cuda.synchronize()
    err, share = err_over_tol(torch, got, want)
    deterministic = torch.equal(got, again)
    dname = str(dtype)
    mask = _visible_mask(torch, ln, max_len, window, ring)
    ms = _time_ms(torch, lambda: attention.flash_decode(q, k, v, ln, **kw),
                  flush)
    plain_ms = _time_ms(
        torch, lambda: attention.flash_decode_reference(q, k, v, ln, **kw),
        flush)
    library_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True), flush)
    live = _live_keys(lengths, max_len, window, ring)
    bound_ms, bound_by = _bound_ms(b, h, hkv, d, q.element_size(), live,
                                   dname)
    splits, ctas = decode_split(b, h, hkv)
    rec = dict(case=label, shape=[b, h, hkv, max_len, d], dtype=dname,
               lengths=list(lengths), window=window, ring=ring,
               max_abs_err=err, err_over_tolerance=share,
               tolerance=TOL_REASON[dname], ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               live_keys=live, deterministic=deterministic,
               splits=splits, ctas=ctas)
    emit("kernel_check", **rec)
    if not share <= 1.0:
        raise AssertionError(f"flash_decode {label}: error {share} times "
                             f"its tolerance (max |err| {err})")
    if not deterministic:
        raise AssertionError(f"flash_decode {label}: two calls on the same "
                             f"inputs differ")
    return rec


def phase_kernel_checks(torch, F, attention, flush, main_lengths):
    """K3 in 21 cases; the first at the linear main path's shape with
    the lengths of its median decode tick; head_dim 96 (read at its true
    width by the d 128 build) and a GQA group of 64 (two clusters a row)
    among them; then the split's edges at bf16 d 64 (no key, one, fewer
    keys than splits, exactly splits x 16 and one more, a window
    starting inside a block, d 48) and the GQA generate call's shape.
    Every case is also run twice and must repeat bit for bit."""
    full = dict(b=4, h=16, hkv=2, max_len=1024, d=64, dtype=torch.bfloat16)
    window, chunk = 256, CHUNK
    ring = dict(full, max_len=window + chunk, window=window, ring=True)
    cases = [
        dict(full, label="full-main-path", lengths=main_lengths),
        dict(full, label="full-edges-a", lengths=[0, 1, 63, 64]),
        dict(full, label="full-edges-b", lengths=[65, 1024, 1, 0]),
        dict(full, label="full-scalar", lengths=[700] * 4),
        dict(full, label="window-256", window=window,
             lengths=[1, 255, 257, 1024]),
        dict(ring, label="ring-before-wrap", lengths=[1, 100, 255, 384]),
        dict(ring, label="ring-after-wrap", lengths=[385, 700, 1024, 5000]),
        dict(full, label="mha", h=16, hkv=16, lengths=[1, 300, 777, 1024]),
        dict(full, label="mqa", h=16, hkv=1, lengths=[1, 300, 777, 1024]),
        dict(full, label="f32-d128", d=128, dtype=torch.float32,
             lengths=[0, 129, 513, 1024]),
        dict(full, label="d32", d=32, lengths=[1, 300, 777, 1024]),
        dict(full, label="f32-d32-window", d=32, dtype=torch.float32,
             window=window, lengths=[0, 100, 257, 1024]),
        dict(full, label="d256", d=256, lengths=[1, 300, 777, 1024]),
        dict(full, label="f32-d256", d=256, dtype=torch.float32,
             lengths=[0, 65, 513, 1024]),
        dict(full, label="d96", d=96, lengths=[1, 300, 777, 1024]),
        dict(full, label="group64", h=64, hkv=1, lengths=[1, 300, 777, 1024]),
        dict(full, label="split-edges", lengths=[0, 1, 5, 128]),
        dict(full, label="split-129", lengths=[129, 127, 17, 1000]),
        dict(full, label="window-100-inside-blocks", window=100,
             lengths=[150, 37, 301, 1024]),
        dict(full, label="d48", d=48, lengths=[5, 129, 777, 1024]),
        dict(full, label="generate-gqa", b=GEN_BATCH,
             max_len=GEN_PROMPT + GEN_STEPS, lengths=[200] * GEN_BATCH),
    ]
    return [check_case(torch, F, attention, flush, seed=i, **c)
            for i, c in enumerate(cases)]


def _paged_visible(torch, tables, lengths, bs, window):
    """[slots, tpr*bs] bool: the keys the paged kernel must read (for
    the bound and the library yardstick's mask)."""
    qpos = (lengths.long() - 1)[:, None]
    kpos = torch.arange(tables.shape[1] * bs, device=tables.device)[None, :]
    vis = (kpos <= qpos) & (tables >= 0).repeat_interleave(bs, dim=1)
    if window is not None:
        vis &= kpos > qpos - window
    return vis


def check_paged_case(torch, F, attention, flush, *, label, slots, h, hkv,
                     bs, tpr, nb, d, dtype, lengths, tables=None,
                     window=None, edits=(), seed=0):
    """One K4 case: random q and pools, ``tables`` (or random block ids
    up to each row's length, -1 past it) with ``edits`` (row, entry,
    block id) applied, against paged_flash_decode_reference."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q = rnd(slots, h, 1, d)
    k, v = rnd(nb, hkv, bs, d), rnd(nb, hkv, bs, d)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if tables is None:
        tables = torch.randint(0, nb, (slots, tpr), generator=g,
                               device="cuda", dtype=torch.int32)
        used = -(-ln.long() // bs)
        tables[torch.arange(tpr, device="cuda")[None, :]
               >= used[:, None]] = -1
    tables = torch.as_tensor(tables, dtype=torch.int32, device="cuda")
    for row, entry, block in edits:
        tables[row, entry] = block
    got = attention.paged_flash_decode(q, k, v, tables, ln, window=window)
    again = attention.paged_flash_decode(q, k, v, tables, ln, window=window)
    want = attention.paged_flash_decode_reference(q, k, v, tables, ln,
                                                  window=window)
    torch.cuda.synchronize()
    err, share = err_over_tol(torch, got, want)
    deterministic = torch.equal(got, again)
    dname = str(dtype)
    vis = _paged_visible(torch, tables, ln, bs, window)
    ms = _time_ms(torch, lambda: attention.paged_flash_decode(
        q, k, v, tables, ln, window=window), flush)
    plain_ms = _time_ms(torch, lambda: attention.paged_flash_decode_reference(
        q, k, v, tables, ln, window=window), flush)
    # No single PyTorch call reads through a block table: the yardstick
    # is SDPA over rows gathered beforehand, the gather timed beside it.
    gather_ms = _time_ms(torch, lambda: (attention.gather_pool_rows(
        k, tables), attention.gather_pool_rows(v, tables)), flush)
    k_rows = attention.gather_pool_rows(k, tables)
    v_rows = attention.gather_pool_rows(v, tables)
    library_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k_rows, v_rows, attn_mask=vis[:, None, None, :],
        enable_gqa=True), flush)
    live = vis.sum(dim=1).tolist()
    bound_ms, bound_by = _bound_ms(slots, h, hkv, d, q.element_size(), live,
                                   dname, extra_bytes=tables.numel() * 4)
    splits, ctas = decode_split(slots, h, hkv)
    rec = dict(case=label, shape=[slots, h, hkv, nb, bs, tpr, d],
               dtype=dname, lengths=list(lengths), window=window,
               edits=[list(e) for e in edits], max_abs_err=err,
               err_over_tolerance=share, tolerance=TOL_REASON[dname], ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, gather_ms=gather_ms,
               bound_ms=bound_ms, bound_by=bound_by, live_keys=live,
               deterministic=deterministic, splits=splits, ctas=ctas)
    emit("paged_kernel_check", **rec)
    if not share <= 1.0:
        raise AssertionError(f"paged_flash_decode {label}: error {share} "
                             f"times its tolerance (max |err| {err})")
    if not deterministic:
        raise AssertionError(f"paged_flash_decode {label}: two calls on "
                             f"the same inputs differ")
    return rec


def phase_paged_kernel_checks(torch, F, attention, flush, main_tick,
                              draft_tick):
    """K4 in 20 cases; the first at the paged main path's shape with the
    block tables and lengths of its median decode tick; head_dim 96 and
    a GQA group of 64 among them; then the split's edges at bf16 d 64:
    parts whose blocks are all dead, and a row of each split edge; last,
    where the speculative engine's draft calls it: the draft pool's
    tables and lengths of its median draft step.  Every case is also
    run twice and must repeat bit for bit."""
    tpr = MAX_LEN // BLOCK_SIZE
    full = dict(slots=PAGED_SLOTS, h=16, hkv=2, bs=BLOCK_SIZE, tpr=tpr,
                nb=NUM_BLOCKS, d=64, dtype=torch.bfloat16)
    spread = [1, 300, 777, 1024] * 4
    edges = [0, 1, 16, 17] + [100, 129, 255, 256, 257, 511, 512, 513, 700,
                              1000, 1023, 1024]
    main_tables, main_lengths = main_tick
    cases = [
        dict(full, label="full-main-path", tables=main_tables,
             lengths=main_lengths),
        dict(full, label="edges", lengths=edges),
        # A -1 below row 1's length; row 2's entries 0 and 5 past the
        # pool (clamped to its last block and read).
        dict(full, label="dead-and-past-pool", lengths=spread,
             edits=((1, 3, -1), (5, 0, -1), (2, 0, NUM_BLOCKS),
                    (2, 5, NUM_BLOCKS + 40))),
        dict(full, label="window-256", window=256, lengths=spread),
        dict(full, label="window-256-dead", window=256, lengths=spread,
             edits=((3, 60, -1), (7, 50, -1))),
        dict(full, label="mha", hkv=16, lengths=spread),
        dict(full, label="mqa", hkv=1, lengths=spread),
        dict(full, label="bs-8", bs=8, tpr=MAX_LEN // 8, nb=2 * NUM_BLOCKS,
             lengths=edges),
        dict(full, label="bs-64", bs=64, tpr=MAX_LEN // 64,
             nb=NUM_BLOCKS // 4, lengths=edges),
        dict(full, label="f32-d128", d=128, dtype=torch.float32,
             lengths=spread),
        dict(full, label="f32-d128-bs-8-window", d=128, dtype=torch.float32,
             bs=8, tpr=MAX_LEN // 8, nb=2 * NUM_BLOCKS, window=100,
             lengths=edges, edits=((4, 1, -1),)),
        dict(full, label="d32", d=32, lengths=spread),
        dict(full, label="f32-d32-bs-8", d=32, dtype=torch.float32, bs=8,
             tpr=MAX_LEN // 8, nb=2 * NUM_BLOCKS, lengths=edges),
        dict(full, label="d256-window", d=256, window=256, lengths=spread,
             edits=((3, 60, -1),)),
        dict(full, label="f32-d256", d=256, dtype=torch.float32,
             lengths=spread),
        dict(full, label="d96-window", d=96, window=256, lengths=spread,
             edits=((3, 60, -1),)),
        dict(full, label="group64", h=64, hkv=1, lengths=spread),
        # Row 3's first 24 blocks dead (its first 3 parts of 8 blocks);
        # row 1's every block but its last.
        dict(full, label="parts-all-dead", lengths=spread,
             edits=tuple((3, e, -1) for e in range(24))
             + tuple((1, e, -1) for e in range(18))),
        dict(full, label="split-edges",
             lengths=[0, 1, 5, 128, 129, 16, 17, 1024] * 2),
        dict(full, label="spec-draft-tick", tables=draft_tick[0],
             lengths=draft_tick[1]),
    ]
    return [check_paged_case(torch, F, attention, flush, seed=100 + i, **c)
            for i, c in enumerate(cases)]


def _visible_pairs(s: int, causal: bool, window) -> int:
    """(query, key) pairs one head of a flash_attention call can see."""
    if not causal:
        return s * s
    w = s if window is None else min(window, s)
    # Query i sees min(i + 1, w) keys.
    return w * (w + 1) // 2 + (s - w) * w


def check_attn_case(torch, F, attention, flush, *, label, b, h, hkv, s, d,
                    dtype, causal=True, window=None, seed=0):
    """One K1 case: random q/k/v against flash_attention_reference (out
    with err_over_tol, lse within LSE_TOL), timed beside the plain
    version and SDPA with the same mask."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q, k, v = rnd(b, h, s, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d)
    kw = dict(causal=causal, window=window)
    out, lse = attention.flash_attention_forward(q, k, v, **kw)
    want, want_lse = attention.flash_attention_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    err, share = err_over_tol(torch, out, want)
    lse_err = (lse - want_lse).abs().max().item()
    dname = str(dtype)
    ms = _time_ms(torch, lambda: attention.flash_attention_forward(
        q, k, v, **kw), flush)
    plain_ms = _time_ms(torch, lambda: attention.flash_attention_reference(
        q, k, v, **kw), flush)
    if causal and window is not None:
        sdpa = dict(attn_mask=attention.causal_band_mask(s, window, "cuda"))
    else:
        sdpa = dict(is_causal=causal)
    library_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, enable_gqa=True, **sdpa), flush)
    elem = q.element_size()
    pairs = _visible_pairs(s, causal, window)
    moved = (2 * b * h + 2 * b * hkv) * s * d * elem + b * h * s * 4
    ops = 4 * d * b * h * pairs
    peak = BF16_OPS_PER_S if dname == "torch.bfloat16" else F32_OPS_PER_S
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / peak
    rec = dict(case=label, shape=[b, h, hkv, s, d], dtype=dname,
               causal=causal, window=window, max_abs_err=err,
               err_over_tolerance=share, tolerance=TOL_REASON[dname],
               lse_max_abs_err=lse_err, lse_tolerance=LSE_TOL, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               tflops=ops / ms * 1e-9, visible_pairs_per_head=pairs)
    emit("attn_kernel_check", **rec)
    if not share <= 1.0:
        raise AssertionError(f"flash_attention {label}: error {share} times "
                             f"its tolerance (max |err| {err})")
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"flash_attention {label}: lse off by "
                             f"{lse_err}")
    return rec


def phase_attn_kernel_checks(torch, F, attention, flush):
    """K1 in 17 cases; the first is the GQA generate path's prefill, the
    next two a layer of the training main path and of the long-sequence
    recipe; the last at head_dim 96 (run zero-padded to 128)."""
    main = dict(b=GEN_BATCH, h=16, hkv=2, s=GEN_PROMPT, d=64,
                dtype=torch.bfloat16)
    cases = [
        dict(main, label="main-path-prefill"),
        dict(main, label="train-main-path", b=TRAIN_BATCH, hkv=16, s=1024),
        dict(main, label="train-large", b=LARGE_BATCH, h=12, hkv=12, s=2048,
             d=128),
        dict(main, label="long-prompt", s=896),
        dict(main, label="seq-len", b=2, s=1024),
        dict(main, label="tail", b=2, s=1000),
        dict(main, label="s1", s=1),
        dict(main, label="s17", s=17),
        dict(main, label="window-256", b=2, s=1024, window=256),
        dict(main, label="window-1", b=2, s=300, window=1),
        dict(main, label="mha", b=2, hkv=16, s=512),
        dict(main, label="mqa", b=2, hkv=1, s=512),
        dict(main, label="non-causal", b=2, s=256, causal=False),
        dict(main, label="f32-d128", b=2, s=300, d=128, dtype=torch.float32),
        dict(main, label="f32-d32", b=2, s=200, d=32, dtype=torch.float32),
        dict(main, label="d256", b=2, s=333, d=256),
        dict(main, label="d96", b=2, s=1000, d=96, window=300),
    ]
    return [check_attn_case(torch, F, attention, flush, seed=200 + i, **c)
            for i, c in enumerate(cases)]


def _bwd_flops(b, h, d, pairs) -> dict:
    """Flops the backward needs, for the whole backward and for each of
    its two kernels: 2*d per visible (query head, key) pair for each
    product of d-long vectors, 5 for the backward (q.k, do.v, P.do, dS.q,
    dS.k), 3 for dq alone (q.k, do.v, dS.k), 4 for dk/dv alone (q.k,
    do.v, P.do, dS.q)."""
    return {name: products * 2 * d * b * h * pairs
            for name, products in (("all", 5), ("dq", 3), ("dkv", 4))}


def _bwd_bounds(b, h, hkv, s, d, elem, pairs, dtype_name):
    """Least times of the backward's work, as (ms, bound_by) for the
    whole backward and for each of its two kernels.  Bytes: each input
    read once and each output written once (q, out, do, dq over h heads;
    k, v, dk, dv over hkv; the f32 lse and delta); operations:
    :func:`_bwd_flops`."""
    peak = BF16_OPS_PER_S if dtype_name == "torch.bfloat16" \
        else F32_OPS_PER_S
    q_t, kv_t, row = b * h * s * d * elem, b * hkv * s * d * elem, b * h * s * 4
    moved = {"all": 4 * q_t + 4 * kv_t + 2 * row,
             "dq": 3 * q_t + 2 * kv_t + 2 * row,
             "dkv": 2 * q_t + 4 * kv_t + 2 * row}
    out = {}
    for name, flops in _bwd_flops(b, h, d, pairs).items():
        t_bytes = moved[name] / HBM_BYTES_PER_S
        t_ops = flops / peak
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def check_bwd_case(torch, F, attention, flush, *, label, b, h, hkv, s, d,
                   dtype, causal=True, window=None, seed=0):
    """One K2 case: random q, k, v and do, out and lse from K1; dq, dk
    and dv against flash_attention_backward_reference with
    grad_err_over_tol; each kernel timed alone and the whole backward
    (delta and both launches) beside the plain version and SDPA's
    backward with the same mask."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q, k, v, do = rnd(b, h, s, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d), \
        rnd(b, h, s, d)
    kw = dict(causal=causal, window=window)
    out, lse = attention.flash_attention_forward(q, k, v, **kw)
    got = attention.flash_attention_backward(q, k, v, out, lse, do, **kw)
    want = attention.flash_attention_backward_reference(q, k, v, out, lse,
                                                        do, **kw)
    torch.cuda.synchronize()
    errs = {name: grad_err_over_tol(torch, gt, wt)
            for name, gt, wt in zip(("dq", "dk", "dv"), got, want)}
    del got, want
    dname = str(dtype)
    delta = attention._delta(out, do)
    # Each kernel alone, through the same padding as the wrapper.
    args, pad = (q, k, v, do, lse, delta), (0, 1, 2, 3)
    ms_dq = _time_ms(torch, lambda: attention.call_padded(
        attention._bwd_dq, args, pad, **kw), flush)
    ms_dkv = _time_ms(torch, lambda: attention.call_padded(
        attention._bwd_dkv, args, pad, **kw), flush)
    ms = _time_ms(torch, lambda: attention.flash_attention_backward(
        q, k, v, out, lse, do, **kw), flush)
    plain_ms = _time_ms(
        torch, lambda: attention.flash_attention_backward_reference(
            q, k, v, out, lse, do, **kw), flush)
    if causal and window is not None:
        sdpa = dict(attn_mask=attention.causal_band_mask(s, window, "cuda"))
    else:
        sdpa = dict(is_causal=causal)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    lout = F.scaled_dot_product_attention(*leaves, enable_gqa=True, **sdpa)
    library_ms = _time_ms(torch, lambda: torch.autograd.grad(
        lout, leaves, do, retain_graph=True), flush)
    del lout, leaves
    pairs = _visible_pairs(s, causal, window)
    bounds = _bwd_bounds(b, h, hkv, s, d, q.element_size(), pairs, dname)
    flops = _bwd_flops(b, h, d, pairs)
    rec = dict(case=label, shape=[b, h, hkv, s, d], dtype=dname,
               causal=causal, window=window,
               max_abs_err={n: e[0] for n, e in errs.items()},
               err_over_tolerance={n: e[1] for n, e in errs.items()},
               tolerance=("bf16: 2^-5 of each row's largest |grad|; f32: "
                          "1e-4 of the tensor's largest |grad|; both at "
                          "least d * 2^-20 (f32 noise of dP - delta where "
                          "dS cancels to 0)"),
               ms=ms, ms_dq=ms_dq, ms_dkv=ms_dkv, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bounds["all"][0],
               bound_by=bounds["all"][1], bound_ms_dq=bounds["dq"][0],
               bound_by_dq=bounds["dq"][1], bound_ms_dkv=bounds["dkv"][0],
               bound_by_dkv=bounds["dkv"][1],
               tflops=flops["all"] / ms * 1e-9,
               tflops_dq=flops["dq"] / ms_dq * 1e-9,
               tflops_dkv=flops["dkv"] / ms_dkv * 1e-9,
               visible_pairs_per_head=pairs)
    emit("bwd_kernel_check", **rec)
    worst = max(e[1] for e in errs.values())
    if not worst <= 1.0:
        raise AssertionError(f"flash_attention backward {label}: error "
                             f"{rec['err_over_tolerance']} of its "
                             f"tolerance (max |err| {rec['max_abs_err']})")
    return rec


def phase_bwd_kernel_checks(torch, F, attention, flush):
    """K2 in 14 cases; the first is a layer of the training main path,
    the second a layer of the long-sequence recipe; the last at head_dim
    96 (run zero-padded to 128)."""
    gqa = dict(b=2, h=16, hkv=2, s=512, d=64, dtype=torch.bfloat16)
    cases = [
        dict(label="train-main-path", b=TRAIN_BATCH, h=16, hkv=16, s=1024,
             d=64, dtype=torch.bfloat16),
        dict(label="train-large", b=LARGE_BATCH, h=12, hkv=12, s=2048, d=128,
             dtype=torch.bfloat16),
        dict(gqa, label="gqa8"),
        dict(gqa, label="mqa", hkv=1),
        dict(gqa, label="window-256", s=1024, window=256),
        dict(gqa, label="window-1", s=300, window=1),
        dict(gqa, label="non-causal", s=256, causal=False),
        dict(gqa, label="s1", b=8, s=1),
        dict(gqa, label="s17", b=8, s=17),
        dict(gqa, label="tail", s=1000),
        dict(gqa, label="f32-d128", s=300, d=128, dtype=torch.float32),
        dict(gqa, label="f32-d32", s=200, d=32, dtype=torch.float32),
        dict(gqa, label="d256", s=333, d=256),
        dict(gqa, label="d96", s=700, d=96, window=300),
    ]
    return [check_bwd_case(torch, F, attention, flush, seed=300 + i, **c)
            for i, c in enumerate(cases)]


def _requests(serving, np, cfg, prompt_lens=PROMPT_LENS):
    rng = np.random.default_rng(0)
    return [serving.Request(
        prompt=rng.integers(0, cfg.vocab, (n,)).astype(np.int32),
        max_new_tokens=NEW_TOKENS) for n in prompt_lens]


def _served(reqs) -> None:
    if not all(r.done and len(r.generated) == r.max_new_tokens
               for r in reqs):
        raise AssertionError("main path left requests unserved")


def _serve_all(eng, reqs) -> float:
    import torch

    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    _served(reqs)
    return dt


def _serve_ticks(eng, reqs, check=False) -> tuple[float, int]:
    """Serve ``reqs`` to the end, tick by tick: (wall seconds, peak
    count of sequences holding a slot after a tick); with ``check``,
    the engine's block accounting must hold after every tick."""
    import torch

    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    peak = 0
    while not eng.idle:
        eng.tick()
        if check:
            eng.check_accounting()
        peak = max(peak, eng.stats().active)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    _served(reqs)
    return dt, peak


def _agreement(reqs, ereqs) -> tuple[int, list[int]]:
    """Free-running greedy agreement of two engines on one traffic:
    (tokens equal position by position, each request's equal prefix,
    i.e. the step at which it first diverges)."""
    agree = sum(int(a == b) for r, e in zip(reqs, ereqs)
                for a, b in zip(r.generated, e.generated))
    prefixes = [next((i for i, (a, b) in enumerate(
        zip(r.generated, e.generated)) if a != b), len(r.generated))
        for r, e in zip(reqs, ereqs)]
    return agree, prefixes


def _compare_tick(torch, logits, want, rows) -> dict:
    """One tick's kernel-route logits against the einsum route's on the
    same inputs: |dlogits| over the active rows, whether every logit is
    finite, and teacher-forced greedy agreement: rows whose argmax
    differs (flips), with the einsum route's top-2 gap and the row's
    largest |dlogits| at each, and the near ties, rows whose top-2 gap
    is under twice their largest |dlogits| (only those can flip)."""
    got, ref = logits[rows].float(), want[rows].float()
    dl = (got - ref).abs()
    row_max = dl.amax(dim=-1)
    top = ref.topk(2, dim=-1).values
    gap = top[:, 0] - top[:, 1]
    flip = got.argmax(dim=-1) != ref.argmax(dim=-1)
    near = int((gap < 2 * row_max).sum())
    return dict(mean=dl.mean().item(), max=dl.max().item(),
                finite=bool(torch.isfinite(logits).all()),
                rows=int(rows.numel()), near_ties=near,
                flips=list(zip(gap[flip].tolist(), row_max[flip].tolist())))


def _compare_record(ticks: list[dict], firsts: list[int]) -> dict:
    """The einsum comparison of a warm pass: |dlogits| over its first
    COMPARE_TICKS ticks, teacher-forced agreement over all of them, and
    the free-running first divergence of each request."""
    head = ticks[:COMPARE_TICKS]
    flips = [f for c in ticks for f in c["flips"]]
    return dict(
        compare_ticks=len(head),
        dlogits_mean=statistics.fmean(c["mean"] for c in head),
        dlogits_max=max(c["max"] for c in head),
        teacher_forced=dict(
            ticks=len(ticks), rows=sum(c["rows"] for c in ticks),
            argmax_equal=sum(c["rows"] for c in ticks) - len(flips),
            near_ties=sum(c["near_ties"] for c in ticks),
            dlogits_max=max(c["max"] for c in ticks),
            flips_gap_and_dlogits=sorted(flips)),
        greedy_first_divergence=firsts)


def phase_main_path(torch, np, attention, model, serving):
    """The server at full width: warm pass (with the einsum route on
    identical inputs every tick), then the timed pass whose kernel
    launches are counted, then the same traffic through an einsum-route
    engine for free-running greedy agreement."""
    import dataclasses

    cfg = model.ModelConfig(**FULL)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg, "cuda")
    eng = serving.ContinuousBatcher(params, cfg, slots=SLOTS,
                                    max_len=MAX_LEN, chunk=CHUNK,
                                    device="cuda")
    ecfg = dataclasses.replace(cfg, attention="einsum")
    einsum_step = serving.make_slot_decode_step(ecfg)
    kernel_step = eng._decode
    diffs, tick_lengths = [], []

    def compared_step(p, cache, tokens, active):
        # Same cache, tokens and mask through the einsum path first, every
        # tick (teacher-forced: both routes see the kernel route's tokens).
        tick_lengths.append((cache.lengths + 1).tolist())
        ref = serving.SlotKVCache(cache.k.clone(), cache.v.clone(),
                                  cache.lengths.clone())
        want, _ = einsum_step(p, ref, tokens, active)
        logits, cache = kernel_step(p, cache, tokens, active)
        diffs.append(_compare_tick(torch, logits, want,
                                   active.nonzero()[:, 0]))
        return logits, cache

    eng._decode = compared_step
    warm_s = _serve_all(eng, _requests(serving, np, cfg))
    eng._decode = kernel_step

    reqs = _requests(serving, np, cfg)
    ticks0, steps0 = eng.ticks, eng.decode_steps
    attention.reset_launch_counts()
    dt = _serve_all(eng, reqs)
    launches = dict(attention.LAUNCHES)
    steps = eng.decode_steps - steps0
    want_launches = steps * cfg.n_layers
    decoded = sum(len(r.generated) for r in reqs)

    eeng = serving.ContinuousBatcher(params, ecfg, slots=SLOTS,
                                     max_len=MAX_LEN, chunk=CHUNK,
                                     device="cuda")
    ereqs = _requests(serving, np, cfg)
    einsum_s = _serve_all(eeng, ereqs)
    agree, firsts = _agreement(reqs, ereqs)
    # The launch pattern of a tick in the middle of the run: the shape
    # the kernel timing below uses.
    by_live = sorted(tick_lengths, key=sum)
    mid_lengths = by_live[len(by_live) // 2]
    rec = dict(
        config=FULL, dtype="bfloat16", slots=SLOTS, max_len=MAX_LEN,
        chunk=CHUNK, prompt_lens=PROMPT_LENS, new_tokens=NEW_TOKENS,
        warm_seconds=warm_s, seconds=dt, ticks=eng.ticks - ticks0,
        decode_steps=steps, decoded_tokens=decoded,
        decode_tokens=eng.decode_tokens, tokens_per_s=decoded / dt,
        flash_decode_launches=launches["flash_decode"],
        expected_launches=want_launches, einsum_seconds=einsum_s,
        einsum_tokens_per_s=decoded / einsum_s,
        **_compare_record(diffs, firsts),
        greedy_tokens_agree=agree, greedy_prefix_agree=sum(firsts),
        greedy_tokens_total=decoded, mid_tick_lengths=mid_lengths)
    emit("main_path", **rec)
    if launches["flash_decode"] != want_launches or want_launches == 0:
        raise AssertionError(
            f"flash_decode launched {launches['flash_decode']} times, "
            f"want decode steps x layers = {want_launches}")
    if not all(c["finite"] for c in diffs):
        raise AssertionError("non-finite logits on the main path")
    if not rec["dlogits_max"] < DLOGITS_MAX:
        raise AssertionError(f"kernel route logits differ from the einsum "
                             f"route by {rec['dlogits_max']}")
    return rec, eng


def phase_paged_main_path(torch, np, attention, model, serving, paged):
    """The paged-KV server at full width: warm pass (with the einsum
    gather route on identical inputs every tick), then the timed pass
    whose kernel launches are counted, then the same traffic through an
    einsum-route engine for free-running greedy agreement."""
    import dataclasses

    cfg = model.ModelConfig(**FULL)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg, "cuda")
    geometry = dict(slots=PAGED_SLOTS, max_len=MAX_LEN,
                    block_size=BLOCK_SIZE, num_blocks=NUM_BLOCKS,
                    chunk=CHUNK, prefill_lanes=PREFILL_LANES)
    eng = paged.PagedBatcher(params, cfg, device="cuda", **geometry)
    ecfg = dataclasses.replace(cfg, attention="einsum")
    einsum_step = paged.make_paged_decode_step(ecfg, MAX_LEN)
    kernel_step = eng._decode
    diffs, ticks_seen, rows = [], [], {}
    warm = _requests(serving, np, cfg, PAGED_PROMPT_LENS)
    index = {id(r): n for n, r in enumerate(warm)}

    def compared_step(p, cache, tables, tokens, active):
        # The kernel's inputs this tick (lengths after the write), then
        # the same cache, tables, tokens and mask through the einsum
        # route first, every tick (teacher-forced).  The kernel route's
        # logits rows are kept for the speculative paths' comparison.
        ticks_seen.append((tables.clone(), (cache.lengths + 1).tolist()))
        ref = paged.PagedKVCache(cache.k.clone(), cache.v.clone(),
                                 cache.lengths.clone())
        want, _ = einsum_step(p, ref, tables, tokens, active)
        logits, cache = kernel_step(p, cache, tables, tokens, active)
        diffs.append(_compare_tick(torch, logits, want,
                                   active.nonzero()[:, 0].to(logits.device)))
        _note_plain_rows(eng, logits, active, index, rows)
        return logits, cache

    eng._decode = compared_step
    warm_s = _serve_all(eng, warm)
    eng._decode = kernel_step

    reqs = _requests(serving, np, cfg, PAGED_PROMPT_LENS)
    ticks0, steps0, pre0 = eng.ticks, eng.decode_steps, eng.preemptions
    attention.reset_launch_counts()
    dt, peak = _serve_ticks(eng, reqs)
    launches = dict(attention.LAUNCHES)
    steps = eng.decode_steps - steps0
    preemptions = eng.preemptions - pre0
    want_launches = steps * cfg.n_layers
    decoded = sum(len(r.generated) for r in reqs)
    if eng.allocator.used_blocks != 0:
        raise AssertionError(f"drained paged engine holds "
                             f"{eng.allocator.used_blocks} blocks")

    eeng = paged.PagedBatcher(params, ecfg, device="cuda", **geometry)
    ereqs = _requests(serving, np, cfg, PAGED_PROMPT_LENS)
    einsum_s = _serve_all(eeng, ereqs)
    agree, firsts = _agreement(reqs, ereqs)
    by_live = sorted(ticks_seen, key=lambda t: sum(t[1]))
    mid_tables, mid_lengths = by_live[len(by_live) // 2]
    rec = dict(
        config=FULL, dtype="bfloat16", **geometry,
        prompt_lens=PAGED_PROMPT_LENS, new_tokens=NEW_TOKENS,
        warm_seconds=warm_s, seconds=dt, ticks=eng.ticks - ticks0,
        decode_steps=steps, decoded_tokens=decoded,
        decode_tokens=eng.decode_tokens, tokens_per_s=decoded / dt,
        preemptions=preemptions, peak_concurrent_sequences=peak,
        paged_flash_decode_launches=launches["paged_flash_decode"],
        flash_decode_launches=launches["flash_decode"],
        expected_launches=want_launches, einsum_seconds=einsum_s,
        einsum_tokens_per_s=decoded / einsum_s,
        einsum_preemptions=eeng.preemptions,
        **_compare_record(diffs, firsts),
        greedy_tokens_agree=agree, greedy_prefix_agree=sum(firsts),
        greedy_tokens_total=decoded, mid_tick_lengths=mid_lengths)
    emit("paged_main_path", **rec)
    if launches["paged_flash_decode"] != want_launches or want_launches == 0:
        raise AssertionError(
            f"paged_flash_decode launched "
            f"{launches['paged_flash_decode']} times, want decode steps x "
            f"layers = {want_launches}")
    if launches["flash_decode"] != 0:
        raise AssertionError(f"flash_decode launched "
                             f"{launches['flash_decode']} times on the "
                             f"paged path")
    if preemptions == 0:
        raise AssertionError("the paged main path never preempted")
    if not all(c["finite"] for c in diffs):
        raise AssertionError("non-finite logits on the paged main path")
    if not rec["dlogits_max"] < DLOGITS_MAX:
        raise AssertionError(f"kernel route logits differ from the einsum "
                             f"gather route by {rec['dlogits_max']}")
    return (rec, (mid_tables, mid_lengths), eng,
            ([r.generated for r in warm], rows))


def phase_profile(torch, np, serving, eng, path, prompt_lens, syncs=None):
    """Where a steady window of a main path spends device time:
    torch.profiler over PROFILE_TICKS engine ticks (after 5 warm ones)
    of a fresh pass of the same traffic.  ``syncs``: counters of the
    engine's host copies of logits, zeroed for the window and
    reported with it."""
    from torch.profiler import ProfilerActivity, profile

    for r in _requests(serving, np, eng.cfg, prompt_lens):
        eng.submit(r)
    for _ in range(5):
        eng.tick()
    torch.cuda.synchronize()
    for name in syncs or ():
        syncs[name] = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_TICKS):
            eng.tick()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    window = dict(syncs or {})
    eng.run()
    _emit_profile(path, "ticks", PROFILE_TICKS, prof, wall_ms,
                  host_logit_syncs=window or None)


def _emit_profile(path, unit, count, prof, wall_ms, **extra) -> dict:
    """Device busy time, idle share and the top kernels of a window of
    ``count`` engine ticks, decode steps or train steps (``unit``)."""
    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    rec = dict(path=path, **{unit: count}, profiled_wall_ms=wall_ms,
               device_busy_ms=busy_ms if busy_ms > 0 else None,
               kernel_launches=sum(e.count for e in kernels),
               device_idle_share=(1 - busy_ms / wall_ms) if busy_ms > 0
               else None,
               top_kernels=[dict(name=e.key[:90], device_ms=dev_us(e) / 1e3,
                                 calls=e.count) for e in top],
               **{k: v for k, v in extra.items() if v is not None})
    emit("profile", **rec)
    return rec


def _wall(torch, fn):
    """(seconds, result) of one call, synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _decode_diffs(torch, decode, params, prompt, kcfg, ecfg, max_len):
    """The kernel route against the einsum route on identical inputs:
    prefill's logits over every [b, s] position (K1's check on the
    path), then COMPARE_TICKS decode steps, each from a copy of the
    kernel route's cache and the same token.  Returns (prefill max
    |dlogits|, whether prefill's logits are finite, [(mean, max,
    finite)] per step)."""
    logits, cache = decode.prefill(params, prompt, kcfg, max_len)
    want, _ = decode.prefill(params, prompt, ecfg, max_len)
    prefill_max = (logits - want).abs().max().item()
    finite = bool(torch.isfinite(logits).all())
    del want
    token = torch.argmax(logits[:, -1], -1).to(torch.int32)
    diffs = []
    for _ in range(COMPARE_TICKS):
        ref = decode.KVCache(cache.k.clone(), cache.v.clone(), cache.length)
        want, _ = decode.decode_step(params, ref, token, ecfg)
        logits, cache = decode.decode_step(params, cache, token, kcfg)
        dl = (logits - want).abs()
        diffs.append((dl.mean().item(), dl.max().item(),
                      bool(torch.isfinite(logits).all())))
        token = torch.argmax(logits, -1).to(torch.int32)
    return prefill_max, finite, diffs


def phase_generate_main_path(torch, np, attention, model, decode, label,
                             arch, prompt_len, steps):
    """decode.generate at full width through its public API: a warm
    call, the kernel route against the einsum route on identical inputs
    (prefill logits and COMPARE_TICKS decode steps), then GEN_REPS timed
    calls, each with the launch counts zeroed just before and read just
    after (K1 once per layer, K3 once per layer per decode step, K4
    never), timed as bench_tpu.py:465-486 does (prefill alone, then the
    whole call, and the difference); then the einsum route's generate
    for its time and greedy agreement."""
    import dataclasses

    cfg = model.ModelConfig(**arch)
    ecfg = dataclasses.replace(cfg, attention="einsum")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg, "cuda")
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (GEN_BATCH, prompt_len)).astype(np.int32)).cuda()
    max_len = prompt_len + steps

    def run(c):
        return decode.generate(params, prompt, c, steps)

    def prefill_alone():
        return decode.prefill(model.cast_params(params, cfg.dtype, "cuda"),
                              prompt, cfg, max_len)[0]

    warm_s, _ = _wall(torch, lambda: run(cfg))
    cast = model.cast_params(params, cfg.dtype, "cuda")
    prefill_max, prefill_finite, diffs = _decode_diffs(
        torch, decode, cast, prompt, cfg, ecfg, max_len)
    del cast
    want = {"flash_attention": cfg.n_layers,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
            "flash_decode": (steps - 1) * cfg.n_layers,
            "paged_flash_decode": 0, **dict.fromkeys(RING_KERNELS, 0)}
    gen_s, pf_s, launches = [], [], []
    for _ in range(GEN_REPS):
        pf_s.append(_wall(torch, prefill_alone)[0])
        attention.reset_launch_counts()
        dt, out = _wall(torch, lambda: run(cfg))
        launches.append(dict(attention.LAUNCHES))
        gen_s.append(dt)
    gen_dt, pf_dt = statistics.fmean(gen_s), statistics.fmean(pf_s)
    decode_dt = gen_dt - pf_dt
    einsum_pf = statistics.fmean(
        _wall(torch, lambda: decode.prefill(
            model.cast_params(params, cfg.dtype, "cuda"), prompt, ecfg,
            max_len)[0])[0] for _ in range(GEN_REPS))
    einsum_s, eout = _wall(torch, lambda: run(ecfg))
    gen = out[:, prompt_len:]
    egen = eout[:, prompt_len:]
    equal = (gen == egen).cpu()
    prefix = sum(steps if bool(row.all()) else int((~row).nonzero()[0])
                 for row in equal)
    rec = dict(
        shape=label, config=arch, dtype="bfloat16", batch=GEN_BATCH,
        prompt_len=prompt_len, steps=steps, max_len=max_len,
        warm_seconds=warm_s, generate_seconds=gen_s, prefill_seconds=pf_s,
        prefill_ms=pf_dt * 1e3, decode_ms_per_step=decode_dt / steps * 1e3,
        decode_tokens_per_s=GEN_BATCH * steps / decode_dt,
        einsum_prefill_ms=einsum_pf * 1e3, einsum_generate_seconds=einsum_s,
        einsum_decode_ms_per_step=(einsum_s - einsum_pf) / steps * 1e3,
        einsum_decode_tokens_per_s=GEN_BATCH * steps / (einsum_s - einsum_pf),
        launches=launches[-1], expected_launches=want,
        prefill_dlogits_max=prefill_max, compare_steps=len(diffs),
        dlogits_mean=statistics.fmean(d[0] for d in diffs),
        dlogits_max=max(d[1] for d in diffs),
        greedy_tokens_agree=int(equal.sum()), greedy_prefix_agree=prefix,
        greedy_tokens_total=GEN_BATCH * steps)
    emit("generate_main_path", **rec)
    if any(n != want for n in launches):
        raise AssertionError(f"generate ({label}) launched {launches}, "
                             f"want {want} per call")
    if not (prefill_finite and all(d[2] for d in diffs)
            and bool(torch.isfinite(out).all())):
        raise AssertionError(f"non-finite logits on the generate path "
                             f"({label})")
    if not (prefill_max < DLOGITS_MAX and rec["dlogits_max"] < DLOGITS_MAX):
        raise AssertionError(
            f"generate ({label}): kernel route logits differ from the "
            f"einsum route by {prefill_max} (prefill), "
            f"{rec['dlogits_max']} (decode)")
    if not decode_dt > 0:
        raise AssertionError(f"generate ({label}) took no longer than its "
                             f"prefill: {gen_dt} s vs {pf_dt} s")
    return rec, params, prompt, cfg


def phase_generate_profile(torch, model, decode, params, prompt, cfg, steps):
    """Where PROFILE_TICKS decode steps of the GQA generate call spend
    device time: the step loop of decode.generate, after prefill and 5
    warm steps, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    cast = model.cast_params(params, cfg.dtype, "cuda")
    logits, cache = decode.prefill(cast, prompt, cfg, prompt.shape[1] + steps)
    token = torch.argmax(logits[:, -1], -1).to(torch.int32)
    for _ in range(5):
        logits, cache = decode.decode_step(cast, cache, token, cfg)
        token = torch.argmax(logits, -1).to(torch.int32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_TICKS):
            logits, cache = decode.decode_step(cast, cache, token, cfg)
            token = torch.argmax(logits, -1).to(torch.int32)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _emit_profile("generate", "decode_steps", PROFILE_TICKS, prof, wall_ms)


def _draft(params, layers):
    """The draft model: the target's first ``layers`` layers (the
    blocks hold stacked [n_layers, ...] tensors)."""
    return {**params, "blocks": {name: w[:layers]
                                 for name, w in params["blocks"].items()}}


def _verify_entry(row):
    """What a speculative token's check needs of the verify logits
    ``row`` [vocab] that emitted it: (top-1 minus top-2, top-1, argmax,
    the row itself)."""
    import torch

    r = torch.as_tensor(row).float()
    top = r.topk(2).values.tolist()
    return top[0] - top[1], top[0], int(torch.argmax(r)), row


def _bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


def _near_tie(gap, dl) -> bool:
    """Whether rounding alone explains a divergence: the verify top-2
    gap is at most twice the largest |dlogits| between the two routes'
    rows that chose the token, and those differ by rounding only."""
    return (gap is not None and dl is not None and dl <= DLOGITS_MAX
            and gap <= 2 * dl)


def _note_plain_rows(eng, logits, active, index, rows) -> None:
    """Keep each active slot's decode logits row in ``rows``, keyed
    (traffic index of its request, generated index of the token it
    chooses); a re-run after preemption overwrites."""
    for i in active.nonzero()[:, 0].tolist():
        req = eng._slots[i].request
        rows[(index[id(req)], len(req.generated))] = logits[i]


def _watch_plain_rows(eng, index, rows):
    """Wrap a PagedBatcher's decode step to keep its logits rows (see
    _note_plain_rows).  Returns restore."""
    step = eng._decode

    def watched(p, cache, tables, tokens, active):
        logits, cache = step(p, cache, tables, tokens, active)
        _note_plain_rows(eng, logits, active, index, rows)
        return logits, cache

    eng._decode = watched

    def restore():
        eng._decode = step
    return restore


def _watch_spec_engine(eng, index=None, rows=None, draft_ticks=None):
    """Wrap a SpeculativePagedBatcher's draft step, verify call, draft
    replay and accept decision.  Returns (syncs, replays, restore):
    ``syncs`` counts the draft steps and verify calls (each copies its
    logits to the host: [slots, vocab] and [slots, k+1, vocab] f32),
    ``replays`` the one-token draft replays and those that open a new
    block.  While ``rows`` is given, it maps (traffic index from
    ``index``, generated index) to _verify_entry of the verify logits
    that emitted that token (a re-run after preemption overwrites), and
    ``draft_ticks`` collects each draft step's tables and lengths after
    its write."""
    syncs = {"draft_decode": 0, "verify": 0}
    replays = {"replays": 0, "replays_at_block_start": 0}
    d_step, verify, replay, accept = (eng._d_decode, eng._verify,
                                      eng._d_replay, eng._accept_row)

    def draft_step(p, cache, tables, tokens, active):
        syncs["draft_decode"] += 1
        if draft_ticks is not None:
            draft_ticks.append((tables.clone(), (cache.lengths + 1).tolist()))
        return d_step(p, cache, tables, tokens, active)

    def verify_step(p, cache, tables, tokens, offsets, n_valid):
        syncs["verify"] += 1
        return verify(p, cache, tables, tokens, offsets, n_valid)

    def replay_step(p, cache, tables, tokens, offsets, n_valid):
        live = n_valid > 0
        replays["replays"] += int(live.sum())
        replays["replays_at_block_start"] += int(
            (live & (offsets % eng.block_size == 0)).sum())
        return replay(p, cache, tables, tokens, offsets, n_valid)

    def accept_row(T, drafts_i, qs_i, req, k_eff):
        emitted, n_acc = accept(T, drafts_i, qs_i, req, k_eff)
        if rows is not None:
            n = len(req.generated)
            for j in range(len(emitted)):
                rows[(index[id(req)], n + j)] = _verify_entry(T[j].copy())
        return emitted, n_acc

    eng._d_decode, eng._verify = draft_step, verify_step
    eng._d_replay, eng._accept_row = replay_step, accept_row

    def restore():
        eng._d_decode, eng._verify = d_step, verify
        eng._d_replay, eng._accept_row = replay, accept
    return syncs, replays, restore


def _divergences(keys, got, want, spec_rows, plain_rows) -> list[dict]:
    """Each sequence's first divergence from the plain route's tokens
    (none where they agree): the verify logits' top-2 gap and top logit
    there, that gap in bf16 ulps of the top logit, the largest |dlogits|
    between the verify row and the plain route's row (``spec_rows``
    holds _verify_entry, ``plain_rows`` the rows, both keyed (key,
    generated index)), and whether it is a near tie (_near_tie)."""
    import torch

    out = []
    for key, a, b in zip(keys, got, want):
        a, b = [int(t) for t in a], [int(t) for t in b]
        at = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                  None if len(a) == len(b) else min(len(a), len(b)))
        if at is None:
            continue
        spec, plain = spec_rows.get((key, at)), plain_rows.get((key, at))
        gap = top = dl = None
        if spec is not None:
            gap, top = spec[0], spec[1]
            if plain is not None:
                dl = (torch.as_tensor(spec[3]).float().cpu()
                      - plain.float().cpu()).abs().max().item()
        out.append(dict(sequence=key, index=at, verify_top2_gap=gap,
                        verify_top1=top,
                        gap_bf16_ulps=None if top is None
                        else gap / _bf16_ulp(top),
                        row_dlogits_max=dl, near_tie=_near_tie(gap, dl)))
    return out


def _argmax_faults(keys, got, spec_rows) -> list[tuple]:
    """Greedy speculative tokens after the first (which prefill emits)
    that are not the argmax of the verify logits that emitted them, or
    that no verify call emitted: (key, index, token, argmax or None)."""
    faults = []
    for key, toks in zip(keys, got):
        for g in range(1, len(toks)):
            entry = spec_rows.get((key, g))
            if entry is None or entry[2] != int(toks[g]):
                faults.append((key, g, int(toks[g]),
                               None if entry is None else entry[2]))
    return faults


def _spec_counters(eng) -> dict:
    return {n: getattr(eng, n) for n in (
        "ticks", "preemptions", "verify_passes", "drafted_tokens",
        "accepted_tokens", "decode_tokens")}


def _spec_economics(before, after) -> dict:
    d = {n: after[n] - before[n] for n in after}
    return dict(d, accept_rate=d["accepted_tokens"]
                / max(1, d["drafted_tokens"]),
                target_pass_ratio=d["verify_passes"]
                / max(1, d["decode_tokens"]))


def _spec_agreement(keys, got, want, spec_rows, plain_rows) -> dict:
    """Greedy speculative tokens ``got`` against the plain route's
    ``want``, sequence by sequence: tokens equal position by position,
    each first divergence (_divergences) and every token that is not the
    argmax of the verify logits that emitted it (_argmax_faults)."""
    return dict(
        tokens_equal=sum(int(a == b) for g, w in zip(got, want)
                         for a, b in zip(g, w)),
        tokens_total=sum(len(g) for g in got),
        first_divergences=_divergences(keys, got, want, spec_rows,
                                       plain_rows),
        not_verify_argmax=_argmax_faults(keys, got, spec_rows),
        near_tie_rule=f"verify top-2 gap <= 2 x the rows' max |dlogits| "
                      f"<= {2 * DLOGITS_MAX}")


def _check_agreement(what: str, agreement: dict) -> None:
    if agreement["not_verify_argmax"]:
        raise AssertionError(
            f"{what}: tokens that are not the argmax of the verify logits "
            f"that emitted them: {agreement['not_verify_argmax'][:8]}")
    bad = [d for d in agreement["first_divergences"] if not d["near_tie"]]
    if bad:
        raise AssertionError(f"{what} diverges from the plain route away "
                             f"from a near tie: {bad}")


def _spec_engine(torch, model, spec_serving, draft_layers):
    """The speculative paged engine on the paged cell's model (random
    weights, seed 0) and pool; the draft is the target's first
    ``draft_layers`` layers."""
    import dataclasses

    cfg = model.ModelConfig(**FULL)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg, "cuda")
    geometry = dict(slots=PAGED_SLOTS, max_len=MAX_LEN,
                    block_size=BLOCK_SIZE, num_blocks=NUM_BLOCKS,
                    chunk=CHUNK, prefill_lanes=PREFILL_LANES)
    eng = spec_serving.SpeculativePagedBatcher(
        params, cfg, _draft(params, draft_layers),
        dataclasses.replace(cfg, n_layers=draft_layers), k=SPEC_K,
        device="cuda", **geometry)
    return eng, cfg, geometry


def phase_spec_main_path(torch, np, attention, model, serving, spec_serving,
                         plain):
    """The speculative paged engine at full serving width: the paged
    cell's model and traffic, the draft the target's first layer, k 4.
    A warm pass (block accounting checked every tick) records each
    emitted token's verify logits and the draft's decode inputs; its
    greedy tokens are held against the plain paged engine's (``plain``:
    its warm pass's tokens and decode logits rows, the K4 route), each
    request's first divergence must be a near tie and every token the
    argmax of its verify logits.  Then the timed pass, accounting
    checked every tick, with the launch counts zeroed just before and
    read just after: K4 once per draft layer per draft step, K1 and K3
    never."""
    eng, cfg, geometry = _spec_engine(torch, model, spec_serving,
                                      DRAFT_LAYERS)
    warm = _requests(serving, np, cfg, PAGED_PROMPT_LENS)
    spec_rows, draft_ticks = {}, []
    _, _, restore = _watch_spec_engine(
        eng, {id(r): n for n, r in enumerate(warm)}, spec_rows, draft_ticks)
    warm_s, _ = _serve_ticks(eng, warm, check=True)
    restore()
    syncs, _, _ = _watch_spec_engine(eng)

    reqs = _requests(serving, np, cfg, PAGED_PROMPT_LENS)
    before = _spec_counters(eng)
    attention.reset_launch_counts()
    dt, peak = _serve_ticks(eng, reqs, check=True)
    launches = dict(attention.LAUNCHES)
    econ = _spec_economics(before, _spec_counters(eng))
    pass_syncs = dict(syncs)
    if eng.allocator.used_blocks or eng.d_allocator.used_blocks:
        raise AssertionError("drained speculative engine holds blocks")
    decoded = sum(len(r.generated) for r in reqs)
    want_k4 = pass_syncs["draft_decode"] * DRAFT_LAYERS
    agreement = _spec_agreement(range(len(warm)), [r.generated for r in warm],
                                plain[0], spec_rows, plain[1])
    by_live = sorted(draft_ticks, key=lambda t: sum(t[1]))
    draft_tick = by_live[len(by_live) // 2]
    rec = dict(
        config=FULL, draft_layers=DRAFT_LAYERS, k=SPEC_K, dtype="bfloat16",
        **geometry, prompt_lens=PAGED_PROMPT_LENS, new_tokens=NEW_TOKENS,
        warm_seconds=warm_s, seconds=dt, **econ,
        verify_passes_per_tick=econ["verify_passes"] / econ["ticks"],
        decoded_tokens=decoded, tokens_per_s=decoded / dt,
        peak_concurrent_sequences=peak, accounting_checked_every_tick=True,
        host_logit_syncs=pass_syncs,
        paged_flash_decode_launches=launches["paged_flash_decode"],
        flash_decode_launches=launches["flash_decode"],
        flash_attention_launches=launches["flash_attention"],
        expected_paged_flash_decode_launches=want_k4,
        plain_engine_agreement=agreement,
        draft_tick_lengths=draft_tick[1])
    emit("spec_main_path", **rec)
    if launches["paged_flash_decode"] != want_k4 or want_k4 == 0:
        raise AssertionError(
            f"paged_flash_decode launched {launches['paged_flash_decode']} "
            f"times, want draft steps x draft layers = {want_k4}")
    if launches["flash_decode"] or launches["flash_attention"]:
        raise AssertionError(f"K1/K3 launched on the speculative paged "
                             f"path: {launches}")
    if not 0 < econ["verify_passes"] <= econ["ticks"]:
        raise AssertionError(f"{econ['verify_passes']} verify passes in "
                             f"{econ['ticks']} ticks")
    _check_agreement("speculative engine", agreement)
    return rec, draft_tick, eng, syncs


def phase_spec_self_draft(torch, np, attention, model, serving, spec_serving,
                          plain):
    """The speculative engine at full serving width with a draft that
    accepts: the target drafts for itself (all its layers, through K4),
    so rounds accept several tokens, replay the draft on full acceptance
    and reserve k_eff + 1 draft positions, under the paged cell's pool,
    traffic and preemptions.  One pass, block accounting checked every
    tick, launch counts zeroed just before and read just after (K4 once
    per layer per draft step, K1 and K3 never); its greedy tokens held
    against the plain engine's (``plain``) as in spec_main_path."""
    eng, cfg, geometry = _spec_engine(torch, model, spec_serving,
                                      FULL["n_layers"])
    reqs = _requests(serving, np, cfg, PAGED_PROMPT_LENS)
    spec_rows = {}
    syncs, replays, restore = _watch_spec_engine(
        eng, {id(r): n for n, r in enumerate(reqs)}, spec_rows)
    before = _spec_counters(eng)
    attention.reset_launch_counts()
    dt, peak = _serve_ticks(eng, reqs, check=True)
    launches = dict(attention.LAUNCHES)
    restore()
    econ = _spec_economics(before, _spec_counters(eng))
    if eng.allocator.used_blocks or eng.d_allocator.used_blocks:
        raise AssertionError("drained speculative engine holds blocks")
    want_k4 = syncs["draft_decode"] * cfg.n_layers
    agreement = _spec_agreement(range(len(reqs)), [r.generated for r in reqs],
                                plain[0], spec_rows, plain[1])
    rec = dict(
        config=FULL, draft_layers=cfg.n_layers, k=SPEC_K, dtype="bfloat16",
        **geometry, prompt_lens=PAGED_PROMPT_LENS, new_tokens=NEW_TOKENS,
        instrumented_seconds=dt, **econ,
        verify_passes_per_tick=econ["verify_passes"] / econ["ticks"],
        peak_concurrent_sequences=peak, accounting_checked_every_tick=True,
        host_logit_syncs=syncs, **replays,
        paged_flash_decode_launches=launches["paged_flash_decode"],
        flash_decode_launches=launches["flash_decode"],
        flash_attention_launches=launches["flash_attention"],
        expected_paged_flash_decode_launches=want_k4,
        plain_engine_agreement=agreement)
    emit("spec_self_draft", **rec)
    if launches["paged_flash_decode"] != want_k4 or want_k4 == 0:
        raise AssertionError(
            f"paged_flash_decode launched {launches['paged_flash_decode']} "
            f"times, want draft steps x layers = {want_k4}")
    if launches["flash_decode"] or launches["flash_attention"]:
        raise AssertionError(f"K1/K3 launched on the speculative paged "
                             f"path: {launches}")
    if not (econ["accepted_tokens"] and replays["replays"]
            and econ["preemptions"]):
        raise AssertionError(
            f"the self-draft run did not accept, replay and preempt: "
            f"{econ}, {replays}")
    _check_agreement("self-drafting speculative engine", agreement)
    return rec


def _watch_spec_generate(decode, dcfg, prompt_len, rows):
    """Wrap decode.decode_step and decode.extend_step, which
    speculative_generate calls by name: counts of the draft's decode
    steps and one-token replays (each launches K3 once per draft layer)
    and of the target's verify calls in the returned dict; while
    ``rows`` is not None, it maps (row, generated index) to
    _verify_entry of the target's verify logits that emit that token (a
    later round that re-verifies the index overwrites).  Returns
    (counts, restore)."""
    counts = {"draft_decode": 0, "draft_replay": 0, "verify": 0}
    step, extend = decode.decode_step, decode.extend_step

    def decode_step(p, cache, tokens, c):
        counts["draft_decode"] += c is dcfg
        return step(p, cache, tokens, c)

    def extend_step(p, cache, tokens, c):
        first = cache.length + 1 - prompt_len
        logits, cache = extend(p, cache, tokens, c)
        if c is dcfg:
            counts["draft_replay"] += tokens.shape[1] == 1
        else:
            counts["verify"] += 1
            if rows is not None:
                top = logits.float().topk(2, dim=-1).values.cpu()
                arg = logits.argmax(dim=-1).cpu()
                for row in range(logits.shape[0]):
                    for j in range(logits.shape[1]):
                        rows[(row, first + j)] = (
                            float(top[row, j, 0] - top[row, j, 1]),
                            float(top[row, j, 0]), int(arg[row, j]),
                            logits[row, j])
        return logits, cache

    def restore():
        decode.decode_step, decode.extend_step = step, extend

    decode.decode_step, decode.extend_step = decode_step, extend_step
    return counts, restore


def _watch_generate_rows(decode, rows):
    """Wrap decode.decode_step, which generate calls by name, to keep
    its logits rows in ``rows``, keyed (row, generated index): the n-th
    step chooses token n (prefill chose token 0).  Returns restore."""
    step = decode.decode_step
    n = [0]

    def decode_step(p, cache, tokens, c):
        logits, cache = step(p, cache, tokens, c)
        n[0] += 1
        for row in range(logits.shape[0]):
            rows[(row, n[0])] = logits[row]
        return logits, cache

    def restore():
        decode.decode_step = step

    decode.decode_step = decode_step
    return restore


def phase_spec_generate_main_path(torch, np, attention, model, decode):
    """speculative_generate on the GQA generate shape (GEN_SHAPES[0]:
    batch 8, prompt 128, 256 steps; its params and prompt), the draft
    the target's first layer, k 4: a warm call that records the verify
    logits, held against decode.generate (the K3 route, its decode
    logits recorded) with every row's first divergence a near tie and
    every token the argmax of its verify logits; then GEN_REPS timed
    calls, each with the launch counts zeroed just before and read just
    after: K1 once per target and draft layer (the two prefills), K3
    once per draft layer per draft step and one-token replay, K4
    never; prefill alone (target and draft) timed beside them."""
    import dataclasses

    _, arch, prompt_len, steps = GEN_SHAPES[0]
    cfg = model.ModelConfig(**arch)
    dcfg = dataclasses.replace(cfg, n_layers=DRAFT_LAYERS)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg, "cuda")
    dparams = _draft(params, DRAFT_LAYERS)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (GEN_BATCH, prompt_len)).astype(np.int32)).cuda()
    max_len = prompt_len + steps

    def run():
        return decode.speculative_generate(params, dparams, prompt, cfg,
                                           steps, draft_cfg=dcfg, k=SPEC_K)

    def prefills():
        decode.prefill(model.cast_params(params, cfg.dtype, "cuda"), prompt,
                       cfg, max_len)
        decode.prefill(model.cast_params(dparams, cfg.dtype, "cuda"),
                       prompt, dcfg, max_len)

    spec_rows = {}
    counts, restore = _watch_spec_generate(decode, dcfg, prompt_len,
                                           spec_rows)
    try:
        warm_s, (out, stats) = _wall(torch, run)
        restore()
        counts, restore = _watch_spec_generate(decode, dcfg, prompt_len,
                                               None)
        gen_s, pf_s, launches, calls = [], [], [], []
        for _ in range(GEN_REPS):
            pf_s.append(_wall(torch, prefills)[0])
            for name in counts:
                counts[name] = 0
            attention.reset_launch_counts()
            dt, (tout, tstats) = _wall(torch, run)
            launches.append(dict(attention.LAUNCHES))
            calls.append(dict(counts))
            gen_s.append(dt)
    finally:
        restore()
    plain_rows = {}
    restore = _watch_generate_rows(decode, plain_rows)
    try:
        plain = decode.generate(params, prompt, cfg, steps)
    finally:
        restore()
    gen, want = out[:, prompt_len:].tolist(), plain[:, prompt_len:].tolist()
    agreement = _spec_agreement(range(GEN_BATCH), gen, want, spec_rows,
                                plain_rows)
    del spec_rows, plain_rows
    gen_dt, pf_dt = statistics.fmean(gen_s), statistics.fmean(pf_s)
    want_launches = [{
        "flash_attention": cfg.n_layers + dcfg.n_layers,
        "flash_decode": (c["draft_decode"] + c["draft_replay"])
        * dcfg.n_layers, "paged_flash_decode": 0} for c in calls]
    got_launches = [{n: ln[n] for n in want_launches[0]} for ln in launches]
    rec = dict(
        config=arch, draft_layers=DRAFT_LAYERS, k=SPEC_K, dtype="bfloat16",
        batch=GEN_BATCH, prompt_len=prompt_len, steps=steps,
        rounds=tstats["rounds"], accept_rate=tstats["accept_rate"],
        target_pass_ratio=tstats["rounds"] / steps, warm_seconds=warm_s,
        generate_seconds=gen_s, prefill_seconds=pf_s, prefill_ms=pf_dt * 1e3,
        decode_ms_per_step=(gen_dt - pf_dt) / steps * 1e3,
        ms_per_emitted_token=(gen_dt - pf_dt) / (steps * GEN_BATCH) * 1e3,
        decode_tokens_per_s=GEN_BATCH * steps / (gen_dt - pf_dt),
        calls=calls[-1], launches=got_launches[-1],
        expected_launches=want_launches[-1],
        same_tokens_each_call=bool(torch.equal(out, tout)),
        generate_agreement=agreement)
    emit("spec_generate_main_path", **rec)
    if got_launches != want_launches or not all(
            n["flash_attention"] and n["flash_decode"] for n in got_launches):
        raise AssertionError(f"speculative_generate launched "
                             f"{got_launches}, want {want_launches}")
    _check_agreement("speculative_generate", agreement)
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError("non-finite speculative_generate tokens")
    return rec


def _bigram_shard(np, dataio, path):
    """bench_tpu.py:676-692's structured shard: 90 % the bigram
    t -> (31t + 17) mod V, 10 % uniform noise, numpy seed 7."""
    rng = np.random.default_rng(7)
    n = SPEC_TOKENS
    toks = np.empty(n, np.uint32)
    toks[0] = 1
    noise = rng.random(n) < 0.1
    rand = rng.integers(0, SPEC_VOCAB, n, dtype=np.uint32)
    for i in range(1, n):
        toks[i] = rand[i] if noise[i] else (31 * int(toks[i - 1]) + 17) \
            % SPEC_VOCAB
    dataio.write_token_file(path, toks)
    return toks


def phase_spec_trained(torch, np, attention, model, decode, dataio, paged,
                       serving, spec_serving):
    """The reference's economics cell (bench_tpu.py:695 _impl_spec) at its
    full size: the bigram shard, a 6-layer target and a 1-layer draft
    trained by the port's train CLI (d_model 512, seq 256, batch 4, 600
    steps, lr 3e-3, grad-clip 1.0); then greedy speculative_generate
    against generate (prompt toks[:16], 128 steps, k 4), the sampled
    accept rate at three temperatures, and the speculative engine
    against the plain PagedBatcher over the reference's 6 requests.
    Launch counts over the whole evaluation."""
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT), os.environ.get("PYTHONPATH", "")])}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        shard = os.path.join(tmp, "shard.bin")
        toks = _bigram_shard(np, dataio, shard)
        shard_s = time.perf_counter() - t0
        trained = {}
        for name, layers in (("target", SPEC_T_LAYERS),
                             ("draft", SPEC_D_LAYERS)):
            ckpt = os.path.join(tmp, name)
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "tpu_autoscaler_torch.workloads.train",
                 "--steps", str(SPEC_TRAIN_STEPS), "--d-model",
                 str(SPEC_D_MODEL), "--n-layers", str(layers), "--seq-len",
                 str(SPEC_SEQ), "--batch", "4", "--vocab", str(SPEC_VOCAB),
                 "--data-file", shard, "--checkpoint-dir", ckpt,
                 "--checkpoint-every", str(SPEC_TRAIN_STEPS), "--lr", "3e-3",
                 "--grad-clip", "1.0", "--platform", "cuda",
                 "--annotations-file", os.path.join(tmp, "none")],
                capture_output=True, text=True, env=env, cwd=ROOT,
                timeout=600)
            if res.returncode != 0:
                raise AssertionError(f"train CLI ({name}) exited "
                                     f"{res.returncode}:\n"
                                     f"{res.stderr[-4000:]}")
            losses = re.findall(r"step (\d+) loss ([0-9.]+)", res.stderr)
            trained[name] = dict(
                layers=layers, seconds=time.perf_counter() - t0,
                first_loss=float(losses[0][1]) if losses else None,
                last_loss=float(losses[-1][1]) if losses else None,
                params=model.load_params(ckpt, SPEC_TRAIN_STEPS, "cuda"))
    arch = dict(vocab=SPEC_VOCAB, d_model=SPEC_D_MODEL, seq_len=SPEC_SEQ)
    t_cfg = model.ModelConfig(**arch, n_layers=SPEC_T_LAYERS)
    d_cfg = model.ModelConfig(**arch, n_layers=SPEC_D_LAYERS)
    t_params = trained["target"].pop("params")
    d_params = trained["draft"].pop("params")
    prompt = torch.from_numpy(toks[:16].astype(np.int32))[None].cuda()

    attention.reset_launch_counts()
    plain_rows, spec_rows = {}, {}
    restore = _watch_generate_rows(decode, plain_rows)
    try:
        plain = decode.generate(t_params, prompt, t_cfg, SPEC_GEN_STEPS)
    finally:
        restore()
    _, restore = _watch_spec_generate(decode, d_cfg, 16, spec_rows)
    try:
        spec, stats = decode.speculative_generate(
            t_params, d_params, prompt, t_cfg, SPEC_GEN_STEPS,
            draft_cfg=d_cfg, k=SPEC_K)
    finally:
        restore()
    agreement = _spec_agreement([0], spec[:, 16:].tolist(),
                                plain[:, 16:].tolist(), spec_rows, plain_rows)
    sampled = {}
    for temp in SPEC_TEMPS:
        _, st = decode.speculative_sample_generate(
            t_params, d_params, prompt, t_cfg, SPEC_GEN_STEPS,
            generator=torch.Generator(device="cuda").manual_seed(0),
            temperature=temp, draft_cfg=d_cfg, k=SPEC_K)
        sampled[str(temp)] = st["accept_rate"]

    eng_kw = dict(slots=4, max_len=128, block_size=16, chunk=16,
                  device="cuda")
    prompts = [toks[o:o + 12].astype(np.int32) for o in range(0, 240, 40)]
    out = {}
    for name, eng in (
            ("spec", spec_serving.SpeculativePagedBatcher(
                t_params, t_cfg, d_params, d_cfg, k=SPEC_K, **eng_kw)),
            ("plain", paged.PagedBatcher(t_params, t_cfg, **eng_kw))):
        reqs = [serving.Request(prompt=p, max_new_tokens=64) for p in prompts]
        index, rows = {id(r): n for n, r in enumerate(reqs)}, {}
        if name == "spec":
            _watch_spec_engine(eng, index, rows)
        else:
            _watch_plain_rows(eng, index, rows)
        dt, _ = _serve_ticks(eng, reqs, check=True)
        out[name] = (eng, reqs, dt, rows)
    launches = dict(attention.LAUNCHES)
    seng, sreqs, sdt, srows = out["spec"]
    engine_agreement = _spec_agreement(
        range(len(sreqs)), [r.generated for r in sreqs],
        [r.generated for r in out["plain"][1]], srows, out["plain"][3])
    rec = dict(
        config=dict(arch, target_layers=SPEC_T_LAYERS,
                    draft_layers=SPEC_D_LAYERS), dtype="bfloat16",
        shard_tokens=SPEC_TOKENS, shard_seconds=shard_s, train=trained,
        train_steps=SPEC_TRAIN_STEPS, gen_steps=SPEC_GEN_STEPS, k=SPEC_K,
        rounds=stats["rounds"], accept_rate=stats["accept_rate"],
        target_pass_ratio=stats["rounds"] / SPEC_GEN_STEPS,
        tokens_match_plain_greedy=bool(torch.equal(spec, plain)),
        generate_agreement=agreement,
        sampled_accept_rate_vs_temperature=sampled,
        engine=dict(
            requests=len(prompts), new_tokens_per_request=64,
            accept_rate=seng.accept_rate,
            target_pass_ratio=seng.target_pass_ratio,
            ticks=seng.ticks, plain_ticks=out["plain"][0].ticks,
            verify_passes=seng.verify_passes, seconds=sdt,
            plain_seconds=out["plain"][2],
            greedy_outputs_match_plain=not
            engine_agreement["first_divergences"],
            plain_engine_agreement=engine_agreement),
        launches={n: launches[n] for n in (
            "flash_attention", "flash_decode", "paged_flash_decode")})
    emit("spec_trained", **rec)
    _check_agreement("the trained pair's speculative_generate", agreement)
    _check_agreement("the trained pair's speculative engine",
                     engine_agreement)
    if not all(r.done for r in sreqs):
        raise AssertionError("the trained speculative engine left requests "
                             "unserved")
    return rec


def _train_flops(n_params, cfg, batch) -> float:
    """A train step's flops as bench_tpu.py:198-200 counts them: 6ND over
    the params and the tokens, plus the attention products
    (causal-halved); remat's recomputed forward is not counted."""
    return (6.0 * n_params * batch * cfg.seq_len
            + 6.0 * cfg.n_layers * batch * cfg.seq_len ** 2 * cfg.d_model)


def _loss_and_grad_norm(torch, model, params, tokens, loss_of):
    """The loss ``loss_of(params, tokens)`` and the global norm of its
    gradient."""
    paths, leaves = zip(*model._flatten(params))
    leaves = [p.detach().requires_grad_() for p in leaves]
    loss = loss_of(model._unflatten(dict(zip(paths, leaves))), tokens)
    grads = torch.autograd.grad(loss, leaves)
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    return loss.item(), norm.item()


def _train_steps(torch, attention, step_fn, params, opt, tokens, warm,
                 steps):
    """``warm`` steps, then ``steps`` timed ones, each with the launch
    counts zeroed just before and read just after: (params, opt state,
    every step's loss, per-step launch counts, seconds per timed step)."""
    losses = []
    for _ in range(warm):
        params, opt, loss = step_fn(params, opt, tokens)
        losses.append(loss)
    torch.cuda.synchronize()
    launches = []
    t0 = time.perf_counter()
    for _ in range(steps):
        attention.reset_launch_counts()
        params, opt, loss = step_fn(params, opt, tokens)
        launches.append(dict(attention.LAUNCHES))
        losses.append(loss)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    return params, opt, [x.item() for x in losses], launches, step_s


def _profile_train(torch, step_fn, params, opt, tokens, path, n) -> dict:
    """Where ``n`` train steps spend device time, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            params, opt, _ = step_fn(params, opt, tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _emit_profile(path, "train_steps", n, prof, wall_ms)


def phase_train_main_path(torch, np, attention, model, path, arch, batch,
                          warm, steps, profile_steps, compare):
    """``model.make_train_step`` through its public API on one fixed
    batch (seed 1), as bench_tpu.py's step phases run it: ``warm`` steps,
    then ``steps`` timed ones whose launches are counted per step (K1
    once per layer, twice under remat; each K2 kernel once per layer; K3
    and K4 never), then ``profile_steps`` under torch.profiler.  With
    ``compare``: the einsum route's first-step loss and gradient norm on
    the same params and batch, and its own run of the same steps; the
    loss must fall on both routes (the batch is fixed, so the model
    memorises it)."""
    import dataclasses

    cfg = model.ModelConfig(**arch)
    init_fn, step_fn = model.make_train_step(cfg, device="cuda")
    params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for _, p in model._flatten(params))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (batch, cfg.seq_len + 1)).astype(np.int32)).cuda()
    want = {"flash_attention": (2 if cfg.remat else 1) * cfg.n_layers,
            "flash_attention_bwd_dq": cfg.n_layers,
            "flash_attention_bwd_dkv": cfg.n_layers,
            "flash_decode": 0, "paged_flash_decode": 0,
            **dict.fromkeys(RING_KERNELS, 0)}
    ecfg = dataclasses.replace(cfg, attention="einsum")
    rec = dict(path=path, config=arch, dtype="bfloat16", batch=batch,
               n_params=n_params, warm_steps=warm, timed_steps=steps)
    if compare:
        kl, kn = _loss_and_grad_norm(
            torch, model, params, tokens,
            lambda p, t: model.loss_fn(p, t, cfg))
        el, en = _loss_and_grad_norm(
            torch, model, params, tokens,
            lambda p, t: model.loss_fn(p, t, ecfg))
        rec.update(first_loss=kl, einsum_first_loss=el, grad_norm=kn,
                   einsum_grad_norm=en)
    torch.cuda.reset_peak_memory_stats()
    params, opt, losses, launches, step_s = _train_steps(
        torch, attention, step_fn, params, opt, tokens, warm, steps)
    flops = _train_flops(n_params, cfg, batch)
    rec.update(step_ms=step_s * 1e3,
               tokens_per_s=batch * cfg.seq_len / step_s,
               flops_per_step=flops, mfu=flops / (step_s * BF16_OPS_PER_S),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               losses=losses, launches_per_step=launches[-1],
               expected_launches_per_step=want)
    rec["profile"] = _profile_train(torch, step_fn, params, opt, tokens,
                                    path, profile_steps)
    del params, opt
    if compare:
        eparams, eopt = model.make_train_step(ecfg, device="cuda")[0](
            torch.Generator(device="cuda").manual_seed(0))
        estep = model.make_train_step(ecfg, device="cuda")[1]
        _, _, elosses, _, estep_s = _train_steps(
            torch, attention, estep, eparams, eopt, tokens, warm, steps)
        del eparams, eopt
        rec.update(einsum_step_ms=estep_s * 1e3,
                   einsum_tokens_per_s=batch * cfg.seq_len / estep_s,
                   einsum_losses=elosses)
    torch.cuda.empty_cache()
    emit("train_main_path", **rec)
    if any(n != want for n in launches):
        raise AssertionError(f"train step ({path}) launched {launches}, "
                             f"want {want} per step")
    all_losses = losses + rec.get("einsum_losses", [])
    if not all(np.isfinite(all_losses)):
        raise AssertionError(f"non-finite loss on the {path} train path")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{path}: loss did not fall over "
                             f"{warm + steps} steps: {losses}")
    if compare:
        if not rec["einsum_losses"][-1] < rec["einsum_losses"][0]:
            raise AssertionError(f"{path}: einsum-route loss did not fall: "
                                 f"{rec['einsum_losses']}")
        if not abs(rec["first_loss"] - rec["einsum_first_loss"]) \
                <= TRAIN_LOSS_GAP:
            raise AssertionError(f"{path}: first-step loss {rec['first_loss']}"
                                 f" vs einsum {rec['einsum_first_loss']}")
        if not abs(rec["grad_norm"] - rec["einsum_grad_norm"]) \
                <= TRAIN_GRAD_NORM_RTOL * rec["einsum_grad_norm"]:
            raise AssertionError(f"{path}: grad norm {rec['grad_norm']} vs "
                                 f"einsum {rec['einsum_grad_norm']}")
    return rec


def phase_small_train(torch, np, model):
    """make_train_step on a small f32 model on the card: 5 steps through
    the kernel route (K1 and K2) and through the einsum route, from the
    same params and batches, give losses within SMALL_TRAIN_LOSS_GAP; MHA
    at head_dim 64, and GQA at head_dim 32 with a window and remat."""
    base = dict(vocab=256, d_model=128, n_layers=2, d_ff=256, seq_len=64,
                dtype=torch.float32)
    rec = {}
    for label, extra in (("mha", dict(n_heads=2)),
                         ("gqa-window-remat", dict(n_heads=4, n_kv_heads=2,
                                                   attention_window=16,
                                                   remat=True))):
        losses = {}
        for impl in ("kernel", "einsum"):
            cfg = model.ModelConfig(**base, **extra, attention=impl)
            init_fn, step_fn = model.make_train_step(cfg, device="cuda")
            params, opt = init_fn(
                torch.Generator(device="cuda").manual_seed(1))
            rng = np.random.default_rng(2)
            out = []
            for _ in range(5):
                tokens = rng.integers(0, 256, (4, 65)).astype(np.int32)
                params, opt, loss = step_fn(params, opt, tokens)
                out.append(loss.item())
            losses[impl] = out
        rec[label] = dict(losses=losses, max_gap=max(
            abs(a - b) for a, b in zip(losses["kernel"], losses["einsum"])))
    emit("small_train", **rec)
    for label, r in rec.items():
        if not r["max_gap"] <= SMALL_TRAIN_LOSS_GAP:
            raise AssertionError(f"f32 train steps ({label}): kernel and "
                                 f"einsum losses differ by {r['max_gap']}")


def phase_small_exact(torch, np, model, serving, paged, decode,
                      spec_serving):
    """A small f32 model on the card, in three cache modes: the linear
    cache, the ``--ring`` cache (window 16 + chunk 8 wide, so the
    prompts wrap it and the ring prefill scatter and decode write index
    run), and the paged cache with a pool of 8 blocks of 8 (so it
    preempts); then decode.generate.  The kernel route and the einsum
    route give the same greedy tokens, as the CPU tests demand of the
    port against JAX; the paged engine, and generate prompt by prompt,
    give the linear engine's tokens; a sampled generate stays in the
    vocab; forward's logits equal prefill's through K1.  Speculative
    decoding with the first layer as the draft gives exactly the plain
    tokens: the speculative paged engine the plain paged engine's (K4
    route), speculative_generate generate's (K3 route)."""
    import dataclasses

    cfg = model.ModelConfig(vocab=256, d_model=128, n_layers=2, n_heads=2,
                            d_ff=256, seq_len=64, dtype=torch.float32)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(1),
                               cfg, "cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32)
               for n in (5, 17, 33, 9, 41)]
    rec = {}
    for mode, window, ring in (("linear", None, False),
                               ("ring", 16, True)):
        out = []
        for impl in ("kernel", "einsum"):
            eng = serving.ContinuousBatcher(
                params, dataclasses.replace(cfg, attention=impl,
                                            attention_window=window),
                slots=3, max_len=64, chunk=8, device="cuda", ring=ring)
            reqs = [serving.Request(prompt=p, max_new_tokens=8)
                    for p in prompts]
            _serve_all(eng, reqs)
            out.append([r.generated for r in reqs])
        rec[mode] = dict(tokens_equal=out[0] == out[1],
                         tokens=sum(len(t) for t in out[0]))
        if mode == "linear":
            linear_tokens = out[0]
    out, preempted = [], []
    for impl in ("kernel", "einsum"):
        eng = paged.PagedBatcher(
            params, dataclasses.replace(cfg, attention=impl), slots=3,
            max_len=64, block_size=8, num_blocks=8, chunk=8,
            prefill_lanes=2, device="cuda")
        reqs = [serving.Request(prompt=p, max_new_tokens=8) for p in prompts]
        _serve_all(eng, reqs)
        out.append([r.generated for r in reqs])
        preempted.append(eng.preemptions)
    rec["paged"] = dict(tokens_equal=out[0] == out[1],
                        tokens=sum(len(t) for t in out[0]),
                        equal_to_linear=out[0] == linear_tokens,
                        preemptions=preempted)
    kcfg = dataclasses.replace(cfg, attention="kernel")
    dcfg = dataclasses.replace(kcfg, n_layers=1)
    dparams = _draft(params, 1)
    eng = spec_serving.SpeculativePagedBatcher(
        params, kcfg, dparams, dcfg, k=3, slots=3, max_len=64, block_size=8,
        num_blocks=8, chunk=8, prefill_lanes=2, device="cuda")
    reqs = [serving.Request(prompt=p, max_new_tokens=8) for p in prompts]
    _serve_ticks(eng, reqs, check=True)
    rec["spec"] = dict(tokens_equal=[r.generated for r in reqs] == out[0],
                       tokens=sum(len(r.generated) for r in reqs),
                       accept_rate=eng.accept_rate,
                       target_pass_ratio=eng.target_pass_ratio,
                       preemptions=eng.preemptions)
    ecfg = dataclasses.replace(cfg, attention="einsum")
    batch = torch.from_numpy(rng.integers(0, 256, (3, 40)).astype(np.int32))
    out = [decode.generate(params, batch, c, 10).tolist()
           for c in (kcfg, ecfg)]
    alone = [decode.generate(params, torch.from_numpy(p)[None], kcfg,
                             8)[0, len(p):].tolist() for p in prompts]
    sampled = decode.generate(
        params, batch, kcfg, 10, temperature=0.8, top_k=20,
        generator=torch.Generator(device="cuda").manual_seed(3))[:, 40:]
    tokens = batch.cuda()
    logits, _ = decode.prefill(params, tokens, kcfg, 40)
    forward_diff = {impl: (model.forward(params, tokens, c) - logits).abs()
                    .max().item() for impl, c in (("kernel", kcfg),
                                                  ("einsum", ecfg))}
    spec_out, spec_stats = decode.speculative_generate(
        params, dparams, batch, kcfg, 10, draft_cfg=dcfg, k=3)
    rec["spec_generate"] = dict(tokens_equal=spec_out.tolist() == out[0],
                                tokens=3 * 10, **spec_stats)
    rec["generate"] = dict(tokens_equal=out[0] == out[1],
                           tokens=3 * 10,
                           equal_to_linear=alone == linear_tokens,
                           sampled_in_vocab=bool(
                               ((sampled >= 0) & (sampled < 256)).all()),
                           forward_vs_prefill_max=forward_diff)
    emit("small_exact", **rec)
    for mode, r in rec.items():
        if not r["tokens_equal"]:
            raise AssertionError(f"f32 {mode}: the kernel route and the "
                                 f"einsum route, or speculative and plain "
                                 f"decoding, disagree")
    if not rec["paged"]["equal_to_linear"]:
        raise AssertionError("f32 paged engine's tokens differ from the "
                             "linear engine's")
    if not rec["generate"]["sampled_in_vocab"]:
        raise AssertionError(f"sampled generate gave tokens outside the "
                             f"vocab: {sampled.tolist()}")
    if not rec["generate"]["equal_to_linear"]:
        raise AssertionError("f32 generate's tokens differ from the "
                             "linear engine's, prompt by prompt")
    if not max(forward_diff.values()) <= 2e-4:
        raise AssertionError(f"forward's logits differ from prefill's "
                             f"through K1 by {forward_diff}")
    if not all(preempted):
        raise AssertionError(f"the small paged engine never preempted: "
                             f"{preempted}")


def _hop_pairs(sq: int, sk: int, offset: int, masked: bool, window) -> int:
    """(query, key) pairs one head of a ring hop sees."""
    if not masked:
        return sq * sk
    total = 0
    for i in range(sq):
        lo = 0 if window is None else max(0, offset + i - window + 1)
        total += max(0, min(sk - 1, offset + i) - lo + 1)
    return total


def _hop_bounds(b, h, hkv, sq, sk, d, elem, pairs, dtype_name):
    """Least times of a hop's work, as (ms, bound_by) for K5 ("fwd": q,
    k, v and the f32 carry in and out moved once, 4·d flops per visible
    (query head, key) pair), the whole of K6 ("bwd": q, do, k, v, lse,
    delta and the f32 dq, dk, dv adds; 10·d), its dq kernel ("dq": the
    inputs and dq; 6·d: q.k, do.v, dS.k) and its dk/dv kernel ("dkv":
    the inputs, dk and dv; 8·d: q.k, do.v, P.do, dS.q)."""
    peak = BF16_OPS_PER_S if dtype_name == "torch.bfloat16" \
        else F32_OPS_PER_S
    q_t, kv_t, row = b * h * sq * d * elem, b * hkv * sk * d * elem, \
        b * h * sq * 4
    dq_t, dkv_t = b * h * sq * d * 4, b * hkv * sk * d * 4
    ins = 2 * q_t + 2 * kv_t + 2 * row
    parts = {"fwd": (q_t + 2 * kv_t + 2 * (2 * row + dq_t), 4),
             "bwd": (ins + dq_t + 2 * dkv_t, 10),
             "dq": (ins + dq_t, 6), "dkv": (ins + 2 * dkv_t, 8)}
    out = {}
    for name, (moved, per_pair) in parts.items():
        t_bytes = moved / HBM_BYTES_PER_S
        t_ops = per_pair * d * b * h * pairs / peak
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def check_ring_case(torch, F, attention, flush, *, label, b, h, hkv, sq, sk,
                    d, dtype, offset, masked, window=None, carry="random",
                    timed=False, seed=0):
    """One K5 and K6 case: random q, k, v, do and carry (or the fresh
    carry); K5's (m, l, acc) against ring_flash_step_reference with
    hop_err_over_tol, and the carry passed in unchanged; then lse and
    delta of the hop itself (a fresh-carry merge) and K6's (dq, dk, dv)
    against ring_flash_bwd_step_reference with grad_err_over_tol by the
    inputs' dtype.
    ``timed``: each kernel timed alone beside its plain version and SDPA
    on the same hop with its mask (forward, and its backward), with the
    TFLOP/s each reaches over the work its hop needs (4·d flops per
    visible pair forward, 6·d dq, 8·d dk/dv, 10·d the backward); at a
    head_dim no kernel is built for, also the zero-padding copy that
    ``attention.call_padded`` makes of the forward's q, k, v and acc."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    q, k, v, do = rnd(b, h, sq, d), rnd(b, hkv, sk, d), rnd(b, hkv, sk, d), \
        rnd(b, h, sq, d)
    fresh = (torch.full((b, h, sq, 1), -1e30, device="cuda"),
             torch.zeros((b, h, sq, 1), device="cuda"),
             torch.zeros((b, h, sq, d), device="cuda"))
    if carry == "fresh":
        m, l_, acc = fresh
    else:
        m, l_, acc = (rnd(b, h, sq, 1, dt=torch.float32),
                      rnd(b, h, sq, 1, dt=torch.float32).abs() + 0.5,
                      rnd(b, h, sq, d, dt=torch.float32))
    kw = dict(offset=offset, masked=masked, window=window)
    before = [t.clone() for t in (m, l_, acc)]
    got = attention.ring_flash_step(q, k, v, m, l_, acc, **kw)
    want = attention.ring_flash_step_reference(q, k, v, m, l_, acc, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(t, t0) for t, t0 in zip((m, l_, acc), before)):
        raise AssertionError(f"ring_flash_step {label}: the carry passed "
                             f"in was written")
    errs = {name: hop_err_over_tol(torch, gt, wt, dtype)
            for name, gt, wt in zip(("m", "l", "acc"), got, want)}
    del got, want, before
    m0, l0, acc0 = attention.ring_flash_step_reference(q, k, v, *fresh, **kw)
    l0 = l0.clamp_min(1e-30)
    lse = (m0 + torch.log(l0)).contiguous()
    delta = attention._delta((acc0 / l0).to(dtype), do)
    del m0, l0, acc0
    got = attention.ring_flash_bwd_step(q, k, v, do, lse, delta, **kw)
    want = attention.ring_flash_bwd_step_reference(q, k, v, do, lse, delta,
                                                   **kw)
    torch.cuda.synchronize()
    errs.update({name: grad_err_over_tol(torch, gt, wt, dtype)
                 for name, gt, wt in zip(("dq", "dk", "dv"), got, want)})
    del got, want
    dname = str(dtype)
    pairs = _hop_pairs(sq, sk, offset, masked, window)
    bounds = _hop_bounds(b, h, hkv, sq, sk, d, q.element_size(), pairs,
                         dname)
    rec = dict(case=label, shape=[b, h, hkv, sq, sk, d], dtype=dname,
               offset=offset, masked=masked, window=window, carry=carry,
               max_abs_err={n: e[0] for n, e in errs.items()},
               err_over_tolerance={n: e[1] for n, e in errs.items()},
               tolerance=("carry: per row, f32 2e-5 / bf16 2^-5 of the "
                          "row's largest |value| (at least 1); adds: as "
                          "grad_err_over_tol by the inputs' dtype"),
               visible_pairs_per_head=pairs,
               **{f"bound_ms_{n}": v[0] for n, v in bounds.items()},
               **{f"bound_by_{n}": v[1] for n, v in bounds.items()})
    if timed:
        # Each K6 kernel alone, through the same padding as the wrapper.
        args, pad = (q, k, v, do, lse, delta), (0, 1, 2, 3)
        rec.update(
            ms_fwd=_time_ms(torch, lambda: attention.ring_flash_step(
                q, k, v, m, l_, acc, **kw), flush),
            plain_ms_fwd=_time_ms(
                torch, lambda: attention.ring_flash_step_reference(
                    q, k, v, m, l_, acc, **kw), flush),
            ms_dq=_time_ms(torch, lambda: attention.call_padded(
                attention._ring_bwd_dq, args, pad, **kw), flush),
            ms_dkv=_time_ms(torch, lambda: attention.call_padded(
                attention._ring_bwd_dkv, args, pad, **kw), flush),
            ms_bwd=_time_ms(torch, lambda: attention.ring_flash_bwd_step(
                q, k, v, do, lse, delta, **kw), flush),
            plain_ms_bwd=_time_ms(
                torch, lambda: attention.ring_flash_bwd_step_reference(
                    q, k, v, do, lse, delta, **kw), flush))
        # No PyTorch call merges into a carry: the yardstick is SDPA on
        # the same hop (its normalised output) and SDPA's backward.
        if masked and offset == 0 and window is None and sq == sk:
            sdpa = dict(is_causal=True)
        elif masked:
            sdpa = dict(attn_mask=attention.ring_hop_mask(
                sq, sk, offset, window, "cuda"))
        else:
            sdpa = {}
        rec["library_ms_fwd"] = _time_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=True, **sdpa), flush)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        lout = F.scaled_dot_product_attention(*leaves, enable_gqa=True,
                                              **sdpa)
        rec["library_ms_bwd"] = _time_ms(torch, lambda: torch.autograd.grad(
            lout, leaves, do, retain_graph=True), flush)
        rec["library"] = ("F.scaled_dot_product_attention on the same hop "
                          "and mask (normalised output, no carry), and its "
                          "backward")
        del lout, leaves
        for part, per_pair in (("fwd", 4), ("dq", 6), ("dkv", 8),
                               ("bwd", 10)):
            rec[f"tflops_{part}"] = per_pair * d * b * h * pairs \
                / (rec[f"ms_{part}"] * 1e-3) / 1e12
        width = attention.kernel_width(d)
        if width != d:
            rec["pad_copy_ms"] = _time_ms(torch, lambda: [
                attention.pad_head_dim(t, width) for t in (q, k, v, acc)],
                flush)
    emit("ring_kernel_check", **rec)
    worst = max(e[1] for e in errs.values())
    if not worst <= 1.0:
        raise AssertionError(f"ring hop {label}: error "
                             f"{rec['err_over_tolerance']} of its tolerance "
                             f"(max |err| {rec['max_abs_err']})")
    return rec


def phase_ring_kernel_checks(torch, F, attention, flush):
    """K5 and K6 in 16 cases each; the first two are the SP main path's
    hops (b 2, h 8, s_loc 2048, d 128, bf16), timed: an unmasked hop (6
    of each layer's 10 visible hops) and a diagonal one (4 of 10).  The
    last two: the main hop at head_dim 96 (zero-padded to 128, timed
    with its padding copy) and an unmasked bf16 hop at d 256."""
    s_loc = SP_FULL["seq_len"] // SP_RANKS
    main = dict(b=SP_BATCH, h=8, hkv=8, sq=s_loc, sk=s_loc, d=128,
                dtype=torch.bfloat16)
    small = dict(b=2, h=8, hkv=8, sq=300, sk=300, d=64, dtype=torch.bfloat16)
    cases = [
        dict(main, label="main-unmasked", offset=s_loc, masked=False,
             timed=True),
        dict(main, label="main-diag", offset=0, masked=True, carry="fresh",
             timed=True),
        dict(small, label="window-cut", offset=300, masked=True, window=400),
        dict(small, label="window-in-diag", offset=0, masked=True, window=37),
        dict(small, label="window-cut-2back", offset=600, masked=True,
             window=650),
        dict(small, label="gqa8", h=16, hkv=2, offset=300, masked=False),
        dict(small, label="mqa-diag", hkv=1, offset=0, masked=True,
             carry="fresh"),
        dict(small, label="f32-d32-diag", d=32, dtype=torch.float32,
             offset=0, masked=True),
        dict(small, label="d256-window-cut", d=256, offset=300, masked=True,
             window=450),
        dict(small, label="f32-d128-tail", d=128, dtype=torch.float32,
             sq=100, sk=100, offset=100, masked=False),
        dict(small, label="f32-d256-diag", d=256, dtype=torch.float32,
             sq=129, sk=129, offset=0, masked=True),
        dict(small, label="sq-ne-sk", sq=70, sk=40, offset=3, masked=True,
             window=9),
        dict(small, label="no-key-rows-fresh", sq=64, sk=64, offset=-20,
             masked=True, carry="fresh"),
        dict(small, label="s1", b=3, sq=1, sk=33, offset=32, masked=True),
        dict(main, label="main-unmasked-d96", d=96, offset=s_loc,
             masked=False, timed=True),
        dict(small, label="d256-unmasked", d=256, sq=500, sk=700, offset=700,
             masked=False),
    ]
    return [check_ring_case(torch, F, attention, flush, seed=400 + i, **c)
            for i, c in enumerate(cases)]


def phase_sp_train_main_path(torch, np, attention, model, sp,
                             ring_attention):
    """The sequence-parallel train step at bench_tpu.py's long-context
    width through ``sp.make_sp_train_step`` (the kernel ring, 4 ranks on
    the visible cards): first the first step's loss and gradient norm
    through the kernel ring, one device (K1/K2 at s 8192), the einsum
    ring and Ulysses on the same params and batch; then SP_WARM warm and
    SP_STEPS timed steps whose launches are counted per step (K5 once per
    visible hop per layer, twice under remat; each K6 kernel once; K1-K4
    never); one profiled step; then one warm and one timed Ulysses step,
    its launches counted (K1 once per rank per layer, twice under remat;
    each K2 kernel once; K5/K6 never)."""
    cfg = model.ModelConfig(**SP_FULL)
    devices = sp.make_sp_mesh(sp=SP_RANKS)
    init_fn, step_fn = sp.make_sp_train_step(devices, cfg, impl="pallas")
    params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for _, p in model._flatten(params))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (SP_BATCH, cfg.seq_len + 1)).astype(np.int32)).cuda()
    s_loc = cfg.seq_len // SP_RANKS
    hops = sum(1 for r in range(SP_RANKS) for src in range(SP_RANKS)
               if ring_attention._hop_mode(src, r, s_loc, True,
                                           cfg.attention_window)[0])
    remat = 2 if cfg.remat else 1
    layers = cfg.n_layers
    zero = dict.fromkeys(attention.LAUNCHES, 0)
    want = {**zero, "ring_flash_step": remat * hops * layers,
            "ring_flash_bwd_dq": hops * layers,
            "ring_flash_bwd_dkv": hops * layers}
    want_ulysses = {**zero, "flash_attention": remat * SP_RANKS * layers,
                    "flash_attention_bwd_dq": SP_RANKS * layers,
                    "flash_attention_bwd_dkv": SP_RANKS * layers}
    first = {}
    for name, loss_of in (
            ("pallas", sp.make_sp_loss(devices, cfg, "pallas")),
            ("single_device", lambda p, t: model.loss_fn(p, t, cfg)),
            ("einsum", sp.make_sp_loss(devices, cfg, "einsum")),
            ("ulysses", sp.make_sp_loss(devices, cfg, "ulysses"))):
        first[name] = _loss_and_grad_norm(torch, model, params, tokens,
                                          loss_of)
        torch.cuda.empty_cache()
    rec = dict(config=SP_FULL, dtype="bfloat16", batch=SP_BATCH,
               ranks=SP_RANKS, devices=[str(d) for d in devices],
               s_loc=s_loc, n_params=n_params, visible_hops_per_layer=hops,
               first_loss={n: v[0] for n, v in first.items()},
               first_grad_norm={n: v[1] for n, v in first.items()},
               warm_steps=SP_WARM, timed_steps=SP_STEPS)
    torch.cuda.reset_peak_memory_stats()
    params, opt, losses, launches, step_s = _train_steps(
        torch, attention, step_fn, params, opt, tokens, SP_WARM, SP_STEPS)
    flops = _train_flops(n_params, cfg, SP_BATCH)
    rec.update(step_ms=step_s * 1e3,
               tokens_per_s=SP_BATCH * cfg.seq_len / step_s,
               flops_per_step=flops, mfu=flops / (step_s * BF16_OPS_PER_S),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               losses=losses, launches_per_step=launches[-1],
               expected_launches_per_step=want)
    rec["profile"] = _profile_train(torch, step_fn, params, opt, tokens,
                                    "sp", 1)
    _, ustep = sp.make_sp_train_step(devices, cfg, impl="ulysses")
    ustep(params, opt, tokens)
    attention.reset_launch_counts()
    ustep_s, (_, _, uloss) = _wall(torch, lambda: ustep(params, opt, tokens))
    ulaunches = dict(attention.LAUNCHES)
    rec.update(ulysses_step_ms=ustep_s * 1e3, ulysses_loss=uloss.item(),
               ulysses_launches_per_step=ulaunches,
               ulysses_expected_launches_per_step=want_ulysses)
    del params, opt
    torch.cuda.empty_cache()
    emit("sp_train_main_path", **rec)
    if any(n != want for n in launches):
        raise AssertionError(f"sp train step launched {launches}, want "
                             f"{want} per step")
    if ulaunches != want_ulysses:
        raise AssertionError(f"ulysses sp train step launched {ulaunches}, "
                             f"want {want_ulysses}")
    if not all(np.isfinite(losses + [rec["ulysses_loss"]])):
        raise AssertionError(f"non-finite loss on the sp train path: "
                             f"{losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"sp: loss did not fall over "
                             f"{SP_WARM + SP_STEPS} steps: {losses}")
    base_loss, base_norm = first["single_device"]
    for name, (loss, norm) in first.items():
        if not abs(loss - base_loss) <= SP_LOSS_GAP:
            raise AssertionError(f"sp ({name}) first-step loss {loss} vs one "
                                 f"device {base_loss}")
        if not abs(norm - base_norm) <= SP_GRAD_NORM_RTOL * base_norm:
            raise AssertionError(f"sp ({name}) grad norm {norm} vs one "
                                 f"device {base_norm}")
    return rec


def phase_small_sp(torch, np, model, sp, decode):
    """make_sp_train_step on a small f32 GQA model on the card: 5 steps
    through the kernel ring (K5/K6) and through the einsum ring from the
    same params and batches, at 2 ranks (window 24 and remat) and 4:
    losses within SMALL_TRAIN_LOSS_GAP, params within SMALL_SP_PARAM_RTOL
    of each leaf's largest |value|, and the greedy tokens that
    decode.generate gives from the two final params equal."""
    base = dict(vocab=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
                d_ff=256, seq_len=64, dtype=torch.float32)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 16)).astype(np.int32)).cuda()
    rec = {}
    for world, extra in ((2, dict(attention_window=24, remat=True)),
                         (4, {})):
        cfg = model.ModelConfig(**base, **extra)
        devices = sp.make_sp_mesh(sp=world)
        runs = {}
        for impl in ("pallas", "einsum"):
            init_fn, step_fn = sp.make_sp_train_step(devices, cfg, impl=impl)
            params, opt = init_fn(torch.Generator(device="cuda").manual_seed(1))
            rng = np.random.default_rng(2)
            losses = []
            for _ in range(5):
                tokens = rng.integers(0, 256, (4, 65)).astype(np.int32)
                params, opt, loss = step_fn(params, opt, tokens)
                losses.append(loss.item())
            runs[impl] = (losses, params,
                          decode.generate(params, prompt, cfg, 8).tolist())
        (kl, kp, kt), (el, ep, et) = runs["pallas"], runs["einsum"]
        ep = dict(model._flatten(ep))
        param_gap = max(((a - ep[path]).abs().max()
                         / ep[path].abs().max().clamp_min(1e-30)).item()
                        for path, a in model._flatten(kp))
        rec[f"sp{world}"] = dict(
            config=extra, losses={"pallas": kl, "einsum": el},
            max_loss_gap=max(abs(a - b) for a, b in zip(kl, el)),
            max_param_gap=param_gap, generate_tokens_equal=kt == et)
    emit("small_sp", **rec)
    for label, r in rec.items():
        if not r["max_loss_gap"] <= SMALL_TRAIN_LOSS_GAP:
            raise AssertionError(f"f32 sp steps ({label}): kernel and einsum "
                                 f"ring losses differ by {r['max_loss_gap']}")
        if not r["max_param_gap"] <= SMALL_SP_PARAM_RTOL:
            raise AssertionError(f"f32 sp steps ({label}): params differ by "
                                 f"{r['max_param_gap']} of their scale")
        if not r["generate_tokens_equal"]:
            raise AssertionError(f"f32 sp steps ({label}): the two rings' "
                                 f"params generate different tokens")


def phase_cli(model, decode, DrainReceipt):
    """The CLIs on the card: serve with the linear cache and with
    ``--paged`` (a 6-block pool, so it preempts), and ``serve --random 4
    --d-model 384`` (head_dim 96, which no kernel is built for); then,
    at the CLIs' default architecture flags (head_dim 32), generate, which must
    print the tokens decode.generate gives in-process, and serve; then
    train (20 steps, checkpoints every 10), resume to 30, drain (a
    checkpoint request in the annotations file: exit 0 with a
    checkpoint), and generate from the trainer's checkpoint; then the
    same with ``train --sp 2 --sp-impl pallas`` (the kernel ring)."""
    import torch

    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT), os.environ.get("PYTHONPATH", "")])}

    def run(cmd, what, expect=()):
        """Run a CLI; it must exit 0 and log each of ``expect``."""
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             cwd=ROOT, timeout=600)
        missing = [e for e in expect if e not in res.stderr]
        if res.returncode != 0 or missing:
            raise AssertionError(f"{what} exited {res.returncode}, missing "
                                 f"{missing}:\n{res.stderr[-4000:]}")
        return time.perf_counter() - t0, res.stdout.strip().splitlines()

    def serve_cmd(ckpt, flags, requests=6):
        return [sys.executable, "-m", "tpu_autoscaler_torch.workloads.serve",
                "--checkpoint-dir", ckpt, "--random", str(requests),
                "--platform", "cuda", "--annotations-file",
                os.path.join(tmp, "annotations"), *flags]

    def serve(ckpt, cache, flags, requests=6, expect=()):
        """Serve ``requests``; every one must be served.  Returns the
        receipt line as a dict."""
        dt, lines = run(serve_cmd(ckpt, flags, requests),
                        f"serve CLI ({cache})", expect)
        receipt = DrainReceipt.parse_line(lines[-1])
        payload = json.loads(lines[-1])
        emit("cli", command="serve", cache=cache, flags=flags, seconds=dt,
             served=receipt.served, unserved=receipt.unserved,
             ticks=receipt.ticks, decode_tokens=receipt.decode_tokens,
             preempted=receipt.stats["preempted_total"],
             trace=payload.get("trace"))
        if receipt.unserved != 0 or receipt.served != requests:
            raise AssertionError(f"serve CLI ({cache}) receipt: {receipt}")
        return payload

    def checkpoint(cfg, name):
        params = model.init_params(
            torch.Generator(device="cuda").manual_seed(2), cfg, "cuda")
        model.save_params(os.path.join(tmp, name), 1, params)
        return os.path.join(tmp, name), params

    with tempfile.TemporaryDirectory() as tmp:
        ckpt, _ = checkpoint(model.ModelConfig(vocab=256, d_model=256,
                                               n_layers=2, seq_len=64),
                             "d256")
        arch = ["--vocab", "256", "--d-model", "256", "--n-layers", "2",
                "--seq-len", "64", "--slots", "2", "--max-len", "128",
                "--chunk", "16"]
        serve(ckpt, "linear", arch)
        paged_flags = arch + ["--paged", "--block-size", "16",
                              "--max-new-tokens", "48"]
        serve(ckpt, "paged", paged_flags + ["--num-blocks", "6"])
        # Speculative serving (the first layer drafts), and request
        # tracing on the preempting pool: every request traced.
        serve(ckpt, "paged-spec", paged_flags + [
            "--spec-k", "4", "--draft-layers", "1"],
            expect=["speculative: accept_rate"])
        traced = serve(ckpt, "paged-trace", paged_flags + [
            "--num-blocks", "6", "--trace-sample", "1.0", "--slo-ticks", "4"])
        if traced.get("trace", {}).get("sampled_total") != 6:
            raise AssertionError(f"serve --trace-sample 1.0 receipt's trace: "
                                 f"{traced.get('trace')}")
        res = subprocess.run(serve_cmd(ckpt, arch + ["--spec-k", "4"]),
                             capture_output=True, text=True, env=env,
                             cwd=ROOT, timeout=600)
        emit("cli", command="serve", cache="spec-without-paged",
             exit_code=res.returncode, error=res.stderr.strip()[-200:])
        if res.returncode != 2 or "add --paged" not in res.stderr:
            raise AssertionError(f"serve --spec-k without --paged exited "
                                 f"{res.returncode}: {res.stderr[-2000:]}")
        # --d-model 384 over the CLIs' 4 heads: head_dim 96, which no
        # kernel is built for (K1 padded to 128, K3 at its true width).
        ckpt, _ = checkpoint(model.ModelConfig(d_model=384), "d384")
        serve(ckpt, "linear-d384", ["--d-model", "384"], requests=4)
        # The CLIs' defaults: vocab 256, d_model 128, 2 layers, 4 heads.
        cfg = model.ModelConfig()
        ckpt, params = checkpoint(cfg, "defaults")
        prompt = [5, 17, 42, 9, 200]
        dt, lines = run([sys.executable, "-m",
                         "tpu_autoscaler_torch.workloads.generate",
                         "--checkpoint-dir", ckpt, "--prompt",
                         ",".join(map(str, prompt)), "--batch", "2",
                         "--steps", "8", "--platform", "cuda"],
                        "generate CLI")
        want = decode.generate(params, torch.tensor([prompt] * 2), cfg,
                               8).tolist()
        want_lines = [f"{','.join(map(str, row[:5]))} | "
                      f"{','.join(map(str, row[5:]))}" for row in want]
        emit("cli", command="generate", head_dim=cfg.head_dim, seconds=dt,
             lines=lines, in_process=want_lines)
        if lines != want_lines:
            raise AssertionError(f"generate CLI printed {lines}, "
                                 f"in-process {want_lines}")
        serve(ckpt, "linear-defaults", [])

        # The train CLI at its defaults: train, resume, drain; then the
        # generate CLI on the trainer's last checkpoint.  Once on one
        # device, once with the sequence over 2 ranks (the kernel ring).
        drain = os.path.join(tmp, "drain-annotations")
        with open(drain, "w") as f:
            f.write('autoscaler.tpu.dev/checkpoint-requested="1"\n')

        for label, flags, first in (
                ("", [], []),
                ("sp ", ["--sp", "2", "--sp-impl", "pallas"],
                 ["sp 2 ranks (pallas)"])):
            tdir = os.path.join(tmp, f"train{label.strip()}")

            def train(steps, annotations, what, expect):
                dt, _ = run([sys.executable, "-m",
                             "tpu_autoscaler_torch.workloads.train",
                             "--checkpoint-dir", tdir, "--steps", str(steps),
                             "--checkpoint-every", "10", "--platform",
                             "cuda", "--annotations-file", annotations,
                             *flags], label + what, expect)
                emit("cli", command="train", flags=flags, run=what,
                     seconds=dt, checkpoints=sorted(os.listdir(tdir)))

            train(20, os.path.join(tmp, "annotations"), "train",
                  [*first, "step 10 loss", "step 20 loss",
                   "training complete at step 20"])
            train(30, os.path.join(tmp, "annotations"), "resume",
                  ["resumed from checkpoint step 20",
                   "training complete at step 30"])
            train(5000, drain, "drain",
                  ["resumed from checkpoint step 30",
                   "drain requested: checkpointed at step 30, exiting "
                   "cleanly"])
            if sorted(os.listdir(tdir)) != ["step_10", "step_20", "step_30"]:
                raise AssertionError(f"{label}train CLI left "
                                     f"{os.listdir(tdir)}")
            dt, lines = run([sys.executable, "-m",
                             "tpu_autoscaler_torch.workloads.generate",
                             "--checkpoint-dir", tdir, "--prompt",
                             ",".join(map(str, prompt)), "--batch", "2",
                             "--steps", "8", "--platform", "cuda"],
                            f"generate CLI on the {label}trainer's "
                            f"checkpoint", ["loaded step 30"])
            want = decode.generate(model.load_params(tdir, 30, "cuda"),
                                   torch.tensor([prompt] * 2), cfg,
                                   8).tolist()
            want_lines = [f"{','.join(map(str, row[:5]))} | "
                          f"{','.join(map(str, row[5:]))}" for row in want]
            emit("cli", command="generate",
                 checkpoint=f"{label}train step_30", seconds=dt, lines=lines,
                 in_process=want_lines)
            if lines != want_lines:
                raise AssertionError(f"generate CLI printed {lines} from the "
                                     f"{label}trainer's checkpoint, "
                                     f"in-process {want_lines}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch.nn.functional as F

    from tpu_autoscaler_torch import dataio
    from tpu_autoscaler_torch.serving.drain import DrainReceipt
    from tpu_autoscaler_torch.workloads import (
        attention,
        decode,
        model,
        paged,
        ring_attention,
        serving,
        sp,
        spec_serving,
    )

    t_start = time.perf_counter()
    name, smi = phase_device(torch)
    phase_build(attention)
    main_rec, eng = phase_main_path(torch, np, attention, model, serving)
    phase_profile(torch, np, serving, eng, "linear", PROMPT_LENS)
    del eng
    paged_rec, paged_tick, eng, paged_plain = phase_paged_main_path(
        torch, np, attention, model, serving, paged)
    phase_profile(torch, np, serving, eng, "paged", PAGED_PROMPT_LENS)
    del eng
    spec_rec, spec_tick, eng, syncs = phase_spec_main_path(
        torch, np, attention, model, serving, spec_serving, paged_plain)
    phase_profile(torch, np, serving, eng, "spec", PAGED_PROMPT_LENS, syncs)
    del eng
    self_draft_rec = phase_spec_self_draft(
        torch, np, attention, model, serving, spec_serving, paged_plain)
    del paged_plain
    # 128 MB scratch, written before each timed launch: evicts the 50 MB L2.
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    floor_ms = phase_launch_floor(torch, flush)
    checks = phase_kernel_checks(torch, F, attention, flush,
                                 main_rec["mid_tick_lengths"])
    paged_checks = phase_paged_kernel_checks(torch, F, attention, flush,
                                             paged_tick, spec_tick)
    attn_checks = phase_attn_kernel_checks(torch, F, attention, flush)
    bwd_checks = phase_bwd_kernel_checks(torch, F, attention, flush)
    ring_checks = phase_ring_kernel_checks(torch, F, attention, flush)
    del flush
    gen_recs = []
    for label, arch, prompt_len, steps in GEN_SHAPES:
        rec, params, prompt, cfg = phase_generate_main_path(
            torch, np, attention, model, decode, label, arch, prompt_len,
            steps)
        gen_recs.append(rec)
        if label == "gqa":
            phase_generate_profile(torch, model, decode, params, prompt, cfg,
                                   steps)
        del params, prompt
    spec_gen_rec = phase_spec_generate_main_path(torch, np, attention, model,
                                                 decode)
    train_rec = phase_train_main_path(
        torch, np, attention, model, "step", TRAIN_FULL, TRAIN_BATCH,
        TRAIN_WARM, TRAIN_STEPS, PROFILE_STEPS, compare=True)
    phase_train_main_path(torch, np, attention, model, "step_large",
                          TRAIN_LARGE, LARGE_BATCH, LARGE_WARM, LARGE_STEPS,
                          1, compare=False)
    sp_rec = phase_sp_train_main_path(torch, np, attention, model, sp,
                                      ring_attention)
    phase_small_exact(torch, np, model, serving, paged, decode, spec_serving)
    phase_small_train(torch, np, model)
    phase_small_sp(torch, np, model, sp, decode)
    trained_rec = phase_spec_trained(torch, np, attention, model, decode,
                                     dataio, paged, serving, spec_serving)
    phase_cli(model, decode, DrainReceipt)
    kernels = []
    for kname, source, replaces, design, launches, kchecks in (
            ("flash_attention", "flash_attention.cu", 192, TC_DESIGN,
             gen_recs[0]["launches"]["flash_attention"], attn_checks),
            ("flash_decode", "flash_decode.cu", 773, SPLIT_DESIGN,
             main_rec["flash_decode_launches"], checks),
            ("paged_flash_decode", "paged_flash_decode.cu", 898,
             SPLIT_DESIGN,
             paged_rec["paged_flash_decode_launches"], paged_checks)):
        at_main = kchecks[0]
        kernels.append(dict(
            name=kname, route="cuda", design=design,
            source=f"tpu_autoscaler_torch/csrc/{source}",
            replaces=f"tpu_autoscaler/workloads/attention.py:{replaces}",
            launches=launches, max_abs_err=at_main["max_abs_err"],
            ms=at_main["ms"], plain_ms=at_main["plain_ms"],
            bound_ms=at_main["bound_ms"], bound_by=at_main["bound_by"],
            library_ms=at_main["library_ms"],
            gather_ms=at_main.get("gather_ms"), cases_passed=len(kchecks),
            shape=at_main["shape"], lengths=at_main.get("lengths")))
        if kname != "flash_attention":
            kernels[-1].update(splits=at_main["splits"],
                               ctas=at_main["ctas"],
                               launch_floor_ms=floor_ms)
    # Launches of K1, K3 and K4 on the speculative paths: per
    # speculative_generate call, over the speculative engine's timed
    # pass and its self-draft pass, over the trained pair's evaluation.
    for kernel, key in zip(kernels, ("flash_attention", "flash_decode",
                                     "paged_flash_decode")):
        kernel["new_path_launches"] = {
            "spec_generate_main_path": spec_gen_rec["launches"][key],
            "spec_main_path": spec_rec[f"{key}_launches"],
            "spec_self_draft": self_draft_rec[f"{key}_launches"],
            "spec_trained": trained_rec["launches"][key]}
    # K1 where the trainer calls it: a layer of the training main path,
    # its launches per train step.
    at_train = attn_checks[1]
    kernels[0]["train_step"] = dict(
        shape=at_train["shape"], ms=at_train["ms"],
        plain_ms=at_train["plain_ms"], bound_ms=at_train["bound_ms"],
        bound_by=at_train["bound_by"], library_ms=at_train["library_ms"],
        tflops=at_train["tflops"], max_abs_err=at_train["max_abs_err"],
        launches=train_rec["launches_per_step"]["flash_attention"],
        launches_per="train step")
    # K2: each kernel at a layer of the training main path, its launches
    # per train step; plain and library times are the whole backward's
    # (neither splits into the two kernels).
    at_main = bwd_checks[0]
    for kname, part, replaces, grads in (
            ("flash_attention_bwd_dq", "dq", 310, ("dq",)),
            ("flash_attention_bwd_dkv", "dkv", 344, ("dk", "dv"))):
        kernels.append(dict(
            name=kname, route="cuda", design=TC_DESIGN,
            source="tpu_autoscaler_torch/csrc/flash_attention_bwd.cu",
            replaces=f"tpu_autoscaler/workloads/attention.py:{replaces}",
            launches=train_rec["launches_per_step"][kname],
            launches_per="train step",
            max_abs_err=max(at_main["max_abs_err"][g] for g in grads),
            ms=at_main[f"ms_{part}"], plain_ms=at_main["plain_ms"],
            bound_ms=at_main[f"bound_ms_{part}"],
            bound_by=at_main[f"bound_by_{part}"],
            library_ms=at_main["library_ms"],
            plain_and_library_scope="whole backward",
            tflops=at_main[f"tflops_{part}"],
            cases_passed=len(bwd_checks), shape=at_main["shape"]))
    # K5 and K6: each kernel at the SP main path's unmasked hop (its
    # diagonal hop beside it), launches per SP train step; K6's plain and
    # library times are the whole backward hop's.
    at_main, at_diag = ring_checks[0], ring_checks[1]
    for kname, part, whole, replaces, source, grads in (
            ("ring_flash_step", "fwd", "fwd", 585, "ring_flash_step.cu",
             ("m", "l", "acc")),
            ("ring_flash_bwd_dq", "dq", "bwd", 651, "ring_flash_bwd.cu",
             ("dq",)),
            ("ring_flash_bwd_dkv", "dkv", "bwd", 672, "ring_flash_bwd.cu",
             ("dk", "dv"))):
        kernels.append(dict(
            name=kname, route="cuda", design=TC_DESIGN,
            source=f"tpu_autoscaler_torch/csrc/{source}",
            replaces=f"tpu_autoscaler/workloads/attention.py:{replaces}",
            launches=sp_rec["launches_per_step"][kname],
            launches_per="sp train step",
            max_abs_err=max(at_main["max_abs_err"][g] for g in grads),
            ms=at_main[f"ms_{part}"], plain_ms=at_main[f"plain_ms_{whole}"],
            bound_ms=at_main[f"bound_ms_{part}"],
            bound_by=at_main[f"bound_by_{part}"],
            library_ms=at_main[f"library_ms_{whole}"],
            library=at_main["library"],
            plain_and_library_scope="whole hop" if whole == "bwd"
            else "kernel", hop="unmasked", diag_hop_ms=at_diag[f"ms_{part}"],
            tflops=at_main[f"tflops_{part}"],
            cases_passed=len(ring_checks), shape=at_main["shape"]))
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
