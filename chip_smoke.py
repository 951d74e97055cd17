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
trained by the port's trainer on a bigram shard), a mixture-of-experts
model (8 experts, top 2) through the linear and paged servers,
``decode.generate``, the train step, expert-parallel training over 4
ranks and sp×ep, the training mesh (the step cell over a dp 4 × tp 2
mesh of 8 ranks on the card, in each shard mode: none, zero1, fsdp;
K1/K2 per shard), serving under a mesh of the card (the linear server
and ``make_sharded_generate`` over dp 2 × tp 2, the paged server over a
TP-only mesh of 2: K3, K1 and K4 per shard, against one device), the
compositions (the step cell on a (dcn 2, data 2, model 2) mesh from
``distributed.make_multislice_mesh``, the MoE step model on data 2 × ep
2 × model 2, the long-context step on data 2 × sp 2 × model 2 under
ZeRO-1 with the kernel ring and Ulysses, two processes of this script
joined by ``distributed.initialize_from_env`` over gloo against one
process, and small f32 models on CUDA ranks against CPU ranks), the
pipeline (``pipeline.make_pipeline_train_step``: the step cell over 4
stages of the card and over data 2 × pp 2 × model 2, the MoE step
model over 2 stages, small f32 pipelines on CUDA ranks against CPU
ranks), the batch shape scorer (``engine/jaxfit.py``: 1,000,000 gangs
on the card against its numpy twin), the real-text training path at
``bench_tpu.py``'s converge size (the port's tokenizer CLI rebuilds
``data/corpus.bin``; the ``train`` CLI trains on it through the native
token loader, is SIGKILLed mid-run and resumes from its checkpoint),
and runs the ``serve`` CLI with each cache,
speculatively and with request tracing, the ``generate`` CLI and the
``train`` CLI (train, resume, drain; on one device, with ``--sp 2``,
with ``--tp 2 --shard fsdp``, whose checkpoint ``serve --tp 2`` and
``generate --tp 2`` then read, with ``--pp-stages 2`` and with
``--pp-stages 2 --tp 2``, whose merged checkpoint ``generate`` reads; a
MoE model also with ``--ep 2``, then served and generated from).
Each phase prints one JSON line; a failed phase raises and the script
exits non-zero.  The last lines are the card's ``nvidia-smi`` name and
power limit, the ``kernels`` summary, and ``{"ok": true, "device":
{...}}``.

Needs one CUDA device; without one it exits non-zero before printing
any result.  Imports nothing of JAX and nothing of the JAX package.
``python3 chip_smoke.py --distributed-worker PORT PID SHARD REF OUT`` is
one process of the two-process phase, which starts it; ``python3
chip_smoke.py --time-mesh-step ROOT [MODES]`` times the mesh step of the
checkout at ROOT (time_mesh_step).
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
GEN_REPS = 2
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
LARGE_BATCH, LARGE_WARM, LARGE_STEPS = 8, 1, 2
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
# The mixture-of-experts paths: the serving model and the step model
# with 8 experts, top 2, capacity factor 1.25 (the ModelConfig defaults),
# bf16 over f32 masters, random weights from seed 0; expert parallelism
# over 4 ranks on the one card, checked against one device at capacity
# factor E / k = 4 (no expert can overflow, so nothing drops).
MOE = dict(moe_experts=8, moe_top_k=2, moe_capacity_factor=1.25)
FULL_MOE = dict(FULL, **MOE)
TRAIN_MOE = dict(TRAIN_FULL, **MOE)
EP_RANKS, EP_NO_DROP = 4, 4.0
# The training mesh: the step cell's model and batch on a dp 4 × tp 2
# mesh of the one card (8 ranks), so each K1/K2 shard is [4, 8, 1024,
# 64]; each shard mode 2 warm and 3 timed steps from the same params.
# The three modes compute the same bf16 products on the same shards,
# sum the same gradient pieces in the same order and run the same
# elementwise AdamW (only where the state is stored differs, and no
# clip norm is taken), so their losses agree to the last bit; the bound
# leaves one f32 ulp at a loss of ~10.4 and nothing for a misplaced
# moment slice.  The card's allocation after init must equal the state
# bytes the placement counts, up to ALLOC_SLACK a block: the caching
# allocator rounds a block up and gives it a whole cached chunk unless
# more than 1 MiB of the chunk would be left.
MESH_RANKS, MESH_TP, MESH_WARM, MESH_STEPS = 8, 2, 2, 3
# Serving under the mesh: the linear cell through ContinuousBatcher and
# the GQA generate shape through make_sharded_generate over a dp 2 × tp 2
# mesh of the card (4 ranks: 2 slots or 4 prompts a data row, 8 query
# heads on 1 KV head a rank), the paged cell under a TP-only mesh of 2
# (each rank's KV head of the pool).  Ticks, decode steps and
# preemptions must equal the one-device cells'; the row-parallel
# products are summed over the ranks in another order than one device's
# product, so the logits differ by bf16 rounding and are held to
# DLOGITS_MAX like the einsum route's.
SERVE_MESH_RANKS, SERVE_MESH_TP, PAGED_MESH_RANKS = 4, 2, 2
# The compositions (the multi-slice mesh, ep×tp, sp×tp, two processes):
# the step cell on make_multislice_mesh(2, model=2) over the 8 ranks of
# the mesh step (dcn 2 × data 2 × model 2) in modes none and zero1; the
# MoE step model on data 2 × ep 2 × model 2; the long-context step on
# data 2 × sp 2 × model 2 (each ring over 2 sp ranks on 4 of the 8
# heads, [1, 4, 4096, 128] a hop); two processes of a dp 1 × tp 2 mesh
# on 8 rows each, at the step cell's widths in f32.
MULTISLICE_SLICES, MULTISLICE_MODES = 2, ("none", "zero1")
EP_TP = (2, 2)
SP_TP_MESH, SP_TP_STEPS = (2, 2, 2), 2
DIST_TP, DIST_LOCAL_BATCH, DIST_STEPS, DIST_TIMEOUT_S = 2, 8, 3, 300
# f32 and the same two row gradients summed in another order only: ten
# f32 ulps at a loss of ~10.4, and 1e-5 of each leaf's largest |value|.
DIST_LOSS_GAP = 1e-5
DIST_PARAM_RTOL = 1e-5
# small_compositions' params after 3 steps, elementwise |Δ| <= tol · (1 +
# |p|): the compositions' CPU parity bound against the JAX package.
# Relative to a leaf's largest |value| (SMALL_SP_PARAM_RTOL) it is too
# tight where Adam meets a near-zero gradient: at |g| ~ eps the update
# lr · g / (|g| + eps) turns f32 summation noise into ~0.1 · lr (ep×tp's
# embed element with g -2.2e-8 on CUDA ranks, -1.4e-8 on CPU ranks
# moved 1.05e-4 apart, 1.26e-3 of the leaf's largest |value|, while the
# gradients agree within 1.1e-7 of a median |g| of 8.8e-3).
COMP_PARAM_TOL = 2e-4
# The pipeline (pp): the step cell's model and batch over PP_STAGES
# stages of the card (2 layers a stage) with PP_MICROBATCHES
# microbatches (the trainer's default) and remat, so K1/K2 run per
# microbatch on [4, 16, 1024, 64]; the MoE step model over
# PP_MOE_STAGES stages at m 1 (the microbatch count JAX's own MoE
# pipeline test pins) and capacity EP_NO_DROP; then data 2 × pp 2 ×
# model 2 (8 ranks) at m PP3D_MICROBATCHES, K1/K2 per (data row, stage,
# model rank) shard on [4, 8, 1024, 64].  MESH_WARM warm and MESH_STEPS
# timed steps each.
PP_STAGES, PP_MICROBATCHES, PP_MOE_STAGES = 4, 4, 2
PP3D_MESH, PP3D_MICROBATCHES = (2, 2, 2), 2
# The batch shape scorer: FIT_GANGS gangs from a numpy seed, scored on
# the card against the whole catalog and each generation, FIT_REPS
# timed calls after a warm one.
FIT_GANGS, FIT_REPS = 1_000_000, 5
FIT_GENERATIONS = (None, "v4", "v5e", "v5p", "v6e")
# The real-text training path at bench_tpu.py:869 _impl_converge's full
# size (:901-903, :918-924): the port's tokenizer CLI rebuilds
# data/corpus.bin (byte-BPE, vocab 8192, CORPUS_TOKENS tokens) from
# data/corpus.txt, and the train CLI trains d_model 512, 6 layers (4
# heads of 128, d_ff 512: 17.8M params), seq 256, batch 16 on it through
# the native loader for 1000 steps, a checkpoint every 100, lr 3e-3,
# warmup 50, cosine, grad-clip 1.0.  Run 1 is SIGKILLed at its first
# logged step >= CONVERGE_KILL_AT (past step 500's checkpoint, so run 2
# re-logs steps 510-550), run 2 is the same command resumed.  The two
# runs' losses at the steps both logged come from the same state and the
# same batches: bf16 products with atomics in the embedding's backward
# may move them apart, by at most CONVERGE_REPLAY_TOL.
CONVERGE_VOCAB, CONVERGE_D_MODEL, CONVERGE_LAYERS = 8192, 512, 6
CONVERGE_SEQ, CONVERGE_BATCH, CONVERGE_STEPS = 256, 16, 1000
CONVERGE_EVERY, CONVERGE_KILL_AT, CONVERGE_WARMUP = 100, 550, 50
CONVERGE_RESUMES = (500, 400)
CONVERGE_REPLAY_TOL = 0.02
CONVERGE_LOADER_BATCHES = 200
CORPUS_TOKENS = 199_762
MESH_MODES = ("none", "zero1", "fsdp")
MESH_MODE_GAP = 1e-6
ALLOC_SLACK = 1 << 20
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


# K7's cases: (label, lanes as (offset, n_valid), chunk, h, hkv, d, block
# size, tokens_per_row, window).  The first is sc2-3b.complete's median
# prefill call: its median prompt (2,560 tokens, 5 chunks of 512) at
# ~3/4 of the lanes busy (the cell's prefill_fill.serve reads ~71%): lanes
# at offsets 512, 1,024 and 2,048, one lane unused, StarCoder2-3B's heads
# (24 on 2 KV heads of 128) and window (4,096), the cell's pages (16) and
# tokens_per_row (4,096).  Then sc2-3b.chat's (2 lanes of 256, one
# resumed), the speculative verify's (k + 1 = 5 rows a slot, GQA 16 on 2
# of 64), a window shorter than the context, and f32.
PREFILL_CASES = (
    ("complete-median-call", [(512, 512), (1024, 512), (2048, 512),
                              (0, 0)], 512, 24, 2, 128, 16, 4096, 4096),
    ("chat-call", [(256, 256), (0, 171)], 256, 24, 2, 128, 16, 3072, 4096),
    ("spec-verify", [(37, 5), (200, 5), (0, 0), (511, 5), (64, 3)] * 3, 5,
     16, 2, 64, 16, 1024, None),
    ("window-300", [(900, 128), (17, 128), (0, 100)], 128, 8, 1, 128, 8,
     2048, 300),
    ("f32-d64", [(70, 64), (0, 33), (0, 0)], 64, 8, 2, 64, 16, 256, None),
)


def _prefill_work(lanes, chunk, h, hkv, d, bs, tpr_keys, window, elem):
    """(flops, bytes) of one paged prefill call: 4*d flops per visible
    (query head, key) pair, the padding rows' too (K7 attends them as
    the einsum does); each visible K/V row once, q and out, the table
    entries read and the lanes' offsets and n_valid."""
    pairs = keys = entries = 0
    for off, _ in lanes:
        end = min(off + chunk, tpr_keys)
        for i in range(chunk):
            p = off + i
            lo = 0 if window is None else max(0, p - window + 1)
            pairs += max(0, min(p, end - 1) - lo + 1)
        lo = 0 if window is None else max(0, off - window + 1)
        keys += max(0, end - lo)
        entries += -(-end // bs) - lo // bs
    moved = (2 * keys * hkv + 2 * len(lanes) * chunk * h) * d * elem \
        + 4 * entries + 8 * len(lanes)
    return 4 * d * h * pairs, moved


def check_prefill_case(torch, attention, paged, model, flush, *, label,
                       lanes, chunk, h, hkv, d, bs, tpr_keys, window,
                       seed=0):
    """One K7 case: random q and pools, scrambled tables (-1 past each
    lane's end, which its padding rows read as block 0), against
    paged_flash_prefill_reference over every row; the kernel, the plain
    version and the einsum route it replaces (paged._lanes_attend over
    the gathered tables) timed, L2 flushed."""
    dtype = torch.float32 if label.startswith("f32") else torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)
    tpr = tpr_keys // bs
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
    args = (q, k, v, tables, offsets, n_valid)
    got = attention.paged_flash_prefill(*args, window=window)
    again = attention.paged_flash_prefill(*args, window=window)
    want = attention.paged_flash_prefill_reference(*args, window=window)
    torch.cuda.synchronize()
    err, share = err_over_tol(torch, got, want)
    deterministic = torch.equal(got, again)
    del got, again, want
    cfg = model.ModelConfig(d_model=h * d, n_heads=h, n_kv_heads=hkv,
                            attention_window=window, dtype=dtype)
    visible = paged._lanes_visible(offsets, chunk, tpr_keys, cfg)
    ms = _time_ms(torch, lambda: attention.paged_flash_prefill(
        *args, window=window), flush)
    plain_ms = _time_ms(torch, lambda: attention.paged_flash_prefill_reference(
        *args, window=window), flush, iters=5)
    einsum_ms = _time_ms(torch, lambda: paged._lanes_attend(
        q, attention.gather_pool_rows(k, tables),
        attention.gather_pool_rows(v, tables), visible, cfg), flush, iters=5)
    flops, moved = _prefill_work(lanes, chunk, h, hkv, d, bs, tpr_keys,
                                 window, q.element_size())
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / peak
    bound_ms = max(t_bytes, t_ops) * 1e3
    dname = str(dtype)
    rec = dict(case=label, lanes=[list(x) for x in lanes],
               shape=[len(lanes), h, hkv, chunk, d, bs, tpr_keys],
               dtype=dname, window=window, max_abs_err=err,
               err_over_tolerance=share, tolerance=TOL_REASON[dname],
               deterministic=deterministic,
               ms=ms, plain_ms=plain_ms, einsum_ms=einsum_ms,
               bound_ms=bound_ms,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               roofline_share=bound_ms / ms, tflops=flops / ms * 1e-9,
               flops=flops, bytes=moved)
    emit("paged_prefill_kernel_check", **rec)
    if not share <= 1.0:
        raise AssertionError(f"paged_flash_prefill {label}: error {share} "
                             f"times its tolerance (max |err| {err})")
    if not deterministic:
        raise AssertionError(f"paged_flash_prefill {label}: two calls on "
                             f"the same inputs differ")
    return rec


def phase_paged_prefill_checks(torch, attention, paged, model, flush):
    """K7 in PREFILL_CASES, the first at sc2-3b.complete's median
    prefill call; each also run twice (bit for bit)."""
    return [check_prefill_case(torch, attention, paged, model, flush,
                               label=label, lanes=lanes, chunk=chunk, h=h,
                               hkv=hkv, d=d, bs=bs, tpr_keys=tpr_keys,
                               window=window, seed=i)
            for i, (label, lanes, chunk, h, hkv, d, bs, tpr_keys, window)
            in enumerate(PREFILL_CASES)]


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
    """K1 in 23 cases; the first is the GQA generate path's prefill, the
    next two a layer of the training main path and of the long-sequence
    recipe, the next two one rank's shard of the mesh step (dp 4 × tp 2:
    [4, 8, 1024, 64], also the multi-slice and the ep×tp rank's shard
    and the dp×pp×tp pipeline's) and of its GQA form (16 q / 2 KV heads
    cut by tp 2: 8 q heads on 1 KV head), the next two a rank's Ulysses
    shard under sp×tp ([1, 2, 8192, 128]) and the distributed phase's
    f32 shard ([8, 8, 1024, 64]); the last three at head_dim 96 (run
    zero-padded to 128), a microbatch of the pipeline ([4, 16, 1024,
    64]) and a layer of the converge run ([16, 4, 256, 128])."""
    main = dict(b=GEN_BATCH, h=16, hkv=2, s=GEN_PROMPT, d=64,
                dtype=torch.bfloat16)
    cases = [
        dict(main, label="main-path-prefill"),
        dict(main, label="train-main-path", b=TRAIN_BATCH, hkv=16, s=1024),
        dict(main, label="train-large", b=LARGE_BATCH, h=12, hkv=12, s=2048,
             d=128),
        dict(main, label="mesh-shard", b=TRAIN_BATCH // 4, h=8, hkv=8,
             s=1024),
        dict(main, label="mesh-shard-gqa", b=TRAIN_BATCH // 4, h=8, hkv=1,
             s=1024),
        dict(main, label="ulysses-tp-shard", b=1, h=2, hkv=2, s=8192,
             d=128),
        dict(main, label="dist-shard-f32", b=DIST_LOCAL_BATCH, h=8, hkv=8,
             s=1024, dtype=torch.float32),
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
        dict(main, label="pp-microbatch", b=TRAIN_BATCH // PP_MICROBATCHES,
             hkv=16, s=1024),
        dict(main, label="converge-layer", b=CONVERGE_BATCH, h=4, hkv=4,
             s=CONVERGE_SEQ, d=CONVERGE_D_MODEL // 4),
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
    """K2 in 20 cases; the first is a layer of the training main path,
    the second a layer of the long-sequence recipe, the next four one
    rank's shard of the mesh step and of its GQA form, the Ulysses shard
    under sp×tp and the distributed phase's f32 shard (as K1's); the
    last three at head_dim 96 (run zero-padded to 128), a microbatch of
    the pipeline and a layer of the converge run (as K1's)."""
    gqa = dict(b=2, h=16, hkv=2, s=512, d=64, dtype=torch.bfloat16)
    cases = [
        dict(label="train-main-path", b=TRAIN_BATCH, h=16, hkv=16, s=1024,
             d=64, dtype=torch.bfloat16),
        dict(label="train-large", b=LARGE_BATCH, h=12, hkv=12, s=2048, d=128,
             dtype=torch.bfloat16),
        dict(gqa, label="mesh-shard", b=TRAIN_BATCH // 4, h=8, hkv=8,
             s=1024),
        dict(gqa, label="mesh-shard-gqa", b=TRAIN_BATCH // 4, h=8, hkv=1,
             s=1024),
        dict(gqa, label="ulysses-tp-shard", b=1, h=2, hkv=2, s=8192, d=128),
        dict(gqa, label="dist-shard-f32", b=DIST_LOCAL_BATCH, h=8, hkv=8,
             s=1024, dtype=torch.float32),
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
        dict(gqa, label="pp-microbatch", b=TRAIN_BATCH // PP_MICROBATCHES,
             hkv=16, s=1024),
        dict(gqa, label="converge-layer", b=CONVERGE_BATCH, h=4, hkv=4,
             s=CONVERGE_SEQ, d=CONVERGE_D_MODEL // 4),
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


class _RouteLog:
    """While in a with-block, model.route_topk (the one routing rule
    moe_ffn calls) also keeps each call's f32 router logits and chosen
    experts, in call order: one call per MoE layer of a step."""

    def __init__(self, model):
        self.model, self.calls = model, []

    def __enter__(self):
        real = self._real = self.model.route_topk

        def logged(logits, k, capacity):
            out = real(logits, k, capacity)
            self.calls.append((logits.detach(), out[0]))
            return out

        self.model.route_topk = logged
        return self

    def __exit__(self, *exc):
        self.model.route_topk = self._real


class _TokenWriteLog:
    """While in a with-block, every write of the one-device paged decode
    step (``paged._scatter_token``: the paged_token_write kernel on the
    card) is also made by the kernel's plain version on copies of the
    pools, and the two pools must match bit for bit.  ``calls`` counts the
    writes, ``unequal`` those that differed, ``written`` the pool entries
    they wrote; ``steps`` keeps each decode step's first-layer inputs
    (new k/v, tables, positions, active)."""

    def __init__(self, torch, attention, paged, n_layers):
        self.torch, self.attention, self.paged = torch, attention, paged
        self.n_layers = n_layers
        self.calls = self.unequal = self.written = 0
        self.steps = []

    def __enter__(self):
        real = self._real = self.paged._scatter_token
        torch = self.torch

        def checked(k_pool, v_pool, k, v, tables, positions, active):
            want_k, want_v = k_pool.clone(), v_pool.clone()
            self.attention.paged_token_write_reference(
                want_k, want_v, k, v, tables, positions, active)
            if self.calls % self.n_layers == 0:
                self.steps.append(tuple(t.clone() for t in (
                    k, v, tables, positions, active)))
            before = k_pool.clone()
            real(k_pool, v_pool, k, v, tables, positions, active)
            self.calls += 1
            self.unequal += not (torch.equal(k_pool, want_k)
                                 and torch.equal(v_pool, want_v))
            self.written += int((k_pool != before).any(-1).sum())

        self.paged._scatter_token = checked
        return self

    def __exit__(self, *exc):
        self.paged._scatter_token = self._real


#: The port's paged kernels by the name of their device code, as a
#: profiler's trace lists them: K4, K7 (bf16 and f32 builds), K8.
PAGED_KERNEL_NAMES = {"paged_flash_decode": ("paged_decode_kernel",),
                      "paged_flash_prefill": ("paged_prefill_tc_kernel",
                                              "paged_prefill_fma_kernel"),
                      "paged_token_write": ("token_write_kernel",)}


def _graph_kernel_nodes(graph) -> dict:
    """The kernel nodes of a captured ``torch.cuda.CUDAGraph`` (made with
    ``keep_graph=True``) counted by the PAGED_KERNEL_NAMES they match,
    read from the graph through the CUDA driver (``cuGraphGetNodes``,
    each kernel node's function and its name): the launches one replay
    makes, whoever counted them in Python."""
    import ctypes

    class Params(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p)] \
            + [(n, ctypes.c_uint) for n in (
                "grid_x", "grid_y", "grid_z", "block_x", "block_y",
                "block_z", "shared_mem")] \
            + [(n, ctypes.c_void_p) for n in (
                "kernel_params", "extra", "kern", "ctx")]

    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} returned CUresult {rc}")

    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    counts = dict.fromkeys(PAGED_KERNEL_NAMES, 0)
    kernels = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        kernels += 1
        params = Params()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                               ctypes.byref(params)),
              "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params.func:
            check(cu.cuFuncGetName(ctypes.byref(name),
                                   ctypes.c_void_p(params.func)),
                  "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name),
                                     ctypes.c_void_p(params.kern)),
                  "cuKernelGetName")
        for key, names in PAGED_KERNEL_NAMES.items():
            if any(m.encode() in name.value for m in names):
                counts[key] += 1
    return dict(counts, kernel_nodes=kernels, nodes=n.value)


def _decode_launches(cfg, step, launches, profiled, steps, replays,
                     captures):
    """K4's and K8's launches over a pass of ``steps`` calls of a
    PagedDecodeStep, from what ran on the card: each eager run of its
    body (a call not replayed, and each capture's warm-up) launches both
    once a layer, as attention's wrappers count at the launch, and each
    replay launches the kernel nodes of the captured graph, read from the
    graph (_graph_kernel_nodes).  Returns (those launches by name, the
    graph's nodes, what disagrees): attention.LAUNCHES must hold the
    same, the graph one node of each a layer, as counted at its capture,
    and the profiler (``profiled``; it may drop records of a replay's
    burst of kernels, never add any) no more than was launched."""
    nodes = dict.fromkeys(PAGED_KERNEL_NAMES, 0)
    bad = []
    if step._graph is not None:
        nodes = _graph_kernel_nodes(step._graph.graph)
        at_capture = {k: step._graph.launches.get(k, 0)
                      for k in PAGED_KERNEL_NAMES}
        if {k: nodes[k] for k in PAGED_KERNEL_NAMES} != at_capture \
                or nodes["paged_flash_decode"] != cfg.n_layers:
            bad.append(f"graph nodes {nodes}, counted at capture "
                       f"{at_capture}")
    eager_runs = steps - replays + captures
    ran = {k: eager_runs * cfg.n_layers + replays * nodes[k]
           for k in ("paged_flash_decode", "paged_token_write")}
    bad += [f"attention.LAUNCHES {k} {launches[k]}, launched {n}"
            for k, n in ran.items() if launches[k] != n or n == 0]
    bad += [f"the profiler saw {profiled[k]} {k}, {launches[k]} launched"
            for k in PAGED_KERNEL_NAMES if profiled[k] > launches[k]]
    return ran, nodes, bad


def _measured_launches(torch, fn):
    """(``fn()``, the PAGED_KERNEL_NAMES kernels that ran on the card
    while it ran, counted by name in a device-only profiler trace: every
    kernel of a replayed CUDA graph is an event of its own there)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    counts = dict.fromkeys(PAGED_KERNEL_NAMES, 0)
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        for key, names in PAGED_KERNEL_NAMES.items():
            if any(n in e.key for n in names):
                counts[key] += e.count
    return out, counts


def _routed_apart(got, want, k, rows) -> dict:
    """Rows (batch indices among ``rows``) whose top-k experts differ
    between two routes' runs of the same step (_RouteLog calls, layer by
    layer), each with (router top-(k+1) gap, router max |dlogits|, near
    tie) over the positions that differ at the first layer where any
    does.  Before that layer both routes routed alike, so their router
    logits there differ by rounding only: each differing position must
    be a near tie of its router logits (_near_tie, the smallest gap
    between adjacent logits of its top k + 1).  A row routed apart may
    then differ by more than rounding; the dense bounds hold elsewhere."""
    apart = {}
    for (gl, ge), (wl, we) in zip(got, want):
        differ = (ge != we).any(dim=-1)                      # [b, s]
        for r in differ.any(dim=-1).nonzero()[:, 0].tolist():
            if r in apart or r not in rows:
                continue
            pos = differ[r]
            top = wl[r][pos].sort(dim=-1, descending=True).values
            gap = (top[:, :k] - top[:, 1:k + 1]).amin(dim=-1)
            dl = (gl[r][pos] - wl[r][pos]).abs().amax(dim=-1)
            apart[r] = (gap.max().item(), dl.max().item(), all(
                _near_tie(g, d) for g, d in zip(gap.tolist(), dl.tolist())))
    return apart


def _compare_routed(torch, logits, want, rows, got, want_routes, k) -> dict:
    """_compare_tick over the rows that both routes routed alike, and
    the rows routed apart (_routed_apart): for a dense model, exactly
    _compare_tick."""
    apart = _routed_apart(got, want_routes, k, set(rows.tolist()))
    same = rows[[r not in apart for r in rows.tolist()]]
    if len(same):
        rec = _compare_tick(torch, logits, want, same)
    else:
        rec = dict(mean=0.0, max=0.0, rows=0, near_ties=0, flips=[],
                   finite=bool(torch.isfinite(logits).all()))
    rec["routed_apart"] = list(apart.values())
    return rec


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
    apart = [a for c in ticks for a in c.get("routed_apart", [])]
    return dict(
        routed_apart=dict(
            rows=len(apart), near_ties=sum(a[2] for a in apart),
            router_dlogits_max=max((a[1] for a in apart), default=0.0),
            router_gap_max=max((a[0] for a in apart), default=0.0)),
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


def _check_ticks(path, diffs) -> None:
    """The teacher-forced checks of a compared pass: finite logits, the
    rows routed alike within DLOGITS_MAX of the einsum route with every
    argmax flip a near tie, and each row routed apart a router near
    tie."""
    if not all(c["finite"] for c in diffs):
        raise AssertionError(f"non-finite logits on the {path}")
    worst = max(c["max"] for c in diffs)
    if not worst < DLOGITS_MAX:
        raise AssertionError(f"{path}: kernel route logits differ from the "
                             f"einsum route by {worst}")
    bad = [f for c in diffs for f in c["flips"] if not _near_tie(*f)]
    bad += [a for c in diffs for a in c.get("routed_apart", []) if not a[2]]
    if bad:
        raise AssertionError(f"{path}: divergences from the einsum route "
                             f"away from a near tie: {bad[:8]}")


def phase_main_path(torch, np, attention, model, serving, arch=FULL,
                    path="main_path"):
    """The server at full width: warm pass (with the einsum route on
    identical inputs every tick), then the timed pass whose kernel
    launches are counted, then the same traffic through an einsum-route
    engine for free-running greedy agreement.  ``arch``: FULL, or
    FULL_MOE for the MoE model (``path`` moe_main_path)."""
    import dataclasses

    cfg = model.ModelConfig(**arch)
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
        with _RouteLog(model) as want_routes:
            want, _ = einsum_step(p, ref, tokens, active)
        with _RouteLog(model) as got_routes:
            logits, cache = kernel_step(p, cache, tokens, active)
        diffs.append(_compare_routed(torch, logits, want,
                                     active.nonzero()[:, 0], got_routes.calls,
                                     want_routes.calls, cfg.moe_top_k))
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
        config=arch, dtype="bfloat16", slots=SLOTS, max_len=MAX_LEN,
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
    emit(path, **rec)
    if launches["flash_decode"] != want_launches or want_launches == 0:
        raise AssertionError(
            f"flash_decode launched {launches['flash_decode']} times, "
            f"want decode steps x layers = {want_launches}")
    _check_ticks(path, diffs)
    return rec, eng, [r.generated for r in reqs]


def phase_paged_main_path(torch, np, attention, model, serving, paged,
                          arch=FULL, path="paged_main_path"):
    """The paged-KV server at full width: warm pass (with the einsum
    gather route on identical inputs every tick, and every token write
    held to its plain version: _TokenWriteLog), then the timed pass
    (the decode step replayed from its CUDA graph) whose kernel launches
    are counted by name on the card (_measured_launches) and held to
    attention.LAUNCHES and to the calls made, then the same traffic
    through an einsum-route engine for free-running greedy agreement.
    ``arch``: FULL, or FULL_MOE (``path`` moe_paged_main_path).  Returns
    (record, the median tick's tables and lengths, the engine, the warm
    pass's tokens and logits rows, the warm pass's median decode step's
    token-write inputs)."""
    import dataclasses

    cfg = model.ModelConfig(**arch)
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
        # Both steps run eagerly, so that each call's routes are logged
        # (a replayed graph calls no Python); the timed pass replays,
        # and paged_decode_graph_check holds replays to eager calls.
        ticks_seen.append((tables.clone(), (cache.lengths + 1).tolist()))
        ref = paged.PagedKVCache(cache.k.clone(), cache.v.clone(),
                                 cache.lengths.clone())
        with _RouteLog(model) as want_routes:
            want, _ = einsum_step.eager(p, ref, tables, tokens, active)
        with _RouteLog(model) as got_routes:
            logits, cache = kernel_step.eager(p, cache, tables, tokens,
                                              active)
        diffs.append(_compare_routed(
            torch, logits, want, active.nonzero()[:, 0].to(logits.device),
            got_routes.calls, want_routes.calls, cfg.moe_top_k))
        _note_plain_rows(eng, logits, active, index, rows)
        return logits, cache

    eng._decode = compared_step
    with _TokenWriteLog(torch, attention, paged, cfg.n_layers) as writes:
        warm_s = _serve_all(eng, warm)
    eng._decode = kernel_step
    kernel_fill, fills = eng._prefill, []

    def counted_fill(*args):
        fills.append(1)
        return kernel_fill(*args)

    eng._prefill = counted_fill

    reqs = _requests(serving, np, cfg, PAGED_PROMPT_LENS)
    ticks0, steps0, pre0 = eng.ticks, eng.decode_steps, eng.preemptions
    captures0, replays0 = eng.decode_graph_captures, eng.decode_graph_replays
    attention.reset_launch_counts()
    (dt, peak), profiled = _measured_launches(
        torch, lambda: _serve_ticks(eng, reqs))
    launches = dict(attention.LAUNCHES)
    eng._prefill = kernel_fill
    want_fills = len(fills) * cfg.n_layers
    steps = eng.decode_steps - steps0
    preemptions = eng.preemptions - pre0
    captures = eng.decode_graph_captures - captures0
    replays = eng.decode_graph_replays - replays0
    ran, nodes, bad = _decode_launches(cfg, kernel_step, launches, profiled,
                                       steps, replays, captures)
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
        config=arch, dtype="bfloat16", **geometry,
        prompt_lens=PAGED_PROMPT_LENS, new_tokens=NEW_TOKENS,
        warm_seconds=warm_s, seconds=dt, ticks=eng.ticks - ticks0,
        decode_steps=steps, decoded_tokens=decoded,
        decode_tokens=eng.decode_tokens, tokens_per_s=decoded / dt,
        timed_pass="profiled (device only)",
        preemptions=preemptions, peak_concurrent_sequences=peak,
        decode_graph_replays=replays, decode_graph_captures=captures,
        graph_kernel_nodes=nodes,
        paged_flash_decode_launches=ran["paged_flash_decode"],
        paged_token_write_launches=ran["paged_token_write"],
        flash_decode_launches=launches["flash_decode"],
        expected_launches=(steps + captures) * cfg.n_layers,
        prefill_calls=len(fills),
        paged_flash_prefill_launches=launches["paged_flash_prefill"],
        expected_prefill_launches=want_fills,
        profiled_launches=profiled,
        token_writes_checked=writes.calls,
        token_writes_unequal=writes.unequal,
        token_write_entries_written=writes.written,
        einsum_seconds=einsum_s,
        einsum_tokens_per_s=decoded / einsum_s,
        einsum_preemptions=eeng.preemptions,
        **_compare_record(diffs, firsts),
        greedy_tokens_agree=agree, greedy_prefix_agree=sum(firsts),
        greedy_tokens_total=decoded, mid_tick_lengths=mid_lengths)
    emit(path, **rec)
    if bad or ran["paged_flash_decode"] != rec["expected_launches"]:
        raise AssertionError(
            f"{path}: K4/K8 launched {ran}, want (decode steps + captures) "
            f"x layers = {rec['expected_launches']}; {bad}")
    if writes.unequal or not writes.calls or not writes.written:
        raise AssertionError(
            f"{path}: {writes.unequal} of {writes.calls} token writes "
            f"differ from the plain version ({writes.written} entries "
            f"written)")
    if launches["flash_decode"] != 0:
        raise AssertionError(f"flash_decode launched "
                             f"{launches['flash_decode']} times on the "
                             f"paged path")
    if launches["paged_flash_prefill"] != want_fills or want_fills == 0:
        raise AssertionError(
            f"paged_flash_prefill launched "
            f"{launches['paged_flash_prefill']} times, want prefill calls "
            f"x layers = {want_fills}")
    if preemptions == 0:
        raise AssertionError(f"the {path} never preempted")
    _check_ticks(path, diffs)
    by_rows = sorted(writes.steps, key=lambda w: int(w[4].sum()))
    return (rec, (mid_tables, mid_lengths), eng,
            ([r.generated for r in warm], rows), by_rows[len(by_rows) // 2])


#: The graph check's small dropless MoE: the main path's widths with 8
#: SwiGLU experts of 1,024, top 2, no capacity (Mellum2's route).
GRAPH_MOE = dict(FULL, moe_experts=8, moe_top_k=2, moe_capacity_factor=None,
                 d_ff=1024)


def _timed_calls(torch, fn, events):
    """``fn`` with CUDA events recorded around each call into
    ``events``."""
    def timed(*args):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn(*args)
        ev[1].record()
        events.append(ev)
        return out
    return timed


def _token_write_check(torch, attention, dtype) -> dict:
    """The paged_token_write kernel against its plain version, bit for
    bit, on one layer's pools at the paged main path's geometry
    (NUM_BLOCKS blocks of BLOCK_SIZE, MAX_LEN // BLOCK_SIZE table
    entries, PAGED_SLOTS rows, its KV heads and head size): inactive
    rows, a row with no block at its position (-1), two whose entry is
    past the pool, a row past its table (its last entry), positions on
    both sides of a block edge; new k/v as the step hands them (views of
    the packed qkv, or contiguous)."""
    g = torch.Generator(device="cuda").manual_seed(7)
    nb, bs, tpr, slots = NUM_BLOCKS, BLOCK_SIZE, MAX_LEN // BLOCK_SIZE, \
        PAGED_SLOTS
    hkv, d = FULL["n_kv_heads"], FULL["d_model"] // FULL["n_heads"]
    positions = [0, 15, 16, 33, 47, 3, 20, 127, 128, MAX_LEN + 5, 64, 31,
                 32, 1, 95, 1023]
    pools = torch.randn((2, nb, hkv, bs, d), generator=g, device="cuda")
    pools = pools.to(dtype)
    # Each row's entries up to its position hold distinct blocks; the
    # rest are -1, as the allocator leaves them.
    need = [min(pos // bs, tpr - 1) + 1 for pos in positions]
    blocks = torch.randperm(nb, generator=g, device="cuda")[:sum(need)]
    tables = torch.full((slots, tpr), -1, dtype=torch.int32, device="cuda")
    at = 0
    for row, n in enumerate(need):
        tables[row, :n] = blocks[at:at + n]
        at += n
    tables[3, 2], tables[5, 0], tables[6, 1] = -1, nb, nb + 5
    positions = torch.tensor(positions, dtype=torch.int32, device="cuda")
    active = torch.ones(slots, dtype=torch.bool, device="cuda")
    active[[2, 11, 14]] = False
    qkv = torch.randn((slots, 1, 4 * hkv * d), generator=g, device="cuda")
    qkv = qkv.to(dtype).reshape(slots, 1, 4 * hkv, d).transpose(1, 2)
    k_view, v_view = qkv[:, 2 * hkv:3 * hkv], qkv[:, 3 * hkv:]
    out = {}
    for name, k, v in (("views", k_view, v_view),
                       ("contiguous", k_view.contiguous(), v_view)):
        got, want = pools.clone(), pools.clone()
        attention.paged_token_write(got[0], got[1], k, v, tables,
                                    positions, active)
        attention.paged_token_write_reference(want[0], want[1], k, v,
                                              tables, positions, active)
        torch.cuda.synchronize()
        out[name] = bool(torch.equal(got, want))
        out[f"{name}_entries_written"] = int((got != pools).any(
            dim=-1).sum())
    return out


def phase_token_write_timing(torch, attention, flush, call) -> dict:
    """K8 at the paged main path's median decode step (by rows that
    write), on a layer's pools of the path's shape: its device time, its
    plain version's (the write lists and the masked ``index_put_``), and
    the least time for its bytes (each writing row's k and v read and
    written, one table entry, and every row's position and flag)."""
    k, v, tables, positions, active = call
    slots, hkv, _, d = k.shape
    pools = torch.zeros((2, NUM_BLOCKS, hkv, BLOCK_SIZE, d), dtype=k.dtype,
                        device="cuda")
    ms = _time_ms(torch, lambda: attention.paged_token_write(
        pools[0], pools[1], k, v, tables, positions, active), flush)
    plain_ms = _time_ms(torch, lambda: attention.paged_token_write_reference(
        pools[0], pools[1], k, v, tables, positions, active), flush)
    rows = int(active.sum())
    moved = rows * (4 * hkv * d * k.element_size() + 4) + slots * (4 + 1)
    rec = dict(shape=dict(slots=slots, hkv=hkv, d=d, nb=NUM_BLOCKS,
                          bs=BLOCK_SIZE, tpr=tables.shape[1],
                          dtype=str(k.dtype)),
               active_rows=rows, ms=ms, plain_ms=plain_ms,
               bound_ms=moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               bytes=moved)
    emit("token_write_timing", **rec)
    return rec


def phase_paged_decode_graph_check(torch, np, attention, model, serving,
                                   paged, label="dense", arch=FULL):
    """The one-device paged decode step replayed from its CUDA graph
    against the same step run eagerly (``PagedDecodeStep.eager``), at
    the paged main path's geometry: the same traffic through one engine
    of each route, for ``arch`` (FULL, or GRAPH_MOE under a tracer, so
    that the dropless route's ``serve.moe`` counter rows are kept),
    must give the same tokens, ticks and preemptions over admissions,
    finishes and preemptions and the same counter rows, with every
    decode step after the first two replayed.  Each route's K4 and K8
    launches are those of its eager runs and of its graph's kernel
    nodes a replay (_decode_launches, read from the graph) and must
    equal attention.LAUNCHES, and no more than a profiler counts on the
    card; the replayed route's K7 equal the eager route's, and its K4
    and K8 the eager route's plus one step's (the capture's warm-up
    run) a capture.  Then a copy of a mid-run pool is a changed pool:
    the step runs it eagerly, captures it on its second call, and that
    replay equals the eager call bit for bit.  The token-write kernel
    is held to its plain version first.  Emits each route's median
    device ms a decode step (CUDA events around the call)."""
    from tpu_autoscaler_torch.obs.trace import Tracer

    path = f"paged_decode_graph_check.{label}"
    writes = {str(dt): _token_write_check(torch, attention, dt)
              for dt in (torch.bfloat16, torch.float32)}
    cfg = model.ModelConfig(**arch)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg, "cuda")
    geometry = dict(slots=PAGED_SLOTS, max_len=MAX_LEN,
                    block_size=BLOCK_SIZE, num_blocks=NUM_BLOCKS,
                    chunk=CHUNK, prefill_lanes=PREFILL_LANES)
    runs, mid = {}, []
    for route in ("graph", "eager"):
        tracer = None if cfg.moe_experts is None else Tracer()
        eng = paged.PagedBatcher(params, cfg, device="cuda", tracer=tracer,
                                 **geometry)
        step, events = eng._decode_step, []
        run = step if route == "graph" else step.eager
        timed = _timed_calls(torch, run, events)

        def decode(p, cache, tables, tokens, active, timed=timed,
                   events=events, route=route):
            if route == "graph" and len(events) == 40:
                mid.append((cache.k.clone(), cache.v.clone(),
                            cache.lengths.clone(), tables.clone(),
                            tokens.clone(), active.clone()))
            return timed(p, cache, tables, tokens, active)

        eng._decode = decode
        reqs = _requests(serving, np, cfg, PAGED_PROMPT_LENS)
        attention.reset_launch_counts()
        (dt, _), profiled = _measured_launches(
            torch, lambda: _serve_ticks(eng, reqs))
        launches = dict(attention.LAUNCHES)
        ran, nodes, faults = _decode_launches(
            cfg, step, launches, profiled, eng.decode_steps,
            eng.decode_graph_replays, eng.decode_graph_captures)
        counter = None if tracer is None else tracer.counter("serve.moe")
        runs[route] = dict(
            tokens=[list(r.generated) for r in reqs], ticks=eng.ticks,
            preemptions=eng.preemptions, decode_steps=eng.decode_steps,
            launches=dict(ran, paged_flash_prefill=launches[
                "paged_flash_prefill"]),
            profiled_launches=profiled, graph_kernel_nodes=nodes,
            launch_faults=faults,
            moe_rows=None if counter is None else counter.read(),
            moe_dropped=None if counter is None else counter.dropped,
            replays=eng.decode_graph_replays,
            captures=eng.decode_graph_captures,
            eager_steps=eng.decode_eager_steps, seconds=dt,
            decode_ms=statistics.median(a.elapsed_time(b)
                                        for a, b in events))
        if route == "graph":
            graph_eng = eng
    graph, eager = runs["graph"], runs["eager"]

    # A changed pool: a copy of the pool at the 41st decode call.
    k, v, lengths, tables, tokens, active = mid[0]
    step = graph_eng._decode_step
    captures, replays = step.captures, step.replays

    def call(fn, k_pool, v_pool):
        cache = paged.PagedKVCache(k_pool, v_pool, lengths.clone())
        return fn(graph_eng.params, cache, tables, tokens, active)[0]

    k2, v2 = k.clone(), v.clone()
    first = call(step, k2, v2)
    again = call(step, k2, v2)
    ek, ev = k.clone(), v.clone()
    by_eager = call(step.eager, ek, ev)
    torch.cuda.synchronize()
    recapture = dict(
        captures=step.captures - captures, replays=step.replays - replays,
        replay_equals_first_call=bool(torch.equal(again, first)),
        replay_equals_eager=bool(torch.equal(again, by_eager)),
        pools_equal=bool(torch.equal(k2, ek) and torch.equal(v2, ev)))
    rec = dict(
        label=label, config=arch, dtype="bfloat16", **geometry,
        prompt_lens=PAGED_PROMPT_LENS, new_tokens=NEW_TOKENS,
        token_write=writes, recapture=recapture,
        **{f"{route}_{key}": value for route, r in runs.items()
           for key, value in r.items()
           if key not in ("tokens", "moe_rows", "launches")},
        graph_launches=graph["launches"], eager_launches=eager["launches"],
        tokens_equal=graph["tokens"] == eager["tokens"],
        moe_rows_equal=graph["moe_rows"] == eager["moe_rows"],
        moe_rows=None if graph["moe_rows"] is None
        else len(graph["moe_rows"]))
    emit(path, **rec)
    bad = [name for name, ok in (
        ("token_write", all(all(v for key, v in w.items()
                                if not key.endswith("written"))
                            for w in writes.values())),
        ("tokens", rec["tokens_equal"]),
        ("ticks", graph["ticks"] == eager["ticks"] >= 64),
        ("preemptions", graph["preemptions"] == eager["preemptions"] > 0),
        ("launches", not graph["launch_faults"]
         and not eager["launch_faults"]
         and eager["launches"]["paged_flash_decode"]
         == eager["launches"]["paged_token_write"]
         == eager["decode_steps"] * cfg.n_layers
         and graph["launches"] == dict(
             eager["launches"], **{
                 k: eager["launches"][k] + graph["captures"] * cfg.n_layers
                 for k in ("paged_flash_decode", "paged_token_write")})),
        ("moe_rows", rec["moe_rows_equal"]
         and graph["moe_dropped"] == eager["moe_dropped"]),
        ("graph_route", graph["captures"] == 1
         and graph["replays"] == graph["decode_steps"] - 1
         and graph["eager_steps"] == 1),
        ("eager_route", eager["replays"] == 0
         and eager["eager_steps"] == eager["decode_steps"]),
        ("recapture", recapture["captures"] == 1
         and recapture["replays"] == 1
         and all(v for key, v in recapture.items()
                 if key not in ("captures", "replays")))) if not ok]
    if bad:
        raise AssertionError(f"{path}: the replayed route differs from the "
                             f"eager route in {bad}")
    return rec


def phase_profile(torch, np, serving, eng, path, prompt_lens, syncs=None,
                  host=True):
    """Where a steady window of a main path spends device time:
    torch.profiler over PROFILE_TICKS engine ticks (after 5 warm ones)
    of a fresh pass of the same traffic.  ``syncs``: counters of the
    engine's host copies of logits, zeroed for the window and
    reported with it.  ``host=False`` traces the card alone, which
    the device time and launches need: the mesh paths' windows hold
    ~50k launches, whose host trace the profiler is slow to process."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if host:
        activities.insert(0, ProfilerActivity.CPU)

    for r in _requests(serving, np, eng.cfg, prompt_lens):
        eng.submit(r)
    for _ in range(5):
        eng.tick()
    torch.cuda.synchronize()
    for name in syncs or ():
        syncs[name] = 0
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_TICKS):
            eng.tick()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    window = dict(syncs or {})
    eng.run()
    _emit_profile(path, "ticks", PROFILE_TICKS, prof, wall_ms,
                  host_logit_syncs=window or None,
                  traced=None if host else "card only")


# Device kernels by class, the first pattern their name matches: the
# port's attention kernels, cuBLAS/CUTLASS products, copies (the casts
# of f32 masters to bf16 and the moves between ranks), adds (the
# replicas' gradient sums, the residual stream, the update), reductions.
KERNEL_CLASSES = (
    ("attention", re.compile(r"flash|ring_|decode_kernel|tc_kernel")),
    ("gemm", re.compile(r"gemm|xmma|cutlass|nvjet|wgmma|sm90_", re.I)),
    ("copy", re.compile(r"copy|Memcpy", re.I)),
    ("add", re.compile(r"add", re.I)),
    ("reduce", re.compile(r"reduce", re.I)),
)


def _kernel_class(name: str) -> str:
    return next((c for c, pat in KERNEL_CLASSES if pat.search(name)),
                "other")


def _emit_profile(path, unit, count, prof, wall_ms, **extra) -> dict:
    """Device busy time, idle share, device time and launches by kernel
    class (KERNEL_CLASSES) and the top kernels of a window of ``count``
    engine ticks, decode steps or train steps (``unit``)."""
    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    by_class = {}
    for e in kernels:
        c = by_class.setdefault(_kernel_class(e.key),
                                dict(device_ms=0.0, calls=0))
        c["device_ms"] += dev_us(e) / 1e3
        c["calls"] += e.count
    rec = dict(path=path, **{unit: count}, profiled_wall_ms=wall_ms,
               device_busy_ms=busy_ms if busy_ms > 0 else None,
               kernel_launches=sum(e.count for e in kernels),
               device_idle_share=(1 - busy_ms / wall_ms) if busy_ms > 0
               else None,
               device_by_class=by_class,
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


def _decode_diffs(torch, model, decode, params, prompt, kcfg, ecfg,
                  max_len):
    """The kernel route against the einsum route on identical inputs:
    prefill's logits over every [b, s] position (K1's check on the
    path), then COMPARE_TICKS decode steps, each from a copy of the
    kernel route's cache and the same token; with MoE layers only over
    the rows both routes routed alike (_routed_apart; in prefill a
    routing difference reaches the row's later positions through
    attention and capacity, so the whole row is set apart).  Returns
    (prefill max |dlogits| (None when every row was routed apart), the
    rows it covers, whether prefill's logits are finite, [(mean, max,
    finite)] per step, every row routed apart)."""
    rows = set(range(prompt.shape[0]))
    k = kcfg.moe_top_k
    with _RouteLog(model) as got:
        logits, cache = decode.prefill(params, prompt, kcfg, max_len)
    with _RouteLog(model) as ref_routes:
        want, _ = decode.prefill(params, prompt, ecfg, max_len)
    apart = list(_routed_apart(got.calls, ref_routes.calls, k,
                               rows).items())
    same = sorted(rows - {r for r, _ in apart})
    prefill_max = (logits[same] - want[same]).abs().max().item() \
        if same else None
    prefill_rows = len(same)
    finite = bool(torch.isfinite(logits).all())
    del want
    token = torch.argmax(logits[:, -1], -1).to(torch.int32)
    diffs = []
    for _ in range(COMPARE_TICKS):
        ref = decode.KVCache(cache.k.clone(), cache.v.clone(), cache.length)
        with _RouteLog(model) as ref_routes:
            want, _ = decode.decode_step(params, ref, token, ecfg)
        with _RouteLog(model) as got:
            logits, cache = decode.decode_step(params, cache, token, kcfg)
        step_apart = _routed_apart(got.calls, ref_routes.calls, k, rows)
        apart += list(step_apart.items())
        same = sorted(rows - set(step_apart))
        dl = (logits[same] - want[same]).abs()
        diffs.append((dl.mean().item() if same else 0.0,
                      dl.max().item() if same else 0.0,
                      bool(torch.isfinite(logits).all())))
        token = torch.argmax(logits, -1).to(torch.int32)
    return prefill_max, prefill_rows, finite, diffs, [a for _, a in apart]


def phase_generate_main_path(torch, np, attention, model, decode, label,
                             arch, prompt_len, steps):
    """decode.generate at full width through its public API (a MoE
    ``arch`` emits moe_generate_main_path): a warm
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
    prefill_max, prefill_rows, prefill_finite, diffs, apart = _decode_diffs(
        torch, model, decode, cast, prompt, cfg, ecfg, max_len)
    del cast
    want = _kernel_launches(attention, flash_attention=cfg.n_layers,
                            flash_decode=(steps - 1) * cfg.n_layers)
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
        prefill_dlogits_max=prefill_max, prefill_rows_compared=prefill_rows,
        compare_steps=len(diffs),
        dlogits_mean=statistics.fmean(d[0] for d in diffs),
        dlogits_max=max(d[1] for d in diffs),
        greedy_tokens_agree=int(equal.sum()), greedy_prefix_agree=prefix,
        greedy_tokens_total=GEN_BATCH * steps,
        routed_apart=dict(rows=len(apart),
                          near_ties=sum(a[2] for a in apart),
                          router_dlogits_max=max((a[1] for a in apart),
                                                 default=0.0)))
    moe = cfg.moe_experts is not None
    emit("moe_generate_main_path" if moe else "generate_main_path", **rec)
    if not all(a[2] for a in apart):
        raise AssertionError(f"generate ({label}): rows routed apart from "
                             f"the einsum route away from a near tie: "
                             f"{apart}")
    if any(n != want for n in launches):
        raise AssertionError(f"generate ({label}) launched {launches}, "
                             f"want {want} per call")
    if not (prefill_finite and all(d[2] for d in diffs)
            and bool(torch.isfinite(out).all())):
        raise AssertionError(f"non-finite logits on the generate path "
                             f"({label})")
    if not ((prefill_max is None or prefill_max < DLOGITS_MAX)
            and rec["dlogits_max"] < DLOGITS_MAX):
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
    read just after: K4 once per draft layer per draft step (and per
    draft-step capture's warm-up run), K1 and K3 never."""
    eng, cfg, geometry = _spec_engine(torch, model, spec_serving,
                                      DRAFT_LAYERS)
    draft = eng._d_decode
    warm = _requests(serving, np, cfg, PAGED_PROMPT_LENS)
    spec_rows, draft_ticks = {}, []
    _, _, restore = _watch_spec_engine(
        eng, {id(r): n for n, r in enumerate(warm)}, spec_rows, draft_ticks)
    warm_s, _ = _serve_ticks(eng, warm, check=True)
    restore()
    syncs, _, _ = _watch_spec_engine(eng)

    reqs = _requests(serving, np, cfg, PAGED_PROMPT_LENS)
    before = _spec_counters(eng)
    captures = draft.captures
    attention.reset_launch_counts()
    dt, peak = _serve_ticks(eng, reqs, check=True)
    launches = dict(attention.LAUNCHES)
    econ = _spec_economics(before, _spec_counters(eng))
    pass_syncs = dict(syncs)
    if eng.allocator.used_blocks or eng.d_allocator.used_blocks:
        raise AssertionError("drained speculative engine holds blocks")
    decoded = sum(len(r.generated) for r in reqs)
    want_k4 = (pass_syncs["draft_decode"] + draft.captures - captures) \
        * DRAFT_LAYERS
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
            f"times, want (draft steps + captures) x draft layers = "
            f"{want_k4}")
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
    per layer per draft step and per draft-step capture's warm-up run,
    K1 and K3 never); its greedy tokens held against the plain engine's
    (``plain``) as in spec_main_path."""
    eng, cfg, geometry = _spec_engine(torch, model, spec_serving,
                                      FULL["n_layers"])
    draft = eng._d_decode
    reqs = _requests(serving, np, cfg, PAGED_PROMPT_LENS)
    spec_rows = {}
    syncs, replays, restore = _watch_spec_engine(
        eng, {id(r): n for n, r in enumerate(reqs)}, spec_rows)
    before = _spec_counters(eng)
    captures = draft.captures
    attention.reset_launch_counts()
    dt, peak = _serve_ticks(eng, reqs, check=True)
    launches = dict(attention.LAUNCHES)
    restore()
    econ = _spec_economics(before, _spec_counters(eng))
    if eng.allocator.used_blocks or eng.d_allocator.used_blocks:
        raise AssertionError("drained speculative engine holds blocks")
    want_k4 = (syncs["draft_decode"] + draft.captures - captures) \
        * cfg.n_layers
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
            f"times, want (draft steps + captures) x layers = {want_k4}")
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

    def decode_step(p, cache, tokens, c, mesh=None):
        counts["draft_decode"] += c is dcfg
        return step(p, cache, tokens, c, mesh)

    def extend_step(p, cache, tokens, c, mesh=None):
        first = cache.length + 1 - prompt_len
        logits, cache = extend(p, cache, tokens, c, mesh)
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

    def decode_step(p, cache, tokens, c, mesh=None):
        logits, cache = step(p, cache, tokens, c, mesh)
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


def _active_params(n_params, cfg) -> int:
    """The params a token's forward reads: every param but the experts a
    token does not visit (E - k of each MoE layer's E expert MLPs)."""
    if cfg.moe_experts is None:
        return n_params
    unvisited = cfg.moe_experts - cfg.moe_top_k
    return n_params - cfg.n_layers * unvisited * 2 * cfg.d_model * cfg.d_ff


def _first_metrics(torch, model, params, tokens, kcfg, ecfg) -> dict:
    """The router losses of the first step's forward on both routes, and
    the batch rows the two routes routed apart (_routed_apart)."""
    out = {}
    with torch.no_grad():
        for name, c in (("kernel", kcfg), ("einsum", ecfg)):
            with _RouteLog(model) as log:
                _, m = model.loss_and_metrics(params, tokens, c)
            out[name] = ({k: m[k].item() for k in ("balance_loss", "z_loss")},
                         log.calls)
    apart = _routed_apart(out["kernel"][1], out["einsum"][1], kcfg.moe_top_k,
                          set(range(tokens.shape[0])))
    return dict(first_metrics=out["kernel"][0],
                einsum_first_metrics=out["einsum"][0],
                first_step_rows_routed_apart=len(apart))


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
    memorises it).  A MoE ``arch`` (phase moe_train_main_path) also
    reports both routes' first router losses, and counts its MFU on the
    active params (_active_params)."""
    import dataclasses

    cfg = model.ModelConfig(**arch)
    init_fn, step_fn = model.make_train_step(cfg, device="cuda")
    params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for _, p in model._flatten(params))
    n_active = _active_params(n_params, cfg)
    moe = cfg.moe_experts is not None
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (batch, cfg.seq_len + 1)).astype(np.int32)).cuda()
    want = _kernel_launches(
        attention, flash_attention=(2 if cfg.remat else 1) * cfg.n_layers,
        flash_attention_bwd_dq=cfg.n_layers,
        flash_attention_bwd_dkv=cfg.n_layers)
    ecfg = dataclasses.replace(cfg, attention="einsum")
    rec = dict(path=path, config=arch, dtype="bfloat16", batch=batch,
               n_params=n_params, warm_steps=warm, timed_steps=steps)
    if moe:
        rec.update(n_active_params=n_active, **_first_metrics(
            torch, model, params, tokens, cfg, ecfg))
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
    flops = _train_flops(n_active, cfg, batch)
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
    emit("moe_train_main_path" if moe else "train_main_path", **rec)
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
    """K5 and K6 in 18 cases each; the first two are the SP main path's
    hops (b 2, h 8, s_loc 2048, d 128, bf16), timed: an unmasked hop (6
    of each layer's 10 visible hops) and a diagonal one (4 of 10).  Then
    the main hop at head_dim 96 (zero-padded to 128, timed with its
    padding copy) and an unmasked bf16 hop at d 256; the last two, timed,
    the sp×tp path's hops (one data row, 4 of the 8 heads, s_loc 4096:
    its unmasked hop, 1 of each ring's 3, and its diagonal, 2 of 3)."""
    s_loc = SP_FULL["seq_len"] // SP_RANKS
    sp_tp_loc = SP_FULL["seq_len"] // SP_TP_MESH[1]
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
        dict(main, label="sp-tp-unmasked", b=SP_BATCH // SP_TP_MESH[0],
             h=8 // SP_TP_MESH[2], hkv=8 // SP_TP_MESH[2], sq=sp_tp_loc,
             sk=sp_tp_loc, offset=sp_tp_loc, masked=False, timed=True),
        dict(main, label="sp-tp-diag", b=SP_BATCH // SP_TP_MESH[0],
             h=8 // SP_TP_MESH[2], hkv=8 // SP_TP_MESH[2], sq=sp_tp_loc,
             sk=sp_tp_loc, offset=0, masked=True, carry="fresh", timed=True),
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
    devices = sp.make_sp_mesh(["cuda:0"] * SP_RANKS, sp=SP_RANKS)
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
               ranks=SP_RANKS, devices=[str(d) for d in devices.ranks],
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
        devices = sp.make_sp_mesh(["cuda:0"] * world, sp=world)
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


def phase_ep_train_main_path(torch, np, attention, model, moe):
    """Expert-parallel training (moe.make_ep_train_step) of the MoE step
    model on the step's batch, EP_RANKS ranks on the one card (data 1):
    at capacity factor EP_NO_DROP, nothing drops, and the first-step loss
    and gradient norm must equal the one-device MoE step's within the
    step's bf16 bounds; at the model's 1.25, TRAIN_WARM warm and
    TRAIN_STEPS timed steps whose launches are counted per step (K1 and
    each K2 kernel once per rank per layer; K3-K6 never), the loss
    falling."""
    import dataclasses

    cfg = model.ModelConfig(**TRAIN_MOE)
    mesh = moe.make_ep_mesh(["cuda"] * EP_RANKS, ep=EP_RANKS)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg, "cuda")
    n_params = sum(p.numel() for _, p in model._flatten(params))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (TRAIN_BATCH, cfg.seq_len + 1)).astype(np.int32)).cuda()
    ncfg = dataclasses.replace(cfg, moe_capacity_factor=EP_NO_DROP)
    ep_loss = moe.make_ep_loss(mesh, ncfg)
    first = {}
    for name, loss_of in (("ep", lambda p, t: ep_loss(p, t)[0]),
                          ("single_device",
                           lambda p, t: model.loss_fn(p, t, ncfg))):
        first[name] = _loss_and_grad_norm(torch, model, params, tokens,
                                          loss_of)
        torch.cuda.empty_cache()
    _, step4 = moe.make_ep_train_step(mesh, cfg)
    opt = model.make_optimizer(model.TrainConfig()).init(params)
    metrics = []

    def step_fn(p, o, t):
        p, o, loss, m = step4(p, o, t)
        metrics.append(m)
        return p, o, loss

    zero = dict.fromkeys(attention.LAUNCHES, 0)
    want = {**zero, "flash_attention": EP_RANKS * cfg.n_layers,
            "flash_attention_bwd_dq": EP_RANKS * cfg.n_layers,
            "flash_attention_bwd_dkv": EP_RANKS * cfg.n_layers}
    torch.cuda.reset_peak_memory_stats()
    params, opt, losses, launches, step_s = _train_steps(
        torch, attention, step_fn, params, opt, tokens, TRAIN_WARM,
        TRAIN_STEPS)
    flops = _train_flops(_active_params(n_params, cfg), cfg, TRAIN_BATCH)
    last = metrics[-1]
    rec = dict(config=TRAIN_MOE, dtype="bfloat16", batch=TRAIN_BATCH,
               ranks=EP_RANKS, data=1, no_drop_capacity_factor=EP_NO_DROP,
               first_loss={n: v[0] for n, v in first.items()},
               first_grad_norm={n: v[1] for n, v in first.items()},
               warm_steps=TRAIN_WARM, timed_steps=TRAIN_STEPS,
               step_ms=step_s * 1e3,
               tokens_per_s=TRAIN_BATCH * cfg.seq_len / step_s,
               mfu=flops / (step_s * BF16_OPS_PER_S),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               losses=losses,
               ce=[m["ce"].item() for m in metrics],
               balance_loss=[m["balance_loss"].item() for m in metrics],
               z_loss=[m["z_loss"].item() for m in metrics],
               expert_fraction=last["expert_fraction"].tolist(),
               launches_per_step=launches[-1],
               expected_launches_per_step=want)
    del params, opt
    torch.cuda.empty_cache()
    emit("ep_train_main_path", **rec)
    if any(n != want for n in launches):
        raise AssertionError(f"ep train step launched {launches}, want "
                             f"{want} per step")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"ep: loss not finite or did not fall: "
                             f"{losses}")
    if not abs(sum(rec["expert_fraction"]) - 1.0) <= 1e-5:
        raise AssertionError(f"ep: expert_fraction {rec['expert_fraction']}")
    (el, en), (sl, sn) = first["ep"], first["single_device"]
    if not (abs(el - sl) <= TRAIN_LOSS_GAP
            and abs(en - sn) <= TRAIN_GRAD_NORM_RTOL * sn):
        raise AssertionError(f"ep at no-drop capacity: loss {el}, grad norm "
                             f"{en} vs one device {sl}, {sn}")
    return rec


def _mesh_loss_and_grad_norm(torch, model, mesh, cfg, params, tokens):
    """The mesh step's loss on ``params`` (Sharded trees) and the global
    norm of its gradient, every block counted once."""
    return _blocks_loss_and_grad_norm(
        torch, model, model._make_mesh_loss(mesh, cfg.resolved_for_mesh(mesh)),
        params, tokens)


def _blocks_loss_and_grad_norm(torch, model, loss_of, params, tokens):
    """``loss_of(params, tokens)`` on ``params`` (trees of Sharded
    leaves, a block on every rank) and the global norm of its gradient:
    each block's gradient summed over the ranks that hold it, then every
    block counted once."""
    import dataclasses

    flat = dict(model._flatten(params))
    live = {path: dataclasses.replace(leaf, blocks={
        r: t.detach().requires_grad_() for r, t in leaf.blocks.items()})
        for path, leaf in flat.items()}
    keys = [(path, leaf.indices[r], t) for path, leaf in live.items()
            for r, t in leaf.blocks.items()]
    loss = loss_of(model._unflatten(live), tokens)
    grads = torch.autograd.grad(loss, [t for *_, t in keys],
                                allow_unused=True)
    sums = {}
    for (path, index, _), g in zip(keys, grads):
        if g is not None:
            prev = sums.get((path, index))
            sums[path, index] = g if prev is None else prev + g.to(prev.device)
    norm = torch.sqrt(sum(g.float().square().sum() for g in sums.values()))
    return loss.item(), norm.item()


def phase_mesh_train_main_path(torch, np, attention, model):
    """``model.make_sharded_train_step`` of the step cell (TRAIN_FULL,
    batch TRAIN_BATCH) on a dp 4 × tp 2 mesh of MESH_RANKS ranks on the
    one card, in each shard mode from the same params (seed 0) and batch
    (numpy seed 1): the first-step loss and gradient norm against the
    one-device ``make_train_step``'s; MESH_WARM warm and MESH_STEPS timed
    steps whose launches are counted per step (K1 and each K2 kernel
    once per rank per layer, K3-K6 never); one profiled step; the bytes
    of params and optimizer state each rank stores as placed
    (``model.rank_state_bytes``: every rank its own blocks, a replicated
    block on each rank of its group, as JAX's devices hold them), and
    the card's allocation after init.  The modes' losses must agree
    within MESH_MODE_GAP, the loss must fall, the allocation must be the
    sum of the ranks' counted bytes (all ranks share the card, so under
    none it holds dp copies of the state), and the busiest rank's bytes
    must rank fsdp < zero1 < none."""
    cfg = model.ModelConfig(**TRAIN_FULL)
    mesh = model.make_mesh(["cuda:0"] * MESH_RANKS, tp=MESH_TP)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (TRAIN_BATCH, cfg.seq_len + 1)).astype(np.int32)).cuda()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg, "cuda")
    n_params = sum(p.numel() for _, p in model._flatten(params))
    one = _loss_and_grad_norm(torch, model, params, tokens,
                              lambda p, t: model.loss_fn(p, t, cfg))
    del params
    torch.cuda.empty_cache()
    zero = dict.fromkeys(attention.LAUNCHES, 0)
    per_step = MESH_RANKS * cfg.n_layers
    want = {**zero, "flash_attention": per_step,
            "flash_attention_bwd_dq": per_step,
            "flash_attention_bwd_dkv": per_step}
    flops = _train_flops(n_params, cfg, TRAIN_BATCH)
    modes = {}
    for shard in MESH_MODES:
        init_fn, step_fn = model.make_sharded_train_step(mesh, cfg,
                                                         shard=shard)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        card = torch.cuda.memory_allocated() - base
        held = model.rank_state_bytes(mesh, params, opt)
        n_blocks = sum(len(leaf.blocks) for tree in (params, opt["mu"],
                                                     opt["nu"])
                       for _, leaf in model._flatten(tree))
        first = _mesh_loss_and_grad_norm(torch, model, mesh, cfg, params,
                                         tokens)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params, opt, losses, launches, step_s = _train_steps(
            torch, attention, step_fn, params, opt, tokens, MESH_WARM,
            MESH_STEPS)
        peak = torch.cuda.max_memory_allocated() / 1e9
        prof = _profile_train(torch, step_fn, params, opt, tokens,
                              f"mesh_{shard}", 1)
        modes[shard] = dict(
            first_loss=first[0], first_grad_norm=first[1],
            step_ms=step_s * 1e3,
            tokens_per_s=TRAIN_BATCH * cfg.seq_len / step_s,
            mfu=flops / (step_s * BF16_OPS_PER_S), peak_memory_gb=peak,
            device_idle_share=prof["device_idle_share"],
            device_busy_ms=prof["device_busy_ms"],
            device_by_class=prof["device_by_class"],
            kernel_launches_per_step=prof["kernel_launches"],
            rank_state_bytes=held, card_state_bytes=card,
            state_blocks=n_blocks, losses=losses,
            launches_per_step=launches)
        del params, opt, init_fn, step_fn
        torch.cuda.empty_cache()
    gap = max(abs(a - b) for m in modes.values()
              for a, b in zip(m["losses"], modes["none"]["losses"]))
    rec = dict(config=TRAIN_FULL, dtype="bfloat16", batch=TRAIN_BATCH,
               mesh=dict(mesh.shape), ranks=MESH_RANKS, n_params=n_params,
               shard_shape=[TRAIN_BATCH // (MESH_RANKS // MESH_TP),
                            cfg.n_heads // MESH_TP, cfg.seq_len,
                            cfg.head_dim],
               warm_steps=MESH_WARM, timed_steps=MESH_STEPS,
               single_device_first_loss=one[0],
               single_device_first_grad_norm=one[1], modes=modes,
               max_mode_loss_gap=gap, mode_loss_gap_bound=MESH_MODE_GAP,
               launches_per_step=modes["none"]["launches_per_step"][-1],
               expected_launches_per_step=want)
    emit("mesh_train_main_path", **rec)
    for shard, m in modes.items():
        if any(n != want for n in m["launches_per_step"]):
            raise AssertionError(f"mesh step ({shard}) launched "
                                 f"{m['launches_per_step']}, want {want}")
        if not all(np.isfinite(m["losses"])) \
                or not m["losses"][-1] < m["losses"][0]:
            raise AssertionError(f"mesh step ({shard}): loss not finite or "
                                 f"did not fall: {m['losses']}")
        if not (abs(m["first_loss"] - one[0]) <= TRAIN_LOSS_GAP
                and abs(m["first_grad_norm"] - one[1])
                <= TRAIN_GRAD_NORM_RTOL * one[1]):
            raise AssertionError(
                f"mesh step ({shard}): first loss {m['first_loss']}, grad "
                f"norm {m['first_grad_norm']} vs one device {one}")
    if not gap <= MESH_MODE_GAP:
        raise AssertionError(f"mesh shard modes' losses differ by {gap}")
    for shard, m in modes.items():
        counted = sum(m["rank_state_bytes"])
        if not counted <= m["card_state_bytes"] \
                <= counted + ALLOC_SLACK * m["state_blocks"]:
            raise AssertionError(
                f"mesh step ({shard}): init allocated "
                f"{m['card_state_bytes']} bytes on the card, the placement "
                f"counts {counted} in {m['state_blocks']} blocks")
    held = {shard: max(m["rank_state_bytes"]) for shard, m in modes.items()}
    if not held["fsdp"] < held["zero1"] < held["none"]:
        raise AssertionError(f"busiest rank's state bytes {held}: want "
                             f"fsdp < zero1 < none")
    return rec


def time_mesh_step(root: str, modes: str = ",".join(MESH_MODES)) -> None:
    """``chip_smoke.py --time-mesh-step ROOT [MODES]``: the mesh step of
    phase_mesh_train_main_path (TRAIN_FULL, batch TRAIN_BATCH, dp 4 ×
    tp 2 on the card, params from seed 0) with the
    ``tpu_autoscaler_torch`` of the checkout at ROOT, in each shard mode
    of MODES (comma-separated): TRAIN_WARM warm steps and TRAIN_STEPS
    timed ones, each ending in a synchronise, then one profiled step
    (its device time by kernel class, _emit_profile); one JSON line per
    mode.  Two commits are compared on one card in one call by running
    it with each root in turn (parent, change, change, parent), the
    other unpacked with ``git archive`` into a directory that
    ``.gitignore`` lists."""
    sys.path.insert(0, str(Path(root).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time-mesh-step: no CUDA device")
    from tpu_autoscaler_torch.workloads import attention, model

    attention.build_kernels()
    cfg = model.ModelConfig(**TRAIN_FULL)
    mesh = model.make_mesh(["cuda:0"] * MESH_RANKS, tp=MESH_TP)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (TRAIN_BATCH, cfg.seq_len + 1)).astype(np.int32)).cuda()
    for shard in modes.split(","):
        init_fn, step_fn = model.make_sharded_train_step(mesh, cfg,
                                                         shard=shard)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        card = torch.cuda.memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for i in range(TRAIN_WARM + TRAIN_STEPS):
            t, (params, opt, loss) = _wall(
                torch, lambda: step_fn(params, opt, tokens))
            if i >= TRAIN_WARM:
                times.append(t * 1e3)
            losses.append(loss.item())
        peak = torch.cuda.max_memory_allocated() / 1e9
        prof = _profile_train(torch, step_fn, params, opt, tokens,
                              f"mesh_{shard}", 1)
        emit("time_mesh_step", root=str(root), shard=shard,
             mesh=dict(mesh.shape), step_ms=times,
             median_step_ms=statistics.median(times),
             card_state_bytes=card, peak_memory_gb=peak, losses=losses,
             profiled_wall_ms=prof["profiled_wall_ms"],
             device_busy_ms=prof["device_busy_ms"],
             device_by_class=prof["device_by_class"],
             device=torch.cuda.get_device_name(0))
        del params, opt, init_fn, step_fn
        torch.cuda.empty_cache()


def phase_small_mesh(torch, np, attention, model):
    """Small f32 models on a dp 4 × tp 2 mesh of the card (the kernel
    route) against the one-device step (K1/K2 whole), 5 steps from the
    same params and batches: losses within SMALL_TRAIN_LOSS_GAP and the
    params after them within SMALL_SP_PARAM_RTOL of each leaf's largest
    |value|; a MoE model (4 experts, top 2) in mode none, a GQA model
    under fsdp, MHA under zero1, and MQA (one KV head, which tp 2 cannot
    cut) under zero1.  Each mesh step must launch K1 and both K2
    kernels once per rank per layer (MQA: once per data row per layer,
    on the row's whole heads) and K3-K6 never."""
    base = dict(vocab=256, d_model=128, n_layers=2, d_ff=256, seq_len=64,
                dtype=torch.float32)
    mesh = model.make_mesh(["cuda:0"] * MESH_RANKS, tp=MESH_TP)
    rec = {}
    for label, extra, shard, attends in (
            ("moe-tp2-none", dict(n_heads=4, moe_experts=4, moe_top_k=2),
             "none", MESH_RANKS),
            ("gqa-fsdp", dict(n_heads=4, n_kv_heads=2), "fsdp", MESH_RANKS),
            ("mha-zero1", dict(n_heads=4), "zero1", MESH_RANKS),
            ("mqa-zero1", dict(n_heads=4, n_kv_heads=1), "zero1",
             MESH_RANKS // MESH_TP)):
        cfg = model.ModelConfig(**base, **extra)
        per_step = attends * cfg.n_layers
        want = {**dict.fromkeys(attention.LAUNCHES, 0),
                "flash_attention": per_step,
                "flash_attention_bwd_dq": per_step,
                "flash_attention_bwd_dkv": per_step}
        init_fn, one_step = model.make_train_step(cfg, device="cuda")
        params, opt = init_fn(
            torch.Generator(device="cuda").manual_seed(1))
        _, mesh_step = model.make_sharded_train_step(mesh, cfg, shard=shard)
        a = (params, opt)
        b = (model.shard_params(mesh, cfg, params, shard),
             model.shard_opt_state(mesh, cfg, opt, shard))
        rng = np.random.default_rng(2)
        losses = {"one_device": [], "mesh": []}
        launches = []
        for _ in range(5):
            tokens = torch.from_numpy(rng.integers(0, 256, (8, 65)).astype(
                np.int32)).cuda()
            *a, la = one_step(*a, tokens)
            attention.reset_launch_counts()
            *b, lb = mesh_step(*b, tokens)
            launches.append(dict(attention.LAUNCHES))
            losses["one_device"].append(la.item())
            losses["mesh"].append(lb.item())
        got = dict(model._flatten(model.gather_params(mesh, b[0])))
        param_err = max(
            ((got[p] - t).abs().max() / t.abs().max()).item()
            for p, t in model._flatten(a[0]))
        rec[label] = dict(shard=shard, losses=losses, param_rel_err=param_err,
                          max_gap=max(abs(x - y) for x, y in zip(
                              losses["one_device"], losses["mesh"])),
                          launches_per_step=launches[-1],
                          expected_launches_per_step=want,
                          launches_as_expected=all(n == want
                                                   for n in launches))
    emit("small_mesh", mesh=dict(mesh.shape), **rec)
    for label, r in rec.items():
        if not r["launches_as_expected"]:
            raise AssertionError(f"f32 mesh steps ({label}): launched "
                                 f"{r['launches_per_step']}, want "
                                 f"{r['expected_launches_per_step']}")
        if not r["max_gap"] <= SMALL_TRAIN_LOSS_GAP:
            raise AssertionError(f"f32 mesh steps ({label}): losses differ "
                                 f"from one device by {r['max_gap']}")
        if not r["param_rel_err"] <= SMALL_SP_PARAM_RTOL:
            raise AssertionError(f"f32 mesh steps ({label}): params differ "
                                 f"from one device by {r['param_rel_err']}")


def _one_device_bytes(model, params, cfg) -> int:
    return sum(t.numel() * t.element_size() for _, t in model._flatten(
        model.cast_params(params, cfg.dtype, "cuda")))


def _tokens_of(tokens):
    """Generated tokens as _agreement reads them (a request's
    ``generated``)."""
    import types

    return [types.SimpleNamespace(generated=t) for t in tokens]


def phase_mesh_main_path(torch, np, attention, model, serving, one_rec,
                         one_tokens):
    """The linear cell under a dp 2 × tp 2 mesh of the card
    (ContinuousBatcher(mesh=...)): a warm pass in which every tick's
    logits are held against the one-device kernel step on the same
    inputs (the mesh cache gathered into the one-device layout), then
    the timed pass whose launches are counted (K3 once per (row, rank)
    shard a layer a decode step: 8 × 4 × steps), its ticks and decode
    steps equal to the one-device pass's, and its free-running tokens
    against the one-device pass's.  The placed params must weigh what
    one device's do: ranks that share the card share their blocks."""
    cfg = model.ModelConfig(**FULL)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg, "cuda")
    mesh = model.make_mesh(["cuda:0"] * SERVE_MESH_RANKS, tp=SERVE_MESH_TP)
    eng = serving.ContinuousBatcher(params, cfg, slots=SLOTS,
                                    max_len=MAX_LEN, chunk=CHUNK, mesh=mesh)
    placed, one_bytes = eng.params.nbytes(), _one_device_bytes(model, params,
                                                               cfg)
    one = model.cast_params(params, cfg.dtype, "cuda")
    one_step, mesh_step = serving.make_slot_decode_step(cfg), eng._decode
    diffs, tick_lengths = [], []

    def compared_step(p, cache, tokens, active):
        ref = cache.gather()
        tick_lengths.append((ref.lengths + 1).tolist())
        want, _ = one_step(one, ref, tokens, active)
        logits, cache = mesh_step(p, cache, tokens, active)
        diffs.append(_compare_tick(torch, logits, want,
                                   active.nonzero()[:, 0]))
        return logits, cache

    eng._decode = compared_step
    warm_s = _serve_all(eng, _requests(serving, np, cfg))
    eng._decode = mesh_step
    del one
    reqs = _requests(serving, np, cfg)
    ticks0, steps0 = eng.ticks, eng.decode_steps
    attention.reset_launch_counts()
    dt = _serve_all(eng, reqs)
    launches = dict(attention.LAUNCHES)
    ticks, steps = eng.ticks - ticks0, eng.decode_steps - steps0
    want_launches = steps * cfg.n_layers * mesh.size
    decoded = sum(len(r.generated) for r in reqs)
    agree, firsts = _agreement(reqs, _tokens_of(one_tokens))
    by_live = sorted(tick_lengths, key=sum)
    rec = dict(
        mesh=dict(mesh.shape), config=FULL, dtype="bfloat16", slots=SLOTS,
        max_len=MAX_LEN, chunk=CHUNK, prompt_lens=PROMPT_LENS,
        new_tokens=NEW_TOKENS, warm_seconds=warm_s, seconds=dt, ticks=ticks,
        decode_steps=steps, preemptions=0, decoded_tokens=decoded,
        tokens_per_s=decoded / dt,
        one_device=dict(ticks=one_rec["ticks"],
                        decode_steps=one_rec["decode_steps"],
                        tokens_per_s=one_rec["tokens_per_s"]),
        flash_decode_launches=launches["flash_decode"],
        expected_launches=want_launches, launches=launches,
        placed_param_bytes=placed, one_device_param_bytes=one_bytes,
        **_compare_record(diffs, firsts), greedy_tokens_agree=agree,
        greedy_prefix_agree=sum(firsts), greedy_tokens_total=decoded,
        mid_tick_lengths=by_live[len(by_live) // 2])
    emit("mesh_main_path", **rec)
    if launches["flash_decode"] != want_launches or want_launches == 0:
        raise AssertionError(
            f"mesh linear path: flash_decode launched "
            f"{launches['flash_decode']} times, want decode steps x layers "
            f"x ranks = {want_launches}")
    if (ticks, steps) != (one_rec["ticks"], one_rec["decode_steps"]):
        raise AssertionError(f"mesh linear path: {ticks} ticks and {steps} "
                             f"decode steps, one device {one_rec['ticks']} "
                             f"and {one_rec['decode_steps']}")
    if placed != one_bytes:
        raise AssertionError(f"mesh linear path placed {placed} bytes of "
                             f"params, one device holds {one_bytes}")
    _check_ticks("mesh_main_path", diffs)
    return rec, eng


def phase_mesh_paged_main_path(torch, np, attention, model, serving, paged,
                               one_rec, one_tokens):
    """The paged cell under a TP-only mesh of 2 ranks on the card
    (PagedBatcher(mesh=...): each rank's KV head of the pool): a warm
    pass held tick by tick against the one-device kernel step on the
    gathered pool, then the timed pass (K4 once per rank a layer a
    decode step, K3 never), its ticks and preemptions equal to the
    one-device pass's, and its tokens against the one-device pass's."""
    cfg = model.ModelConfig(**FULL)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg, "cuda")
    mesh = model.make_mesh(["cuda:0"] * PAGED_MESH_RANKS,
                           tp=PAGED_MESH_RANKS)
    geometry = dict(slots=PAGED_SLOTS, max_len=MAX_LEN,
                    block_size=BLOCK_SIZE, num_blocks=NUM_BLOCKS,
                    chunk=CHUNK, prefill_lanes=PREFILL_LANES)
    eng = paged.PagedBatcher(params, cfg, mesh=mesh, **geometry)
    one = model.cast_params(params, cfg.dtype, "cuda")
    one_step = paged.make_paged_decode_step(cfg, MAX_LEN)
    mesh_step = eng._decode
    diffs, ticks_seen = [], []

    def compared_step(p, cache, tables, tokens, active):
        ticks_seen.append((tables.clone(), (cache.lengths + 1).tolist()))
        want, _ = one_step(one, cache.gather(), tables, tokens, active)
        logits, cache = mesh_step(p, cache, tables, tokens, active)
        diffs.append(_compare_tick(torch, logits, want,
                                   active.nonzero()[:, 0].to(logits.device)))
        return logits, cache

    eng._decode = compared_step
    warm_s = _serve_all(eng, _requests(serving, np, cfg, PAGED_PROMPT_LENS))
    eng._decode = mesh_step
    del one
    reqs = _requests(serving, np, cfg, PAGED_PROMPT_LENS)
    ticks0, steps0, pre0 = eng.ticks, eng.decode_steps, eng.preemptions
    attention.reset_launch_counts()
    dt, peak = _serve_ticks(eng, reqs)
    launches = dict(attention.LAUNCHES)
    ticks, steps = eng.ticks - ticks0, eng.decode_steps - steps0
    preemptions = eng.preemptions - pre0
    want_launches = steps * cfg.n_layers * mesh.size
    decoded = sum(len(r.generated) for r in reqs)
    agree, firsts = _agreement(reqs, _tokens_of(one_tokens))
    by_live = sorted(ticks_seen, key=lambda t: sum(t[1]))
    mid_tables, mid_lengths = by_live[len(by_live) // 2]
    rec = dict(
        mesh=dict(mesh.shape), config=FULL, dtype="bfloat16", **geometry,
        prompt_lens=PAGED_PROMPT_LENS, new_tokens=NEW_TOKENS,
        warm_seconds=warm_s, seconds=dt, ticks=ticks, decode_steps=steps,
        preemptions=preemptions, peak_concurrent_sequences=peak,
        decoded_tokens=decoded, tokens_per_s=decoded / dt,
        one_device=dict(ticks=one_rec["ticks"],
                        decode_steps=one_rec["decode_steps"],
                        preemptions=one_rec["preemptions"],
                        tokens_per_s=one_rec["tokens_per_s"]),
        paged_flash_decode_launches=launches["paged_flash_decode"],
        flash_decode_launches=launches["flash_decode"],
        expected_launches=want_launches,
        placed_param_bytes=eng.params.nbytes(),
        **_compare_record(diffs, firsts), greedy_tokens_agree=agree,
        greedy_prefix_agree=sum(firsts), greedy_tokens_total=decoded,
        mid_tick_lengths=mid_lengths)
    emit("mesh_paged_main_path", **rec)
    if launches["paged_flash_decode"] != want_launches or want_launches == 0:
        raise AssertionError(
            f"mesh paged path: paged_flash_decode launched "
            f"{launches['paged_flash_decode']} times, want decode steps x "
            f"layers x ranks = {want_launches}")
    if launches["flash_decode"] != 0:
        raise AssertionError(f"mesh paged path: flash_decode launched "
                             f"{launches['flash_decode']} times")
    if (ticks, preemptions) != (one_rec["ticks"], one_rec["preemptions"]):
        raise AssertionError(
            f"mesh paged path: {ticks} ticks and {preemptions} preemptions, "
            f"one device {one_rec['ticks']} and {one_rec['preemptions']}")
    if eng.allocator.used_blocks != 0:
        raise AssertionError(f"drained mesh paged engine holds "
                             f"{eng.allocator.used_blocks} blocks")
    _check_ticks("mesh_paged_main_path", diffs)
    return rec, (mid_tables, mid_lengths), eng


def phase_mesh_generate_main_path(torch, np, attention, model, decode,
                                  one_rec):
    """The GQA generate shape through make_sharded_generate over a dp 2
    × tp 2 mesh of the card: the prefill logits and COMPARE_TICKS decode
    steps held against one device's on the same inputs (the mesh cache
    gathered), then GEN_REPS timed calls with the launches counted (K1
    once per shard a layer: 8 × 4; K3 8 × 4 × (steps − 1)), timed as the
    one-device phase is (prefill alone, then the whole call; the
    comparison warms the path), and the tokens against one device's
    generate."""
    cfg = model.ModelConfig(**FULL)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg, "cuda")
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (GEN_BATCH, GEN_PROMPT)).astype(np.int32)).cuda()
    steps, max_len = GEN_STEPS, GEN_PROMPT + GEN_STEPS
    mesh = model.make_mesh(["cuda:0"] * SERVE_MESH_RANKS, tp=SERVE_MESH_TP)
    placed = model.place_params(mesh, cfg, params)
    run = decode.make_sharded_generate(mesh, cfg, steps)
    one = model.cast_params(params, cfg.dtype, "cuda")
    logits, cache = decode.prefill(placed, prompt, cfg, max_len, mesh=mesh)
    want, _ = decode.prefill(one, prompt, cfg, max_len)
    prefill_max = (logits - want).abs().max().item()
    finite = bool(torch.isfinite(logits).all())
    token = torch.argmax(logits[:, -1], -1).to(torch.int32)
    diffs = []
    for _ in range(COMPARE_TICKS):
        want, _ = decode.decode_step(one, cache.gather(), token, cfg)
        logits, cache = decode.decode_step(placed, cache, token, cfg, mesh)
        diffs.append(_compare_tick(torch, logits, want,
                                   torch.arange(GEN_BATCH, device="cuda")))
        token = torch.argmax(logits, -1).to(torch.int32)
    del cache, want, logits
    expect = {**dict.fromkeys(attention.LAUNCHES, 0),
              "flash_attention": cfg.n_layers * mesh.size,
              "flash_decode": (steps - 1) * cfg.n_layers * mesh.size}
    gen_s, pf_s, launches = [], [], []
    for _ in range(GEN_REPS):
        pf_s.append(_wall(torch, lambda: decode.prefill(
            placed, prompt, cfg, max_len, mesh=mesh)[0])[0])
        attention.reset_launch_counts()
        dt, out = _wall(torch, lambda: run(placed, prompt))
        launches.append(dict(attention.LAUNCHES))
        gen_s.append(dt)
    gen_dt, pf_dt = statistics.fmean(gen_s), statistics.fmean(pf_s)
    decode_dt = gen_dt - pf_dt
    one_out = decode.generate(one, prompt, cfg, steps)
    del one
    equal = (out[:, GEN_PROMPT:] == one_out[:, GEN_PROMPT:]).cpu()
    prefix = sum(steps if bool(row.all()) else int((~row).nonzero()[0])
                 for row in equal)
    rec = dict(
        shape="gqa", mesh=dict(mesh.shape), config=FULL, dtype="bfloat16",
        batch=GEN_BATCH, prompt_len=GEN_PROMPT, steps=steps,
        generate_seconds=gen_s, prefill_seconds=pf_s,
        prefill_ms=pf_dt * 1e3, decode_ms_per_step=decode_dt / steps * 1e3,
        decode_tokens_per_s=GEN_BATCH * steps / decode_dt,
        one_device=dict(prefill_ms=one_rec["prefill_ms"],
                        decode_ms_per_step=one_rec["decode_ms_per_step"]),
        launches=launches[-1], expected_launches=expect,
        prefill_dlogits_max=prefill_max, prefill_finite=finite,
        **_compare_record(diffs, []), greedy_tokens_agree=int(equal.sum()),
        greedy_prefix_agree=prefix, greedy_tokens_total=GEN_BATCH * steps)
    emit("mesh_generate_main_path", **rec)
    if any(n != expect for n in launches):
        raise AssertionError(f"mesh generate launched {launches}, want "
                             f"{expect} per call")
    if not (finite and prefill_max < DLOGITS_MAX):
        raise AssertionError(f"mesh generate: prefill logits differ from "
                             f"one device's by {prefill_max} (finite "
                             f"{finite})")
    if not bool(((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError("mesh generate: tokens out of the vocab")
    _check_ticks("mesh_generate_main_path", diffs)
    return rec


def phase_mesh_kernel_checks(torch, F, attention, flush, linear_lengths,
                             paged_tick):
    """K3, K4 and K1 at the shard shapes the mesh serving paths give
    them, each against its plain version, timed beside it and SDPA: K3
    over one data row's 2 slots and one rank's KV head of the linear
    cache ([2, 8, 1, 64] over [2, 1, 1024, 64]) at the mesh linear
    path's median tick; K4 over one rank's KV head of the pool ([16, 8,
    1, 64] over [256, 1, 16, 64]) at the mesh paged path's median tick;
    K1 over one shard of the mesh generate prefill ([4, 8, 128, 64] on
    one KV head)."""
    h, d, bf16 = FULL["n_heads"] // SERVE_MESH_TP, 64, torch.bfloat16
    row = SLOTS // (SERVE_MESH_RANKS // SERVE_MESH_TP)
    tables, lengths = paged_tick
    return dict(
        flash_decode=check_case(
            torch, F, attention, flush, label="mesh-shard", b=row, h=h,
            hkv=1, max_len=MAX_LEN, d=d, dtype=bf16,
            lengths=linear_lengths[:row], seed=300),
        paged_flash_decode=check_paged_case(
            torch, F, attention, flush, label="mesh-shard", slots=PAGED_SLOTS,
            h=FULL["n_heads"] // PAGED_MESH_RANKS, hkv=1, bs=BLOCK_SIZE,
            tpr=MAX_LEN // BLOCK_SIZE, nb=NUM_BLOCKS, d=d, dtype=bf16,
            tables=tables, lengths=lengths, seed=301),
        flash_attention=check_attn_case(
            torch, F, attention, flush, label="mesh-shard-prefill",
            b=GEN_BATCH // (SERVE_MESH_RANKS // SERVE_MESH_TP), h=h, hkv=1,
            s=GEN_PROMPT, d=d, dtype=bf16, seed=302))


def phase_small_mesh_serving(torch, np, model, serving, paged, decode,
                             spec_serving):
    """Small f32 models served under meshes of the card (the kernel
    route: K3/K4/K1 per shard) against one device: the same greedy
    tokens through the linear, ring, paged (its pool preempts) and
    speculative paged engines, a MoE model (4 experts, top 2) through
    the linear engine, MQA (one KV head, which tp 2 cannot cut: each
    data row's whole head on its first rank) and make_sharded_generate.
    Linear, ring, MoE, MQA and generate run at dp 2 × tp 2, the paged
    engines at tp 2; the speculative engine's accept rate must equal one
    device's too."""
    import dataclasses

    base = model.ModelConfig(vocab=256, d_model=128, n_layers=2, n_heads=4,
                             n_kv_heads=2, d_ff=256, seq_len=64,
                             dtype=torch.float32)
    grid = model.make_mesh(["cuda:0"] * SERVE_MESH_RANKS, tp=SERVE_MESH_TP)
    tp_only = model.make_mesh(["cuda:0"] * PAGED_MESH_RANKS,
                              tp=PAGED_MESH_RANKS)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32)
               for n in (5, 17, 33, 9, 41)]

    def served(make):
        eng = make()
        reqs = [serving.Request(prompt=p, max_new_tokens=8) for p in prompts]
        _serve_ticks(eng, reqs, check=hasattr(eng, "check_accounting"))
        return ([r.generated for r in reqs],
                getattr(eng, "preemptions", 0),
                getattr(eng, "accept_rate", None))

    rec = {}
    for label, cfg, mesh, kind, kw in (
            ("linear", base, grid, "linear", {}),
            ("ring", dataclasses.replace(base, attention_window=16), grid,
             "linear", dict(ring=True)),
            ("moe", dataclasses.replace(base, moe_experts=4, moe_top_k=2),
             grid, "linear", {}),
            ("mqa", dataclasses.replace(base, n_kv_heads=1), grid, "linear",
             {}),
            ("paged", base, tp_only, "paged", {}),
            ("spec", base, tp_only, "spec", {})):
        params = model.init_params(
            torch.Generator(device="cuda").manual_seed(1), cfg, "cuda")

        def make(where, cfg=cfg, kind=kind, kw=kw, params=params):
            if kind == "linear":
                return serving.ContinuousBatcher(
                    params, cfg, slots=2, max_len=64, chunk=8, **kw, **where)
            geometry = dict(slots=3, max_len=64, block_size=8,
                            num_blocks=8, chunk=8, prefill_lanes=2)
            if kind == "paged":
                return paged.PagedBatcher(params, cfg, **geometry, **where)
            return spec_serving.SpeculativePagedBatcher(
                params, cfg, _draft(params, 1),
                dataclasses.replace(cfg, n_layers=1), k=3, **geometry,
                **where)

        one = served(lambda: make(dict(device="cuda")))
        got = served(lambda: make(dict(mesh=mesh)))
        rec[label] = dict(mesh=dict(mesh.shape), tokens_equal=got == one,
                          tokens=sum(len(t) for t in got[0]),
                          preemptions=got[1], accept_rate=got[2])
    params = model.init_params(torch.Generator(device="cuda").manual_seed(1),
                               base, "cuda")
    batch = torch.from_numpy(rng.integers(0, 256, (4, 40)).astype(np.int32))
    want = decode.generate(params, batch, base, 10)
    got = decode.make_sharded_generate(grid, base, 10)(params, batch)
    rec["generate"] = dict(mesh=dict(grid.shape),
                           tokens_equal=bool(torch.equal(got, want)),
                           tokens=4 * 10)
    emit("small_mesh_serving", **rec)
    for label, r in rec.items():
        if not r["tokens_equal"]:
            raise AssertionError(f"f32 {label} under the mesh: tokens differ "
                                 f"from one device's")
    for label in ("paged", "spec"):
        if not rec[label]["preemptions"]:
            raise AssertionError(f"f32 {label} under the mesh never "
                                 f"preempted")


def phase_small_moe_exact(torch, np, model, serving, paged, decode, moe):
    """A small f32 MoE model on the card: the kernel route and the einsum
    route give the same greedy tokens through the linear, ring and paged
    engines (the paged pool preempts) and decode.generate, and route the
    same way in generate (_RouteLog); route_topk on the card gives the
    integers it gives on the CPU for the same logits (generate's
    prefill logits, with uniform rows for ties and a capacity small
    enough to drop)."""
    import dataclasses

    cfg = model.ModelConfig(vocab=256, d_model=128, n_layers=2, n_heads=2,
                            d_ff=256, seq_len=64, dtype=torch.float32, **MOE)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(1),
                               cfg, "cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32)
               for n in (5, 17, 33, 9, 41)]
    rec = {}
    for mode, window in (("linear", None), ("ring", 16), ("paged", None)):
        out, preempted = [], []
        for impl in ("kernel", "einsum"):
            c = dataclasses.replace(cfg, attention=impl,
                                    attention_window=window)
            if mode == "paged":
                eng = paged.PagedBatcher(
                    params, c, slots=3, max_len=64, block_size=8,
                    num_blocks=8, chunk=8, prefill_lanes=2, device="cuda")
            else:
                eng = serving.ContinuousBatcher(
                    params, c, slots=3, max_len=64, chunk=8, device="cuda",
                    ring=mode == "ring")
            reqs = [serving.Request(prompt=p, max_new_tokens=8)
                    for p in prompts]
            _serve_all(eng, reqs)
            out.append([r.generated for r in reqs])
            preempted.append(getattr(eng, "preemptions", 0))
        rec[mode] = dict(tokens_equal=out[0] == out[1],
                         tokens=sum(len(t) for t in out[0]),
                         preemptions=preempted)
    batch = torch.from_numpy(rng.integers(0, 256, (3, 40)).astype(np.int32))
    out, calls = [], []
    for impl in ("kernel", "einsum"):
        with _RouteLog(model) as log:
            out.append(decode.generate(params, batch, dataclasses.replace(
                cfg, attention=impl), 10).tolist())
        calls.append(log.calls)
    routes_equal = len(calls[0]) == len(calls[1]) and all(
        torch.equal(a[1], b[1]) for a, b in zip(*calls))
    logits = calls[0][0][0].reshape(-1, cfg.moe_experts).clone()
    logits[::5] = 0.0                                # uniform rows: ties
    same = {}
    for cap in (logits.shape[0], 4):
        dev = moe.route_topk(logits, cfg.moe_top_k, cap)
        cpu = moe.route_topk(logits.cpu(), cfg.moe_top_k, cap)
        same[cap] = all(torch.equal(dev[i].cpu(), cpu[i]) for i in (0, 1, 3))
    rec["generate"] = dict(tokens_equal=out[0] == out[1], tokens=3 * 10,
                           routes_equal=routes_equal)
    emit("small_moe_exact", **rec, route_topk=dict(
        rows=logits.shape[0], card_equals_cpu_at_capacity=same))
    for mode, r in rec.items():
        if not r["tokens_equal"]:
            raise AssertionError(f"f32 MoE {mode}: the kernel route and the "
                                 f"einsum route disagree: {r}")
    if not routes_equal:
        raise AssertionError("f32 MoE generate: the kernel route and the "
                             "einsum route chose different experts")
    if not all(same.values()):
        raise AssertionError(f"route_topk on the card and on the CPU differ "
                             f"on the same logits: {same}")
    if not all(rec["paged"]["preemptions"]):
        raise AssertionError(f"the small MoE paged engine never preempted: "
                             f"{rec['paged']['preemptions']}")


def phase_small_sp_ep(torch, np, attention, model, sp):
    """sp×ep on the card: a small f32 MoE model (8 experts, top 2) with
    the sequence over 4 ranks that double as the expert group, on the
    kernel ring (K5, K6).  At capacity factor E / k (nothing drops) and
    balance weight 0 (the pool and per-row balance estimators differ;
    the z loss is a mean over tokens either way), its first-step loss
    and gradient norm equal the one-device MoE step's and the einsum
    ring's within SMALL_TRAIN_LOSS_GAP and GRAD_F32_RTOL; then one
    kernel-ring step at the model's own capacity and weights, its K5/K6
    launches counted and its router metrics finite."""
    import dataclasses

    cfg = model.ModelConfig(vocab=256, d_model=128, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=256, seq_len=64,
                            dtype=torch.float32, **MOE)
    ncfg = dataclasses.replace(cfg, moe_capacity_factor=EP_NO_DROP,
                               moe_balance_weight=0.0)
    devices = sp.make_sp_mesh(["cuda:0"] * 4, sp=4)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(1),
                               cfg, "cuda")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (4, 65)).astype(np.int32)).cuda()
    first = {}
    for name, loss_of in (
            ("pallas", sp.make_sp_loss(devices, ncfg, "pallas")),
            ("einsum", sp.make_sp_loss(devices, ncfg, "einsum")),
            ("single_device", None)):
        fn = (lambda p, t: model.loss_fn(p, t, ncfg)) if loss_of is None \
            else (lambda p, t, f=loss_of: f(p, t)[0])
        first[name] = _loss_and_grad_norm(torch, model, params, tokens, fn)
    _, step4 = sp.make_sp_train_step(devices, cfg, impl="pallas")
    opt = model.make_optimizer(model.TrainConfig()).init(params)
    attention.reset_launch_counts()
    _, _, loss, metrics = step4(params, opt, tokens)
    launches = dict(attention.LAUNCHES)
    rec = dict(ranks=4, config={k: v for k, v in dataclasses.asdict(
        cfg).items() if k != "dtype"}, dtype="float32",
        no_drop_capacity_factor=EP_NO_DROP,
        first_loss={n: v[0] for n, v in first.items()},
        first_grad_norm={n: v[1] for n, v in first.items()},
        step_loss=loss.item(),
        step_metrics={k: v.tolist() for k, v in metrics.items()},
        launches_per_step=launches)
    emit("small_sp_ep", **rec)
    base_loss, base_norm = first["single_device"]
    for name, (loss_v, norm) in first.items():
        if not (abs(loss_v - base_loss) <= SMALL_TRAIN_LOSS_GAP
                and abs(norm - base_norm) <= GRAD_F32_RTOL * base_norm):
            raise AssertionError(f"sp×ep ({name}): first loss {loss_v}, grad "
                                 f"norm {norm} vs one device {base_loss}, "
                                 f"{base_norm}")
    if not all(launches[k] > 0 for k in RING_KERNELS):
        raise AssertionError(f"sp×ep kernel ring launched {launches}")
    if not all(np.isfinite(v).all() for v in rec["step_metrics"].values()):
        raise AssertionError(f"sp×ep router metrics: {rec['step_metrics']}")
    return rec


def _kernel_launches(attention, **counts) -> dict:
    """Every kernel's expected launches: the ones named, the rest 0."""
    return {**dict.fromkeys(attention.LAUNCHES, 0), **counts}


def phase_multislice_train(torch, np, attention, model, distributed,
                           mesh_rec):
    """``model.make_sharded_train_step`` of the step cell (TRAIN_FULL,
    batch TRAIN_BATCH) on ``distributed.make_multislice_mesh(2,
    model=2)`` over MESH_RANKS ranks of the card: (dcn 2, data 2, model
    2), the batch cut over (dcn, data), in modes none and zero1 from the
    same params (seed 0) and batch (numpy seed 1) as
    mesh_train_main_path.  The batch falls into the same four row blocks
    in the same order as on the dp 4 × tp 2 mesh, so the first-step loss
    must equal mesh_train_main_path's within MESH_MODE_GAP; MESH_WARM
    warm and MESH_STEPS timed steps whose launches are counted per
    step (K1 and each K2 kernel once per rank per layer, K3-K6 never);
    the loss must fall, and zero1's busiest rank must store less than
    none's (its moments cut over dcn × data)."""
    cfg = model.ModelConfig(**TRAIN_FULL)
    mesh = distributed.make_multislice_mesh(
        MULTISLICE_SLICES, model=MESH_TP, devices=["cuda:0"] * MESH_RANKS)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (TRAIN_BATCH, cfg.seq_len + 1)).astype(np.int32)).cuda()
    per_step = MESH_RANKS * cfg.n_layers
    want = _kernel_launches(attention, flash_attention=per_step,
                            flash_attention_bwd_dq=per_step,
                            flash_attention_bwd_dkv=per_step)
    modes = {}
    for shard in MULTISLICE_MODES:
        init_fn, step_fn = model.make_sharded_train_step(mesh, cfg,
                                                         shard=shard)
        params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
        n_params = sum(int(np.prod(leaf.shape))
                       for _, leaf in model._flatten(params))
        held = model.rank_state_bytes(mesh, params, opt)
        first = _mesh_loss_and_grad_norm(torch, model, mesh, cfg, params,
                                         tokens)
        torch.cuda.empty_cache()
        params, opt, losses, launches, step_s = _train_steps(
            torch, attention, step_fn, params, opt, tokens, MESH_WARM,
            MESH_STEPS)
        flops = _train_flops(n_params, cfg, TRAIN_BATCH)
        modes[shard] = dict(
            first_loss=first[0], first_grad_norm=first[1],
            step_ms=step_s * 1e3,
            tokens_per_s=TRAIN_BATCH * cfg.seq_len / step_s,
            mfu=flops / (step_s * BF16_OPS_PER_S), losses=losses,
            rank_state_bytes=held, launches_per_step=launches)
        del params, opt, init_fn, step_fn
        torch.cuda.empty_cache()
    dp4 = mesh_rec["modes"]["none"]
    rec = dict(config=TRAIN_FULL, dtype="bfloat16", batch=TRAIN_BATCH,
               mesh=dict(mesh.shape),
               batch_spec=[list(a) if isinstance(a, tuple) else a
                           for a in model.batch_spec(mesh)],
               shard_shape=[TRAIN_BATCH // (MESH_RANKS // MESH_TP),
                            cfg.n_heads // MESH_TP, cfg.seq_len,
                            cfg.head_dim],
               warm_steps=MESH_WARM, timed_steps=MESH_STEPS,
               dp4_tp2_first_loss=dp4["first_loss"],
               dp4_tp2_first_grad_norm=dp4["first_grad_norm"], modes=modes,
               launches_per_step=modes["none"]["launches_per_step"][-1],
               expected_launches_per_step=want)
    emit("multislice_train", **rec)
    for shard, m in modes.items():
        if any(n != want for n in m["launches_per_step"]):
            raise AssertionError(f"multislice step ({shard}) launched "
                                 f"{m['launches_per_step']}, want {want}")
        if not all(np.isfinite(m["losses"])) \
                or not m["losses"][-1] < m["losses"][0]:
            raise AssertionError(f"multislice step ({shard}): loss not "
                                 f"finite or did not fall: {m['losses']}")
        if not abs(m["first_loss"] - dp4["first_loss"]) <= MESH_MODE_GAP:
            raise AssertionError(
                f"multislice step ({shard}): first loss {m['first_loss']} "
                f"vs the dp 4 x tp 2 mesh's {dp4['first_loss']}")
    if not max(modes["zero1"]["rank_state_bytes"]) \
            < max(modes["none"]["rank_state_bytes"]):
        raise AssertionError("multislice zero1 does not cut the busiest "
                             "rank's state")
    return rec


def phase_ep_tp_train_main_path(torch, np, attention, model, moe, ep_rec):
    """dp×ep×tp (``moe.make_ep_train_step`` on ``make_ep_mesh(ep=2,
    tp=2)`` over MESH_RANKS ranks of the card: data 2 × ep 2 × model 2)
    of the MoE step model on the step's batch and params (as
    ep_train_main_path; every rank holds its own copy of the dense
    state, as JAX places it, so the card holds eight, and the step
    updates them in place): at capacity factor EP_NO_DROP the first-step
    loss and gradient norm must equal the one-device MoE step's that
    ep_train_main_path took, within TRAIN_LOSS_GAP /
    TRAIN_GRAD_NORM_RTOL; then, at the model's 1.25, on the cut state
    (each rank's experts and their moments: 1/(ep·tp) of the whole, as
    ``model.rank_state_bytes`` counts them), MESH_WARM warm and
    MESH_STEPS timed steps whose launches are counted per step (K1 and
    each K2 kernel once per rank per layer on its h/tp heads, K3-K6
    never); the loss must fall."""
    import dataclasses

    cfg = model.ModelConfig(**TRAIN_MOE)
    mesh = moe.make_ep_mesh(["cuda:0"] * MESH_RANKS, ep=EP_TP[0],
                            tp=EP_TP[1])
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg, "cuda")
    n_params = sum(p.numel() for _, p in model._flatten(params))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (TRAIN_BATCH, cfg.seq_len + 1)).astype(np.int32)).cuda()
    ep_loss = moe.make_ep_loss(mesh, dataclasses.replace(
        cfg, moe_capacity_factor=EP_NO_DROP))
    first = _loss_and_grad_norm(torch, model, params, tokens,
                                lambda p, t: ep_loss(p, t)[0])
    torch.cuda.empty_cache()
    optimizer = model.make_optimizer(model.TrainConfig())
    opt = moe.shard_ep_opt_state(mesh, cfg, optimizer.init(params))
    params = moe.shard_ep_params(mesh, cfg, params)
    experts = {"blocks": {k: params["blocks"][k] for k in ("w1", "w2")}}
    held = model.rank_state_bytes(mesh, experts, {
        key: {"blocks": {k: opt[key]["blocks"][k] for k in ("w1", "w2")}}
        for key in ("mu", "nu")})
    whole = 3 * 4 * sum(int(np.prod(leaf.shape))
                        for leaf in experts["blocks"].values())
    all_held = model.rank_state_bytes(mesh, params, opt)
    del experts
    _, step4 = moe.make_ep_train_step(mesh, cfg)
    metrics = []

    def step_fn(p, o, t):
        p, o, loss, m = step4(p, o, t)
        metrics.append(m)
        return p, o, loss

    per_step = MESH_RANKS * cfg.n_layers
    want = _kernel_launches(attention, flash_attention=per_step,
                            flash_attention_bwd_dq=per_step,
                            flash_attention_bwd_dkv=per_step)
    torch.cuda.reset_peak_memory_stats()
    params, opt, losses, launches, step_s = _train_steps(
        torch, attention, step_fn, params, opt, tokens, MESH_WARM,
        MESH_STEPS)
    flops = _train_flops(_active_params(n_params, cfg), cfg, TRAIN_BATCH)
    data = MESH_RANKS // (EP_TP[0] * EP_TP[1])
    rec = dict(config=TRAIN_MOE, dtype="bfloat16", batch=TRAIN_BATCH,
               mesh=dict(mesh.shape),
               rank_shard_shape=[TRAIN_BATCH // (data * EP_TP[0]),
                                 cfg.n_heads // EP_TP[1], cfg.seq_len,
                                 cfg.head_dim],
               no_drop_capacity_factor=EP_NO_DROP,
               first_loss=first[0], first_grad_norm=first[1],
               single_device_first_loss=ep_rec["first_loss"]["single_device"],
               single_device_first_grad_norm=ep_rec["first_grad_norm"][
                   "single_device"],
               warm_steps=MESH_WARM, timed_steps=MESH_STEPS,
               step_ms=step_s * 1e3,
               tokens_per_s=TRAIN_BATCH * cfg.seq_len / step_s,
               mfu=flops / (step_s * BF16_OPS_PER_S),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               losses=losses, ce=[m["ce"].item() for m in metrics],
               balance_loss=[m["balance_loss"].item() for m in metrics],
               expert_fraction=metrics[-1]["expert_fraction"].tolist(),
               expert_state_bytes_whole=whole,
               expert_state_bytes_per_rank=held,
               state_bytes_per_rank=all_held,
               launches_per_step=launches[-1],
               expected_launches_per_step=want)
    del params, opt
    torch.cuda.empty_cache()
    emit("ep_tp_train_main_path", **rec)
    if any(n != want for n in launches):
        raise AssertionError(f"ep×tp train step launched {launches}, want "
                             f"{want} per step")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"ep×tp: loss not finite or did not fall: "
                             f"{losses}")
    sl, sn = rec["single_device_first_loss"], \
        rec["single_device_first_grad_norm"]
    if not (abs(first[0] - sl) <= TRAIN_LOSS_GAP
            and abs(first[1] - sn) <= TRAIN_GRAD_NORM_RTOL * sn):
        raise AssertionError(f"ep×tp at no-drop capacity: loss {first[0]}, "
                             f"grad norm {first[1]} vs one device {sl}, {sn}")
    if held != [whole // (EP_TP[0] * EP_TP[1])] * MESH_RANKS:
        raise AssertionError(f"ep×tp expert state per rank {held}, whole "
                             f"{whole}: want 1/(ep·tp) on every rank")
    return rec


def _sp_ring_hops(ring_attention, cfg, sp_n) -> int:
    """Visible (rank, source) hops of one causal ring of ``sp_n`` ranks
    over cfg.seq_len."""
    s_loc = cfg.seq_len // sp_n
    return sum(1 for r in range(sp_n) for src in range(sp_n)
               if ring_attention._hop_mode(src, r, s_loc, True,
                                           cfg.attention_window)[0])


def phase_sp_tp_train_main_path(torch, np, attention, model, sp,
                                ring_attention, sp_rec):
    """sp×tp at the long-context width: ``sp.make_sp_train_step`` of
    SP_FULL (batch SP_BATCH) on ``make_sp_mesh(sp=2, tp=2)`` over
    MESH_RANKS ranks of the card (data 2 × sp 2 × model 2), the kernel
    ring, shard zero1: the first-step loss and gradient norm against the
    one-device K1/K2 step that sp_train_main_path took on the same
    params (seed 0) and batch (numpy seed 1), within SP_LOSS_GAP /
    SP_GRAD_NORM_RTOL; SP_WARM warm and SP_TP_STEPS timed steps whose
    launches are counted per step (K5 once per visible hop per (data
    row, model rank) ring per layer, twice under remat; each K6 kernel
    once; K1-K4 never), each ring on its rank's h/tp heads; then one warm
    and one timed Ulysses step under tp, its launches counted (K1 once
    per rank per layer, twice under remat, on (h/tp)/sp heads at the
    full sequence; each K2 kernel once)."""
    cfg = model.ModelConfig(**SP_FULL)
    data, sp_n, tp = SP_TP_MESH
    mesh = sp.make_sp_mesh(["cuda:0"] * (data * sp_n * tp), sp=sp_n, tp=tp)
    init_fn, step_fn = sp.make_sp_train_step(mesh, cfg, impl="pallas",
                                             shard="zero1")
    params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (SP_BATCH, cfg.seq_len + 1)).astype(np.int32)).cuda()
    first = _loss_and_grad_norm(torch, model, params, tokens,
                                sp.make_sp_loss(mesh, cfg, "pallas"))
    torch.cuda.empty_cache()
    hops = _sp_ring_hops(ring_attention, cfg, sp_n)
    rings = data * tp
    remat = 2 if cfg.remat else 1
    layers = cfg.n_layers
    want = _kernel_launches(
        attention, ring_flash_step=remat * hops * rings * layers,
        ring_flash_bwd_dq=hops * rings * layers,
        ring_flash_bwd_dkv=hops * rings * layers)
    ranks = data * sp_n * tp
    want_ulysses = _kernel_launches(
        attention, flash_attention=remat * ranks * layers,
        flash_attention_bwd_dq=ranks * layers,
        flash_attention_bwd_dkv=ranks * layers)
    moment_bytes = model.rank_state_bytes(
        mesh, {}, {key: opt[key] for key in ("mu", "nu")})
    torch.cuda.reset_peak_memory_stats()
    params, opt, losses, launches, step_s = _train_steps(
        torch, attention, step_fn, params, opt, tokens, SP_WARM,
        SP_TP_STEPS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for _, p in model._flatten(params))
    flops = _train_flops(n_params, cfg, SP_BATCH)
    _, ustep = sp.make_sp_train_step(mesh, cfg, impl="ulysses",
                                     shard="zero1")
    ustep(params, opt, tokens)
    attention.reset_launch_counts()
    ustep_s, (_, _, uloss) = _wall(torch, lambda: ustep(params, opt, tokens))
    ulaunches = dict(attention.LAUNCHES)
    s_loc = cfg.seq_len // sp_n
    rec = dict(config=SP_FULL, dtype="bfloat16", batch=SP_BATCH,
               mesh=dict(mesh.shape), shard="zero1",
               hop_shape=[SP_BATCH // data, cfg.n_heads // tp, s_loc,
                          cfg.head_dim],
               ulysses_shape=[SP_BATCH // data, cfg.n_heads // tp // sp_n,
                              cfg.seq_len, cfg.head_dim],
               visible_hops_per_ring=hops, rings_per_layer=rings,
               first_loss=first[0], first_grad_norm=first[1],
               single_device_first_loss=sp_rec["first_loss"][
                   "single_device"],
               single_device_first_grad_norm=sp_rec["first_grad_norm"][
                   "single_device"],
               moment_bytes_per_rank=moment_bytes,
               warm_steps=SP_WARM, timed_steps=SP_TP_STEPS,
               step_ms=step_s * 1e3,
               tokens_per_s=SP_BATCH * cfg.seq_len / step_s,
               mfu=flops / (step_s * BF16_OPS_PER_S), peak_memory_gb=peak,
               losses=losses, launches_per_step=launches[-1],
               expected_launches_per_step=want,
               ulysses_step_ms=ustep_s * 1e3, ulysses_loss=uloss.item(),
               ulysses_launches_per_step=ulaunches,
               ulysses_expected_launches_per_step=want_ulysses)
    del params, opt
    torch.cuda.empty_cache()
    emit("sp_tp_train_main_path", **rec)
    if any(n != want for n in launches):
        raise AssertionError(f"sp×tp train step launched {launches}, want "
                             f"{want} per step")
    if ulaunches != want_ulysses:
        raise AssertionError(f"ulysses sp×tp step launched {ulaunches}, "
                             f"want {want_ulysses}")
    if not all(np.isfinite(losses + [rec["ulysses_loss"]])) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"sp×tp: loss not finite or did not fall: "
                             f"{losses}")
    sl, sn = rec["single_device_first_loss"], \
        rec["single_device_first_grad_norm"]
    if not (abs(first[0] - sl) <= SP_LOSS_GAP
            and abs(first[1] - sn) <= SP_GRAD_NORM_RTOL * sn):
        raise AssertionError(f"sp×tp first-step loss {first[0]}, grad norm "
                             f"{first[1]} vs one device {sl}, {sn}")
    return rec


def _dist_cfg(model, torch):
    """The distributed phase's model: the step cell's widths in f32."""
    return model.ModelConfig(**TRAIN_FULL, dtype=torch.float32)


def distributed_worker(port: str, pid: str, shard: str, ref_path: str,
                       out_path: str) -> None:
    """One process of phase_distributed_train (``chip_smoke.py
    --distributed-worker PORT PID SHARD REF OUT``): joins the two-process
    group through ``distributed.initialize_from_env`` over gloo, runs
    the dp+tp step in shard mode SHARD on the two processes' one mesh
    (``distributed.make_process_mesh``: its own data row of DIST_TP
    ranks of the card, the other process's row beside it) on its
    DIST_LOCAL_BATCH rows of the trainer's stream, the gradients and
    the loss averaged over the processes, for DIST_STEPS steps, and
    writes its ranks' state bytes, its peak allocation over init and
    the steps (``torch.cuda.max_memory_allocated``, this process's own
    allocator), losses, launches, step times and the gap of its final
    params (gathered over both processes) to the one-process run's
    (``REF``) as JSON."""
    import torch

    from tpu_autoscaler_torch.workloads import (
        attention,
        distributed,
        model,
        train,
    )

    distributed._COORDINATOR_PORT = int(port)
    topo = distributed.initialize_from_env(
        {"TPU_WORKER_HOSTNAMES": "localhost,localhost",
         "TPU_WORKER_ID": pid}, backend="gloo")
    cfg = _dist_cfg(model, torch)
    mesh = distributed.make_process_mesh(["cuda:0"] * DIST_TP, tp=DIST_TP)
    init_fn, step = model.make_sharded_train_step(mesh, cfg, shard=shard)
    params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
    held = model.rank_state_bytes(mesh, params, opt)
    losses, launches, step_ms = [], [], []
    for s in range(DIST_STEPS):
        tokens = torch.from_numpy(train.synthetic_rows(
            s, topo.process_id, DIST_LOCAL_BATCH, cfg.vocab,
            cfg.seq_len)).cuda()
        attention.reset_launch_counts()
        t, (params, opt, loss) = _wall(torch,
                                       lambda: step(params, opt, tokens))
        launches.append(dict(attention.LAUNCHES))
        step_ms.append(t * 1e3)
        losses.append(loss.item())
    peak = torch.cuda.max_memory_allocated()
    ref = torch.load(ref_path, map_location="cuda")
    gap, differing = 0.0, 0
    for path, t in model._flatten(model.gather_params(mesh, params)):
        diff = (t - ref[path]).abs()
        gap = max(gap, (diff.max() / ref[path].abs().max()).item())
        differing += int((diff > 0).sum())
    torch.distributed.destroy_process_group()
    Path(out_path).write_text(json.dumps(dict(
        process_id=topo.process_id, num_processes=topo.num_processes,
        shard=shard, mesh=dict(mesh.shape), local_ranks=mesh.local,
        rank_state_bytes=held, peak_memory_bytes=peak, losses=losses,
        step_ms=step_ms, launches_per_step=launches, param_rel_gap=gap,
        params_differing=differing)))


def _dist_pair(port, shard, ref_path, tmp):
    """Run the two distributed_worker processes of one shard mode and
    return their records and the wall seconds; a worker that does not
    finish within DIST_TIMEOUT_S fails, and both are stopped either
    way."""
    outs = [os.path.join(tmp, f"{shard}_p{pid}.json") for pid in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--distributed-worker",
         str(port), str(pid), shard, ref_path, outs[pid]], cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=DIST_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"distributed worker ({shard}) did not finish "
                             f"in {DIST_TIMEOUT_S} s") from e
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.perf_counter() - t0
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"distributed worker ({shard}) exited "
                                 f"{p.returncode}: {log[-3000:]}")
    return [json.loads(Path(path).read_text()) for path in outs], wall_s


def phase_distributed_train(torch, np, attention, model, train):
    """Multi-process data parallelism on the card, in each shard mode of
    MESH_MODES: two processes of this script (distributed_worker) joined
    by ``initialize_from_env`` over gloo (TPU_WORKER_HOSTNAMES=
    localhost,localhost, a free port; NCCL refuses two ranks on one GPU,
    so the transport is gloo over CUDA tensors), sharing one data 2 ×
    model 2 mesh (``distributed.make_process_mesh``), each process a
    data row of DIST_TP ranks on DIST_LOCAL_BATCH rows of the trainer's
    stream, against the one-process dp 2 × tp 2 mesh on both processes'
    rows, all at the step cell's widths in f32 for DIST_STEPS steps.
    ZeRO-1 and FSDP cut over both processes' rows, so each process's
    ranks must hold the bytes the one-process mesh places on the same
    ranks (``model.rank_state_bytes``).  The processes sum the same two
    row gradients as the one-process mesh does (in f32: in bf16 the
    one-process mesh's rows share one bf16 cast of each weight on the
    card, so their gradients would be summed in bf16 there), and scale
    by powers of two, so the losses must agree within DIST_LOSS_GAP and
    the params within DIST_PARAM_RTOL of each leaf's largest |value|;
    K1 and each K2 kernel launch once per local rank per layer a step.
    Each worker reports its peak allocation."""
    import socket
    import tempfile

    cfg = _dist_cfg(model, torch)
    mesh = model.make_mesh(["cuda:0"] * (2 * DIST_TP), tp=DIST_TP)
    per_step = DIST_TP * cfg.n_layers
    want = _kernel_launches(attention, flash_attention=per_step,
                            flash_attention_bwd_dq=per_step,
                            flash_attention_bwd_dkv=per_step)
    modes = {}
    with tempfile.TemporaryDirectory() as tmp:
        for shard in MESH_MODES:
            init_fn, step = model.make_sharded_train_step(mesh, cfg,
                                                          shard=shard)
            params, opt = init_fn(
                torch.Generator(device="cuda").manual_seed(0))
            held = model.rank_state_bytes(mesh, params, opt)
            ref_losses, ref_ms = [], []
            for s in range(DIST_STEPS):
                tokens = torch.from_numpy(np.concatenate([
                    train.synthetic_rows(s, pid, DIST_LOCAL_BATCH,
                                         cfg.vocab, cfg.seq_len)
                    for pid in range(2)])).cuda()
                t, (params, opt, loss) = _wall(
                    torch, lambda: step(params, opt, tokens))
                ref_losses.append(loss.item())
                ref_ms.append(t * 1e3)
            ref_path = os.path.join(tmp, f"{shard}_ref.pt")
            torch.save(dict(model._flatten(model.gather_params(mesh,
                                                               params))),
                       ref_path)
            del params, opt, init_fn, step
            torch.cuda.empty_cache()
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            got, wall_s = _dist_pair(port, shard, ref_path, tmp)
            modes[shard] = dict(reference_rank_state_bytes=held,
                                reference_losses=ref_losses,
                                reference_step_ms=ref_ms, workers=got,
                                workers_wall_s=wall_s)
    rec = dict(config=TRAIN_FULL, dtype="float32", processes=2,
               transport="gloo over CUDA tensors (NCCL refuses two ranks "
                         "on one GPU)",
               process_mesh={"data": 2, "model": DIST_TP},
               ranks_per_process=DIST_TP, reference_mesh=dict(mesh.shape),
               local_batch=DIST_LOCAL_BATCH, steps=DIST_STEPS, modes=modes,
               loss_gap_bound=DIST_LOSS_GAP,
               param_rel_gap_bound=DIST_PARAM_RTOL,
               launches_per_step=modes["none"]["workers"][0][
                   "launches_per_step"][-1],
               expected_launches_per_step=want)
    emit("distributed_train", **rec)
    for shard, m in modes.items():
        for w in m["workers"]:
            who = f"distributed process {w['process_id']} ({shard})"
            if any(n != want for n in w["launches_per_step"]):
                raise AssertionError(f"{who} launched "
                                     f"{w['launches_per_step']}, want "
                                     f"{want}")
            mine = m["reference_rank_state_bytes"][
                w["local_ranks"][0]:w["local_ranks"][-1] + 1]
            if w["rank_state_bytes"] != mine:
                raise AssertionError(f"{who} holds {w['rank_state_bytes']} "
                                     f"bytes a rank; the one-process mesh "
                                     f"places {mine} there")
            gap = max(abs(a - b) for a, b in zip(w["losses"],
                                                 m["reference_losses"]))
            if not gap <= DIST_LOSS_GAP:
                raise AssertionError(f"{who}: losses {w['losses']} vs one "
                                     f"process {m['reference_losses']}")
            if not w["param_rel_gap"] <= DIST_PARAM_RTOL:
                raise AssertionError(f"{who}: params {w['param_rel_gap']} "
                                     f"of their scale from one process's")
    busiest = {shard: max(m["reference_rank_state_bytes"])
               for shard, m in modes.items()}
    if not busiest["fsdp"] < busiest["zero1"] < busiest["none"]:
        raise AssertionError(f"distributed busiest rank's state bytes "
                             f"{busiest}: want fsdp < zero1 < none")
    return rec


def phase_small_compositions(torch, np, attention, model, moe, sp,
                             ring_attention):
    """The compositions on small f32 models, CUDA ranks (the kernels)
    against CPU ranks (their plain versions), from the same params and
    batches: ep×tp (data 2 × ep 2 × model 2: K1/K2 per rank on its h/tp
    heads), sp×tp on the kernel ring under zero1 and on Ulysses (data 2
    × sp 2 × model 2), data × sp on the kernel ring with a window and
    remat (data 2 × sp 2), and sp×ep×tp on the kernel ring.  The first
    step's gradient within GRAD_F32_RTOL of each leaf's largest |grad|,
    3 steps' losses within SMALL_TRAIN_LOSS_GAP, the params after them
    within COMP_PARAM_TOL; the CUDA route's launches counted per step
    and exact."""
    base = dict(vocab=256, d_model=128, n_layers=2, n_heads=4, d_ff=256,
                seq_len=64, dtype=torch.float32)
    moe_kw = dict(moe_experts=4, moe_top_k=2)
    cases = (
        ("ep-tp", "ep", (2, 2, 2), dict(n_kv_heads=2, **moe_kw), None,
         "none", 8),
        ("sp-tp-ring-zero1", "sp", (2, 2, 2), dict(n_kv_heads=2), "pallas",
         "zero1", 4),
        ("sp-tp-ulysses", "sp", (2, 2, 2), {}, "ulysses", "none", 4),
        ("data-sp-ring", "sp", (2, 2, 1),
         dict(n_kv_heads=2, attention_window=24, remat=True), "pallas",
         "none", 4),
        ("sp-ep-tp-ring", "sp", (2, 2, 2), moe_kw, "pallas", "none", 4),
    )
    rec = {}
    for label, kind, (data, n, tp), extra, impl, shard, batch in cases:
        cfg = model.ModelConfig(**base, **extra)
        ranks = data * n * tp
        runs = {}
        for dev in ("cuda:0", "cpu"):
            if kind == "ep":
                mesh = moe.make_ep_mesh([dev] * ranks, ep=n, tp=tp)
                _, step = moe.make_ep_train_step(mesh, cfg)
                loss_of = moe.make_ep_loss(mesh, cfg)
            else:
                mesh = sp.make_sp_mesh([dev] * ranks, sp=n, tp=tp)
                _, step = sp.make_sp_train_step(mesh, cfg, impl=impl,
                                                shard=shard)
                loss_of = sp.make_sp_loss(mesh, cfg, impl)
            params = model.init_params(torch.Generator().manual_seed(1), cfg,
                                       dev)
            paths, leaves = zip(*model._flatten(params))
            live = [t.detach().requires_grad_() for t in leaves]
            first = loss_of(model._unflatten(dict(zip(paths, live))),
                            torch.from_numpy(np.random.default_rng(2).integers(
                                0, 256, (batch, 65)).astype(np.int32)).to(dev))
            first = first[0] if isinstance(first, tuple) else first
            grads = dict(zip(paths, (g.cpu() for g in torch.autograd.grad(
                first, live))))
            opt = model.make_optimizer(model.TrainConfig()).init(params)
            if kind == "ep":
                params = moe.shard_ep_params(mesh, cfg, params)
                opt = moe.shard_ep_opt_state(mesh, cfg, opt)
            else:
                opt = sp.shard_sp_opt_state(mesh, cfg, opt, shard)
            rng = np.random.default_rng(2)
            losses, launches = [], []
            for _ in range(3):
                tokens = rng.integers(0, 256, (batch, 65)).astype(np.int32)
                attention.reset_launch_counts()
                params, opt, loss = step(params, opt,
                                         torch.from_numpy(tokens).to(dev))[:3]
                launches.append(dict(attention.LAUNCHES))
                losses.append(loss.item())
            if kind == "ep":
                params = model.gather_params(mesh, params)
            runs[dev] = (losses, dict(model._flatten(params)), launches,
                         grads)
        (kl, kp, kn, kg), (pl, pp, _, pg) = runs["cuda:0"], runs["cpu"]
        if kind == "ep" or impl == "ulysses":
            per = ranks * cfg.n_layers * (2 if cfg.remat else 1)
            want = _kernel_launches(
                attention, flash_attention=per,
                flash_attention_bwd_dq=ranks * cfg.n_layers,
                flash_attention_bwd_dkv=ranks * cfg.n_layers)
        else:
            hops = _sp_ring_hops(ring_attention, cfg, n) * data * tp
            want = _kernel_launches(
                attention,
                ring_flash_step=hops * cfg.n_layers
                * (2 if cfg.remat else 1),
                ring_flash_bwd_dq=hops * cfg.n_layers,
                ring_flash_bwd_dkv=hops * cfg.n_layers)
        grad_gap = max(((g - pg[path]).abs().max()
                        / pg[path].abs().max().clamp_min(1e-30)).item()
                       for path, g in kg.items())
        param_gap = max(((t.cpu() - pp[path]).abs().max()
                         / pp[path].abs().max().clamp_min(1e-30)).item()
                        for path, t in kp.items())
        param_over = max(((t.cpu() - pp[path]).abs() / (
            COMP_PARAM_TOL * (1 + pp[path].abs()))).max().item()
            for path, t in kp.items())
        rec[label] = dict(mesh=dict(mesh.shape), impl=impl, shard=shard,
                          losses={"cuda": kl, "cpu": pl},
                          max_loss_gap=max(abs(a - b)
                                           for a, b in zip(kl, pl)),
                          first_grad_rel_gap=grad_gap,
                          max_param_gap=param_gap,
                          param_gap_over_tolerance=param_over,
                          launches_per_step=kn[-1],
                          expected_launches_per_step=want,
                          launches_as_expected=all(x == want for x in kn))
    emit("small_compositions", **rec)
    for label, r in rec.items():
        if not r["launches_as_expected"]:
            raise AssertionError(f"f32 {label}: launched "
                                 f"{r['launches_per_step']}, want "
                                 f"{r['expected_launches_per_step']}")
        if not r["first_grad_rel_gap"] <= GRAD_F32_RTOL:
            raise AssertionError(f"f32 {label}: first-step gradients differ "
                                 f"by {r['first_grad_rel_gap']} of their "
                                 f"scale")
        if not r["max_loss_gap"] <= SMALL_TRAIN_LOSS_GAP:
            raise AssertionError(f"f32 {label}: CUDA and CPU ranks' losses "
                                 f"differ by {r['max_loss_gap']}")
        if not r["param_gap_over_tolerance"] <= 1.0:
            raise AssertionError(f"f32 {label}: params differ by "
                                 f"{r['param_gap_over_tolerance']} of "
                                 f"COMP_PARAM_TOL")
    return rec


def _pp_mesh(model, np, devices):
    """A (pp,) mesh of the pipeline over ``devices``, one stage each."""
    return model.Mesh(np.array(devices, dtype=object), ("pp",))


def phase_pp_train_main_path(torch, np, attention, model, pipeline,
                             train_rec, ep_rec):
    """``pipeline.make_pipeline_train_step`` of the step cell
    (TRAIN_FULL, batch TRAIN_BATCH) over PP_STAGES stages of the card (a
    (pp,) mesh, 2 layers a stage), PP_MICROBATCHES microbatches and
    remat, from the one-device step's params (seed 0) and batch (numpy
    seed 1): the first-step loss and gradient norm against
    train_main_path's one-device kernel step within TRAIN_LOSS_GAP /
    TRAIN_GRAD_NORM_RTOL; each stage's stored bytes as placed
    (``model.rank_state_bytes``: its blocks and their moments are 1/P of
    the whole, and every stage holds its own copy of the replicated
    leaves); the
    stage forwards a step (m·P, the bubble slots skipped) beside the
    GPipe bubble (P−1)/(m+P−1); MESH_WARM warm and MESH_STEPS timed
    steps whose launches are counted per step (K1 2·L·m under remat,
    each K2 kernel L·m, K3-K6 never); one profiled step; the loss must
    fall.  Then the MoE step model over PP_MOE_STAGES stages at m 1 and
    capacity EP_NO_DROP: its first loss and gradient norm against the
    one-device MoE step's that ep_train_main_path took, K1 and each K2
    kernel L launches (one microbatch, no remat)."""
    t0 = time.perf_counter()
    cfg = model.ModelConfig(**TRAIN_FULL)
    mesh = _pp_mesh(model, np, ["cuda:0"] * PP_STAGES)
    m, stages = PP_MICROBATCHES, PP_STAGES
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (TRAIN_BATCH, cfg.seq_len + 1)).astype(np.int32)).cuda()
    init_fn, step_fn = pipeline.make_pipeline_train_step(mesh, cfg, m)
    params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(int(np.prod(leaf.shape))
                   for _, leaf in model._flatten(params))
    held = model.rank_state_bytes(mesh, params, opt)
    placed = _placed_state_bytes(np, model, mesh, params)
    block_bytes = model.rank_state_bytes(
        mesh, {"blocks": params["blocks"]},
        {key: {"blocks": opt[key]["blocks"]} for key in ("mu", "nu")})
    first = _blocks_loss_and_grad_norm(
        torch, model, pipeline.make_pipeline_loss(mesh, cfg, m, remat=True),
        params, tokens)
    torch.cuda.empty_cache()
    per = cfg.n_layers * m
    want = _kernel_launches(attention, flash_attention=2 * per,
                            flash_attention_bwd_dq=per,
                            flash_attention_bwd_dkv=per)
    before = step_fn.counts["stage_forwards"]
    torch.cuda.reset_peak_memory_stats()
    params, opt, losses, launches, step_s = _train_steps(
        torch, attention, step_fn, params, opt, tokens, MESH_WARM,
        MESH_STEPS)
    forwards = (step_fn.counts["stage_forwards"] - before) \
        / (MESH_WARM + MESH_STEPS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = _profile_train(torch, step_fn, params, opt, tokens, "pp", 1)
    del params, opt, init_fn, step_fn
    torch.cuda.empty_cache()
    flops = _train_flops(n_params, cfg, TRAIN_BATCH)

    mcfg = model.ModelConfig(**dict(TRAIN_MOE,
                                    moe_capacity_factor=EP_NO_DROP))
    mmesh = _pp_mesh(model, np, ["cuda:0"] * PP_MOE_STAGES)
    mparams, _ = pipeline.make_pipeline_train_step(mmesh, mcfg, 1)[0](
        torch.Generator(device="cuda").manual_seed(0))
    attention.reset_launch_counts()
    moe_first = _blocks_loss_and_grad_norm(
        torch, model, pipeline.make_pipeline_loss(mmesh, mcfg, 1), mparams,
        tokens)
    moe_launches = dict(attention.LAUNCHES)
    moe_want = _kernel_launches(
        attention, flash_attention=mcfg.n_layers,
        flash_attention_bwd_dq=mcfg.n_layers,
        flash_attention_bwd_dkv=mcfg.n_layers)
    del mparams
    torch.cuda.empty_cache()
    single = ep_rec["first_loss"]["single_device"], \
        ep_rec["first_grad_norm"]["single_device"]
    rec = dict(config=TRAIN_FULL, dtype="bfloat16", batch=TRAIN_BATCH,
               mesh=dict(mesh.shape), microbatches=m,
               layers_per_stage=cfg.n_layers // stages, remat=True,
               shard_shape=[TRAIN_BATCH // m, cfg.n_heads, cfg.seq_len,
                            cfg.head_dim],
               n_params=n_params, first_loss=first[0],
               first_grad_norm=first[1],
               single_device_first_loss=train_rec["first_loss"],
               single_device_first_grad_norm=train_rec["grad_norm"],
               warm_steps=MESH_WARM, timed_steps=MESH_STEPS,
               step_ms=step_s * 1e3,
               tokens_per_s=TRAIN_BATCH * cfg.seq_len / step_s,
               mfu=flops / (step_s * BF16_OPS_PER_S), peak_memory_gb=peak,
               device_idle_share=prof["device_idle_share"],
               device_busy_ms=prof["device_busy_ms"],
               kernel_launches_per_step=prof["kernel_launches"],
               rank_state_bytes=held, rank_block_state_bytes=block_bytes,
               stage_forwards_per_step=forwards,
               stage_slots_per_step=(m + stages - 1) * stages,
               bubble_fraction=(stages - 1) / (m + stages - 1),
               losses=losses, launches_per_step=launches[-1],
               expected_launches_per_step=want,
               moe=dict(config=TRAIN_MOE, mesh=dict(mmesh.shape),
                        microbatches=1, capacity_factor=EP_NO_DROP,
                        first_loss=moe_first[0],
                        first_grad_norm=moe_first[1],
                        single_device_first_loss=single[0],
                        single_device_first_grad_norm=single[1],
                        launches=moe_launches, expected_launches=moe_want),
               seconds=time.perf_counter() - t0)
    emit("pp_train_main_path", **rec)
    if any(n != want for n in launches):
        raise AssertionError(f"pp step launched {launches}, want {want} per "
                             f"step")
    if forwards != m * stages:
        raise AssertionError(f"pp step ran {forwards} stage forwards a step, "
                             f"want m·P = {m * stages}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"pp: loss not finite or did not fall: {losses}")
    sl, sn = train_rec["first_loss"], train_rec["grad_norm"]
    if not (abs(first[0] - sl) <= TRAIN_LOSS_GAP
            and abs(first[1] - sn) <= TRAIN_GRAD_NORM_RTOL * sn):
        raise AssertionError(f"pp: first loss {first[0]}, grad norm "
                             f"{first[1]} vs one device {sl}, {sn}")
    whole = sum(block_bytes)
    if block_bytes != [whole // stages] * stages:
        raise AssertionError(f"pp: each stage's blocks and moments "
                             f"{block_bytes}, want 1/{stages} of {whole}")
    if sum(held) != placed:
        raise AssertionError(f"pp: the stages hold {sum(held)} bytes, a "
                             f"block of each leaf and its two moments on "
                             f"every stage is {placed}")
    if moe_launches != moe_want:
        raise AssertionError(f"pp MoE loss launched {moe_launches}, want "
                             f"{moe_want}")
    if not (abs(moe_first[0] - single[0]) <= TRAIN_LOSS_GAP
            and abs(moe_first[1] - single[1])
            <= TRAIN_GRAD_NORM_RTOL * single[1]):
        raise AssertionError(f"pp MoE at m 1, no-drop capacity: loss "
                             f"{moe_first[0]}, grad norm {moe_first[1]} vs "
                             f"one device {single}")
    return rec


def phase_pp3d_train_main_path(torch, np, attention, model, pipeline,
                               train_rec):
    """dp×pp×tp: ``pipeline.make_pipeline_train_step`` of the step cell
    on ``make_pipeline_mesh(["cuda:0"] * 8, pp=2, tp=2)`` (data 2 × pp 2
    × model 2), PP3D_MICROBATCHES microbatches and remat, its init the
    split (``split_qkv_weights``) of the seed-0 params: the first-step
    loss and gradient norm against train_main_path's one-device kernel
    step within TRAIN_LOSS_GAP / TRAIN_GRAD_NORM_RTOL; MESH_WARM warm
    and MESH_STEPS timed steps whose launches are counted per step (K1
    and each K2 kernel once per (data row, stage, model rank,
    microbatch, layer) on [4, 8, 1024, 64] shards, K1 twice under
    remat); each rank's stored bytes as placed; the loss must fall."""
    t0 = time.perf_counter()
    cfg = model.ModelConfig(**TRAIN_FULL)
    dp, pp, tp = PP3D_MESH
    m = PP3D_MICROBATCHES
    mesh = pipeline.make_pipeline_mesh(["cuda:0"] * (dp * pp * tp), pp=pp,
                                       tp=tp)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (TRAIN_BATCH, cfg.seq_len + 1)).astype(np.int32)).cuda()
    init_fn, step_fn = pipeline.make_pipeline_train_step(mesh, cfg, m)
    params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(int(np.prod(leaf.shape))
                   for _, leaf in model._flatten(params))
    held = model.rank_state_bytes(mesh, params, opt)
    placed = _placed_state_bytes(np, model, mesh, params)
    first = _blocks_loss_and_grad_norm(
        torch, model, pipeline.make_pipeline3d_loss(mesh, cfg, m, remat=True),
        params, tokens)
    torch.cuda.empty_cache()
    per = dp * tp * m * cfg.n_layers
    want = _kernel_launches(attention, flash_attention=2 * per,
                            flash_attention_bwd_dq=per,
                            flash_attention_bwd_dkv=per)
    torch.cuda.reset_peak_memory_stats()
    params, opt, losses, launches, step_s = _train_steps(
        torch, attention, step_fn, params, opt, tokens, MESH_WARM,
        MESH_STEPS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params, opt, init_fn, step_fn
    torch.cuda.empty_cache()
    flops = _train_flops(n_params, cfg, TRAIN_BATCH)
    rec = dict(config=TRAIN_FULL, dtype="bfloat16", batch=TRAIN_BATCH,
               mesh=dict(mesh.shape), microbatches=m, remat=True,
               shard_shape=[TRAIN_BATCH // (dp * m), cfg.n_heads // tp,
                            cfg.seq_len, cfg.head_dim],
               n_params=n_params, first_loss=first[0],
               first_grad_norm=first[1],
               single_device_first_loss=train_rec["first_loss"],
               single_device_first_grad_norm=train_rec["grad_norm"],
               warm_steps=MESH_WARM, timed_steps=MESH_STEPS,
               step_ms=step_s * 1e3,
               tokens_per_s=TRAIN_BATCH * cfg.seq_len / step_s,
               mfu=flops / (step_s * BF16_OPS_PER_S), peak_memory_gb=peak,
               rank_state_bytes=held,
               bubble_fraction=(pp - 1) / (m + pp - 1), losses=losses,
               launches_per_step=launches[-1],
               expected_launches_per_step=want,
               seconds=time.perf_counter() - t0)
    emit("pp3d_train_main_path", **rec)
    if any(n != want for n in launches):
        raise AssertionError(f"dp×pp×tp step launched {launches}, want "
                             f"{want} per step")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"dp×pp×tp: loss not finite or did not fall: "
                             f"{losses}")
    sl, sn = train_rec["first_loss"], train_rec["grad_norm"]
    if not (abs(first[0] - sl) <= TRAIN_LOSS_GAP
            and abs(first[1] - sn) <= TRAIN_GRAD_NORM_RTOL * sn):
        raise AssertionError(f"dp×pp×tp: first loss {first[0]}, grad norm "
                             f"{first[1]} vs one device {sl}, {sn}")
    if sum(held) != placed:
        raise AssertionError(f"dp×pp×tp: the ranks hold {sum(held)} bytes, "
                             f"a block of each leaf and its two moments on "
                             f"every rank is {placed}")
    return rec


def _placed_state_bytes(np, model, mesh, params) -> int:
    """The bytes of params and their two f32 moments at the params' specs
    when every rank holds its own block of every leaf."""
    return mesh.size * sum(
        3 * 4 * int(np.prod(leaf.shape)) // int(np.prod(leaf.counts))
        for _, leaf in model._flatten(params))


def _pipeline_grads(torch, model, pipeline, mesh, cfg, loss_of, params,
                    tokens) -> dict:
    """The gradient of ``loss_of`` with respect to every block of the
    pipeline's ``params``, in the one-device layout on the CPU (qkv
    packed)."""
    import dataclasses

    live = {path: dataclasses.replace(leaf, blocks={
        r: t.detach().requires_grad_() for r, t in leaf.blocks.items()})
        for path, leaf in model._flatten(params)}
    keys = [(path, r) for path, leaf in live.items() for r in leaf.blocks]
    grads = torch.autograd.grad(loss_of(model._unflatten(live), tokens),
                                [live[p].blocks[r] for p, r in keys],
                                allow_unused=True)
    # Each block's gradient summed over its ranks, held by its first.
    tree = {path: dataclasses.replace(leaf, blocks={})
            for path, leaf in live.items()}
    for (path, r), g in zip(keys, grads):
        leaf = live[path]
        first = leaf.first_holders(leaf.blocks)[leaf.indices[r]]
        g = torch.zeros_like(leaf.blocks[r]) if g is None else g
        if first in tree[path].blocks:
            g = tree[path].blocks[first] + g.to(tree[path].blocks[first].device)
        tree[path].blocks[first] = g
    out = model.gather_params(mesh, model._unflatten(tree))
    if "wq" in out["blocks"]:
        out = pipeline.merge_qkv_weights(out, cfg)
    return {path: t.cpu() for path, t in model._flatten(out)}


def phase_small_pipeline(torch, np, attention, model, pipeline):
    """The pipeline on small f32 models, CUDA ranks (K1/K2) against CPU
    ranks (their plain versions), from the same params and batches: pp
    only at (P, m) = (2, 4) (MHA) and (4, 2) (GQA), MoE over 2 stages
    at m 1 and m 4, dp×pp×tp on data 2 × pp 2 × model 2 at m 2 (MHA, and
    GQA with a window), and the CUDA ranks without remat against the CPU
    ranks with it.  The first step's gradient within GRAD_F32_RTOL of
    each leaf's largest |grad|, 3 steps' losses within
    SMALL_TRAIN_LOSS_GAP (small_mesh's bound), the params after them
    elementwise within COMP_PARAM_TOL · (1 + |p|) (small_compositions'
    bound for CUDA against CPU ranks; each leaf's largest relative gap
    beside it); the CUDA route's launches counted per step and exact:
    K1 L·m a step per (data row, model rank) shard (twice under remat),
    each K2 kernel L·m."""
    t0 = time.perf_counter()
    base = dict(vocab=256, d_model=128, n_layers=4, n_heads=4, d_ff=256,
                seq_len=64, dtype=torch.float32)
    moe_kw = dict(moe_experts=4, moe_top_k=2)
    cases = (
        ("pp2-m4", 2, 4, {}, True),
        ("pp4-m2-gqa", 4, 2, dict(n_kv_heads=2), True),
        ("moe-pp2-m1", 2, 1, moe_kw, True),
        ("moe-pp2-m4", 2, 4, moe_kw, True),
        ("3d-mha", PP3D_MESH, 2, {}, True),
        ("3d-gqa-window", PP3D_MESH, 2,
         dict(n_kv_heads=2, attention_window=24), True),
        ("pp2-m4-no-remat", 2, 4, {}, False),
    )
    rec = {}
    for label, shape, m, extra, cuda_remat in cases:
        cfg = model.ModelConfig(**base, **extra)
        runs = {}
        for dev, remat in (("cuda:0", cuda_remat), ("cpu", True)):
            if isinstance(shape, tuple):
                dp, pp, tp = shape
                mesh = pipeline.make_pipeline_mesh([dev] * (dp * pp * tp),
                                                   pp=pp, tp=tp)
                loss_of = pipeline.make_pipeline3d_loss(mesh, cfg, m,
                                                        remat=remat)
                shards = dp * tp
            else:
                mesh = _pp_mesh(model, np, [dev] * shape)
                loss_of = pipeline.make_pipeline_loss(mesh, cfg, m,
                                                      remat=remat)
                shards = 1
            _, step = pipeline.make_pipeline_train_step(mesh, cfg, m,
                                                        remat=remat)
            params = model.init_params(torch.Generator().manual_seed(1), cfg,
                                       dev)
            opt = model.make_optimizer(model.TrainConfig()).init(params)
            state = pipeline.shard_pipeline_state(
                mesh, cfg, {"params": params, "opt": opt})
            params, opt = state["params"], state["opt"]
            first = torch.from_numpy(np.random.default_rng(2).integers(
                0, 256, (8, 65)).astype(np.int32)).to(dev)
            grads = _pipeline_grads(torch, model, pipeline, mesh, cfg,
                                    loss_of, params, first)
            rng = np.random.default_rng(2)
            losses, launches = [], []
            for _ in range(3):
                tokens = torch.from_numpy(rng.integers(0, 256, (8, 65)).astype(
                    np.int32)).to(dev)
                attention.reset_launch_counts()
                params, opt, loss = step(params, opt, tokens)
                launches.append(dict(attention.LAUNCHES))
                losses.append(loss.item())
            final = pipeline.gather_pipeline_state(
                mesh, cfg, {"params": params, "opt": opt})["params"]
            runs[dev] = (losses, {p: t.cpu() for p, t in
                                  model._flatten(final)}, launches, grads)
        (kl, kp, kn, kg), (pl, pp_, _, pg) = runs["cuda:0"], runs["cpu"]
        per = shards * m * cfg.n_layers
        want = _kernel_launches(
            attention, flash_attention=per * (2 if cuda_remat else 1),
            flash_attention_bwd_dq=per, flash_attention_bwd_dkv=per)
        rec[label] = dict(
            mesh=dict(mesh.shape), microbatches=m, cuda_remat=cuda_remat,
            losses={"cuda": kl, "cpu": pl},
            max_loss_gap=max(abs(a - b) for a, b in zip(kl, pl)),
            first_grad_rel_gap=max(
                ((g - pg[path]).abs().max()
                 / pg[path].abs().max().clamp_min(1e-30)).item()
                for path, g in kg.items()),
            max_param_rel_gap=max(
                ((t - pp_[path]).abs().max()
                 / pp_[path].abs().max().clamp_min(1e-30)).item()
                for path, t in kp.items()),
            param_gap_over_tolerance=max(
                ((t - pp_[path]).abs()
                 / (COMP_PARAM_TOL * (1 + pp_[path].abs()))).max().item()
                for path, t in kp.items()),
            launches_per_step=kn[-1], expected_launches_per_step=want,
            launches_as_expected=all(x == want for x in kn))
    emit("small_pipeline", seconds=time.perf_counter() - t0, **rec)
    for label, r in rec.items():
        if not r["launches_as_expected"]:
            raise AssertionError(f"f32 pipeline {label}: launched "
                                 f"{r['launches_per_step']}, want "
                                 f"{r['expected_launches_per_step']}")
        if not r["first_grad_rel_gap"] <= GRAD_F32_RTOL:
            raise AssertionError(f"f32 pipeline {label}: first-step "
                                 f"gradients differ by "
                                 f"{r['first_grad_rel_gap']} of their scale")
        if not r["max_loss_gap"] <= SMALL_TRAIN_LOSS_GAP:
            raise AssertionError(f"f32 pipeline {label}: CUDA and CPU ranks' "
                                 f"losses differ by {r['max_loss_gap']}")
        if not r["param_gap_over_tolerance"] <= 1.0:
            raise AssertionError(f"f32 pipeline {label}: params differ by "
                                 f"{r['param_gap_over_tolerance']} of "
                                 f"COMP_PARAM_TOL")
    return rec


def _fit_demands(np, n: int):
    """``n`` gangs (total_chips, per_pod_chips, n_pods) from numpy seed 5:
    totals 1..2048 chips (the largest shape has 1,024), per-pod chips in
    {0, 1, 2, 4, 8} (0 takes the scorer's per_pod == 0 branch), pods
    from 1 to total / per-pod and two past it (a share no shape can
    hold)."""
    rng = np.random.default_rng(5)
    total = rng.integers(1, 2049, n)
    per_pod = rng.choice([0, 1, 2, 4, 8], n)
    pods = rng.integers(1, total // np.maximum(per_pod, 1) + 3)
    return np.stack([total, per_pod, pods], axis=1).astype(np.float32)


def phase_fit_scorer(torch, np, jaxfit):
    """The batch shape scorer (``engine/jaxfit.py``) on the card:
    FIT_GANGS gangs (_fit_demands) scored against the whole catalog and
    against each generation; every decision (the shape, or none) and
    every stranded cost must equal ``best_shapes_np``'s.  The card's ms
    per call (the demands already on the card; a warm call, then
    FIT_REPS calls, synchronised) beside the numpy twin's host ms."""
    t0 = time.perf_counter()
    demands = _fit_demands(np, FIT_GANGS)
    on_card = torch.from_numpy(demands).cuda()
    rec = {}
    for gen in FIT_GENERATIONS:
        names, score = jaxfit.make_batch_scorer(gen)
        score(on_card)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(FIT_REPS):
            best, cost = score(on_card)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t) / FIT_REPS * 1e3
        t = time.perf_counter()
        want = jaxfit.best_shapes_np(demands, gen)
        host_ms = (time.perf_counter() - t) * 1e3
        got = [(None, float("inf")) if c >= jaxfit._BIG
               else (names[int(b)], float(c))
               for b, c in zip(best.cpu().numpy(), cost.cpu().numpy())]
        rec[gen or "all"] = dict(
            shapes=len(names), card_ms=card_ms, numpy_host_ms=host_ms,
            mismatches=sum(a != b for a, b in zip(got, want)),
            infeasible=sum(name is None for name, _ in want),
            shapes_picked=len({name for name, _ in want}))
    emit("fit_scorer", gangs=FIT_GANGS,
         per_pod_zero=int((demands[:, 1] == 0).sum()), reps=FIT_REPS,
         seconds=time.perf_counter() - t0, **rec)
    for gen, r in rec.items():
        if r["mismatches"]:
            raise AssertionError(f"fit scorer ({gen}): {r['mismatches']} of "
                                 f"{FIT_GANGS} decisions differ from "
                                 f"best_shapes_np")
    return rec


def phase_moe_cli(model, decode, DrainReceipt):
    """The CLIs on a MoE model (--moe-experts 8 at the CLIs' default
    architecture): train, resume and drain; train --ep 2 and --sp 2 (the
    kernel ring); then serve (linear and --paged) and generate from the
    trainer's checkpoint, generate printing the tokens decode.generate
    gives in-process; and serve --spec-k 4 exits with its usage error.
    The runs that share no checkpoint run at once, each a process."""
    import concurrent.futures

    import torch

    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT), os.environ.get("PYTHONPATH", "")])}
    arch = ["--moe-experts", "8"]

    def run(module, args, expect=(), code=0):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", f"tpu_autoscaler_torch.workloads.{module}",
             "--platform", "cuda", *arch, *args], capture_output=True,
            text=True, env=env, cwd=ROOT, timeout=600)
        missing = [e for e in expect if e not in res.stderr]
        if res.returncode != code or missing:
            raise AssertionError(f"{module} {args} exited {res.returncode}, "
                                 f"missing {missing}:\n{res.stderr[-4000:]}")
        return time.perf_counter() - t0, res

    with tempfile.TemporaryDirectory() as tmp:
        none = os.path.join(tmp, "annotations")
        drain = os.path.join(tmp, "drain-annotations")
        with open(drain, "w") as f:
            f.write('autoscaler.tpu.dev/checkpoint-requested="1"\n')
        ckpt = os.path.join(tmp, "train")

        def train(tdir, steps, annotations, what, expect, flags=()):
            dt, _ = run("train", ["--checkpoint-dir", tdir, "--steps",
                                  str(steps), "--checkpoint-every", "10",
                                  "--annotations-file", annotations,
                                  *flags], expect)
            emit("cli", command="train", flags=arch + list(flags), run=what,
                 seconds=dt, checkpoints=sorted(os.listdir(tdir)))

        def chain():
            train(ckpt, 20, none, "train", ["step 10 loss",
                                            "training complete at step 20"])
            train(ckpt, 30, none, "resume", ["resumed from checkpoint step 20",
                                             "training complete at step 30"])
            train(ckpt, 5000, drain, "drain", [
                "drain requested: checkpointed at step 30, exiting cleanly"])

        def spec_refused():
            _, res = run("serve", ["--checkpoint-dir", ckpt, "--random", "2",
                                   "--paged", "--spec-k", "4",
                                   "--annotations-file", none], code=2)
            emit("cli", command="serve", cache="paged-spec-moe",
                 exit_code=res.returncode, error=res.stderr.strip()[-200:])
            if "--spec-k with MoE targets is not wired" not in res.stderr:
                raise AssertionError(f"serve --spec-k with MoE: "
                                     f"{res.stderr[-2000:]}")

        def serve(flags, cache):
            dt, res = run("serve", ["--checkpoint-dir", ckpt, "--random",
                                    "6", "--annotations-file", none,
                                    *flags], ["loaded step 30"])
            receipt = DrainReceipt.parse_line(
                res.stdout.strip().splitlines()[-1])
            emit("cli", command="serve", cache=cache, flags=arch + flags,
                 seconds=dt, served=receipt.served,
                 unserved=receipt.unserved, ticks=receipt.ticks,
                 preempted=receipt.stats["preempted_total"])
            if receipt.unserved != 0 or receipt.served != 6:
                raise AssertionError(f"serve CLI ({cache}, MoE) receipt: "
                                     f"{receipt}")

        prompt = [5, 17, 42, 9, 200]

        def generate():
            dt, res = run("generate", ["--checkpoint-dir", ckpt, "--prompt",
                                       ",".join(map(str, prompt)), "--batch",
                                       "2", "--steps", "8"],
                          ["loaded step 30"])
            cfg = model.ModelConfig(moe_experts=8)
            want = decode.generate(model.load_params(ckpt, 30, "cuda"),
                                   torch.tensor([prompt] * 2), cfg,
                                   8).tolist()
            want_lines = [f"{','.join(map(str, row[:5]))} | "
                          f"{','.join(map(str, row[5:]))}" for row in want]
            lines = res.stdout.strip().splitlines()
            emit("cli", command="generate", checkpoint="moe train step_30",
                 seconds=dt, lines=lines, in_process=want_lines)
            if lines != want_lines:
                raise AssertionError(f"generate CLI (MoE) printed {lines}, "
                                     f"in-process {want_lines}")

        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            first = [pool.submit(chain), pool.submit(
                train, os.path.join(tmp, "ep"), 10, none, "train",
                ["ep 2 ranks on cuda:0, cuda:0", "step 10 loss",
                 " balance "], ["--ep", "2"]), pool.submit(
                train, os.path.join(tmp, "sp"), 10, none, "train",
                ["sp 2 ranks (pallas) on cuda:0, cuda:0", " balance "],
                ["--sp", "2", "--sp-impl", "pallas"])]
            for f in first:
                f.result()
            then = [pool.submit(serve, [], "linear-moe"),
                    pool.submit(serve, ["--paged", "--block-size", "16",
                                        "--max-new-tokens", "48",
                                        "--num-blocks", "6"], "paged-moe"),
                    pool.submit(generate), pool.submit(spec_refused)]
            for f in then:
                f.result()


def phase_cli(model, decode, DrainReceipt):
    """The CLIs on the card: serve with the linear cache and with
    ``--paged`` (a 6-block pool, so it preempts), and ``serve --random 4
    --d-model 384`` (head_dim 96, which no kernel is built for); then,
    at the CLIs' default architecture flags (head_dim 32), generate, which must
    print the tokens decode.generate gives in-process, and serve; then
    train (20 steps, checkpoints every 10), resume to 30, drain (a
    checkpoint request in the annotations file: exit 0 with a
    checkpoint), and generate from the trainer's checkpoint; then the
    same with ``train --sp 2 --sp-impl pallas`` (the kernel ring) and
    with ``train --tp 2 --shard fsdp`` (a dp 1 × tp 2 mesh on the card,
    K1/K2 per shard), with ``train --pp-stages 2 --pp-microbatches 2``
    (2 stages of the card) and with ``train --pp-stages 2 --tp 2`` (data
    1 × pp 2 × model 2, its checkpoint merged back to the one-device
    layout, which generate reads).  Runs that share no checkpoint run at
    once, each a process."""
    import concurrent.futures

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
        d256, _ = checkpoint(model.ModelConfig(vocab=256, d_model=256,
                                               n_layers=2, seq_len=64),
                             "d256")
        # --d-model 384 over the CLIs' 4 heads: head_dim 96, which no
        # kernel is built for (K1 padded to 128, K3 at its true width).
        d384, _ = checkpoint(model.ModelConfig(d_model=384), "d384")
        # The CLIs' defaults: vocab 256, d_model 128, 2 layers, 4 heads.
        cfg = model.ModelConfig()
        defaults, params = checkpoint(cfg, "defaults")
        arch = ["--vocab", "256", "--d-model", "256", "--n-layers", "2",
                "--seq-len", "64", "--slots", "2", "--max-len", "128",
                "--chunk", "16"]
        paged_flags = arch + ["--paged", "--block-size", "16",
                              "--max-new-tokens", "48"]
        prompt = [5, 17, 42, 9, 200]

        def traced():
            # Request tracing on the preempting pool: every request traced.
            payload = serve(d256, "paged-trace", paged_flags + [
                "--num-blocks", "6", "--trace-sample", "1.0",
                "--slo-ticks", "4"])
            if payload.get("trace", {}).get("sampled_total") != 6:
                raise AssertionError(f"serve --trace-sample 1.0 receipt's "
                                     f"trace: {payload.get('trace')}")

        def spec_refused():
            res = subprocess.run(serve_cmd(d256, arch + ["--spec-k", "4"]),
                                 capture_output=True, text=True, env=env,
                                 cwd=ROOT, timeout=600)
            emit("cli", command="serve", cache="spec-without-paged",
                 exit_code=res.returncode, error=res.stderr.strip()[-200:])
            if res.returncode != 2 or "add --paged" not in res.stderr:
                raise AssertionError(f"serve --spec-k without --paged exited "
                                     f"{res.returncode}: {res.stderr[-2000:]}")

        def generate(ckpt, what, want_params, expect=(), tp=None):
            """The generate CLI on ``ckpt`` must print the tokens
            decode.generate gives in-process from ``want_params`` (with
            ``tp``: under the dp 1 × tp mesh of the card, as the CLI's
            ``--tp`` builds it)."""
            flags = [] if tp is None else ["--tp", str(tp)]
            dt, lines = run([sys.executable, "-m",
                             "tpu_autoscaler_torch.workloads.generate",
                             "--checkpoint-dir", ckpt, "--prompt",
                             ",".join(map(str, prompt)), "--batch", "2",
                             "--steps", "8", "--platform", "cuda", *flags],
                            f"generate CLI on {what}", expect)
            mesh = None if tp is None else model.make_mesh(["cuda:0"] * tp,
                                                           tp=tp)
            want = decode.generate(want_params(), torch.tensor([prompt] * 2),
                                   cfg, 8, mesh=mesh).tolist()
            want_lines = [f"{','.join(map(str, row[:5]))} | "
                          f"{','.join(map(str, row[5:]))}" for row in want]
            emit("cli", command="generate", checkpoint=what, flags=flags,
                 head_dim=cfg.head_dim, seconds=dt, lines=lines,
                 in_process=want_lines)
            if lines != want_lines:
                raise AssertionError(f"generate CLI printed {lines} from "
                                     f"{what}, in-process {want_lines}")

        # The train CLI at its defaults: train, resume, drain; then the
        # generate CLI on the trainer's last checkpoint.  On one device,
        # with the sequence over 2 ranks (the kernel ring) and over a
        # dp 1 × tp 2 mesh with FSDP state (K1/K2 per shard).
        drain = os.path.join(tmp, "drain-annotations")
        with open(drain, "w") as f:
            f.write('autoscaler.tpu.dev/checkpoint-requested="1"\n')

        def train_chain(label, flags, first):
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
            generate(tdir, f"{label}train step_30",
                     lambda: model.load_params(tdir, 30, "cuda"),
                     ["loaded step 30"])
            if label == "mesh ":
                # What train --tp 2 wrote, served and generated from
                # under the same mesh, each a process, at once.
                under = ["serving under mesh {'data': 1, 'model': 2}"]
                with concurrent.futures.ThreadPoolExecutor(3) as pool:
                    jobs = [
                        pool.submit(serve, tdir, "mesh-linear", ["--tp", "2"],
                                    expect=under),
                        pool.submit(serve, tdir, "mesh-paged",
                                    ["--tp", "2", "--paged"], expect=under),
                        pool.submit(generate, tdir,
                                    f"{label}train step_30 (--tp 2)",
                                    lambda: model.load_params(tdir, 30,
                                                              "cuda"),
                                    ["loaded step 30", *under], tp=2)]
                    for job in jobs:
                        job.result()

        # Every run reads or writes its own checkpoint: they run at once,
        # each a process.
        with concurrent.futures.ThreadPoolExecutor(5) as pool:
            jobs = [
                pool.submit(train_chain, "", [], []),
                pool.submit(train_chain, "sp ",
                            ["--sp", "2", "--sp-impl", "pallas"],
                            ["sp 2 ranks (pallas)"]),
                pool.submit(train_chain, "mesh ",
                            ["--tp", "2", "--shard", "fsdp"],
                            ["mesh {'data': 1, 'model': 2}, shard fsdp on "
                             "cuda:0, cuda:0", "attention kernel"]),
                # The pipeline: 2 stages (a layer each) of the card, then
                # data 1 × pp 2 × model 2, whose checkpoint (qkv packed
                # again) generate then reads.
                pool.submit(train_chain, "pp ",
                            ["--pp-stages", "2", "--pp-microbatches", "2"],
                            ["pp 2 stages on cuda:0, cuda:0; mesh {'pp': "
                             "2}, 2 microbatches"]),
                pool.submit(train_chain, "pp×tp ",
                            ["--pp-stages", "2", "--tp", "2"],
                            ["mesh {'data': 1, 'pp': 2, 'model': 2}, 4 "
                             "microbatches"]),
                pool.submit(serve, d256, "linear", arch),
                pool.submit(serve, d256, "paged",
                            paged_flags + ["--num-blocks", "6"]),
                # Speculative serving: the first layer drafts.
                pool.submit(serve, d256, "paged-spec", paged_flags + [
                    "--spec-k", "4", "--draft-layers", "1"],
                    expect=["speculative: accept_rate"]),
                pool.submit(traced), pool.submit(spec_refused),
                pool.submit(serve, d384, "linear-d384", ["--d-model", "384"],
                            requests=4),
                pool.submit(generate, defaults, "the defaults checkpoint",
                            lambda: params),
                pool.submit(serve, defaults, "linear-defaults", [])]
            for job in jobs:
                job.result()


def _watch_train(cmd, env, kill_at=None) -> dict:
    """Run a train CLI command, reading its log as it runs: its losses
    and tok/s by logged step, its log lines and seconds.  With
    ``kill_at`` it is SIGKILLed at its first logged step >= kill_at;
    otherwise it must exit 0.  A run is killed after 600 s."""
    import threading

    step_re = re.compile(r"step (\d+) loss ([0-9.]+) \(([0-9.]+) tok/s\)")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    watchdog = threading.Timer(600, proc.kill)
    watchdog.start()
    losses, toks, lines, killed = {}, {}, [], None
    try:
        for line in proc.stderr:
            lines.append(line.rstrip("\n"))
            m = step_re.search(line)
            if m:
                step = int(m.group(1))
                losses[step], toks[step] = float(m.group(2)), \
                    float(m.group(3))
                if kill_at is not None and step >= kill_at:
                    proc.kill()                         # SIGKILL
                    killed = step
                    break
        proc.wait(timeout=60)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
    if killed is None and (proc.returncode != 0 or kill_at is not None):
        raise AssertionError(f"train CLI exited {proc.returncode} (kill at "
                             f"{kill_at}):\n" + "\n".join(lines[-40:]))
    return dict(losses=losses, toks=toks, log="\n".join(lines),
                seconds=time.perf_counter() - t0, killed_at=killed)


def _loader_ms(engine, shard) -> float:
    """Host ms a batch of ``engine`` over CONVERGE_LOADER_BATCHES steps
    in order (the native one prefetching each next step as it returns)."""
    loader = engine(shard, CONVERGE_BATCH, CONVERGE_SEQ + 1, 0)
    try:
        t0 = time.perf_counter()
        for step in range(CONVERGE_LOADER_BATCHES):
            loader.next(step)
        return (time.perf_counter() - t0) * 1e3 / CONVERGE_LOADER_BATCHES
    finally:
        loader.close()


def phase_converge(np, dataio):
    """The real-text training path (bench_tpu.py:869 _impl_converge at its
    full size), in order: the port's tokenizer CLI rebuilds
    data/corpus.bin byte for byte into a temporary directory (from a
    copy of data/tokenizer.json); the train CLI trains on that shard and
    is SIGKILLed at step >= CONVERGE_KILL_AT; the same command resumes
    from step 500 (or 400, if 500's checkpoint had not landed) on the
    native loader and runs to CONVERGE_STEPS.  Checks, each failing the
    phase: the shard; the kill; the resume and its loader; the loss curve
    falls (last < first - 0.5 and < ln V - 0.5: bench_tpu.py's gates)
    and run 2 starts below ln V - 0.2; the loader replays the stream (in
    process, the native engine against the numpy one over steps R..560)
    and run 2's losses at the steps both runs logged are within
    CONVERGE_REPLAY_TOL of run 1's; run 2's log counts K1 = K2 dq = K2
    dk/dv = one a layer a step and no other kernel.  Also reports the
    curve every 100th step, epochs, each run's seconds, run 2's median
    tok/s, a step_N directory's bytes, and both loader engines' host ms a
    batch.  The temporary directory (~10 checkpoints) is removed."""
    import shutil

    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT), os.environ.get("PYTHONPATH", "")])}
    data = ROOT / "data"
    with tempfile.TemporaryDirectory() as tmp:
        tokenizer = os.path.join(tmp, "tokenizer.json")
        shutil.copy(data / "tokenizer.json", tokenizer)
        shard = os.path.join(tmp, "corpus.bin")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "tpu_autoscaler_torch.workloads.tokenizer",
             "--corpus", str(data / "corpus.txt"), "--vocab",
             str(CONVERGE_VOCAB), "--tokenizer-out", tokenizer,
             "--shard-out", shard], capture_output=True, text=True, env=env,
            cwd=ROOT, timeout=600)
        tokenize_s = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"tokenizer CLI exited {res.returncode}:\n"
                                 f"{res.stderr[-4000:]}")
        shard_tokens = os.path.getsize(shard) // 4
        shard_rebuilt = (Path(shard).read_bytes()
                         == (data / "corpus.bin").read_bytes()
                         and shard_tokens == CORPUS_TOKENS)
        ckpt = os.path.join(tmp, "ckpt")
        cmd = [sys.executable, "-m", "tpu_autoscaler_torch.workloads.train",
               "--steps", str(CONVERGE_STEPS), "--vocab",
               str(CONVERGE_VOCAB), "--d-model", str(CONVERGE_D_MODEL),
               "--n-layers", str(CONVERGE_LAYERS), "--seq-len",
               str(CONVERGE_SEQ), "--batch", str(CONVERGE_BATCH),
               "--data-file", shard, "--checkpoint-dir", ckpt,
               "--checkpoint-every", str(CONVERGE_EVERY), "--lr", "3e-3",
               "--warmup-steps", str(CONVERGE_WARMUP), "--lr-schedule",
               "cosine", "--grad-clip", "1.0", "--platform", "cuda",
               "--annotations-file", os.path.join(tmp, "none")]
        run1 = _watch_train(cmd, env, kill_at=CONVERGE_KILL_AT)
        after_kill = sorted(os.listdir(ckpt))
        run2 = _watch_train(cmd, env)
        resumed = re.search(r"resumed from checkpoint step (\d+)",
                            run2["log"])
        resume = int(resumed.group(1)) if resumed else None
        loader = re.search(r"token shard \S+: (\d+) tokens \((\w+) "
                           r"loader\)", run2["log"])
        launches = re.search(r"kernel launches (\{.*\})", run2["log"])
        launches = json.loads(launches.group(1)) if launches else {}
        final = Path(ckpt) / f"step_{CONVERGE_STEPS}"
        step_bytes = sum(f.stat().st_size for f in final.iterdir()) \
            if final.is_dir() else None
        native = dataio.open_token_loader(shard, CONVERGE_BATCH,
                                          CONVERGE_SEQ + 1, 0)
        plain = dataio.PyTokenLoader(shard, CONVERGE_BATCH, CONVERGE_SEQ + 1,
                                     0)
        try:
            replayed = range(resume or 0, CONVERGE_KILL_AT + 11)
            stream_equal = isinstance(native, dataio.NativeTokenLoader) \
                and all(np.array_equal(native.next(s), plain.next(s))
                        for s in replayed)
        finally:
            native.close()
            plain.close()
        loader_ms = {"native": _loader_ms(dataio.NativeTokenLoader, shard),
                     "numpy": _loader_ms(dataio.PyTokenLoader, shard)}
    ln_v = math.log(CONVERGE_VOCAB)
    curve = {**run1["losses"], **run2["losses"]}
    first, last = curve[min(curve)], curve.get(CONVERGE_STEPS)
    both = sorted(set(run1["losses"]) & set(run2["losses"]))
    replay_diffs = [abs(run1["losses"][s] - run2["losses"][s]) for s in both]
    run2_first = run2["losses"][min(run2["losses"])] if run2["losses"] \
        else None
    want = CONVERGE_LAYERS * (CONVERGE_STEPS - (resume or 0))
    want_launches = {k: (want if k.startswith("flash_attention") else 0)
                     for k in launches}
    checks = {
        "shard_rebuilt": shard_rebuilt,
        "killed": (run1["killed_at"] is not None
                   and run1["killed_at"] >= CONVERGE_KILL_AT),
        "resumed": resume in CONVERGE_RESUMES,
        "native_loader": bool(loader) and loader.group(2)
        == "NativeTokenLoader" and int(loader.group(1)) == CORPUS_TOKENS,
        "completed": (f"training complete at step {CONVERGE_STEPS}"
                      in run2["log"] and last is not None),
        "decreasing": (last is not None and last < first - 0.5
                       and last < ln_v - 0.5),
        "resume_continued_curve": (run2_first is not None
                                   and run2_first < ln_v - 0.2),
        "replay_stream": stream_equal,
        "replay_losses": (bool(both) and max(replay_diffs)
                          <= CONVERGE_REPLAY_TOL),
        "launches": bool(launches) and launches == want_launches,
    }
    rec = dict(
        config=dict(vocab=CONVERGE_VOCAB, d_model=CONVERGE_D_MODEL,
                    n_layers=CONVERGE_LAYERS, n_heads=4, head_dim=128,
                    d_ff=512, seq_len=CONVERGE_SEQ, batch=CONVERGE_BATCH,
                    steps=CONVERGE_STEPS, checkpoint_every=CONVERGE_EVERY,
                    lr=3e-3, warmup=CONVERGE_WARMUP, schedule="cosine",
                    grad_clip=1.0, dtype="bf16 over f32 masters"),
        checks=checks, tokenize_seconds=tokenize_s,
        shard_tokens=shard_tokens, killed_at=run1["killed_at"],
        checkpoints_after_kill=after_kill, resumed_from=resume,
        loader=loader.group(2) if loader else None,
        loss_first=first, loss_last=last, ln_vocab=ln_v,
        run2_first_loss=run2_first,
        curve={s: curve[s] for s in sorted(curve) if s % 100 == 0},
        replayed_steps=both, replay_max_abs_diff=max(replay_diffs,
                                                     default=None),
        replay_equal_as_logged=bool(both) and max(replay_diffs) == 0,
        epochs=CONVERGE_STEPS * CONVERGE_BATCH * CONVERGE_SEQ / shard_tokens,
        run1_seconds=run1["seconds"], run2_seconds=run2["seconds"],
        run2_median_tok_s=statistics.median(run2["toks"].values())
        if run2["toks"] else None,
        step_dir_bytes=step_bytes, launches=launches,
        launches_want=want_launches, run2_steps=CONVERGE_STEPS - (resume
                                                                  or 0),
        loader_host_ms_per_batch=loader_ms)
    emit("converge", **rec)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"converge failed {failed}:\n"
                             f"{run2['log'][-4000:]}")
    return rec


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch.nn.functional as F

    from tpu_autoscaler_torch import dataio
    from tpu_autoscaler_torch.engine import jaxfit
    from tpu_autoscaler_torch.serving.drain import DrainReceipt
    from tpu_autoscaler_torch.workloads import (
        attention,
        decode,
        distributed,
        model,
        moe,
        paged,
        pipeline,
        ring_attention,
        serving,
        sp,
        spec_serving,
        train,
    )

    t_start = time.perf_counter()
    name, smi = phase_device(torch)
    phase_build(attention)
    main_rec, eng, main_tokens = phase_main_path(torch, np, attention, model,
                                                 serving)
    phase_profile(torch, np, serving, eng, "linear", PROMPT_LENS)
    del eng
    paged_rec, paged_tick, eng, paged_plain, write_call = \
        phase_paged_main_path(torch, np, attention, model, serving, paged)
    phase_profile(torch, np, serving, eng, "paged", PAGED_PROMPT_LENS)
    del eng
    for label, arch in (("dense", FULL), ("moe", GRAPH_MOE)):
        phase_paged_decode_graph_check(torch, np, attention, model, serving,
                                       paged, label, arch)
    mesh_serve_rec, eng = phase_mesh_main_path(
        torch, np, attention, model, serving, main_rec, main_tokens)
    phase_profile(torch, np, serving, eng, "mesh_linear", PROMPT_LENS,
                  host=False)
    del eng, main_tokens
    mesh_paged_rec, mesh_paged_tick, eng = phase_mesh_paged_main_path(
        torch, np, attention, model, serving, paged, paged_rec,
        paged_plain[0])
    phase_profile(torch, np, serving, eng, "mesh_paged", PAGED_PROMPT_LENS,
                  host=False)
    del eng
    spec_rec, spec_tick, eng, syncs = phase_spec_main_path(
        torch, np, attention, model, serving, spec_serving, paged_plain)
    phase_profile(torch, np, serving, eng, "spec", PAGED_PROMPT_LENS, syncs)
    del eng
    self_draft_rec = phase_spec_self_draft(
        torch, np, attention, model, serving, spec_serving, paged_plain)
    del paged_plain
    moe_rec, eng, _ = phase_main_path(torch, np, attention, model, serving,
                                      FULL_MOE, "moe_main_path")
    phase_profile(torch, np, serving, eng, "moe_linear", PROMPT_LENS)
    del eng
    moe_paged_rec = phase_paged_main_path(
        torch, np, attention, model, serving, paged, FULL_MOE,
        "moe_paged_main_path")[0]
    # 128 MB scratch, written before each timed launch: evicts the 50 MB L2.
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    floor_ms = phase_launch_floor(torch, flush)
    checks = phase_kernel_checks(torch, F, attention, flush,
                                 main_rec["mid_tick_lengths"])
    paged_checks = phase_paged_kernel_checks(torch, F, attention, flush,
                                             paged_tick, spec_tick)
    prefill_checks = phase_paged_prefill_checks(torch, attention, paged,
                                                model, flush)
    write_timing = phase_token_write_timing(torch, attention, flush,
                                            write_call)
    del write_call
    attn_checks = phase_attn_kernel_checks(torch, F, attention, flush)
    bwd_checks = phase_bwd_kernel_checks(torch, F, attention, flush)
    ring_checks = phase_ring_kernel_checks(torch, F, attention, flush)
    mesh_checks = phase_mesh_kernel_checks(
        torch, F, attention, flush, mesh_serve_rec["mid_tick_lengths"],
        mesh_paged_tick)
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
    mesh_gen_rec = phase_mesh_generate_main_path(torch, np, attention, model,
                                                 decode, gen_recs[0])
    moe_gen_rec = phase_generate_main_path(
        torch, np, attention, model, decode, "moe-gqa", FULL_MOE, GEN_PROMPT,
        GEN_STEPS)[0]
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
    moe_train_rec = phase_train_main_path(
        torch, np, attention, model, "moe_step", TRAIN_MOE, TRAIN_BATCH,
        TRAIN_WARM, TRAIN_STEPS, 1, compare=True)
    ep_rec = phase_ep_train_main_path(torch, np, attention, model, moe)
    mesh_rec = phase_mesh_train_main_path(torch, np, attention, model)
    multislice_rec = phase_multislice_train(torch, np, attention, model,
                                            distributed, mesh_rec)
    ep_tp_rec = phase_ep_tp_train_main_path(torch, np, attention, model, moe,
                                            ep_rec)
    sp_tp_rec = phase_sp_tp_train_main_path(torch, np, attention, model, sp,
                                            ring_attention, sp_rec)
    pp_rec = phase_pp_train_main_path(torch, np, attention, model, pipeline,
                                      train_rec, ep_rec)
    pp3d_rec = phase_pp3d_train_main_path(torch, np, attention, model,
                                          pipeline, train_rec)
    dist_rec = phase_distributed_train(torch, np, attention, model, train)
    phase_small_exact(torch, np, model, serving, paged, decode, spec_serving)
    phase_small_moe_exact(torch, np, model, serving, paged, decode, moe)
    phase_small_train(torch, np, model)
    phase_small_sp(torch, np, model, sp, decode)
    phase_small_mesh(torch, np, attention, model)
    phase_small_mesh_serving(torch, np, model, serving, paged, decode,
                             spec_serving)
    sp_ep_rec = phase_small_sp_ep(torch, np, attention, model, sp)
    small_comp_rec = phase_small_compositions(torch, np, attention, model,
                                              moe, sp, ring_attention)
    small_pp_rec = phase_small_pipeline(torch, np, attention, model,
                                        pipeline)
    phase_fit_scorer(torch, np, jaxfit)
    trained_rec = phase_spec_trained(torch, np, attention, model, decode,
                                     dataio, paged, serving, spec_serving)
    phase_cli(model, decode, DrainReceipt)
    phase_moe_cli(model, decode, DrainReceipt)
    converge_rec = phase_converge(np, dataio)
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
    # K7 replaces no TPU kernel: the JAX package's paged prefill is an
    # einsum; at sc2-3b.complete's median call beside that einsum.
    at_main = prefill_checks[0]
    kernels.append(dict(
        name="paged_flash_prefill", route="cuda",
        design="wgmma+tma through the block table (f32: cuda-core fma)",
        source="tpu_autoscaler_torch/csrc/paged_flash_prefill.cu",
        replaces=None, added_for="the gathered-table einsum of the paged "
        "prefill (tpu_autoscaler/workloads/paged.py has no kernel there)",
        launches=paged_rec["paged_flash_prefill_launches"],
        max_abs_err=at_main["max_abs_err"], ms=at_main["ms"],
        plain_ms=at_main["plain_ms"], einsum_ms=at_main["einsum_ms"],
        bound_ms=at_main["bound_ms"], bound_by=at_main["bound_by"],
        tflops=at_main["tflops"], cases_passed=len(prefill_checks),
        shape=at_main["shape"], lanes=at_main["lanes"]))
    # K8 replaces no TPU kernel: the JAX package's decode step writes
    # with a dropping scatter; at the paged main path's median decode
    # step beside the write lists and masked index_put_ it stands in for.
    # Its launches were counted on the card over the timed pass, and
    # every write of the warm pass was held to the plain version.
    kernels.append(dict(
        name="paged_token_write", route="cuda",
        design="one CTA per (row, KV head); each row decides on the card "
        "whether it writes",
        source="tpu_autoscaler_torch/csrc/paged_token_write.cu",
        replaces=None, added_for="the dropping scatter of the decode "
        "step's new k/v (tpu_autoscaler/workloads/paged.py::_scatter_token, "
        "mode=drop), so that the step keeps one shape as a CUDA graph",
        launches=paged_rec["paged_token_write_launches"],
        max_abs_err=0.0, ms=write_timing["ms"],
        plain_ms=write_timing["plain_ms"],
        bound_ms=write_timing["bound_ms"],
        bound_by=write_timing["bound_by"], launch_floor_ms=floor_ms,
        shape=write_timing["shape"],
        active_rows=write_timing["active_rows"],
        writes_checked=paged_rec["token_writes_checked"]))
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
    # K1 and K2 per shard of the mesh step: one rank's shard and its GQA
    # form, launches per mesh train step (all 8 ranks).
    def mesh_shard(checks, part=None, grads=None):
        out = {}
        for case in ("mesh-shard", "mesh-shard-gqa"):
            c = next(c for c in checks if c["case"] == case)
            key = "" if part is None else f"_{part}"
            err = c["max_abs_err"] if grads is None else max(
                c["max_abs_err"][g] for g in grads)
            out[case] = dict(shape=c["shape"], ms=c[f"ms{key}"],
                             plain_ms=c["plain_ms"],
                             bound_ms=c[f"bound_ms{key}"],
                             bound_by=c[f"bound_by{key}"],
                             library_ms=c["library_ms"], max_abs_err=err,
                             tflops=c[f"tflops{key}"])
        return out

    kernels[0]["mesh_shard"] = dict(
        mesh_shard(attn_checks),
        launches=mesh_rec["launches_per_step"]["flash_attention"],
        launches_per="mesh train step (dp 4 x tp 2, 8 ranks)")
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
            cases_passed=len(bwd_checks), shape=at_main["shape"],
            mesh_shard=dict(
                mesh_shard(bwd_checks, part, grads),
                launches=mesh_rec["launches_per_step"][kname],
                launches_per="mesh train step (dp 4 x tp 2, 8 ranks)")))
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
    # Launches of every kernel on the MoE paths: over the MoE linear and
    # paged engines' timed passes, per MoE generate call, per MoE train
    # step on one device and with expert parallelism, per sp×ep step.
    moe_paths = {
        "moe_main_path": {"flash_decode": moe_rec["flash_decode_launches"]},
        "moe_paged_main_path": {
            "paged_flash_decode": moe_paged_rec["paged_flash_decode_launches"],
            "paged_flash_prefill":
                moe_paged_rec["paged_flash_prefill_launches"],
            "paged_token_write":
                moe_paged_rec["paged_token_write_launches"]},
        "moe_generate_main_path": moe_gen_rec["launches"],
        "moe_train_main_path": moe_train_rec["launches_per_step"],
        "ep_train_main_path": ep_rec["launches_per_step"],
        "small_sp_ep": sp_ep_rec["launches_per_step"]}
    for kernel in kernels:
        kernel["moe_path_launches"] = {
            path: n[kernel["name"]] for path, n in moe_paths.items()
            if n.get(kernel["name"])}
        if not kernel["moe_path_launches"]:
            raise AssertionError(f"{kernel['name']} never launched on a MoE "
                                 f"path: {moe_paths}")
    # K1/K2 and K5/K6 on the compositions' paths, per train step: the
    # multi-slice mesh, ep×tp, sp×tp (the ring, and Ulysses under tp),
    # each of the two processes of the distributed phase, and the small
    # f32 models on CUDA ranks; each at its shard shape there (the
    # multi-slice and ep×tp ranks' shard is the mesh step's).
    comp_paths = {
        "multislice_train": multislice_rec["launches_per_step"],
        "ep_tp_train_main_path": ep_tp_rec["launches_per_step"],
        "sp_tp_train_main_path": sp_tp_rec["launches_per_step"],
        "sp_tp_ulysses": sp_tp_rec["ulysses_launches_per_step"],
        "distributed_train_per_process": dist_rec["launches_per_step"],
        **{f"small_compositions/{label}": r["launches_per_step"]
           for label, r in small_comp_rec.items()}}

    def shard_case(checks, label, part=None, grads=None):
        # A ring hop's plain and library times are the whole forward or
        # backward hop's, as in its main row.
        c = next(c for c in checks if c["case"] == label)
        key = "" if part is None else f"_{part}"
        whole = "_fwd" if part == "fwd" else "_bwd"
        err = c["max_abs_err"] if grads is None else max(
            c["max_abs_err"][g] for g in grads)
        return dict(shape=c["shape"], dtype=c["dtype"], ms=c[f"ms{key}"],
                    plain_ms=c.get("plain_ms", c.get(f"plain_ms{whole}")),
                    bound_ms=c[f"bound_ms{key}"],
                    bound_by=c[f"bound_by{key}"],
                    library_ms=c.get("library_ms",
                                     c.get(f"library_ms{whole}")),
                    max_abs_err=err, tflops=c[f"tflops{key}"])

    shards = {
        "flash_attention": (attn_checks, None, None,
                            ("ulysses-tp-shard", "dist-shard-f32")),
        "flash_attention_bwd_dq": (bwd_checks, "dq", ("dq",),
                                   ("ulysses-tp-shard", "dist-shard-f32")),
        "flash_attention_bwd_dkv": (bwd_checks, "dkv", ("dk", "dv"),
                                    ("ulysses-tp-shard", "dist-shard-f32")),
        "ring_flash_step": (ring_checks, "fwd", ("m", "l", "acc"),
                            ("sp-tp-unmasked", "sp-tp-diag")),
        "ring_flash_bwd_dq": (ring_checks, "dq", ("dq",),
                              ("sp-tp-unmasked", "sp-tp-diag")),
        "ring_flash_bwd_dkv": (ring_checks, "dkv", ("dk", "dv"),
                               ("sp-tp-unmasked", "sp-tp-diag"))}
    for kernel in kernels:
        kname = kernel["name"]
        if kname not in shards:
            continue
        kernel["composition_launches"] = {
            path: n[kname] for path, n in comp_paths.items() if n.get(kname)}
        if not kernel["composition_launches"]:
            raise AssertionError(f"{kname} never launched on a composition "
                                 f"path: {comp_paths}")
        checks_of, part, grads, labels = shards[kname]
        kernel["composition_shard"] = {
            label: shard_case(checks_of, label, part, grads)
            for label in labels}
    # K1/K2 on the pipeline's paths, per train step: pp 4 (m 4, remat),
    # the MoE loss over 2 stages at m 1 (one loss and its gradient),
    # data 2 × pp 2 × model 2 (m 2, remat) and the small f32 models on
    # CUDA ranks; each at its shard shape there (a microbatch; the
    # dp×pp×tp rank's shard is the mesh step's).
    pp_paths = {
        "pp_train_main_path": pp_rec["launches_per_step"],
        "pp_moe_no_drop_loss": pp_rec["moe"]["launches"],
        "pp3d_train_main_path": pp3d_rec["launches_per_step"],
        **{f"small_pipeline/{label}": r["launches_per_step"]
           for label, r in small_pp_rec.items()}}
    for kernel in kernels:
        kname = kernel["name"]
        if not kname.startswith("flash_attention"):
            continue
        kernel["pipeline_launches"] = {
            path: n[kname] for path, n in pp_paths.items() if n.get(kname)}
        if not kernel["pipeline_launches"]:
            raise AssertionError(f"{kname} never launched on a pipeline "
                                 f"path: {pp_paths}")
        checks_of, part, grads, _ = shards[kname]
        kernel["pipeline_shard"] = {
            label: shard_case(checks_of, label, part, grads)
            for label in ("pp-microbatch", "mesh-shard")}
    # K1/K2 on the real-text training path: over the converge phase's
    # resumed run (one launch a layer a step), at a layer's shape there.
    for kernel in kernels:
        kname = kernel["name"]
        if not kname.startswith("flash_attention"):
            continue
        checks_of, part, grads, _ = shards[kname]
        kernel["converge"] = dict(
            shard_case(checks_of, "converge-layer", part, grads),
            launches=converge_rec["launches"][kname],
            launches_per=f"converge run 2 ({converge_rec['run2_steps']} "
                         f"steps of {CONVERGE_LAYERS} layers)")
    # K1, K3 and K4 on the mesh serving paths: over the mesh linear and
    # paged engines' timed passes, per mesh generate call; each at its
    # shard shape there.
    mesh_paths = {
        "mesh_main_path": {
            "flash_decode": mesh_serve_rec["flash_decode_launches"]},
        "mesh_paged_main_path": {"paged_flash_decode":
                                 mesh_paged_rec["paged_flash_decode_launches"]},
        "mesh_generate_main_path": mesh_gen_rec["launches"]}
    for kernel in kernels[:3]:
        kname = kernel["name"]
        kernel["mesh_serving_launches"] = {
            path: n[kname] for path, n in mesh_paths.items() if n.get(kname)}
        if not kernel["mesh_serving_launches"]:
            raise AssertionError(f"{kname} never launched on a mesh serving "
                                 f"path: {mesh_paths}")
        c = mesh_checks[kname]
        kernel["mesh_serving_shard"] = dict(
            shape=c["shape"], ms=c["ms"], plain_ms=c["plain_ms"],
            bound_ms=c["bound_ms"], bound_by=c["bound_by"],
            library_ms=c["library_ms"], max_abs_err=c["max_abs_err"])
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--distributed-worker"]:
        distributed_worker(*sys.argv[2:])
    elif sys.argv[1:2] == ["--time-mesh-step"]:
        time_mesh_step(*sys.argv[2:])
    else:
        main()
