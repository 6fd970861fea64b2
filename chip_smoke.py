#!/usr/bin/env python3
"""Smoke test of the PyTorch port (vlm_clip_tpu_torch) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It runs what neither the card tests nor the benchmark runs. The kernels'
correctness against their plain versions is the card tests' (``python -m
pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
tests/test_torch_decode_graph.py``); the end-to-end rates are the
benchmark's (``h100_bench/``). Each phase raises (exit != 0) on the
failure it names.

setup: prints the card and its power limit, builds the kernels (one nvcc
each), prints ptxas's registers and spills and the HMMA instructions in
the SASS of each tensor-core kernel. Fails without CUDA, or on a
tensor-core kernel with no HMMA instruction.

times: the timing table (:func:`kernel_times`): each kernel at the
shapes its paths give it (bf16 and fp32, batch 96 and 1), beside its
plain version, a library call where one exists and the bound its cost
gives, in turns by CUDA events, then its device time by kernel
(torch.profiler). Fails on a row whose kernel is past its limit against
its plain version (TOL elementwise for a forward, per gradient for a
backward, K7_TOL, check_decode_attn's limit for K8, INT8_TOL), or when
the int8 GEMM's route (``KERNEL_MAX_M_INT8``) takes rows where the
kernel lost to the materialize route.

train: cli/train_m trains one epoch of ViT-B/16 on a synthetic RAF-DB
tree and its checkpoints load back; bench.py's step runs with the kernels
and with impl="torch" from the same state, without and with the K4 head.
Fails on a non-finite loss or weight, steps apart by more than STEP_TOL,
a plain step that launched a kernel, or a kernel of the path that never
launched.

data_parallel: cli/train_m --zero1 under NCCL at world 1 and in one
process must write the same adapter files; bench.py's step through the
DP + ZeRO-1 route must equal the plain step bit for bit (both timed in
turns). Fails on a difference or on K1-K3 not launching under NCCL.

pipeline_t: cli/compare_t at ViT-L/14 with K5 on; one T step with the
kernels against impl="torch"; image features and the prompt bank with K5
on against off; cli/predict_image with a T checkpoint. Fails on bad
losses or accuracies, a disagreement, or a kernel that never launched.

pipeline_v: cli/main_v, cli/build_context_cache and serve in v-context
mode at ViT-L/14; V's eval logits, two V steps and the served
probabilities against impl="torch". Fails on a disagreement, a wrong
cache or mode, or K6 not launching.

serve: cli/serve in-process (ViT-B/16, M adapters) answers /embed,
/embed_text and /classify, held to impl="torch"; a second server in
t-adapter mode. Fails on a bad response, a disagreement, a kernel that
never launched, or a plain path that launched one.

real_weights_emotic: an HF-layout checkpoint (pytorch_model.bin, and
model.safetensors by this script's writer) loads bit for bit; cli/smoke,
cli/serve --hf-checkpoint, cli/train_emotic and cli/validate_parity's
card legs run on it, each held to impl="torch" or the in-process path.
Fails on a difference, a non-finite result or a kernel that never
launched.

data_paths: the native JPEG decoder's rate beside PIL's; BASELINE config
5 through cli/bench_label_finetune (its launches as C5_CALLS predicts,
one step held to impl="torch" twice); a full train-state resume bit for
bit; config 4's video scorer with K5 on and off and the uint8 folded
tower. Fails on a launch count, a disagreement or a resume that differs.

vlm: cli/check_decode_attn; Qwen2.5-VL-3B at full width under 8h4 (and
the mixed preset, an int8 cache) generates for 8 images with K8 off and
on and through impl="torch"; logits and first tokens held (VLM_TOL),
launches counted; a decode step's profile. Fails on a disagreement or a
launch count.

nf4: the NF4 quantizer on the card against the CPU's, its matmul routes
against float64, both NF4 presets generate. Fails on a disagreement or a
launch count.

vlm_engine: the continuous-batching engine on the vlm phase's model:
launch counts, logits against the fixed batch and the plain versions,
speculative and int8-cache loads, a chunk with a cancelled row under
sync_debug_mode("error"), cli/serve_vlm over HTTP, the engine's benches
and cli/bench_decode, shortened. Fails on any of these.

model_parallel: NCCL at world 1 (the engine's mesh, PipelineGenerator,
the sharded video scorer) against the unsharded paths; the
tensor-parallel layers across four gloo processes on the card; K7, K8
and K5 on each rank's shard against the plain versions and recombined.
Fails on a disagreement or a launch count.

The last two lines: ``{"kernels": [...]}`` (each kernel's times, bound
and shapes from the table, its launches on its main path and, as
``launches_serve``, ``launches_v``, ``launches_emotic``, ``launches_c5``,
``launches_dp``, ``launches_nf4``, ``launches_engine`` and
``launches_mp``, on the other paths it ran) and ``{"ok": true, "device":
{...}}``.

``python3 chip_smoke.py --int8`` runs the int8 GEMM's rows of the table
alone and prints its entry. ``python3 chip_smoke.py --times <checkout>``
runs the table's K4, K6 and K5 rows on the package at <checkout>, to
compare two checkouts in turns in one call.
``python3 chip_smoke.py --tp-layer-rank`` is one rank of the
model_parallel phase's layer check (:func:`tp_layer_rank`).
"""

from __future__ import annotations

import contextlib
import gc
import http.client
import io
import json
import os
import subprocess
import sys
import threading
import time

from typing import Callable, NamedTuple

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
B = 96  # the bench batch of the pipeline-M train step
# |got - want| <= ATOL + RTOL * |want|, elementwise, kernel vs plain.
# bf16: both sides round the same operands to bf16 and differ only in
# fp32 summation order, which can flip a rounding: about 2 bf16 ulps.
# fp32: summation order alone, over at most 2048 terms.
TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-4, 1e-4)}
EMBED_ATOL = 5e-3  # unit-norm features, served kernel path vs plain path
# The train step, kernels vs plain versions from the same state (bf16
# towers under FAST; the kernels and the plain versions differ by bf16
# rounding flips, which the backward carries into every gradient): loss
# and grad norm within 1e-2 relative, each adapter gradient within 5e-2
# relative in Frobenius norm (relative to at least 1e-2 of the global
# gradient norm).
STEP_TOL = {"loss": 1e-2, "grad_norm": 1e-2, "grad": 5e-2}
# Pipeline T's step, kernels vs plain versions from the same state: the
# features and K6 are fp32, so only summation order separates them: the
# loss within 1e-5 relative, each adapter gradient within 1e-4 relative in
# Frobenius norm.
T_STEP_TOL = {"loss": 1e-5, "grad": 1e-4}
# ViT-L/14 under the BF16 policy with K5 on against off: both run fp32
# softmax over the same bf16 operands, and a bf16 rounding flip in one of
# the 24 layers carries into the pooled feature: unit-norm features
# within 5e-2 elementwise and a cosine of at least 0.995 row by row.
ENCODE_TOL = {"max_abs": 5e-2, "cosine": 0.995}
CLASSIFY_ATOL = 1e-3  # t-adapter /classify, kernel path vs plain path
# Pipeline V's eval logits, kernels vs plain versions from the same
# state: fp32 features and fp32 K6 math, only summation order between
# them, times exp(logit_scale) (14.3 at the init): 1e-4 absolute.
V_LOGIT_ATOL = 1e-4
# K7 against its plain version: both unpack the same nibbles exactly and
# sum 2048 fp32 products in another order: |got - want| <= 1e-4 + 1e-4 *
# |want| elementwise, in bf16 and fp32 x alike (the output is fp32).
K7_TOL = (1e-4, 1e-4)
# Qwen2.5-VL-3B (8h4, bf16), kernels against the plain versions from the
# same weights: the prefill differs only in K7's fp32 summation order:
# max |diff| <= 1e-4 x max |logit|; the first decode step with K8 on
# against off carries K8's bf16 rounding of p through 36 bf16 layers:
# max |diff| <= 5e-2 x max |logit|, and with K8 off against the plain
# versions 1e-4 again. Every row's first token must agree.
# The int8 GEMM on against off (its twin) at step 1, K8 off: its bf16
# outputs differ from the twin's by a rounding flip where their fp32 sums
# (in another order) straddle a bf16 boundary, carried through 36 bf16
# layers as K8's rounding of p is: K8's limit. The K7 checks hold the
# int8 route the same on both sides.
VLM_TOL = {"k7": 1e-4, "k8": 5e-2, "int8": 5e-2}
VLM_NEW = 32  # tokens generated per row in the VLM phase
# The engine phase (vlm/engine.py, the vlm phase's model): the reference
# engine's defaults (32 slots, 16 steps a chunk) on 48 requests whose
# budgets are drawn from 8-64 by seed; its first logits are held to the
# fixed-batch path and to the plain versions with the vlm phase's
# tolerances (VLM_TOL).
ENGINE_SLOTS, ENGINE_SYNC, ENGINE_REQUESTS = 32, 16, 48
ENGINE_BUDGETS = (8, 64)
_VLM: dict = {}  # the vlm phase's model, kept for the nf4 and vlm_engine
# phases
FUSED = "vlm_clip_tpu_torch/csrc/fused_adapter.cu"
QUANT = "vlm_clip_tpu_torch/csrc/quant.cu"
# The {"kernels"} line's entries, in its order: each kernel's source and
# the TPU kernel it replaces.
KERNELS = {
    "seq_adapter_fused": (FUSED, "vlm_clip_tpu/ops/fused_adapter.py:310"),
    "cross_attn_block_fused": (FUSED,
                               "vlm_clip_tpu/ops/fused_adapter.py:796"),
    "prenorm_mlp_fused": (FUSED, "vlm_clip_tpu/ops/fused_adapter.py:532"),
    "seq_adapter_bwd_cuda": (FUSED, "vlm_clip_tpu/ops/fused_adapter.py:328"),
    "cross_attn_block_bwd_cuda": (FUSED,
                                  "vlm_clip_tpu/ops/fused_adapter.py:807"),
    "prenorm_mlp_bwd_cuda": (FUSED, "vlm_clip_tpu/ops/fused_adapter.py:550"),
    "contrastive_loss_fused": ("vlm_clip_tpu_torch/csrc/contrastive.cu",
                               "vlm_clip_tpu/ops/contrastive.py:52"),
    "contrastive_loss_bwd_cuda": ("vlm_clip_tpu_torch/csrc/contrastive.cu",
                                  "vlm_clip_tpu/ops/contrastive.py:68"),
    "feature_adapter_blend_fused": (FUSED,
                                    "vlm_clip_tpu/ops/fused_adapter.py:109"),
    "feature_adapter_blend_bwd_cuda": (
        FUSED, "vlm_clip_tpu/ops/fused_adapter.py:127"),
    "fused_attention": ("vlm_clip_tpu_torch/csrc/attention.cu",
                        "vlm_clip_tpu/ops/attention.py:59"),
    "quant_matmul_int4": (QUANT, "vlm_clip_tpu/ops/quant.py:233"),
    "decode_attention_kernel": ("vlm_clip_tpu_torch/csrc/decode_attention.cu",
                                "vlm_clip_tpu/ops/decode_attention.py:130"),
    # no Pallas kernel: XLA's int8 dequantize fused into the dot's operand
    "quant_matmul_int8": (QUANT, "none (XLA's fused int8 dequant-dot, "
                                 "vlm_clip_tpu/ops/quant.py:225-230)"),
}
# The int8 GEMM at the 8h4 text linears of Qwen2.5-VL-3B (K, N, bias): a
# decode forward makes 36 calls of each. Against its plain twin: fp32
# sums of the same bf16-valued operands, bf16 out cast once from them
# (a rounding flip at most: 2e-2 of |want| + 2e-2).
INT8_SHAPES = {"qkv": (2048, 2560, True), "o": (2048, 2048, False),
               "gateup": (2048, 22016, False), "down": (11008, 2048, False)}
INT8_TOL = 2e-2
# H100 SXM peaks (NVIDIA data sheet, dense): the least time a kernel
# could take is the larger of its bytes over the memory rate and its
# operations over the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
# The kernels on the tensor cores, by wrapper (in bf16: K5, K3 and K2
# forward and backward, the bf16 x bf16 weight gradients and K8; K1
# forward's and backward's error-compensated TF32 products and the fp32
# weight gradients, HMMA.1684.F32.TF32; K7's int4 product in bf16; the
# LayerNorm row kernels among their passes do no product): setup() counts each
# one's HMMA instructions in the built library's SASS and fails on a
# kernel with none.
K8_BF16_SASS = "decode_attention_kernelI13__nv_bfloat16"
KERNEL_HMMA = {
    "seq_adapter_fused": ("seqfwd_pre_kernel", "seqfwd_z_kernel"),
    "seq_adapter_bwd_cuda": ("seqbwd_pre_kernel", "seqbwd_z_kernel",
                             "seqbwd_dpre_kernel", "seqbwd_dx_kernel",
                             "wgrad_tf32_kernel"),
    "quant_matmul_int4": ("qmm4_mma_kernel",),
    "quant_matmul_int8": ("qmm8_mma_kernel",),
    "fused_attention": ("attention_mma_kernel",),
    "prenorm_mlp_fused": ("pnmlp_fwd_hidden_kernel", "pnmlp_fwd_out_kernel"),
    "prenorm_mlp_bwd_cuda": ("pnmlp_bwd_hidden_kernel",
                             "pnmlp_bwd_du_kernel", "wgrad_mma_kernel"),
    "cross_attn_block_bwd_cuda": (
        "cab_bwd_t_kernel", "cab_bwd_q_kernel", "cab_bwd_dom_kernel",
        "cab_bwd_attn_kernel", "cab_bwd_du_kernel", "cab_bwd_dx_kernel",
        "wgrad_mma_kernel"),
    "cross_attn_block_fused": ("cab_fwd_t_kernel", "cab_fwd_q_kernel",
                               "cab_fwd_attn_kernel", "cab_fwd_out_kernel"),
    # K8's bf16-q instantiations (bf16 and int8 cache), by their mangled
    # names; its fp32 ones run on the CUDA cores
    "decode_attention_kernel": (K8_BF16_SASS,),
}
TENSOR_CORE_KERNELS = sorted({k for ks in KERNEL_HMMA.values() for k in ks})
HMMA: dict = {}  # kernel -> HMMA instructions in its SASS
PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}


def bound(flops: float, nbytes: float, kind: str):
    """(bound_ms, bound_by) for one call."""
    t_ops, t_mem = flops / PEAK_FLOPS[kind], nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem
                                     else "bytes")


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def setup(root: str = REPO) -> str:
    """Refuse without CUDA, print the card, build and load the kernels of
    the package at root (this checkout unless another one is compared)."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    print(card(), flush=True)
    sys.path.insert(0, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vlm_clip_tpu_torch.ops import attention as K5
    from vlm_clip_tpu_torch.ops import build, fused_adapter as F

    t0 = time.time()
    build.load_libraries(["fused_adapter", "contrastive", "attention",
                          "quant", "decode_attention"])
    F._lib()
    K5._lib()
    print(f"built kernels in {time.time() - t0:.1f}s (nvcc each: "
          f"{ {k: round(v, 1) for k, v in build.build_seconds.items()} })",
          flush=True)
    for name, log in build.build_logs.items():
        regs, spills, fn = [], [], "?"
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                fn = ln.split("'")[1] if "'" in ln else ln.strip()
            elif "Used" in ln:
                regs.append(ln.split("Used")[1].split(",")[0].strip())
            elif "spill" in ln and not ln.strip().startswith("0 bytes"):
                spills.append(f"{fn}: {ln.strip()}")
        print(f"  ptxas {name}: registers {regs}; spills {spills or 'none'}",
              flush=True)
    for name in ("attention", "fused_adapter", "quant", "decode_attention"):
        HMMA.update(hmma_counts(build._out_path(name)))
    for fn, count in sorted(HMMA.items()):
        print(f"  SASS HMMA {fn}: {count}", flush=True)
    missing = [fn for fn in TENSOR_CORE_KERNELS if not HMMA.get(fn)]
    if missing:
        raise SystemExit(f"no HMMA instruction in the SASS of {missing}: "
                         "these kernels must run on the tensor cores")
    return torch.cuda.get_device_name(0)


def hmma_counts(lib: str) -> dict:
    """{kernel name: HMMA instructions in its SASS} of a built library
    (cuobjdump -sass), kernels with none left out."""
    from vlm_clip_tpu_torch.ops.build import find_nvcc

    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = next((k for k in TENSOR_CORE_KERNELS if k in line),
                      line.split("Function :")[1].strip())
        elif fn is not None and "HMMA" in line:
            counts[fn] = counts.get(fn, 0) + 1
    return counts


def _timed(fn, iters: int = 10) -> float:
    """fn's ms a call on the card by CUDA events around iters calls."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _profiled(fn, n: int = 5) -> dict:
    """{kernel: [device ms, launches] a call} by torch.profiler over n calls
    of fn after one more. The profiler has dropped launches' records (a
    whole short trace; a cluster kernel's beside its neighbours): each
    trace opens with a launch of the spin kernel (``torch.cuda._sleep``),
    whose record is left out, and an empty trace is taken again, up to
    five times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    per = {}
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA \
                    and "spin_kernel" not in e.name:
                d = per.setdefault(e.name, [0.0, 0.0])
                d[0] += e.time_range.elapsed_us() / 1e3 / n
                d[1] += 1 / n
        if per:
            break
    return per


# ---------------------------------------------------------------------------
# The timing table (phase times; --int8 runs its int8 rows alone, --times
# its K4, K6 and K5 rows)
# ---------------------------------------------------------------------------

class Row(NamedTuple):
    """One row of the timing table. kern, plain and library (or None) are
    calls of no argument, each making `calls` calls of its op (the int8
    GEMM's: a CUDA graph over a ring of weights, as a decode forward reads
    them); work is (operations, bytes, peak kind) of one call; check(the
    kernel's output, the plain one's) is their error over its limit, and a
    row past 1 fails the table. An entry row adds its times, bound and
    shape to its kernel's entry of the {"kernels"} line (the shapes of
    PERF.md's kernel table); every row adds its largest error there."""
    name: str
    entry: bool
    shape: str
    kern: Callable
    plain: Callable
    library: Callable | None
    work: tuple
    check: Callable
    calls: int = 1
    iters: int = 10


def _dt(dtype) -> str:
    return {torch.bfloat16: "bf16", torch.float32: "fp32"}[dtype]


def _worst(ratios) -> float:
    """The largest of ratios; inf if one is NaN (a non-finite output)."""
    ratios = list(ratios)
    return float("inf") if any(r != r for r in ratios) \
        else max(ratios, default=0.0)


def _leaves(out) -> list:
    """The tensors of a call's output (a tensor, or tuples and lists of
    tensors and Nones), Nones kept."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    return [out]


def _elementwise(atol: float, rtol: float):
    """check: max |got - want| / (atol + rtol |want|) over every element."""
    def check(got, want):
        return _worst(
            float(((g.float() - w.float()).abs()
                   / (atol + rtol * w.float().abs())).max())
            for g, w in zip(_leaves(got), _leaves(want), strict=True))
    return check


def _per_grad(dtype, fp32_from=None):
    """check, per gradient: max |got - want| / (tol x max(max |want|,
    1e-2)); tol is dtype's TOL, or fp32's for the gradients from index
    fp32_from on (K1's function is fp32 in both dtypes). A gradient that
    was not asked for, or is missing, fails."""
    def check(got, want):
        ratios = []
        for i, (g, w) in enumerate(zip(_leaves(got), _leaves(want),
                                       strict=True)):
            if g is None or w is None:
                ratios.append(0.0 if g is w else float("inf"))
                continue
            tol = TOL[torch.float32 if fp32_from is not None
                      and i >= fp32_from else dtype][0]
            ratios.append(float((g.float() - w.float()).abs().max())
                          / (tol * max(float(w.float().abs().max()), 1e-2)))
        return _worst(ratios)
    return check


def cost(name: str, x: torch.Tensor, need_dx: bool = True,
         fp32_yardstick: bool = False, hidden: int = 512):
    """(operations, bytes, peak kind) of one call of K1-K4 at x's shape
    on the pipeline-M widths: each product counts 2*m*n*k; each input is
    read once and each output written once (params and their fp32
    gradients at 4 bytes, x, g, dx and k, v in x's type). K1 counts the
    TF32 tensor-core passes it runs, forward and backward (fp32_yardstick,
    or widths off those passes: its fp32 products at the CUDA cores' peak,
    the yardstick of its first version). K2's hidden width: ``hidden``."""
    from vlm_clip_tpu_torch.ops.fused_adapter import seq_adapter_tensor_cores

    N, D = x.shape
    es = x.element_size()
    mm = "bf16" if x.dtype == torch.bfloat16 else "fp32"
    K, Tk, H = 256, 197, hidden
    if name in ("seq_adapter_fused", "seq_adapter_bwd_cuda"):
        params = (2 * D * K + K + 3 * D) * 4
        fwd = name == "seq_adapter_fused"
        nbytes = 2 * N * D * es + params if fwd else \
            (3 if need_dx else 2) * N * D * es + 2 * params
        if fp32_yardstick or not seq_adapter_tensor_cores(D, K):
            products = 2 if fwd else (6 if need_dx else 5)
            return 2 * N * D * K * products, nbytes, "fp32"
        # the error-compensated TF32 products it runs: 3 passes each, 2
        # for x W1 and x^T dpre when x is bf16 (exact in TF32)
        x_passes = 2 if x.dtype == torch.bfloat16 else 3
        passes = x_passes + 3 if fwd else \
            2 * x_passes + 3 * (3 if need_dx else 2)
        return 2 * N * D * K * passes, nbytes, "tf32"
    if name in ("prenorm_mlp_fused", "prenorm_mlp_bwd_cuda"):
        K = 4 * D
        params = (2 * D * K + K + 3 * D) * 4
        if name == "prenorm_mlp_fused":
            return 4 * N * D * K, 2 * N * D * es + params, mm
        return 10 * N * D * K, 3 * N * D * es + 2 * params, mm
    if name in ("cross_attn_block_fused", "cross_attn_block_bwd_cuda"):
        params = (D * H + 2 * H * H + 5 * H) * 4
        kv = 2 * Tk * H * es
        if name == "cross_attn_block_fused":
            return (2 * N * (D * H + 2 * H * H + 2 * Tk * H),
                    N * D * es + N * H * es + params + kv, mm)
        return (2 * N * (3 * D * H + 5 * H * H + 6 * Tk * H),
                2 * N * D * es + N * H * es + 2 * params + kv
                + 2 * Tk * H * 4, mm)
    if name == "contrastive_loss_fused":
        return 2 * N * N * D, 2 * N * D * es + 8, "fp32"
    if name == "contrastive_loss_bwd_cuda":
        return 6 * N * N * D, 4 * N * D * es + 12, "fp32"
    raise KeyError(name)


def t_cost(name: str, x: torch.Tensor, k: int = 64, mask=None,
           need_dx: bool = True):
    """(operations, bytes, peak kind) of one call of K5 or K6: each
    product counts 2*m*n*k; each input is read once and each output
    written once. K6 ([N, D] x, fp32 math): params and their gradients at
    4 bytes. K5 ([B, h, T, d] q, k, v): the scores and p v, the fp32 mask
    as it is stored (a batch-broadcast one once)."""
    es = x.element_size()
    if name == "fused_attention":
        Bq, h, T, d = x.shape
        mbytes = 0 if mask is None else mask.numel() * 4
        return (4 * Bq * h * T * T * d, 4 * x.numel() * es + mbytes,
                "bf16" if x.dtype == torch.bfloat16 else "fp32")
    N, D = x.shape
    params = (2 * D * k + k + D) * 4
    if name == "feature_adapter_blend_fused":
        return 4 * N * D * k, 2 * N * D * es + params, "fp32"
    return (2 * N * D * k * (6 if need_dx else 5),
            (3 if need_dx else 2) * N * D * es + 2 * params, "fp32")


def k7_cost(M: int, K: int, N: int, es: int):
    """(operations, bytes, peak kind) of one K7 call: 2*M*K*N FLOP at the
    peak of x's type (bf16 x: the nibbles are exact in bf16, so a bf16
    tensor-core product with fp32 sums computes the same function); the
    logical packed bytes, x, scale and the fp32 output each once."""
    return (2 * M * K * N, K // 2 * N + M * K * es + 4 * N + 4 * M * N,
            "bf16" if es == 2 else "fp32")


def k8_cost(case):
    """(operations, bytes, peak kind) of one K8 call on these inputs: the
    cache rows below each row's depth (and their scales) once, q, the
    fresh rows and the output once; 4 d FLOP per (query head, attended
    column) at the peak of q's type (an int8 cache widens exactly)."""
    q, k_old, _, k_cur, _, depths, k_scale, _ = case
    B, T, h, d = q.shape
    kv = k_old.shape[2]
    cols = int(depths.sum())
    nbytes = 2 * cols * kv * d * k_old.element_size() \
        + (2 * cols * kv * 4 if k_scale is not None else 0) \
        + 2 * q.numel() * q.element_size() \
        + 2 * k_cur.numel() * q.element_size()
    flops = 4 * h * T * d * (cols + B * T)
    return flops, nbytes, "bf16" if q.dtype == torch.bfloat16 else "fp32"


def int8_cost(M: int, K: int, N: int, bias: bool):
    """(operations, bytes, peak kind) of one int8 GEMM call: 2*M*K*N at the
    bf16 peak; the int8 weight, its scale (and bias), x and the bf16
    output once each."""
    return (2 * M * K * N,
            K * N + 4 * N * (2 if bias else 1) + 2 * M * K + 2 * M * N,
            "bf16")


def _k8_library(case, depth: int):
    """SDPA on K8's inputs (a bf16 cache, every row at ``depth``): the
    cache's columns below the depth and the fresh rows' causal triangle,
    grouped heads; the library yardstick, used nowhere in the port."""
    import torch.nn.functional as TF

    q, k_old, v_old, k_cur, v_cur = case[:5]
    b, T = q.shape[:2]
    S = k_old.shape[1]
    qh = q.transpose(1, 2)                                   # [B, h, T, d]
    kf = torch.cat([k_old, k_cur], 1).transpose(1, 2)
    vf = torch.cat([v_old, v_cur], 1).transpose(1, 2)
    cols = torch.arange(S + T, device=q.device)
    rows = torch.arange(T, device=q.device)
    allowed = (cols[None] < depth) | (
        (cols[None] >= S) & (cols[None] - S <= rows[:, None]))
    amask = allowed[None, None].expand(b, 1, T, S + T)
    return lambda: TF.scaled_dot_product_attention(
        qh, kf, vf, attn_mask=amask, enable_gqa=True)


def _materialize(x, q):
    """The parent's route for an int8 linear (the library yardstick, no
    longer on the port's decode path): dequantize to fp32, cast to x's
    dtype, torch.matmul, the bias added in fp32, one more cast."""
    from vlm_clip_tpu_torch.ops import quant as K7

    y = torch.matmul(x, K7.dequantize_weight(q).to(x.dtype))
    if q.bias is not None:
        y = y.float() + q.bias.float()
    return y.to(x.dtype)


def _graph(fns):
    """One pass over fns captured as one CUDA graph (the decode step's
    launch path); the returned call replays it and returns fns' outputs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for fn in fns]

    def replay():
        graph.replay()
        return outs
    return replay


def _time_row(results: dict, row: Row, failures: list,
              label: str = "time"):
    """One row of the table: the kernel against its plain version (the
    row's check), then CUDA-event turns plain, kernel, kernel, plain (and
    the library call twice after a first call), then the kernel's device
    time and launches by kernel (and the library's) from one profile.
    Prints them with the bound; returns (kernel, plain, library or None)
    ms a call."""
    with torch.no_grad():
        got, want = row.kern(), row.plain()
        ratio = row.check(got, want)
        err = _worst(float((g.float() - w.float()).abs().max())
                     for g, w in zip(_leaves(got), _leaves(want))
                     if g is not None and w is not None)
        del got, want
        ms = {"kernel": 0.0, "plain": 0.0}
        for side, fn in (("plain", row.plain), ("kernel", row.kern),
                         ("kernel", row.kern), ("plain", row.plain)):
            ms[side] += _timed(fn, row.iters) / 2 / row.calls
        if row.library is not None:
            row.library()  # its first call at a shape picks a backend
            ms["library"] = sum(_timed(row.library, row.iters)
                                for _ in range(2)) / 2 / row.calls
        per = _profiled(row.kern)
        lib_per = None if row.library is None else _profiled(row.library)
    ok = ratio <= 1.0
    if not ok:
        failures.append(f"{row.name} {row.shape}")
    device = sum(v[0] for v in per.values()) / row.calls
    launches = sum(v[1] for v in per.values()) / row.calls
    by_kernel = {n[:48]: round(v[0] / row.calls, 5) for n, v in per.items()}
    b_ms, b_by = bound(*row.work)
    lib = ""
    if lib_per is not None:
        lib = (f", library {ms['library']:.4f} ms (device "
               f"{sum(v[0] for v in lib_per.values()) / row.calls:.4f} ms: "
               f"{sorted(n[:48] for n in lib_per)})")
    print(f"{label} {row.name} {row.shape}: kernel {ms['kernel']:.4f} ms "
          f"(device {device:.4f} ms, {launches:g} launches a call: "
          f"{by_kernel}), plain {ms['plain']:.4f} ms{lib}, bound "
          f"{b_ms:.5f} ms ({b_by}); max |kernel - plain| {err:.3e}, "
          f"err/limit {ratio:.3f} {'ok' if ok else 'FAIL'}", flush=True)
    r = results.setdefault(row.name, {
        "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
        "bound_by": "", "shapes": [], "library_ms": None})
    r["max_abs_err"] = _worst([r["max_abs_err"], err])
    if row.entry:
        r["ms"] += ms["kernel"]
        r["plain_ms"] += ms["plain"]
        if b_ms >= r.get("_largest", 0.0):
            r["_largest"], r["bound_by"] = b_ms, b_by
        r["bound_ms"] += b_ms
        r["shapes"].append(row.shape)
        if row.library is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + ms["library"]
    return ms["kernel"], ms["plain"], ms.get("library")


def _m_rows():
    """K1-K4 at bench.py's B=96 shapes (ViT-B/16, adapters 256/256/2, 8
    heads, a 197-row pseudo-image; K1's vision rows without dx, as the
    frozen towers need none) in bf16, the table's entries, and in fp32;
    K1-K3's forwards at batch 1 (a served request's shapes) in both;
    K3 backward's bf16 weight-gradient route alone; then K1 and K3 at
    config 5's shapes (ViT-L/14-336, B=32), K3 in fp32 too."""
    from vlm_clip_tpu_torch.core.config import AdapterConfig, clip_preset
    from vlm_clip_tpu_torch.models import adapters as A
    from vlm_clip_tpu_torch.models.layers import layer_slice
    from vlm_clip_tpu_torch.models.model_m import init_m_adapters
    from vlm_clip_tpu_torch.ops import contrastive as K4
    from vlm_clip_tpu_torch.ops import fused_adapter as F

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def seq_args(p):
        return (p["down"]["kernel"], p["down"]["bias"], p["up"]["kernel"],
                p["up"]["bias"], p["ln"]["scale"], p["ln"]["bias"])

    def mlp_args(shared):
        mp = shared["mlp"]
        return (mp["fc1"]["kernel"], mp["fc1"]["bias"], mp["fc2"]["kernel"],
                mp["fc2"]["bias"], shared["norm3"]["scale"],
                shared["norm3"]["bias"])

    def rows(stem, tag, x, args, need_dx, entry, extra=(), bwd=True,
             hidden=512):
        """The forward (and backward) rows of K1, K2 or K3 (``stem``) at
        x; extra follows the gradient (K2's heads, K2's hidden width
        ``hidden``)."""
        shape = f"{tag} {list(x.shape)} {_dt(x.dtype)}"
        fwd = f"{stem}_fused"
        yield Row(fwd, entry, shape,
                  lambda: getattr(F, fwd)(x, *args, *extra),
                  lambda: getattr(F, f"{stem}_torch")(x, *args, *extra),
                  None, cost(fwd, x, hidden=hidden),
                  _elementwise(*TOL[x.dtype]))
        if stem == "seq_adapter":
            print(f"bound of {fwd} {shape}: its fp32 products at the CUDA "
                  f"cores' peak {bound(*cost(fwd, x, fp32_yardstick=True))[0]:.4f}"
                  f" ms (the yardstick)", flush=True)
        if not bwd:
            return
        g = torch.randn(x.shape, generator=gen, device=dev).to(x.dtype)
        name, call = f"{stem}_bwd_cuda", (*args, g, *extra)
        yield Row(name, entry, shape + ("" if need_dx else " no dx"),
                  lambda: getattr(F, name)(x, *call, need_dx=need_dx),
                  lambda: getattr(F, f"{stem}_bwd_torch")(x, *call,
                                                          need_dx=need_dx),
                  None, cost(name, x, need_dx, hidden=hidden),
                  _per_grad(x.dtype, 1 if stem == "seq_adapter" else None))
        if stem == "seq_adapter":
            print(f"bound of {name} {shape}: its fp32 products at the CUDA "
                  f"cores' peak "
                  f"{bound(*cost(name, x, need_dx, True))[0]:.4f} ms (the "
                  f"yardstick)", flush=True)

    cfg = clip_preset("vit-base-patch16")
    ad = init_m_adapters(gen, cfg, AdapterConfig(), device=dev)
    for leaf in (ad["text_adapter"]["down"]["bias"],
                 ad["vision_adapter"]["down"]["bias"]):
        leaf.normal_(generator=gen).mul_(0.1)
    shared = layer_slice(ad["shared_adapters"], 0)
    heads = (AdapterConfig().shared_num_heads,)
    Tt, Tv = cfg.text.max_positions, cfg.vision.seq_len
    Ht, Hv = cfg.text.hidden_size, cfg.vision.hidden_size
    text = {n: torch.randn(n * Tt, Ht, generator=gen, device=dev)
            for n in (B, 1)}
    vis = {n: torch.randn(n * Tv, Hv, generator=gen, device=dev)
           for n in (B, 1)}
    # the pseudo-image: a [1, 197, 768] table at the position table's scale
    pseudo = torch.randn(1, Tv, Hv, generator=gen, device=dev) * Hv ** -0.5
    feats = [torch.randn(B, cfg.projection_dim, generator=gen, device=dev)
             for _ in range(2)]
    ls = torch.tensor(cfg.logit_scale_init, device=dev)
    one = torch.ones((), device=dev)
    for dtype in (bf, torch.float32):
        entry = dtype == bf
        k, v = A.shared_kv(shared, pseudo.to(dtype))
        ap = shared["attn"]
        cab = (shared["text_proj"]["kernel"], shared["text_proj"]["bias"],
               shared["norm2"]["scale"], shared["norm2"]["bias"],
               ap["q"]["kernel"], ap["q"]["bias"], k, v, ap["out"]["kernel"],
               ap["out"]["bias"])
        for n in (B, 1):  # batch 1: the forwards alone
            xt, xv = text[n].to(dtype), vis[n].to(dtype)
            full = n == B
            tag = "" if full else "batch 1 "
            yield from rows("seq_adapter", f"{tag}text", xt,
                            seq_args(ad["text_adapter"]), True,
                            entry and full, bwd=full)
            yield from rows("seq_adapter", f"{tag}vision", xv,
                            seq_args(ad["vision_adapter"]), False,
                            entry and full, bwd=full)
            yield from rows("cross_attn_block", f"{tag}text", xt, cab, True,
                            entry and full, heads, bwd=full)
            yield from rows("prenorm_mlp", f"{tag}text", xt,
                            mlp_args(shared), True, entry and full, bwd=full)
        # K4 on the step's [96, 512] features, fp32 math
        t, m = (f.to(dtype) for f in feats)
        yield Row("contrastive_loss_fused", entry,
                  f"loss {list(t.shape)} {_dt(dtype)}",
                  lambda: K4.contrastive_loss_fused(t, m, ls),
                  lambda: K4.contrastive_loss_torch(t, m, ls), None,
                  cost("contrastive_loss_fused", t),
                  _per_grad(torch.float32))
        yield Row("contrastive_loss_bwd_cuda", entry,
                  f"grads {list(t.shape)} {_dt(dtype)}",
                  lambda: K4.contrastive_loss_bwd_cuda(t, m, ls, one),
                  lambda: K4.contrastive_loss_bwd_torch(t, m, ls, one), None,
                  cost("contrastive_loss_bwd_cuda", t), _per_grad(dtype))

    # K3 backward's bf16 x bf16 weight gradients alone at the B=96 text
    # rows (dW1 = um^T dpm, dW2 = dpm^T g), fp32 sums on both sides
    N, H = B * Tt, Ht
    K = 4 * H
    um, g = (torch.randn(N, H, generator=gen, device=dev).to(bf)
             for _ in range(2))
    dpm = torch.randn(N, K, generator=gen, device=dev).to(bf)
    dw1 = torch.empty(H, K, device=dev)
    dw2 = torch.empty(K, H, device=dev)

    def route():
        F._wgrad(um, dpm, dw1, H, K)
        F._wgrad(dpm, g, dw2, K, H)
        return dw1, dw2

    yield Row("prenorm_mlp_bwd_cuda", False,
              f"its bf16 weight-gradient route alone (dW1 + dW2) at N={N}, "
              f"H={H}, K={K}", route,
              lambda: (um.float().t() @ dpm.float(),
                       dpm.float().t() @ g.float()), None,
              (4 * N * H * K, 2 * (N * H + N * K) * 2 + 2 * H * K * 4,
               "bf16"), _per_grad(torch.float32))

    # K2 at ViT-L/14's widths: 8 heads of 96 (text 768, image 1024)
    # against a 197-row pseudo-image, 8 captions; backward without dx
    p = A.init_cross_modal_adapter(gen, text_dim=768, image_dim=1024,
                                   hidden=768, device=dev)
    image = (torch.randn(1, Tv, 1024, generator=gen, device=dev)
             * 1024 ** -0.5).to(bf)
    k, v = A.shared_kv(p, image)
    ap = p["attn"]
    cab = (p["text_proj"]["kernel"], p["text_proj"]["bias"],
           p["norm2"]["scale"], p["norm2"]["bias"], ap["q"]["kernel"],
           ap["q"]["bias"], k, v, ap["out"]["kernel"], ap["out"]["bias"])
    x = torch.randn(8 * Tt, 768, generator=gen, device=dev).to(bf)
    yield from rows("cross_attn_block", "ViT-L/14 widths, heads of 96, text",
                    x, cab, False, False, heads, hidden=768)

    # config 5: text [32*77, 768], vision [32*577, 1024], K3 at 768
    cfg = clip_preset("vit-large-patch14-336")
    ad = init_m_adapters(gen, cfg, AdapterConfig(), device=dev)
    text = torch.randn(C5_B * cfg.text.max_positions, cfg.text.hidden_size,
                       generator=gen, device=dev).to(bf)
    vis = torch.randn(C5_B * cfg.vision.seq_len, cfg.vision.hidden_size,
                      generator=gen, device=dev).to(bf)
    shared = layer_slice(ad["shared_adapters"], 0)
    for stem, tag, x, args, need_dx in (
            ("seq_adapter", "text", text, seq_args(ad["text_adapter"]), True),
            ("seq_adapter", "vision", vis, seq_args(ad["vision_adapter"]),
             False),
            ("prenorm_mlp", "text", text, mlp_args(shared), True),
            ("prenorm_mlp", "text", text.float(), mlp_args(shared), True)):
        yield from rows(stem, f"config 5 {tag}", x, args, need_dx, False)


def _t_rows():
    """K6 at pipeline T's three calls (32 image features, 7 class means,
    35 descriptions; D 768, K 64; backward without dx) in fp32, the
    table's entries, and in bf16; K6 at EMOTIC's head ([32, 512], K 192)
    and at D 4100, K 1100 (35 rows, dropout 0.1). K5 (SDPA beside it) at
    pipeline T's ViT-L/14 encodes in bf16 (32 images; 35 descriptions
    with their padding mask), the table's entries, at those with the
    broadcast mask and at ViT-B/16's towers (96 images, 96 captions), in
    bf16 and fp32; K5 at heads of 256, 272 and 512 columns (the CUDA-core
    and column-chunk kernels) and at ViT-B/16's heads split over model 2
    and 4."""
    import torch.nn.functional as TF

    from vlm_clip_tpu_torch.models import adapters as A
    from vlm_clip_tpu_torch.models.clip import text_mask
    from vlm_clip_tpu_torch.ops import attention as K5
    from vlm_clip_tpu_torch.ops import fused_adapter as F

    dev, bf, f32 = torch.device("cuda"), torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(3)
    fwd, bwd = "feature_adapter_blend_fused", "feature_adapter_blend_bwd_cuda"
    for n, d, k, drop, dtype, need_dx, entry in (
            *((n, 768, 64, 0.0, dtype, False, dtype == f32)
              for dtype in (f32, bf) for n in (32, 7, 35)),
            (32, 512, 192, 0.0, f32, False, False),
            (35, 4100, 1100, 0.1, f32, True, False),
            (35, 4100, 1100, 0.1, bf, True, False)):
        p = A.init_feature_adapter(gen, d, k, device=dev)
        for leaf in (p["fc1"]["bias"], p["fc2"]["bias"]):
            leaf.normal_(generator=gen).mul_(0.1)
        w = (p["fc1"]["kernel"], p["fc1"]["bias"], p["fc2"]["kernel"],
             p["fc2"]["bias"])
        x = torch.randn(n, d, generator=gen, device=dev)
        x = (x / x.norm(dim=-1, keepdim=True)).to(dtype)
        g = torch.randn(n, d, generator=gen, device=dev).to(dtype)
        shape = f"[{n}, {d}] {_dt(dtype)}" + (f", K {k}" if k != 64 else "") \
            + (f", dropout {drop}" if drop else "")
        yield Row(fwd, entry, shape,
                  lambda: F.feature_adapter_blend_fused(x, *w, 0.2, drop,
                                                        1234),
                  lambda: F.feature_adapter_blend_torch(x, *w, 0.2, drop,
                                                        1234),
                  None, t_cost(fwd, x, k), _elementwise(*TOL[dtype]))
        yield Row(bwd, entry, shape + ("" if need_dx else " no dx"),
                  lambda: F.feature_adapter_blend_bwd_cuda(
                      x, *w, 0.2, g, drop, 1234, need_dx=need_dx),
                  lambda: F.feature_adapter_blend_bwd_torch(
                      x, *w, 0.2, g, drop, 1234, need_dx=need_dx),
                  None, t_cost(bwd, x, k, need_dx=need_dx),
                  _per_grad(dtype))
    for tag, b, h, t, d, kind, dtypes in (
            ("ViT-L/14 vision", 32, 16, 257, 64, None, (bf, f32)),
            ("ViT-L/14 text", 35, 12, 77, 64, "batch", (bf, f32)),
            ("ViT-L/14 text", 35, 12, 77, 64, "broadcast", (bf, f32)),
            ("ViT-B/16 vision", 96, 12, 197, 64, None, (bf, f32)),
            ("ViT-B/16 text", 96, 8, 77, 64, "batch", (bf, f32)),
            ("wide heads", 4, 4, 77, 256, None, (bf, f32)),
            ("wide heads", 4, 4, 77, 272, None, (bf, f32)),
            ("wide heads", 4, 4, 77, 512, None, (bf, f32)),
            ("ViT-B/16 vision, model 2", 32, 6, 197, 64, None, (bf,)),
            ("ViT-B/16 vision, model 4", 32, 3, 197, 64, None, (bf,))):
        for dtype in dtypes:
            q, kk, vv = (torch.randn(b, h, t, d, generator=gen,
                                     device=dev).to(dtype) for _ in range(3))
            mask = None
            if kind is not None:  # the captions' padding, 8 to 77 tokens
                am = torch.ones(b, t, dtype=torch.int32, device=dev)
                lens = torch.randint(8, t + 1, (b,), generator=gen,
                                     device=dev)
                am[torch.arange(t, device=dev)[None] >= lens[:, None]] = 0
                mask = text_mask(am if kind == "batch" else None, t,
                                 device=dev)
            lib_mask = None if mask is None else mask.to(dtype)
            sc = d ** -0.5
            yield Row("fused_attention",
                      dtype == bf and tag.startswith("ViT-L")
                      and kind != "broadcast",
                      f"{tag} [{b}, {h}, {t}, {d}] mask {kind} {_dt(dtype)} "
                      f"(kernel width {K5.kernel_width(d)})",
                      lambda: K5.fused_attention(q, kk, vv, sc, mask),
                      lambda: K5.fused_attention_torch(q, kk, vv, sc, mask),
                      lambda: TF.scaled_dot_product_attention(
                          q, kk, vv, attn_mask=lib_mask, scale=sc),
                      t_cost("fused_attention", q, mask=mask),
                      _elementwise(*TOL[dtype]))
    # the frozen ViT-L/14-336 tower's attention as mha passes it: [B, h, T,
    # d] views of the [B, T, h d] projections, read where they lie
    b, h, t, d = 32, 16, 577, 64
    q, kk, vv = (torch.randn(b, t, h * d, generator=gen, device=dev).to(bf)
                 .view(b, t, h, d).transpose(1, 2) for _ in range(3))
    sc = d ** -0.5
    yield Row("fused_attention", False,
              f"ViT-L/14-336 vision [{b}, {h}, {t}, {d}] mask None bf16, "
              "strided as mha passes it",
              lambda: K5.fused_attention(q, kk, vv, sc),
              lambda: K5.fused_attention_torch(q, kk, vv, sc),
              lambda: TF.scaled_dot_product_attention(q, kk, vv, scale=sc),
              t_cost("fused_attention", q), _elementwise(*TOL[bf]))


def _vlm_rows():
    """K7 (a bf16 matmul on the dequantized weight beside it) on the 8h4
    head (N 151,936) at x [1, 2048], [8, 2048] (the table's entry) and
    [32, 2048] (the engine's slots), on the mixed preset's gateup (N
    22,016) at the same rows and on each rank's head shard of model 2 and
    4 (re-padded as ``shard_quantized`` cuts them); K8 at the 3B heads (16
    q and 2 kv of 128, S=768, every row at the vlm phase's mid-decode
    depth; SDPA beside it on a bf16 cache) on a bf16 cache at B=8 (T = 1:
    the table's entry; and a T = 5 verify), an int8 cache at B=16 and an
    fp32 one at B=2, each also after 256 MB written over the 50 MB L2 (the
    decode step streams the weights between two layers' calls, so there
    the cache comes from HBM); then at the engine's shapes (32 rows) and
    each rank's local heads under model 2 and 4."""
    from vlm_clip_tpu_torch.cli.check_decode_attn import compare, rand_case
    from vlm_clip_tpu_torch.ops import decode_attention as K8
    from vlm_clip_tpu_torch.ops import quant as K7

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(5)
    K = 2048
    for N, cases in ((151936, ((1, False, "8h4 head"), (8, True, "8h4 head"),
                               (ENGINE_SLOTS, False, "8h4 head, engine"))),
                     (22016, ((1, False, "mixed gateup"),
                              (8, False, "mixed gateup"),
                              (32, False, "mixed gateup"))),
                     (151936 // 2, ((8, False, "head shard, model 2"),)),
                     (151936 // 4, ((8, False, "head shard, model 4"),))):
        q = K7.quantize_weight(
            torch.randn(K, N, generator=gen, device=dev) * 0.02, 4)
        w_lib = K7.dequantize_weight(q).to(bf)
        for M, entry, what in cases:
            x = torch.randn(M, K, generator=gen, device=dev).to(bf)
            yield Row("quant_matmul_int4", entry,
                      f"{what} x[{M}, {K}] bf16 N={N}",
                      lambda: K7.quant_matmul_int4(x, q),
                      lambda: K7.quant_matmul_int4_torch(x, q),
                      lambda: torch.matmul(x, w_lib), k7_cost(M, K, N, 2),
                      _elementwise(*K7_TOL), iters=20)
    del q, w_lib
    depth = len(_qwen_prompt()) + VLM_NEW // 2
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    for b, T, h, kv, S, dtype, quant, what in (
            (8, 1, 16, 2, 768, bf, False, "bf16 cache"),
            (8, 5, 16, 2, 768, bf, False, "bf16 cache"),
            (16, 1, 16, 2, 768, bf, True, "int8 cache"),
            (16, 5, 16, 2, 768, bf, True, "int8 cache"),
            (2, 1, 16, 2, 768, torch.float32, False, "fp32"),
            (2, 5, 16, 2, 768, torch.float32, False, "fp32"),
            (ENGINE_SLOTS, 1, 16, 2, 384, bf, False, "engine"),
            (ENGINE_SLOTS, 5, 16, 2, 384, bf, False, "engine"),
            (ENGINE_SLOTS, 1, 16, 2, 768, bf, False, "engine"),
            (8, 1, 8, 1, 768, bf, False, "local heads, model 2"),
            (8, 1, 4, 1, 768, bf, False, "local heads, model 4")):
        case = list(rand_case(gen, b, T, h, kv, 128, S, dtype, quant, dev))
        case[5] = torch.full((b,), depth, dtype=torch.int32, device=dev)
        shape = (f"{what} B={b} T={T} heads {h}/{kv} S={S} depth {depth} "
                 f"{_dt(dtype)} ({K8.kernel_splits(b, kv, 128, S)} column "
                 f"splits)")

        def kern(case=case):
            return K8.decode_attention_kernel(*case)

        def plain(case=case):
            return K8.decode_attention_reference(*case)

        def check(got, want, case=case):
            return compare(got, want, case)[1]

        yield Row("decode_attention_kernel", what == "bf16 cache" and T == 1,
                  shape, kern, plain,
                  _k8_library(case, depth) if dtype == bf and not quant
                  else None, k8_cost(case), check, iters=20)
        if what in ("bf16 cache", "int8 cache", "fp32"):
            yield Row("decode_attention_kernel", False,
                      f"{shape}, each call after an L2 flush",
                      lambda: (flush.zero_(), kern())[1],
                      lambda: (flush.zero_(), plain())[1], None,
                      k8_cost(case), check, iters=20)


def _int8_times(results: dict, failures: list, layers: int = 36) -> None:
    """The int8 GEMM at the four 8h4 text shapes, M = 1 to 64 rows of bf16
    x, each side a CUDA graph over `layers` weights of the shape (an
    L2-cold ring, as a decode forward reads them): the kernel, its plain
    twin (INT8_TOL) and the parent's materialize route (the library
    column); M = 32 is the table's entry. Then a decode forward's 144
    calls at M = 1 and 32, and the rows up to which the kernel beats the
    materialize route at every shape: the route's KERNEL_MAX_M_INT8 must
    not pass them."""
    from vlm_clip_tpu_torch.ops import quant as K7

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    weights = {name: [K7.quantize_weight(
        torch.randn(K, N, generator=gen, device=dev) * 0.02, 8,
        torch.randn(N, generator=gen, device=dev) if bias else None)
        for _ in range(layers)] for name, (K, N, bias) in INT8_SHAPES.items()}

    def ring(calls, fn):
        return _graph([lambda q=q, x=x: fn(x, q) for q, x in calls])

    check = _elementwise(INT8_TOL, INT8_TOL)
    wins = {}
    for M in (1, 8, 16, 32, 48, 64):
        for name, (K, N, bias) in INT8_SHAPES.items():
            x = torch.randn(M, K, generator=gen, device=dev).bfloat16()
            calls = [(q, x) for q in weights[name]]
            t_k, _, t_l = _time_row(results, Row(
                "quant_matmul_int8", M == 32,
                f"{name} x[{M}, {K}] bf16 N={N} ({K7.int8_splits(N, K)} "
                f"depth slices)", ring(calls, K7.quant_matmul_int8),
                ring(calls, K7.quant_matmul_int8_torch),
                ring(calls, _materialize), int8_cost(M, K, N, bias), check,
                layers, 20), failures)
            wins.setdefault(M, []).append(t_k < t_l)
    for M in (1, 32):
        xs = {name: torch.randn(M, K, generator=gen, device=dev).bfloat16()
              for name, (K, _, _) in INT8_SHAPES.items()}
        calls = [(weights[name][i], xs[name]) for i in range(layers)
                 for name in INT8_SHAPES]
        work = [int8_cost(M, *INT8_SHAPES[name]) for name in INT8_SHAPES]
        _time_row(results, Row(
            "quant_matmul_int8", False,
            f"a decode forward's {len(calls)} calls at M={M}",
            ring(calls, K7.quant_matmul_int8),
            ring(calls, K7.quant_matmul_int8_torch),
            ring(calls, _materialize),
            (layers * sum(w[0] for w in work),
             layers * sum(w[1] for w in work), "bf16"), check, 1, 20),
            failures)
    top = max((M for M, w in wins.items() if all(w)), default=0)
    print(f"int8 crossover: the kernel beats the materialize route at every "
          f"text shape up to M={top} of those timed {sorted(wins)}; "
          f"KERNEL_MAX_M_INT8 = {K7.KERNEL_MAX_M_INT8}", flush=True)
    if K7.KERNEL_MAX_M_INT8 > top:
        failures.append(f"KERNEL_MAX_M_INT8 {K7.KERNEL_MAX_M_INT8} past the "
                        f"measured crossover {top}")
    del weights
    torch.cuda.empty_cache()


# the kernels --times compares across checkouts: K4, K6 and K5
TIMES_KERNELS = ("contrastive_loss_fused", "contrastive_loss_bwd_cuda",
                 "feature_adapter_blend_fused",
                 "feature_adapter_blend_bwd_cuda", "fused_attention")


def kernel_times(root: str | None = None) -> dict:
    """The timing table on the card: every row of :func:`_m_rows`,
    :func:`_t_rows`, :func:`_vlm_rows` and :func:`_int8_times`; with a
    root (``--times``), the TIMES_KERNELS rows of the package there, each
    line tagged with it. Raises on a row past its limit or on the int8
    route's crossover; returns the entries of the {"kernels"} line by
    kernel."""
    label = "time" if root is None else f"times {root}:"
    print(f"timing table on {card()}", flush=True)
    results, failures = {}, []
    for rows in ((_m_rows, _t_rows, _vlm_rows) if root is None
                 else (_m_rows, _t_rows)):
        for row in rows():
            if root is None or row.name in TIMES_KERNELS:
                _time_row(results, row, failures, label)
        torch.cuda.empty_cache()
    if root is None:
        _int8_times(results, failures)
    if failures:
        raise SystemExit(f"timing table: kernels past their limits against "
                         f"their plain versions: {failures}")
    return results


def _write_rafdb(root: str, n_train: int, n_eval: int) -> None:
    """A synthetic RAF-DB tree: 100x100 JPEGs (the aligned RAF-DB size)
    under train/val/test/<emotion>/."""
    from PIL import Image

    from vlm_clip_tpu_torch.core.config import EMOTIONS

    rng = np.random.default_rng(0)
    for split, n in (("train", n_train), ("val", n_eval),
                     ("test", n_eval)):
        for e in EMOTIONS:
            d = os.path.join(root, split, e)
            os.makedirs(d, exist_ok=True)
            for i in range(-(-n // len(EMOTIONS))):
                Image.fromarray(rng.integers(0, 255, (100, 100, 3),
                                             dtype=np.uint8)).save(
                    os.path.join(d, f"{e}_{i}.jpg"))


def _clone(tree, device=None):
    """A detached copy of tree's tensors (on ``device`` when given)."""
    from vlm_clip_tpu_torch.bridge import tree_map

    return tree_map(lambda t: t.detach().to(device).clone(), tree)


def _fresh_step(cfg, acfg, tx, clip, adapters, impl, fused_loss,
                policy=None):
    """A train state from (clip, a copy of adapters) and bench.py's M
    step (FAST unless policy says otherwise, frozen towers) through
    impl."""
    from vlm_clip_tpu_torch.bridge import tree_leaves
    from vlm_clip_tpu_torch.core.dtypes import FAST
    from vlm_clip_tpu_torch.train.steps import (init_train_state,
                                                make_m_train_step)

    state = init_train_state(None, cfg, acfg, tx, clip_params=clip,
                             adapter_params=_clone(adapters),
                             device=tree_leaves(clip)[0].device)
    return state, make_m_train_step(cfg, acfg, tx, policy or FAST,
                                    freeze_clip=True, fused_loss=fused_loss,
                                    impl=impl)


def _step_pair(cfg, acfg, tx, clip, adapters, batch, fused_loss,
               label, policy=None) -> dict:
    """One M step with impl="auto" and one with impl="torch" from the same
    state: loss, grad norm and every adapter gradient within STEP_TOL;
    the plain step launches nothing. Returns the launch counts (pipeline
    M's kernels and K4) after the two steps."""
    from vlm_clip_tpu_torch.bridge import tree_leaves
    from vlm_clip_tpu_torch.ops import contrastive as K4
    from vlm_clip_tpu_torch.ops import fused_adapter as F

    def grads(state):
        return [p.grad for p in tree_leaves(state.adapter_params)]

    def names(tree, prefix=""):
        if isinstance(tree, dict):
            return [n for k, v in tree.items()
                    for n in names(v, f"{prefix}{k}.")]
        return [prefix[:-1]]

    state_k, step_k = _fresh_step(cfg, acfg, tx, clip, adapters, "auto",
                                  fused_loss, policy)
    state_k, mk = step_k(state_k, batch)
    counts = {**F.launch_counts(), **K4.launch_counts()}
    state_p, step_p = _fresh_step(cfg, acfg, tx, clip, adapters, "torch",
                                  fused_loss, policy)
    state_p, mp = step_p(state_p, batch)
    torch.cuda.synchronize()
    if {**F.launch_counts(), **K4.launch_counts()} != counts:
        raise SystemExit("the impl='torch' step launched kernels")
    d_loss = abs(float(mk.loss) - float(mp.loss)) / abs(float(mp.loss))
    d_norm = abs(float(mk.grad_norm) - float(mp.grad_norm)) \
        / float(mp.grad_norm)
    # a gradient that is zero in exact arithmetic (the attention's key
    # bias: the softmax is invariant to it) is rounding noise in both
    # paths, so each is held relative to at least 1e-2 of the global
    # gradient norm
    floor = 1e-2 * float(mp.grad_norm)
    diffs = sorted(
        ((float((a - b).norm()) / max(float(b.norm()), floor), name)
         for (a, b), name in zip(zip(grads(state_k), grads(state_p)),
                                 names(adapters))), reverse=True)
    d_grad = diffs[0][0]
    print(f"  largest adapter gradient differences: {diffs[:3]}",
          flush=True)
    ok = d_loss <= STEP_TOL["loss"] and d_norm <= STEP_TOL["grad_norm"] \
        and d_grad <= STEP_TOL["grad"]
    print(f"{label}: kernels loss {float(mk.loss):.6f} grad_norm "
          f"{float(mk.grad_norm):.6f}; plain loss {float(mp.loss):.6f} "
          f"grad_norm {float(mp.grad_norm):.6f}; rel diff loss "
          f"{d_loss:.2e}, grad_norm {d_norm:.2e}, worst adapter gradient "
          f"{d_grad:.2e} (limits {STEP_TOL}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SystemExit(f"{label}: the kernel step disagrees with the "
                         "plain step")
    return counts


def _bench_setup():
    """bench.py's step: ViT-B/16, adapters 256/256/2, Adam 3e-4 and one
    fixed random B=96 batch, made on the card from seed 0: (cfg, acfg,
    clip params, adapter params, batch, optimizer recipe)."""
    from vlm_clip_tpu_torch.core.config import AdapterConfig, clip_preset
    from vlm_clip_tpu_torch.models.clip import init_clip
    from vlm_clip_tpu_torch.models.model_m import init_m_adapters
    from vlm_clip_tpu_torch.train import optim

    dev = torch.device("cuda")
    cfg = clip_preset("vit-base-patch16")
    acfg = AdapterConfig(text_adapter_size=256, vision_adapter_size=256,
                         shared_adapter_layers=2)
    gen = torch.Generator(device=dev).manual_seed(0)
    clip = init_clip(gen, cfg, device=dev)
    adapters = init_m_adapters(gen, cfg, acfg, device=dev)
    batch = {
        "input_ids": torch.randint(1, cfg.text.vocab_size, (B, 77),
                                   generator=gen, device=dev),
        "attention_mask": torch.ones(B, 77, dtype=torch.int32,
                                     device=dev),
        "pixel_values": torch.randn(
            B, 3, cfg.vision.image_size, cfg.vision.image_size,
            generator=gen, device=dev).to(torch.bfloat16),
    }
    return cfg, acfg, clip, adapters, batch, optim.adam(3e-4)


def train_phase() -> dict:
    """cli/train_m for one epoch, then bench.py's step: kernels against
    plain versions, without and with K4."""
    import shutil

    from vlm_clip_tpu_torch.bridge import tree_leaves
    from vlm_clip_tpu_torch.cli import train_m
    from vlm_clip_tpu_torch.core.config import AdapterConfig
    from vlm_clip_tpu_torch.ops import contrastive as K4
    from vlm_clip_tpu_torch.ops import fused_adapter as F
    from vlm_clip_tpu_torch.train.checkpoint import load_adapter_weights

    work = os.path.join(REPO, "build", "chip_smoke")
    data, out = os.path.join(work, "rafdb"), os.path.join(work, "train_m")
    shutil.rmtree(out, ignore_errors=True)
    _write_rafdb(data, n_train=2 * B, n_eval=14)
    os.environ["VLM_CLIP_LOG_DIR"] = os.path.join(work, "logs")

    F.reset_launch_counts()
    K4.reset_launch_counts()
    t0 = time.time()
    res = train_m.main(["--data-root", data, "--clip-model-name",
                        "vit-base-patch16", "--batch-size", str(B),
                        "--num-epochs", "1", "--warmup-steps", "1",
                        "--device", "cuda", "--output-dir", out])
    torch.cuda.synchronize()
    epoch = res["history"][0]
    print(f"train_m: one epoch in {time.time() - t0:.1f}s: {epoch}, test "
          f"loss {res['test_loss']:.4f}", flush=True)
    if not all(np.isfinite([epoch["train_loss"], epoch["val_loss"],
                            res["test_loss"]])):
        raise SystemExit(f"train_m: a loss is not finite: {res}")
    acfg = AdapterConfig(text_adapter_size=256, vision_adapter_size=256,
                         shared_adapter_layers=2)
    for name in ("best_adapter", "adapter_epoch_1", "final_adapter"):
        params = load_adapter_weights(os.path.join(out, name), acfg)
        if not all(bool(torch.isfinite(t).all())
                   for t in tree_leaves(params)):
            raise SystemExit(f"train_m: {name} holds non-finite weights")
    print("train_m: best_adapter, adapter_epoch_1, final_adapter written "
          "and read back", flush=True)

    cfg, acfg, clip, adapters, batch, tx = _bench_setup()
    for fused_loss in (False, True):
        _step_pair(cfg, acfg, tx, clip, adapters, batch, fused_loss,
                   f"bench step fused_loss={fused_loss}")
    counts = {**F.launch_counts(F.M_KERNELS), **K4.launch_counts()}
    print(f"launches on the train path: {counts}", flush=True)
    if min(counts.values()) < 1:
        raise SystemExit(f"a kernel of the train path never launched: "
                         f"{counts}")
    return counts


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


# the launcher's variables that bring a process group up at one rank
LAUNCH_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT")
DP_STEPS = (3, 20)  # warmup, timed steps of each round of the DP timing


DP_RESULT = "train_m result: "


def _train_m_child(args, env) -> subprocess.Popen:
    """cli/train_m's main(args) in a fresh process under env; it prints
    a DP_RESULT line with a JSON object of the history, the test loss and
    K1-K3's launches in that process."""
    code = ("import json, sys, torch\n"
            "from vlm_clip_tpu_torch.cli import train_m\n"
            "from vlm_clip_tpu_torch.ops import fused_adapter as F\n"
            "F.reset_launch_counts()\n"
            "res = train_m.main(sys.argv[1:])\n"
            "torch.cuda.synchronize()\n"
            f"print({DP_RESULT!r} + json.dumps({{'history': res['history'], "
            "'test_loss': res['test_loss'], "
            "'launches': F.launch_counts(F.M_KERNELS)}), flush=True)\n")
    return subprocess.Popen([sys.executable, "-c", code, *args], cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def data_parallel_phase() -> dict:
    """Pipeline M's data-parallel step on the card at one rank (the machine
    has one GPU, and NCCL takes one rank a GPU): cli/train_m --zero1 under
    the launcher's variables (NCCL at world 1) and without them (one
    process, no process group), both from seed 42 on the train phase's
    synthetic tree, must write the same adapter files bit for bit; then,
    in this process, bench.py's step through make_m_train_step's DP and
    ZeRO-1 route against the plain step from the same state, bit for bit,
    and both timed in turns. Returns K1-K3's launches in the launcher
    run."""
    from vlm_clip_tpu_torch.bridge import tree_leaves
    from vlm_clip_tpu_torch.core.dtypes import FAST
    from vlm_clip_tpu_torch.ops import fused_adapter as F
    from vlm_clip_tpu_torch.parallel import distributed as D
    from vlm_clip_tpu_torch.parallel.sharding import zero1_place
    from vlm_clip_tpu_torch.train.steps import (init_train_state,
                                                make_m_train_step)

    work = os.path.join(REPO, "build", "chip_smoke")
    data = os.path.join(work, "rafdb")  # written by the train phase
    outs = {name: os.path.join(work, f"train_m_{name}")
            for name in ("launcher", "single")}
    args = ["--data-root", data, "--clip-model-name", "vit-base-patch16",
            "--batch-size", str(B), "--num-epochs", "1", "--warmup-steps",
            "1", "--learning-rate", "3e-4", "--weight-decay", "0",
            "--device", "cuda", "--zero1"]
    plain_env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    launcher_env = dict(plain_env, WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                        LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
                        MASTER_PORT=str(_free_port()))
    t0 = time.time()
    procs = {name: _train_m_child(args + ["--output-dir", outs[name]], env)
             for name, env in (("launcher", launcher_env),
                               ("single", plain_env))}
    runs = {}
    try:
        for name, proc in procs.items():
            text, err = proc.communicate(timeout=300)
            lines = [ln for ln in text.splitlines()
                     if ln.startswith(DP_RESULT)]
            if proc.returncode != 0 or not lines:
                raise SystemExit(f"train_m --zero1 ({name}) failed:\n"
                                 f"{text[-2000:]}\n{err[-4000:]}")
            runs[name] = json.loads(lines[-1][len(DP_RESULT):])
            print(f"train_m --zero1, {name}: {runs[name]['history']}, test "
                  f"loss {runs[name]['test_loss']}", flush=True)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"both runs in {time.time() - t0:.1f}s (side by side)", flush=True)
    for name in ("best_adapter", "adapter_epoch_1", "final_adapter"):
        a, b = (torch.load(os.path.join(outs[k], name), weights_only=True)
                for k in ("launcher", "single"))
        same = a.keys() == b.keys() and all(
            a[kind].keys() == b[kind].keys() and all(
                torch.equal(a[kind][key], b[kind][key]) for key in a[kind])
            for kind in a)
        if not same:
            raise SystemExit(f"train_m --zero1: {name} under NCCL at world "
                             "1 differs from the single-process run")
    counts = runs["launcher"]["launches"]
    print(f"train_m --zero1 under NCCL at world 1 and in one process wrote "
          f"the same adapter files bit for bit; K1-K3 launches in the "
          f"NCCL run: {counts}", flush=True)
    if min(counts.values()) < 1:
        raise SystemExit(f"a kernel of the DP path never launched: {counts}")

    # this process, at one rank: the DP + ZeRO-1 step against the plain
    # step, bit for bit, then timed in turns
    cfg, acfg, clip, adapters, batch, tx = _bench_setup()
    D.maybe_initialize(D.DistributedConfig(
        coordinator_address=f"localhost:{_free_port()}", num_processes=1,
        process_id=0, local_rank=0, local_world_size=1), device="cuda")
    try:
        mesh = D.global_mesh(device="cuda")
        print(f"NCCL {torch.cuda.nccl.version()} (backend "
              f"{torch.distributed.get_backend()}), world "
              f"{torch.distributed.get_world_size()}", flush=True)

        def fresh(dp):
            state = init_train_state(None, cfg, acfg, tx, clip_params=clip,
                                     adapter_params=_clone(adapters),
                                     device=torch.device("cuda"))
            if dp:
                state = state._replace(opt_state=zero1_place(
                    state.opt_state, mesh, tx))
            return state, make_m_train_step(
                cfg, acfg, tx, FAST, freeze_clip=True,
                zero1_mesh=mesh if dp else None)

        steps = {}
        for dp in (False, True):
            state, step = fresh(dp)
            state, m = step(state, batch)
            steps[dp] = (m, _clone(state.adapter_params))
        same = torch.equal(steps[False][0].loss, steps[True][0].loss) and \
            torch.equal(steps[False][0].grad_norm,
                        steps[True][0].grad_norm) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(steps[False][1]),
                                              tree_leaves(steps[True][1])))
        print(f"bench step, DP + ZeRO-1 at world 1 vs the plain step: loss "
              f"{float(steps[True][0].loss):.6f}, bit for bit {same}",
              flush=True)
        if not same:
            raise SystemExit("the DP step at world 1 differs from the plain "
                             "step")
        ms = {False: [], True: []}
        for dp in (False, True, True, False):
            state, step = fresh(dp)
            for _ in range(DP_STEPS[0]):
                state, m = step(state, batch)
            torch.cuda.synchronize()
            if dp:
                F.reset_launch_counts()
            t0 = time.perf_counter()
            for _ in range(DP_STEPS[1]):
                state, m = step(state, batch)
            float(m.loss)
            ms[dp].append((time.perf_counter() - t0) * 1e3 / DP_STEPS[1])
            if dp:
                in_process = F.launch_counts(F.M_KERNELS)
                moments = sum(
                    t.numel() * t.element_size()
                    for st in state.opt_state.optimizer.state.values()
                    for k, t in st.items() if k.startswith("exp_avg"))
        # the card's busy time a step (torch.profiler, 3 steps each)
        busy, nccl = {}, {}
        for dp in (False, True):
            held = list(fresh(dp))

            def one():
                held[0], _ = held[1](held[0], batch)

            per = _profiled(one, 3)
            busy[dp] = sum(v[0] for v in per.values())
            nccl[dp] = sum(v[0] for name, v in per.items() if "nccl" in name)
    finally:
        torch.distributed.destroy_process_group()
    print(f"DP step ms (B={B}, ViT-B/16, adapters 256/256/2, FAST, Adam "
          f"3e-4; {DP_STEPS[1]} steps after {DP_STEPS[0]} warmup, two "
          f"rounds each): DP + ZeRO-1 under NCCL at world 1 {ms[True]}, "
          f"plain step {ms[False]}, ratio "
          f"{sum(ms[True]) / sum(ms[False]):.4f}; device busy a step "
          f"{busy[True]:.3f} ms (NCCL kernels {nccl[True]:.3f}) against "
          f"{busy[False]:.3f} on {card()}", flush=True)
    print(f"K1-K3 launches in the timed DP steps: {in_process}; Adam's "
          f"moments on rank 0: {moments} bytes (world 1: zero1_specs shards "
          f"no leaf, so every moment is whole)", flush=True)
    print("at world 1 no leaf is sharded, so the card runs the gather and "
          "all-reduce route of the DP step but never ZeRO-1's "
          "reduce-scatter, parameter all-gather or state gather under NCCL; "
          "those, and the two-rank semantics (the global-batch loss, the "
          "gradient average, the global grad norm and clipping, half of "
          "every shardable moment a rank, the gathered resume), are held "
          "only on the CPU, by tests/test_torch_data_parallel.py (gloo): "
          "NCCL takes one rank a GPU and this machine has one", flush=True)
    return counts


def _write_flat_tree(root: str, per_class: int, seed: int) -> None:
    """A flat root/<emotion>/*.jpg tree of 100x100 JPEGs (the aligned
    RAF-DB size), the layout cli/compare_t reads."""
    from PIL import Image

    from vlm_clip_tpu_torch.core.config import EMOTIONS

    rng = np.random.default_rng(seed)
    for e in EMOTIONS:
        d = os.path.join(root, e)
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            Image.fromarray(rng.integers(0, 255, (100, 100, 3),
                                         dtype=np.uint8)).save(
                os.path.join(d, f"{e}_{i}.jpg"))


def pipeline_t_phase() -> dict:
    """Pipeline T at ViT-L/14 full width with K5 on: cli/compare_t, the
    kernel T step against the plain one, K5 on against off, and
    cli/predict_image with a T checkpoint."""
    import shutil

    from vlm_clip_tpu_torch.bridge import tree_leaves, tree_map
    from vlm_clip_tpu_torch.cli import compare_t, predict_image
    from vlm_clip_tpu_torch.cli.common import load_backbone, make_tokenizer
    from vlm_clip_tpu_torch.core.config import EMOTIONS
    from vlm_clip_tpu_torch.data.captions import get_emotion_descriptions
    from vlm_clip_tpu_torch.data.preprocess import normalize_batch
    from vlm_clip_tpu_torch.models import model_t as T
    from vlm_clip_tpu_torch.models.clip import get_text_features
    from vlm_clip_tpu_torch.models.layers import l2_normalize
    from vlm_clip_tpu_torch.ops import attention as K5
    from vlm_clip_tpu_torch.ops import fused_adapter as F
    from vlm_clip_tpu_torch.train import optim
    from vlm_clip_tpu_torch.train.trainer_t import make_t_train_step

    name, bt = "vit-large-patch14", 32
    work = os.path.join(REPO, "build", "chip_smoke", "pipeline_t")
    shutil.rmtree(work, ignore_errors=True)
    train_dir, test_dir = (os.path.join(work, s) for s in ("train", "test"))
    _write_flat_tree(train_dir, per_class=10, seed=1)  # 70: 2 steps a epoch
    _write_flat_tree(test_dir, per_class=5, seed=2)    # 35: 2 eval batches
    os.environ["VLM_CLIP_LOG_DIR"] = os.path.join(work, "logs")

    # 1. the entry point, K5 on for the frozen towers' encodes
    was_on = K5.fused_attention_enabled()
    K5.set_fused_attention(True)
    try:
        F.reset_launch_counts()
        K5.reset_launch_counts()
        t0 = time.time()
        res = compare_t.main(["--train-dir", train_dir, "--test-dir",
                              test_dir, "--clip-model-name", name,
                              "--batch-size", str(bt), "--num-epochs", "3",
                              "--no-plots", "--device", "cuda",
                              "--out-dir", work])
        torch.cuda.synchronize()
        counts = {**F.launch_counts(F.T_KERNELS), **K5.launch_counts()}
    finally:
        K5.set_fused_attention(was_on)
    losses = res.pop("losses")
    print(f"compare_t ViT-L/14, B={bt}, 3 epochs, K5 on: "
          f"{time.time() - t0:.1f}s; epoch losses {losses}; {res}",
          flush=True)
    print(f"launches on the pipeline-T path: {counts}", flush=True)
    if len(losses) != 3 or not np.isfinite(losses).all() \
            or not all(0.0 <= v <= 1.0 for v in res.values()):
        raise SystemExit(f"compare_t: bad losses or accuracies: {losses}, "
                         f"{res}")
    if min(counts.values()) < 1:
        raise SystemExit(f"a kernel of the pipeline-T path never launched: "
                         f"{counts}")

    # 2. one T train step with the kernels and one with impl="torch" from
    # the same state, on cached-feature inputs (what epochs >= 2 see)
    dev = torch.device("cuda")
    clip, cfg = load_backbone(name, seed=0, device=dev)
    model = T.CLIPAdapterT(clip, cfg, make_tokenizer(cfg), seed=0)
    gen = torch.Generator(device=dev).manual_seed(4)
    feats = torch.randn(bt, cfg.projection_dim, generator=gen, device=dev)
    feats = feats / feats.norm(dim=-1, keepdim=True)
    labels = torch.randint(0, 7, (bt,), generator=gen, device=dev)
    tx = optim.adam(3e-4)

    def fresh(impl):
        params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                          model.adapter_params)
        return (params, tx.init(tree_leaves(params)),
                make_t_train_step(tx, model.alpha, model.beta, impl))

    out = {}
    for impl in ("auto", "torch"):
        params, opt, step = fresh(impl)
        F.reset_launch_counts()
        loss = step(params, opt, 0, feats, labels, model.bank.mean,
                    model.temperature)
        torch.cuda.synchronize()
        launched = F.launch_counts(F.T_KERNELS)
        if (impl == "torch") == any(launched.values()):
            raise SystemExit(f"impl={impl} step launches: {launched}")
        out[impl] = (float(loss), [p.grad.clone()
                                   for p in tree_leaves(params)])
    (lk, gk), (lp, gp) = out["auto"], out["torch"]
    d_loss = abs(lk - lp) / abs(lp)
    floor = 1e-2 * float(torch.sqrt(sum((g ** 2).sum() for g in gp)))
    d_grad = max(float((a - b).norm()) / max(float(b.norm()), floor)
                 for a, b in zip(gk, gp))
    ok = d_loss <= T_STEP_TOL["loss"] and d_grad <= T_STEP_TOL["grad"]
    print(f"T step B={bt}: kernels loss {lk:.7f}, plain {lp:.7f}; rel diff "
          f"loss {d_loss:.2e}, worst adapter gradient {d_grad:.2e} (limits "
          f"{T_STEP_TOL}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("the kernel T step disagrees with the plain step")

    # the cached-feature step's time, kernels and plain in turns
    step_ms = {"auto": [], "torch": []}
    for impl in ("auto", "torch", "auto", "torch"):
        params, opt, step = fresh(impl)
        for i in range(5):
            step(params, opt, i, feats, labels, model.bank.mean,
                 model.temperature)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(50):
            loss = step(params, opt, 5 + i, feats, labels, model.bank.mean,
                        model.temperature)
        float(loss)
        step_ms[impl].append((time.perf_counter() - t0) * 1e3 / 50)

    # 3. K5 on against off: one batch of 32 images and the prompt bank
    px = normalize_batch(torch.randint(0, 255, (bt, cfg.vision.image_size,
                                                 cfg.vision.image_size, 3),
                                       generator=gen, device=dev,
                                       dtype=torch.uint8))
    ids, am = model.tokenizer([d for e in EMOTIONS for d in
                               get_emotion_descriptions()[e]])
    ids = torch.as_tensor(ids, device=dev)
    am = torch.as_tensor(am, device=dev)
    enc = {}
    encode_ms = {False: [], True: []}
    for on in (False, True, True, False):
        with _k5_off(not on), torch.no_grad():
            K5.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = model.encode_images(px)
            torch.cuda.synchronize()
            encode_ms[on].append((time.perf_counter() - t0) * 1e3)
            n_img = K5.fused_attention.launches
            txt = l2_normalize(get_text_features(
                model.clip_params, ids, am, cfg, model.policy)).float()
            enc[on] = (img, txt, n_img, K5.fused_attention.launches - n_img)
    (img0, txt0, _, _), (img1, txt1, n_img, n_txt) = enc[False], enc[True]
    if (n_img, n_txt) != (cfg.vision.num_layers, cfg.text.num_layers) \
            or enc[False][2] or enc[False][3]:
        raise SystemExit(f"K5 launches: image batch {n_img}, bank {n_txt} "
                         f"(want {cfg.vision.num_layers}, "
                         f"{cfg.text.num_layers}; none with K5 off)")
    worst = {}
    for what, a, b in (("image", img1, img0), ("bank", txt1, txt0)):
        worst[what] = (float((a - b).abs().max()),
                       float((a * b).sum(-1).min()))
    ok = all(m <= ENCODE_TOL["max_abs"] and c >= ENCODE_TOL["cosine"]
             for m, c in worst.values())
    print(f"K5 on vs off, ViT-L/14 BF16 (max abs diff, least cosine): "
          f"{worst} (limits {ENCODE_TOL}) {'ok' if ok else 'FAIL'}; K5 "
          f"launches: {n_img} per image batch, {n_txt} for the bank",
          flush=True)
    if not ok:
        raise SystemExit("features with K5 disagree with the plain path")

    # 4. predict_image on one JPEG with a T checkpoint the port saved
    ckpt = os.path.join(work, "t_adapters.pt")
    model.save_adapters(ckpt)
    jpg = os.path.join(work, "face.jpg")
    with open(jpg, "wb") as f:
        f.write(_jpeg(7, (120, 96)))
    F.reset_launch_counts()
    probs = predict_image.main([jpg, "--clip-model-name", name,
                                "--adapter-ckpt", ckpt, "--device", "cuda",
                                "--plot-out", os.path.join(work, "p.png")])
    if probs.shape != (7,) or not np.isfinite(probs).all() \
            or abs(float(probs.sum()) - 1.0) > 1e-4 \
            or not F.feature_adapter_blend_fused.launches:
        raise SystemExit(f"predict_image: bad output {probs} or no K6 "
                         "launch")
    smi = card()
    print(f"predict_image ViT-L/14 with a T checkpoint: {probs.round(4)}",
          flush=True)
    print(f"T train step with cached features (B={bt}, D=768, K=64, Adam; "
          f"50 steps after 5, two rounds each): kernels {step_ms['auto']} "
          f"ms, plain versions {step_ms['torch']} ms on {smi}", flush=True)
    print(f"ViT-L/14 image encode (B={bt}, BF16, host clock to a "
          f"synchronize): K5 on {encode_ms[True]} ms, off "
          f"{encode_ms[False]} ms on {smi}", flush=True)
    return counts


V_NAME, V_B = "vit-large-patch14", 4  # pipeline V's backbone and batch


def pipeline_v_phase() -> dict:
    """Pipeline V at ViT-L/14 full width (24 + 12 layers, seeded random
    weights), the stub context backend: cli/main_v (bottleneck 192,
    B=4, 2 epochs, dropout 0.1 through K6's hash, on 42 train and 21 test
    synthetic images), then cli/build_context_cache on the test tree,
    then serve --v-adapter-ckpt --context-cache answering 3 /classify
    requests (two images the cache holds, one it does not). K6 must
    launch, forward and backward, on that path (counts zeroed just before
    it, read just after). Then, from the trained adapters: V's eval
    logits with the kernels against impl="torch" (V_LOGIT_ATOL), one V
    train step at dropout 0 (B=8) and one as main_v trains (dropout 0.1,
    B=4, the same seeds on both sides) against impl="torch"
    (T_STEP_TOL), and the served probabilities against impl="torch"
    (CLASSIFY_ATOL)."""
    import shutil
    from pathlib import Path

    from PIL import Image

    from vlm_clip_tpu_torch.bridge import tree_leaves
    from vlm_clip_tpu_torch.cli import build_context_cache, main_v
    from vlm_clip_tpu_torch.cli.common import load_backbone, make_tokenizer
    from vlm_clip_tpu_torch.cli.serve import build_server
    from vlm_clip_tpu_torch.core.config import EMOTIONS, clip_preset
    from vlm_clip_tpu_torch.data.preprocess import (load_and_resize,
                                                    normalize_batch)
    from vlm_clip_tpu_torch.data.rafdb import scan_class_folders
    from vlm_clip_tpu_torch.models import model_v as V
    from vlm_clip_tpu_torch.ops import fused_adapter as F
    from vlm_clip_tpu_torch.train import optim
    from vlm_clip_tpu_torch.train.checkpoint import load_v_adapters
    from vlm_clip_tpu_torch.train.trainer_v import make_v_train_step
    from vlm_clip_tpu_torch.vlm.extractor import CachedContextExtractor

    work = os.path.join(REPO, "build", "chip_smoke", "pipeline_v")
    shutil.rmtree(work, ignore_errors=True)
    train_dir, test_dir, cache_dir = (os.path.join(work, s) for s in
                                      ("train", "test", "cache"))
    _write_flat_tree(train_dir, per_class=6, seed=3)  # 42: 10 steps a epoch
    _write_flat_tree(test_dir, per_class=3, seed=4)   # 21
    os.environ["VLM_CLIP_LOG_DIR"] = os.path.join(work, "logs")
    ckpt = os.path.join(work, "v_adapters.pt")
    bodies = []
    test_images = [path for path, _ in scan_class_folders(Path(test_dir))]
    for path in test_images[:2]:
        with open(path, "rb") as f:
            bodies.append(f.read())
    bodies.append(_jpeg(9, (140, 120)))  # an image the cache lacks

    # the main path: the entry points a user calls
    F.reset_launch_counts()
    t0 = time.time()
    res = main_v.main(["--train-dir", train_dir, "--test-dir", test_dir,
                       "--clip-model-name", V_NAME, "--vlm-backend", "stub",
                       "--bottleneck-dim", "192", "--batch-size", str(V_B),
                       "--num-epochs", "2", "--adapter-out", ckpt,
                       "--device", "cuda", "--no-plots"])
    torch.cuda.synchronize()
    t_main = time.time() - t0
    t0 = time.time()
    # the content keys at the served image size
    size = clip_preset(V_NAME).vision.image_size
    cache = build_context_cache.main([
        "--data-dir", test_dir, "--out-dir", cache_dir, "--clip-model-name",
        V_NAME, "--image-size", str(size), "--device", "cuda"])
    t_cache = time.time() - t0
    server = build_server(["--port", "0", "--device", "cuda",
                           "--clip-model-name", V_NAME,
                           "--allow-random-weights", "--allow-hash-tokenizer",
                           "--v-adapter-ckpt", ckpt, "--context-cache",
                           cache_dir])
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    served, lat = [], []
    try:
        for body in bodies:
            out, ms = _post(port, "/classify", body)
            served.append(np.asarray([out["probs"][e] for e in EMOTIONS]))
            lat.append(ms)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    torch.cuda.synchronize()
    counts = F.launch_counts(F.T_KERNELS)
    losses, results = res["losses"], res["results"]
    print(f"main_v ViT-L/14, stub contexts, B={V_B}, 2 epochs: "
          f"{t_main:.1f}s; epoch losses {losses}; accuracy "
          f"{results.accuracy:.4f} over {len(results.labels)} images; "
          f"context success rate {res['context_stats']['success_rate']}%",
          flush=True)
    print(f"build_context_cache ViT-L/14: {cache} in {t_cache:.1f}s; "
          f"server mode {server.mode}", flush=True)
    print(f"latency /classify v-context: mean {np.mean(lat):.2f} ms, min "
          f"{np.min(lat):.2f} ms over {len(lat)} requests", flush=True)
    print(f"launches on the pipeline-V path: {counts}", flush=True)
    if len(losses) != 2 or not np.isfinite(losses).all() \
            or len(results.astuple()) != 9 or len(results.labels) != 21 \
            or cache != {"images": 21, "keys": 42, "failures": 0} \
            or server.mode != "v-context+cache":
        raise SystemExit(f"pipeline V: bad losses, results, cache or mode: "
                         f"{losses}, {len(results.labels)}, {cache}, "
                         f"{server.mode}")
    if min(counts.values()) < 1:
        raise SystemExit(f"a kernel of the pipeline-V path never launched: "
                         f"{counts}")

    # the trained adapters against impl="torch" on the served backbone
    dev = torch.device("cuda")
    clip, cfg = load_backbone(V_NAME, device=dev)
    tok = make_tokenizer(cfg)
    models = {}
    for impl in ("auto", "torch"):
        with torch.no_grad():
            m = V.EnhancedCLIPAdapterV(clip, cfg, tok, impl=impl)
            m.adapter_params = load_v_adapters(ckpt, device=dev)
            m.encode_emotion_descriptions()
        models[impl] = m
    lookup = CachedContextExtractor(cache_dir)
    S = cfg.vision.image_size
    u8 = np.zeros((8, S, S, 3), np.uint8)
    ctx = np.zeros((8, cfg.projection_dim), np.float32)
    for i, path in enumerate(test_images[:8]):
        u8[i] = load_and_resize(path, S)
        f = lookup.encode_context_descriptions(
            lookup.extract_context_from_image(u8[i]))
        ctx[i] = f[0]
    px = normalize_batch(torch.from_numpy(u8).to(dev))
    F.reset_launch_counts()
    logits = {impl: m.forward(px, ctx) for impl, m in models.items()}
    d_logit = float((logits["auto"] - logits["torch"]).abs().max())
    ok = d_logit <= V_LOGIT_ATOL and F.feature_adapter_blend_fused.launches
    print(f"V eval logits (8 test images with cached contexts), kernels vs "
          f"impl=torch: max abs diff {d_logit:.3e} (limit {V_LOGIT_ATOL}; "
          f"scale exp(logit_scale) {float(clip['logit_scale'].exp()):.2f}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("V's logits with the kernels disagree with the "
                         "plain path")
    feats = models["auto"].encode_images(px)
    labels = torch.arange(8, device=dev) % 7
    ctx_t = torch.from_numpy(ctx).to(dev)
    tx = optim.adam(3e-4)
    # dropout 0 at B=8 against impl="torch"; then main_v's training step,
    # dropout 0.1 at B=4, against K6's plain version (impl="auto" on CPU
    # copies: the same hash masks, since both sides draw K6's seeds from
    # generators seeded alike; impl="torch" draws another mask)
    cpu = torch.device("cpu")
    for drop, nb in ((0.0, 8), (0.1, V_B)):
        sides = {"auto": (models["auto"], "auto", dev),
                 "torch": (models["torch"], "torch", dev)} if not drop else \
            {"auto": (models["auto"], "auto", dev),
             "torch": (models["auto"], "auto", cpu)}
        out = {}
        for side, (m, impl, where) in sides.items():
            params = _clone(m.adapter_params, where)
            for leaf in tree_leaves(params):
                leaf.requires_grad_(True)
            step = make_v_train_step(tx, m.alpha, m.beta, m.gamma, drop,
                                     impl)
            gen = torch.Generator().manual_seed(7) if drop else None
            loss = step(params, tx.init(tree_leaves(params)), 0,
                        feats[:nb].to(where), ctx_t[:nb].to(where),
                        labels[:nb].to(where),
                        m.emotion_embedding_tensor.to(where),
                        clip["logit_scale"].detach().to(where), gen)
            out[side] = (float(loss), [p.grad.to(dev)
                                       for p in tree_leaves(params)])
        (lk, gk), (lp, gp) = out["auto"], out["torch"]
        d_loss = abs(lk - lp) / abs(lp)
        floor = 1e-2 * float(torch.sqrt(sum((g ** 2).sum() for g in gp)))
        d_grad = max(float((a - b).norm()) / max(float(b.norm()), floor)
                     for a, b in zip(gk, gp))
        ok = d_loss <= T_STEP_TOL["loss"] and d_grad <= T_STEP_TOL["grad"]
        plain = "K6's plain version on the CPU" if drop else "impl=torch"
        print(f"V step B={nb} (dropout {drop}): kernels loss {lk:.7f}, "
              f"{plain} {lp:.7f}; rel diff loss {d_loss:.2e}, worst adapter "
              f"gradient {d_grad:.2e} (limits {T_STEP_TOL}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"the kernel V step (dropout {drop}) disagrees "
                             f"with the plain step")
    with torch.inference_mode():
        for i, body in enumerate(bodies):
            b8 = np.zeros((8, S, S, 3), np.uint8)  # the served batch
            b8[0] = load_and_resize(Image.open(io.BytesIO(body)), S)
            c8 = np.zeros((8, cfg.projection_dim), np.float32)
            f = lookup.encode_context_descriptions(
                lookup.extract_context_from_image(b8[0]))
            if f is not None:
                c8[0] = f[0]
            want = models["torch"].predict_probs(normalize_batch(
                torch.from_numpy(b8).to(dev)), c8).float().cpu().numpy()[0]
            d = float(np.abs(want - served[i]).max())
            ok = np.isfinite(served[i]).all() \
                and abs(served[i].sum() - 1.0) < 1e-4 and d <= CLASSIFY_ATOL
            print(f"/classify v-context[{i}] ({'cached' if f is not None else
                  'no'} context) vs impl=torch: max abs diff {d:.3e} (limit "
                  f"{CLASSIFY_ATOL}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok or (f is None) != (i == 2):
                raise SystemExit("v-context /classify disagrees with the "
                                 "plain path, or the cache lookup failed")
    return counts


def _jpeg(seed: int, size) -> bytes:
    from PIL import Image

    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)
                    ).save(buf, format="JPEG")
    return buf.getvalue()


def _post(port: int, path: str, body: bytes):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.perf_counter()
    conn.request("POST", path, body=body)
    resp = conn.getresponse()
    out = json.loads(resp.read().decode())
    ms = (time.perf_counter() - t0) * 1e3
    conn.close()
    if resp.status != 200:
        raise RuntimeError(f"{path} -> HTTP {resp.status}: {out}")
    return out, ms


def _unit(vec, what: str) -> np.ndarray:
    v = np.asarray(vec, np.float32)
    if v.shape != (512,) or not np.isfinite(v).all() \
            or abs(float(np.linalg.norm(v)) - 1.0) > 2 ** -8:  # bf16
        raise RuntimeError(f"{what}: not a finite unit-norm 512-vector "
                           f"(shape {v.shape}, norm "
                           f"{float(np.linalg.norm(v))})")
    return v


def serve_phase() -> dict:
    from vlm_clip_tpu_torch.cli.serve import build_server
    from vlm_clip_tpu_torch.core.config import (AdapterConfig, EMOTIONS,
                                                clip_preset)
    from vlm_clip_tpu_torch.models.layers import l2_normalize
    from vlm_clip_tpu_torch.models.model_m import (init_m_adapters,
                                                   m_get_image_features,
                                                   m_get_text_features)
    from vlm_clip_tpu_torch.ops import fused_adapter as F
    from vlm_clip_tpu_torch.train.checkpoint import save_adapter_weights

    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    ckpt = os.path.join(work, "m_adapters_vitb16.pt")
    cfg = clip_preset("vit-base-patch16")
    acfg = AdapterConfig()
    save_adapter_weights(ckpt, init_m_adapters(
        torch.Generator().manual_seed(1), cfg, acfg, device="cpu"))

    t0 = time.time()
    server = build_server([
        "--port", "0", "--device", "cuda",
        "--clip-model-name", "vit-base-patch16", "--allow-random-weights",
        "--allow-hash-tokenizer", "--m-adapter-ckpt", ckpt])
    print(f"server up in {time.time() - t0:.1f}s: {server.mode}", flush=True)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    images = [_jpeg(i, size) for i, size in
              enumerate([(224, 224), (300, 240), (180, 260)])]
    texts = ["a happy face with a broad smile",
             "a person expressing anger with narrowed eyes",
             json.dumps({"text": "a neutral, calm face"})]
    lat = {"/embed": [], "/embed_text": [], "/classify": []}
    served_img, served_txt = [], []
    try:
        F.reset_launch_counts()
        for body in images:
            out, ms = _post(port, "/embed", body)
            served_img.append(_unit(out["features"], "/embed"))
            lat["/embed"].append(ms)
        for text in texts:
            out, ms = _post(port, "/embed_text", text.encode())
            served_txt.append(_unit(out["features"], "/embed_text"))
            lat["/embed_text"].append(ms)
        for body in images:
            out, ms = _post(port, "/classify", body)
            probs = np.asarray([out["probs"][e] for e in EMOTIONS])
            if not (np.isfinite(probs).all() and probs.min() >= 0
                    and abs(probs.sum() - 1.0) < 1e-4):
                raise RuntimeError(f"/classify: bad probabilities {out}")
            lat["/classify"].append(ms)
        counts = {fn.__name__: fn.launches for fn in F.FORWARD}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    print("launches on the served path:", counts, flush=True)
    if min(counts.values()) < 1:
        raise SystemExit(f"a kernel of the path never launched: {counts}")
    for route, ms in lat.items():
        print(f"latency {route}: mean {np.mean(ms):.2f} ms, min "
              f"{np.min(ms):.2f} ms over {len(ms)} requests (B=1, first "
              "request after warmup included)", flush=True)

    # the same weights through the plain versions on the card; this run
    # must launch no kernel, or it would not be the plain path
    emb = server.embedder
    model = emb.model
    F.reset_launch_counts()
    with torch.inference_mode():
        for i, body in enumerate(images):
            ref = l2_normalize(m_get_image_features(
                model.clip_params, model.adapter_params, emb.pixels(body),
                model.cfg, model.acfg, model.policy, impl="torch"))
            d = float(np.abs(ref.float().cpu().numpy()[0]
                             - served_img[i]).max())
            print(f"/embed[{i}] vs impl=torch: max abs diff {d:.3e} "
                  f"(limit {EMBED_ATOL})", flush=True)
            if not d <= EMBED_ATOL:
                raise SystemExit("/embed disagrees with the plain path")
        for i, text in enumerate(texts):
            raw = json.loads(text)["text"] if text.startswith("{") else text
            ids, mask = emb.tokenizer([raw])
            ref = l2_normalize(m_get_text_features(
                model.clip_params, model.adapter_params,
                torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda(),
                model.cfg, model.acfg, model.policy, impl="torch"))
            d = float(np.abs(ref.float().cpu().numpy()[0]
                             - served_txt[i]).max())
            print(f"/embed_text[{i}] vs impl=torch: max abs diff {d:.3e} "
                  f"(limit {EMBED_ATOL})", flush=True)
            if not d <= EMBED_ATOL:
                raise SystemExit("/embed_text disagrees with the plain path")
    if any(F.launch_counts().values()):
        raise SystemExit(f"the plain path launched kernels: "
                         f"{F.launch_counts()}")
    counts.update(serve_t_adapter(images))
    return counts


def serve_t_adapter(images) -> dict:
    """A second server, /classify in t-adapter mode (a T checkpoint),
    held against the plain path on the same weights."""
    from PIL import Image

    from vlm_clip_tpu_torch.cli.common import load_backbone, make_tokenizer
    from vlm_clip_tpu_torch.cli.serve import build_server
    from vlm_clip_tpu_torch.core.config import EMOTIONS, clip_preset
    from vlm_clip_tpu_torch.data.preprocess import (load_and_resize,
                                                    normalize_batch)
    from vlm_clip_tpu_torch.models.model_t import (CLIPAdapterT,
                                                   init_t_adapters)
    from vlm_clip_tpu_torch.ops import fused_adapter as F
    from vlm_clip_tpu_torch.train.checkpoint import save_t_adapters

    name = "vit-base-patch16"
    cfg = clip_preset(name)
    ckpt = os.path.join(REPO, "build", "chip_smoke", "t_adapters_vitb16.pt")
    save_t_adapters(ckpt, init_t_adapters(torch.Generator().manual_seed(2),
                                          cfg.projection_dim, 64,
                                          device="cpu"))
    F.reset_launch_counts()
    server = build_server(["--port", "0", "--device", "cuda",
                           "--clip-model-name", name,
                           "--allow-random-weights", "--allow-hash-tokenizer",
                           "--adapter-ckpt", ckpt])
    print(f"server up: {server.mode}", flush=True)
    if server.mode != "t-adapter":
        raise SystemExit(f"--adapter-ckpt served mode {server.mode}")
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    served, lat = [], []
    try:
        F.reset_launch_counts()
        for body in images:
            out, ms = _post(port, "/classify", body)
            served.append(np.asarray([out["probs"][e] for e in EMOTIONS]))
            lat.append(ms)
        launched = F.feature_adapter_blend_fused.launches
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    print(f"latency /classify t-adapter: mean {np.mean(lat):.2f} ms, min "
          f"{np.min(lat):.2f} ms over {len(lat)} requests; K6 forward "
          f"launches {launched}", flush=True)
    if not launched:
        raise SystemExit("t-adapter /classify never launched K6")
    # the same weights (the server's seed) through the plain versions
    dev = torch.device("cuda")
    clip, cfg = load_backbone(name, device=dev)
    F.reset_launch_counts()
    with torch.inference_mode():
        model = CLIPAdapterT(clip, cfg, make_tokenizer(cfg), impl="torch")
        model.load_adapters(ckpt)
        S = cfg.vision.image_size
        for i, body in enumerate(images):
            u8 = np.zeros((8, S, S, 3), np.uint8)  # the served batch
            u8[0] = load_and_resize(Image.open(io.BytesIO(body)), S)
            want = model.predict(normalize_batch(torch.from_numpy(u8).to(
                dev))).float().cpu().numpy()[0]
            d = float(np.abs(want - served[i]).max())
            ok = np.isfinite(served[i]).all() \
                and abs(served[i].sum() - 1.0) < 1e-4 and d <= CLASSIFY_ATOL
            print(f"/classify t-adapter[{i}] vs impl=torch: max abs diff "
                  f"{d:.3e} (limit {CLASSIFY_ATOL}) {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                raise SystemExit("t-adapter /classify disagrees with the "
                                 "plain path")
    if any(F.launch_counts().values()):
        raise SystemExit(f"the plain path launched kernels: "
                         f"{F.launch_counts()}")
    return {"feature_adapter_blend_fused": launched}


# ---------------------------------------------------------------------------
# real weights in, and the EMOTIC workload (phase real_weights_emotic)
# ---------------------------------------------------------------------------

RW_NAME = "vit-base-patch16"  # train_emotic's default backbone
EMOTIC_TOL = {"loss": 1e-5, "grad": T_STEP_TOL["grad"], "scores": 1e-5}
ST_DTYPES = {torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16"}


def hf_state_dict(params, cfg) -> dict:
    """The port's CLIP tree under HF ``CLIPModel``'s state-dict names, on
    the CPU: the inverse of ``convert/hf.convert_hf_clip`` (linear
    kernels back to [out, in], the patch kernel [P, P, 3, H] back to the
    conv's [H, 3, P, P], stacked layers unstacked)."""
    def c(t):
        return t.detach().contiguous().cpu()

    sd = {}
    for tower, hf, n in (("vision", "vision_model", cfg.vision.num_layers),
                         ("text", "text_model", cfg.text.num_layers)):
        lay = params[tower]["layers"]
        for i in range(n):
            base = f"{hf}.encoder.layers.{i}"
            for key, name in (("q", "self_attn.q_proj"),
                              ("k", "self_attn.k_proj"),
                              ("v", "self_attn.v_proj"),
                              ("out", "self_attn.out_proj")):
                lin = lay["attn"][key]
                sd[f"{base}.{name}.weight"] = c(lin["kernel"][i].T)
                sd[f"{base}.{name}.bias"] = c(lin["bias"][i])
            for key in ("fc1", "fc2"):
                lin = lay["mlp"][key]
                sd[f"{base}.mlp.{key}.weight"] = c(lin["kernel"][i].T)
                sd[f"{base}.mlp.{key}.bias"] = c(lin["bias"][i])
            for key, name in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
                sd[f"{base}.{name}.weight"] = c(lay[key]["scale"][i])
                sd[f"{base}.{name}.bias"] = c(lay[key]["bias"][i])
    v, t = params["vision"], params["text"]
    sd["vision_model.embeddings.class_embedding"] = c(v["class_embedding"])
    sd["vision_model.embeddings.patch_embedding.weight"] = c(
        v["patch_embedding"]["kernel"].permute(3, 2, 0, 1))
    sd["vision_model.embeddings.position_embedding.weight"] = c(
        v["position_embedding"])
    for ln, name in (("pre_layernorm", "pre_layrnorm"),  # sic, HF's name
                     ("post_layernorm", "post_layernorm")):
        sd[f"vision_model.{name}.weight"] = c(v[ln]["scale"])
        sd[f"vision_model.{name}.bias"] = c(v[ln]["bias"])
    sd["text_model.embeddings.token_embedding.weight"] = c(
        t["token_embedding"])
    sd["text_model.embeddings.position_embedding.weight"] = c(
        t["position_embedding"])
    sd["text_model.final_layer_norm.weight"] = c(
        t["final_layernorm"]["scale"])
    sd["text_model.final_layer_norm.bias"] = c(t["final_layernorm"]["bias"])
    sd["visual_projection.weight"] = c(params["visual_projection"]["kernel"].T)
    sd["text_projection.weight"] = c(params["text_projection"]["kernel"].T)
    sd["logit_scale"] = c(params["logit_scale"])
    return sd


def write_safetensors(path: str, tensors: dict) -> None:
    """A safetensors file of CPU tensors (header: dtype, shape, offsets;
    padded with spaces to 8 bytes, as the format's own writer does)."""
    import struct

    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        data = t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": ST_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)


def hf_config_json(cfg) -> dict:
    """A ``config.json`` carrying cfg's dims, as HF's CLIPConfig writes
    it."""
    t, v = cfg.text, cfg.vision
    return {
        "architectures": ["CLIPModel"], "model_type": "clip",
        "projection_dim": cfg.projection_dim,
        "logit_scale_init_value": cfg.logit_scale_init,
        "text_config": {
            "model_type": "clip_text_model", "hidden_size": t.hidden_size,
            "intermediate_size": t.intermediate_size,
            "num_hidden_layers": t.num_layers,
            "num_attention_heads": t.num_heads, "vocab_size": t.vocab_size,
            "max_position_embeddings": t.max_positions,
            "hidden_act": t.hidden_act, "layer_norm_eps": t.layer_norm_eps,
            "eos_token_id": t.eos_token_id},
        "vision_config": {
            "model_type": "clip_vision_model", "hidden_size": v.hidden_size,
            "intermediate_size": v.intermediate_size,
            "num_hidden_layers": v.num_layers,
            "num_attention_heads": v.num_heads, "image_size": v.image_size,
            "patch_size": v.patch_size, "hidden_act": v.hidden_act,
            "layer_norm_eps": v.layer_norm_eps},
    }


def write_byte_vocab(d: str) -> None:
    """A byte-level CLIP ``vocab.json``/``merges.txt``: the 256 byte
    tokens and their ``</w>`` forms, a few merges, the two specials."""
    from vlm_clip_tpu_torch.data.tokenizer import bytes_to_unicode

    toks = list(bytes_to_unicode().values())
    toks += [t + "</w>" for t in toks]
    merges = [("h", "a"), ("p", "p"), ("pp", "y</w>"), ("ha", "ppy</w>"),
              ("a", "n"), ("an", "g")]
    toks += ["".join(m) for m in merges]
    toks += ["<|startoftext|>", "<|endoftext|>"]
    with open(os.path.join(d, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({t: i for i, t in enumerate(toks)}, f, ensure_ascii=False)
    with open(os.path.join(d, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges))


def write_hf_checkpoint(d: str, params, cfg, fmt: str) -> None:
    """An HF-layout checkpoint directory: the weights (``fmt``: ``bin``,
    ``pytorch_model.bin`` by torch.save; ``safetensors``,
    ``model.safetensors`` by :func:`write_safetensors`), ``config.json``
    and a byte-level vocab."""
    os.makedirs(d, exist_ok=True)
    sd = hf_state_dict(params, cfg)
    if fmt == "bin":
        torch.save(sd, os.path.join(d, "pytorch_model.bin"))
    else:
        write_safetensors(os.path.join(d, "model.safetensors"), sd)
    with open(os.path.join(d, "config.json"), "w", encoding="utf-8") as f:
        json.dump(hf_config_json(cfg), f, indent=2)
    write_byte_vocab(d)


def write_emotic_split(d: str, split: str, n: int, seed: int) -> None:
    """A synthetic split in data/emotic_mat's npy format: uint8 224^2
    context and 128^2 body, 26-way one-hot categories (every class has a
    positive once n >= 26), VAD in [0, 10)."""
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    cat = (rng.random((n, 26)) > 0.8).astype(np.float32)
    cat[np.arange(n), np.arange(n) % 26] = 1.0
    arrays = {"context": rng.integers(0, 255, (n, 224, 224, 3), np.uint8),
              "body": rng.integers(0, 255, (n, 128, 128, 3), np.uint8),
              "cat": cat,
              "cont": (rng.random((n, 3)) * 10).astype(np.float32)}
    for name, arr in arrays.items():
        np.save(os.path.join(d, f"{split}_{name}_arr.npy"), arr)


def _same_tree(got, want, what: str) -> None:
    """Every leaf of ``got`` equals ``want``'s bit for bit."""
    from vlm_clip_tpu_torch.bridge import tree_leaves

    g, w = tree_leaves(got), tree_leaves(want)
    bad = [i for i, (a, b) in enumerate(zip(g, w))
           if a.dtype != b.dtype or a.shape != b.shape
           or not torch.equal(a, b.to(a.device))]
    if len(g) != len(w) or bad:
        raise SystemExit(f"{what}: {len(bad)} of {len(w)} tensors differ "
                         f"from the written ones (leaves {len(g)})")


def _held_forward(fn):
    """(fn(), {kernel: {calls, shapes, max_abs_err, ok}}): while fn runs,
    every K1-K3 forward call the adapters make also runs its plain
    version on the same inputs, and the kernel's output is held to it
    (TOL). The adapters see a copy of the ops module with the held
    calls; the ops module itself (whose wrappers count their launches on
    their own names) is not touched."""
    import types

    from vlm_clip_tpu_torch.models import adapters as A
    from vlm_clip_tpu_torch.ops import fused_adapter as F

    plain = {"seq_adapter_fused": F.seq_adapter_torch,
             "cross_attn_block_fused": F.cross_attn_block_torch,
             "prenorm_mlp_fused": F.prenorm_mlp_torch}
    held = {name: {"calls": 0, "shapes": [], "max_abs_err": 0.0, "ok": True}
            for name in plain}

    def holding(name):
        kernel = getattr(F, name)

        def call(*args, **kw):
            y = kernel(*args, **kw)
            want = plain[name](*args, **kw)
            atol, rtol = TOL[y.dtype]
            h = held[name]
            h["calls"] += 1
            h["shapes"].append(list(args[0].shape))
            h["max_abs_err"] = max(h["max_abs_err"], float(
                (y.float() - want.float()).abs().max()))
            h["ok"] = h["ok"] and bool(torch.isclose(
                y.float(), want.float(), atol=atol, rtol=rtol).all())
            return y
        return call

    A.F = types.SimpleNamespace(**{**vars(F), **{
        name: holding(name) for name in plain}})
    try:
        out = fn()
    finally:
        A.F = F
    return out, held


def real_weights_emotic_phase() -> dict:
    """Real weights in, then the EMOTIC workload on them, at ViT-B/16
    full width (12 + 12 layers, 768/512, projection 512), weights made
    from a seed on the card:

    1. a checkpoint directory in HF's layout, twice: pytorch_model.bin
       (torch.save) and model.safetensors (this script's writer), each
       with config.json and a byte-level vocab.json/merges.txt;
    2. cli/common.load_backbone(require_real=True) on each: every tensor
       equal to the written one bit for bit, last_backbone_was_real(),
       make_tokenizer's BPE tokenizer from the directory, the seconds;
    3. cli/smoke on the directory: a finite loss, K1-K3 forward launched;
       its forward again with each K1-K3 call held against its plain
       version (TOL), its features and loss against impl="torch" (TOL,
       STEP_TOL);
    4. cli/serve --hf-checkpoint without --allow-random-weights: three
       /classify requests, held against the in-process zero-shot on the
       same weights (CLASSIFY_ATOL), the HTTP latency;
    5. EMOTIC: cli/train_emotic (B=32, 2 epochs) on a synthetic split of
       64 train and 32 test items: a head npz and a finite test mAP, K6
       launched forward and backward (counts zeroed just before, read
       just after; the epoch seconds); one train step against
       impl="torch" from the trained head (loss 1e-5 relative, gradients
       T_STEP_TOL), K6 launching forward and backward in it, and
       evaluate_emotic's scores against impl="torch" (1e-5);
    6. cli/validate_parity --eval-only on the directory (the RAF-DB
       zero-shot and EMOTIC mAP legs, on the card): finite numbers.
    Cut: the datasets and the epochs, never the widths."""
    import shutil

    from PIL import Image

    from vlm_clip_tpu_torch.bridge import tree_leaves
    from vlm_clip_tpu_torch.cli import common, smoke, train_emotic
    from vlm_clip_tpu_torch.cli import validate_parity as VP
    from vlm_clip_tpu_torch.cli.serve import build_server
    from vlm_clip_tpu_torch.core.config import EMOTIONS, clip_preset
    from vlm_clip_tpu_torch.data import emotic as E
    from vlm_clip_tpu_torch.data.preprocess import (load_and_resize,
                                                    normalize_batch)
    from vlm_clip_tpu_torch.data.rafdb import BatchLoader
    from vlm_clip_tpu_torch.data.tokenizer import CLIPBPETokenizer
    from vlm_clip_tpu_torch.eval.emotic import (encode_category_embeddings,
                                                evaluate_emotic)
    from vlm_clip_tpu_torch.models.clip import init_clip
    from vlm_clip_tpu_torch.models.model_t import ZeroShotEmotionRecognition
    from vlm_clip_tpu_torch.ops import fused_adapter as F
    from vlm_clip_tpu_torch.train import trainer_emotic as TE
    from vlm_clip_tpu_torch.train.optim import adam

    dev = torch.device("cuda")
    work = os.path.join(REPO, "build", "chip_smoke", "real_weights")
    shutil.rmtree(work, ignore_errors=True)
    cfg = clip_preset(RW_NAME)
    written = init_clip(torch.Generator(device=dev).manual_seed(5), cfg,
                        device=dev)
    dirs = {}
    for fmt in ("bin", "safetensors"):
        d = os.path.join(work, fmt, "clip-" + RW_NAME)
        t0 = time.time()
        write_hf_checkpoint(d, written, cfg, fmt)
        dirs[fmt] = d
        size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
        print(f"real weights: wrote {d} ({size / 1e6:.1f} MB) in "
              f"{time.time() - t0:.2f}s", flush=True)

    # 2. load each through the entry point every CLI calls
    for fmt, d in dirs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, lcfg = common.load_backbone(RW_NAME, hf_checkpoint=d,
                                           require_real=True, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        _same_tree(params, written, f"load_backbone({fmt})")
        if not common.last_backbone_was_real() or lcfg != cfg:
            raise SystemExit(f"load_backbone({fmt}): not real weights")
        tok = common.make_tokenizer(lcfg)
        want = CLIPBPETokenizer.from_files(os.path.join(d, "vocab.json"),
                                           os.path.join(d, "merges.txt"))
        if not isinstance(tok, CLIPBPETokenizer) \
                or tok.encode("a happy angry face") \
                != want.encode("a happy angry face"):
            raise SystemExit(f"make_tokenizer({fmt}): not the directory's "
                             f"BPE vocab ({type(tok).__name__})")
        print(f"real weights: load_backbone({fmt}) {secs:.3f}s for "
              f"{len(tree_leaves(params))} tensors, bit for bit; tokenizer "
              f"{type(tok).__name__} from the directory on {card()}",
              flush=True)
    ckpt = dirs["safetensors"]
    clip = params

    # 3. cli/smoke on the loaded backbone: K1-K3 forward
    F.reset_launch_counts()
    out = smoke.main(["--clip-model-name", ckpt, "--device", "cuda"])
    counts = {fn.__name__: fn.launches for fn in F.FORWARD}
    print(f"real weights: cli/smoke loss {out['loss']:.4f}, launches "
          f"{counts}", flush=True)
    if not np.isfinite(out["loss"]) or min(counts.values()) < 1:
        raise SystemExit("cli/smoke on real weights: bad loss or a K1-K3 "
                         "forward never launched")
    # K1-K3 at the smoke's own shapes (B=1, adapters of width 32, the
    # shared block at 4 heads of 128) against their plain versions: each
    # kernel call of the forward on the same inputs, then the features
    # and the loss against the forward with impl="torch"
    s = smoke.build(ckpt, dev)
    got, held = _held_forward(lambda: smoke.forward(s, "auto"))
    want = smoke.forward(s, "torch")
    atol, rtol = TOL[torch.bfloat16]
    errs = {k: float((getattr(got, k).float()
                      - getattr(want, k).float()).abs().max())
            for k in ("text_features", "image_features")}
    ok = all(bool(torch.isclose(getattr(got, k).float(),
                                getattr(want, k).float(), atol=atol,
                                rtol=rtol).all()) for k in errs)
    d_loss = abs(float(got.loss) - float(want.loss))
    ok = ok and d_loss <= STEP_TOL["loss"] \
        and all(h["calls"] >= 1 and h["ok"] for h in held.values())
    print(f"real weights: cli/smoke's forward, each kernel call vs its "
          f"plain version on the same inputs {held}; features vs "
          f"impl=torch max abs err {errs} (atol {atol}, rtol {rtol}), loss "
          f"{float(got.loss):.6f} / {float(want.loss):.6f} (limit "
          f"{STEP_TOL['loss']}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("cli/smoke's forward disagrees with impl='torch'")

    # 4. serving real weights: no --allow-* flag
    server = build_server(["--port", "0", "--device", "cuda",
                           "--clip-model-name", RW_NAME,
                           "--hf-checkpoint", ckpt])
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    bodies = [_jpeg(20 + i, size) for i, size in
              enumerate([(224, 224), (260, 200), (150, 190)])]
    served, lat = [], []
    try:
        for body in bodies:
            res, ms = _post(port, "/classify", body)
            served.append(np.asarray([res["probs"][e] for e in EMOTIONS]))
            lat.append(ms)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    S = cfg.vision.image_size
    with torch.inference_mode():
        zs = ZeroShotEmotionRecognition(clip, cfg, common.make_tokenizer(cfg))
        for i, body in enumerate(bodies):
            u8 = np.zeros((8, S, S, 3), np.uint8)  # the served batch
            u8[0] = load_and_resize(Image.open(io.BytesIO(body)), S)
            want = zs.predict(normalize_batch(torch.from_numpy(u8).to(
                dev))).float().cpu().numpy()[0]
            d = float(np.abs(want - served[i]).max())
            ok = np.isfinite(served[i]).all() and d <= CLASSIFY_ATOL
            print(f"real weights: /classify[{i}] vs in-process zero-shot: "
                  f"max abs diff {d:.3e} (limit {CLASSIFY_ATOL}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise SystemExit("/classify on real weights disagrees with "
                                 "the in-process zero-shot")
    print(f"real weights: /classify latency mean {np.mean(lat):.2f} ms, min "
          f"{np.min(lat):.2f} ms over {len(lat)} requests (mode "
          f"{server.mode}) on {card()}", flush=True)

    # 5. EMOTIC through the entry point, then its kernels against plain
    data = os.path.join(work, "emotic")
    write_emotic_split(data, "train", 64, seed=6)
    write_emotic_split(data, "test", 32, seed=7)
    head_path = os.path.join(work, "emotic_head.npz")
    os.environ["VLM_CLIP_LOG_DIR"] = os.path.join(work, "logs")
    F.reset_launch_counts()
    res = train_emotic.main(["--data-dir", data, "--clip-model-name", ckpt,
                             "--batch-size", "32", "--num-epochs", "2",
                             "--output", head_path, "--device", "cuda"])
    launches = F.launch_counts(F.T_KERNELS)
    mAP = res["eval"]["mAP"]
    print(f"real weights: cli/train_emotic losses {res['losses']}, epoch "
          f"seconds {[round(s, 4) for s in res['epoch_seconds']]}, test mAP "
          f"{mAP:.4f} over {res['eval']['num_samples']}, K6 launches "
          f"{launches} on {card()}", flush=True)
    if not (os.path.isfile(head_path) and np.isfinite(mAP)
            and np.isfinite(res["losses"]).all()
            and min(launches.values()) >= 1):
        raise SystemExit("cli/train_emotic: no head, a non-finite mAP or "
                         "loss, or K6 never launched")
    head = TE.load_emotic_head(head_path, device=dev)
    tok = common.make_tokenizer(cfg)
    train_ds = E.EmoticPreDataset.from_dir(data, "train")
    cat_emb = encode_category_embeddings(clip, cfg, tok)
    feats = TE.encode_all_contexts(clip, cfg, train_ds)[:32]
    items = [train_ds[i] for i in range(32)]
    cats = torch.from_numpy(np.stack([it[2] for it in items])).to(dev)
    vads = torch.from_numpy(np.stack([it[3] for it in items])).to(dev)
    valid = torch.ones(32, dtype=torch.bool, device=dev)
    valid[-3:] = False  # a masked tail, as the trainer's last batch

    def one_step(impl):
        params = _clone(head)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        tx = adam(3e-4)
        step = TE.make_emotic_train_step(tx, 0.2, 100.0, 0.5, impl)
        loss = step(params, tx.init(leaves), 0, feats, cats, vads, valid,
                    cat_emb)
        return float(loss), [p.grad.clone() for p in leaves]

    F.reset_launch_counts()
    loss_k, grads_k = one_step("auto")
    step_launches = F.launch_counts(F.T_KERNELS)
    loss_p, grads_p = one_step("torch")
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    rel_grad = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(grads_k, grads_p))
    ok = rel_loss <= EMOTIC_TOL["loss"] and rel_grad <= EMOTIC_TOL["grad"] \
        and min(step_launches.values()) >= 1
    print(f"real weights: EMOTIC step vs impl=torch: loss {loss_k:.6f} / "
          f"{loss_p:.6f} (relative {rel_loss:.2e}, limit "
          f"{EMOTIC_TOL['loss']}), gradients relative {rel_grad:.2e} (limit "
          f"{EMOTIC_TOL['grad']}); the step's K6 launches "
          f"{step_launches} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"the EMOTIC step disagrees with impl='torch' or "
                         f"missed a K6 kernel: loss relative {rel_loss:.2e},"
                         f" gradients relative {rel_grad:.2e}, K6 "
                         f"launches {step_launches}")
    test_ds = E.EmoticPreDataset.from_dir(data, "test")
    scores = {}
    for impl in ("auto", "torch"):
        loader = BatchLoader(test_ds, batch_size=32,
                             collate_fn=E.emotic_collate)
        scores[impl] = evaluate_emotic(clip, cfg, tok, loader,
                                       adapter_params=head, alpha=0.2,
                                       impl=impl)
    d = float(np.abs(scores["auto"]["scores"]
                     - scores["torch"]["scores"]).max())
    print(f"real weights: evaluate_emotic scores vs impl=torch: max abs "
          f"diff {d:.3e} (limit {EMOTIC_TOL['scores']}), mAP "
          f"{scores['auto']['mAP']:.6f} / {scores['torch']['mAP']:.6f}",
          flush=True)
    if not d <= EMOTIC_TOL["scores"]:
        raise SystemExit("evaluate_emotic disagrees with impl='torch'")

    # 6. validate_parity's card legs: the entry point on the directory
    rafdb = os.path.join(work, "rafdb")
    VP._fixture_rafdb_tree(rafdb, cfg.vision.image_size)
    md = os.path.join(work, "parity.md")
    rc = VP.main(["--clip", ckpt, "--eval-only", "--rafdb", rafdb,
                  "--emotic-npy", data, "--append", md])
    with open(md, encoding="utf-8") as f:
        block = f.read()
    legs = json.loads(block[block.index("```json") + 7:block.rindex("```")])
    zs_res, map_res = legs["rafdb-zeroshot"], legs["emotic-mAP"]
    print(f"real weights: validate_parity --eval-only rc {rc}: "
          f"rafdb-zeroshot {zs_res}, emotic-mAP {map_res}; the CLIP and "
          "Qwen logit legs need transformers, which this machine lacks: "
          "they ran only in the CPU tests "
          "(tests/test_torch_validate_parity.py)", flush=True)
    if rc != 0 or zs_res["num_images"] != 14 or zs_res["tokenizer_degraded"] \
            or not (np.isfinite(zs_res["accuracy"])
                    and np.isfinite(map_res["mAP"])):
        raise SystemExit("validate_parity's card legs gave no finite result")
    return launches


# BASELINE config 5 in the data_paths phase: cli/bench_label_finetune at
# ViT-L/14-336, B=32, 16 images a class (112 train images: 3 steps an
# epoch), 2 epochs, stub labels, seeded weights; then its device-resident
# rate over 20 steps after 1 warmup step. Cut: the dataset and the
# epochs, not the widths.
C5_B, C5_PER_CLASS, C5_EPOCHS, C5_RESIDENT = 32, 16, 2, 20
C5_STEPS = C5_EPOCHS * (7 * C5_PER_CLASS // C5_B) + 1 + C5_RESIDENT
# calls a config-5 step makes of each M kernel: K1 on the text and the
# vision rows, K3 once for each of the 2 shared layers, forward and
# backward; K2 none (Tk = 577 is past its 256 shared rows: plain, as in
# the reference); and K5 once a frozen tower layer (24 vision, 12 text)
C5_CALLS = {"seq_adapter_fused": 2, "seq_adapter_bwd_cuda": 2,
            "prenorm_mlp_fused": 2, "prenorm_mlp_bwd_cuda": 2,
            "cross_attn_block_fused": 0, "cross_attn_block_bwd_cuda": 0}
C5_K5_CALLS = 24 + 12
# config 4's video: 64 frames at 480x640 made from a seed (the scorer's
# checks), cli/bench_video --no-demux over 256 (its rates)
VIDEO_FRAMES, VIDEO_HW, VIDEO_BENCH_FRAMES = 64, (480, 640), 256


def _native_loader_rate(work: str) -> None:
    """(a) The C++ batch decoder, built at first use into build/: 64
    synthetic 448x448 JPEGs decoded at 336, its images/s beside
    data/preprocess.load_and_resize's (PIL); where it does not build, the
    line says why and the decode runs on PIL."""
    from PIL import Image

    from vlm_clip_tpu_torch.data import native_loader as NL
    from vlm_clip_tpu_torch.data.preprocess import load_and_resize

    d = os.path.join(work, "jpegs")
    os.makedirs(d)
    rng = np.random.default_rng(11)
    paths = []
    for i in range(64):
        p = os.path.join(d, f"{i:02d}.jpg")
        Image.fromarray(rng.integers(0, 255, (56, 56, 3), dtype=np.uint8)
                        ).resize((448, 448)).save(p, quality=90)
        paths.append(p)
    t0 = time.perf_counter()
    for p in paths:
        load_and_resize(p, 336)
    pil_rate = len(paths) / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ok = NL.native_available()
    built = time.perf_counter() - t0
    if not ok:
        print(f"data_paths native loader: unavailable "
              f"({NL.unavailable_reason()}); decoder route PIL: 64 448x448 "
              f"JPEGs at 336 -> {pil_rate:.1f} img/s", flush=True)
        return
    NL.load_batch_native(paths[:8], 336)
    t0 = time.perf_counter()
    NL.load_batch_native(paths, 336)
    rate = len(paths) / (time.perf_counter() - t0)
    print(f"data_paths native loader: built {NL.library_path()} with g++ "
          f"and libjpeg ({built:.1f}s); decoder route native "
          f"({os.cpu_count()} threads): 64 448x448 JPEGs at 336 -> "
          f"{rate:.1f} img/s (PIL {pil_rate:.1f})", flush=True)


def _cancelling_grads(cfg, acfg, tx, clip, adapters, batch) -> None:
    """On config 5's own batch under FAST: each path's worst adapter
    gradient (Frobenius, relative to at least 1e-2 of the global norm, as
    _step_pair holds them) against the plain versions' FP32 step, the
    kernels' beside the plain versions' own. Printed, not held."""
    from vlm_clip_tpu_torch.bridge import tree_leaves
    from vlm_clip_tpu_torch.core.dtypes import FAST, FP32

    def grads(impl, policy):
        state, step = _fresh_step(cfg, acfg, tx, clip, adapters, impl,
                                  False, policy)
        state, m = step(state, batch)
        return [p.grad.detach().float().clone()
                for p in tree_leaves(state.adapter_params)], m

    want, m = grads("torch", FP32)
    floor = 1e-2 * float(m.grad_norm)
    worst = {}
    for impl in ("auto", "torch"):
        got, _ = grads(impl, FAST)
        worst[impl] = max(float((a - b).norm()) / max(float(b.norm()), floor)
                          for a, b in zip(got, want))
    print(f"config 5 step, its batch, FAST against the plain FP32 step "
          f"(loss {float(m.loss):.6f}, grad norm {float(m.grad_norm):.6f}): "
          f"worst adapter gradient kernels {worst['auto']:.3e}, plain "
          f"versions {worst['torch']:.3e}", flush=True)


def _config5_check(work: str) -> dict:
    """(b) BASELINE config 5 through cli/bench_label_finetune (its rates
    printed there): K1's and K3's launches must equal C5_STEPS x the
    calls a step (C5_CALLS), K2's and K4's 0, K5's C5_STEPS x C5_K5_CALLS
    (counts zeroed just before, read just after); one step with the
    kernels held against impl="torch" from the trained state on the same
    batch (STEP_TOL), twice: on config 5's own batch under FP32, and
    under FAST (config 5's policy) on its pixels with random caption
    ids. Its captions all start with the same BOS
    token, so CLS-slice pooling (the reference's quirk) gives every row
    the same text feature and the loss is ln 32 to 3 digits: the adapter
    gradients are what is left of sums that nearly cancel, so under FAST
    on that batch the worst adapter gradient of each path, the kernels'
    and the plain versions', is printed against the plain FP32 step's
    (_cancelling_grads), not held. Returns the launches."""
    from vlm_clip_tpu_torch.cli import bench_label_finetune as BLF
    from vlm_clip_tpu_torch.ops import attention as K5
    from vlm_clip_tpu_torch.ops import contrastive as K4
    from vlm_clip_tpu_torch.ops import fused_adapter as F
    from vlm_clip_tpu_torch.train import optim

    F.reset_launch_counts()
    K4.reset_launch_counts()
    K5.reset_launch_counts()
    out = BLF.main(["--model", "vit-large-patch14-336", "--batch",
                    str(C5_B), "--per-class", str(C5_PER_CLASS), "--epochs",
                    str(C5_EPOCHS), "--tmpdir", os.path.join(work, "config5"),
                    "--device", "cuda"])
    torch.cuda.synchronize()
    counts = F.launch_counts(F.M_KERNELS)
    want = {k: C5_STEPS * v for k, v in C5_CALLS.items()}
    others = {**K4.launch_counts(), **K5.launch_counts()}
    ok = out["steps"] == C5_STEPS and counts == want and others == {
        "contrastive_loss_fused": 0, "contrastive_loss_bwd_cuda": 0,
        "fused_attention": C5_STEPS * C5_K5_CALLS}
    print(f"config 5: bench_label_finetune, {C5_STEPS} steps; launches "
          f"{counts} (want {want}; K4, K5 {others}) "
          f"{'ok' if ok else 'FAIL'}; losses "
          f"{[round(v, 4) for v in out['losses']]}", flush=True)
    if not ok or not all(np.isfinite(out["losses"])):
        raise SystemExit("config 5: launches or losses not as predicted")
    from vlm_clip_tpu_torch.core.dtypes import FP32

    tr = out["trainer"]
    args = (tr.cfg, tr.acfg, optim.adam(3e-4), tr.state.clip_params,
            tr.state.adapter_params)
    _step_pair(*args, out["batch"], False, f"config 5 step ViT-L/14-336 "
               f"B={C5_B}, its batch, FP32", policy=FP32)
    _cancelling_grads(*args, out["batch"])
    gen = torch.Generator(device="cuda").manual_seed(14)
    ids = torch.randint(1, tr.cfg.text.vocab_size, (C5_B, 77),
                        generator=gen, device="cuda")
    _step_pair(*args, {**out["batch"], "input_ids": ids,
                       "attention_mask": torch.ones_like(ids)}, False,
               f"config 5 step ViT-L/14-336 B={C5_B}, its pixels, random "
               f"caption ids, FAST")
    return counts


def _resume_check(work: str) -> None:
    """(c) Full train-state resume at bench.py's step (ViT-B/16, adapters
    256/256/2, FAST, Adam 3e-4, B=96; four fixed random batches): 2
    steps, save_full_state(wait=False), a third step while the save is in
    flight, finish_saves, a fresh trainer (other random adapters)
    restored from the file, the third step again and a fourth: losses,
    adapter params and Adam's moments bit for bit those of 4
    uninterrupted steps."""
    from vlm_clip_tpu_torch.bridge import tree_leaves
    from vlm_clip_tpu_torch.core.config import AdapterConfig, clip_preset
    from vlm_clip_tpu_torch.core.dtypes import FAST
    from vlm_clip_tpu_torch.models.clip import init_clip
    from vlm_clip_tpu_torch.train.trainer_m import CLIPAdapterTrainer

    dev = torch.device("cuda")
    cfg = clip_preset("vit-base-patch16")
    acfg = AdapterConfig(text_adapter_size=256, vision_adapter_size=256,
                         shared_adapter_layers=2)
    gen = torch.Generator(device=dev).manual_seed(6)
    clip = init_clip(gen, cfg, device=dev)
    batches = [{
        "input_ids": torch.randint(1, cfg.text.vocab_size, (B, 77),
                                   generator=gen, device=dev),
        "attention_mask": torch.ones(B, 77, dtype=torch.int32, device=dev),
        "pixel_values": torch.randn(
            B, 3, cfg.vision.image_size, cfg.vision.image_size,
            generator=gen, device=dev).to(torch.bfloat16)}
        for _ in range(4)]

    def trainer(seed):
        return CLIPAdapterTrainer(
            clip, cfg, acfg, batches, learning_rate=3e-4, weight_decay=0.0,
            max_grad_norm=None, schedule="constant", policy=FAST, seed=seed,
            output_dir=os.path.join(work, f"resume{seed}"))

    def run(tr, bs):
        out = []
        for b in bs:
            tr.state, m = tr._step(tr.state, b)
            out.append(float(m.loss))
        return out

    def state(tr):
        return tree_leaves(tr.state.adapter_params) + [
            t for s in tr.state.opt_state.state.values()
            for t in s.values()]

    whole = trainer(0)
    want = run(whole, batches)
    first = trainer(0)
    got = run(first, batches[:2])
    path = os.path.join(work, "train_state.pt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first.save_full_state(path, wait=False)
    t_call = time.perf_counter() - t0
    inflight = run(first, batches[2:3])
    first.finish_saves()
    t_done = time.perf_counter() - t0
    fresh = trainer(1)
    fresh.restore_full_state(path)
    got += run(fresh, batches[2:])
    same = got == want and inflight == want[2:3] \
        and fresh.state.step == whole.state.step == 4 \
        and all(torch.equal(a, b) for a, b in zip(state(fresh), state(whole)))
    print(f"resume (ViT-B/16, B={B}, FAST, Adam 3e-4): losses "
          f"{got} against uninterrupted {want}; the step during the save "
          f"{inflight}; params and moments bit for bit: {same}; the save "
          f"({os.path.getsize(path) / 1e6:.1f} MB) returned in "
          f"{t_call * 1e3:.1f} ms and was on disk {t_done:.2f}s after",
          flush=True)
    if not same:
        raise SystemExit("resume: the restored trainer does not continue "
                         "bit for bit")


def _video_check() -> None:
    """(d) Config 4's scorer at ViT-B/16 full width under BF16 on 64
    uint8 480x640 frames made from a seed: score_video_frames_raw with K5
    on, then off (K5 launches once a tower layer with it on, never off);
    rows finite and summing to 1 within 1e-3; held (ENCODE_TOL on the
    probability rows) against the plain version (K5 off) and against
    score_video_frames on the frames after the port's own shortest-edge
    resize and crop; cli/bench_video --no-demux's chip-only and
    device-resident frames/s; then the uint8 folded tower against the
    normalize-then-tower path on the cropped frames (ENCODE_TOL on the
    unit-norm features)."""
    from vlm_clip_tpu_torch.cli import bench_video
    from vlm_clip_tpu_torch.core.config import clip_preset
    from vlm_clip_tpu_torch.core.dtypes import BF16
    from vlm_clip_tpu_torch.data import video as V
    from vlm_clip_tpu_torch.data.preprocess import normalize_batch
    from vlm_clip_tpu_torch.models import clip as C
    from vlm_clip_tpu_torch.models.clip import init_clip
    from vlm_clip_tpu_torch.models.layers import l2_normalize
    from vlm_clip_tpu_torch.ops import attention as K5
    from vlm_clip_tpu_torch.ops.image import resize_center_crop

    dev = torch.device("cuda")
    cfg = clip_preset("vit-base-patch16")
    params = init_clip(torch.Generator(device=dev).manual_seed(7), cfg,
                       device=dev)
    rng = np.random.default_rng(13)
    frames = rng.integers(0, 256, (VIDEO_FRAMES, *VIDEO_HW, 3),
                          dtype=np.uint8)
    emb = rng.normal(size=(7, cfg.projection_dim)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    size = cfg.vision.image_size

    def close(a, b):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
        return float((a - b).abs().max()), float(cos.min())

    probs, launches = {}, {}
    for on in (True, False):
        with _k5_off(not on):
            K5.reset_launch_counts()
            probs[on] = V.score_video_frames_raw(params, cfg, frames, emb,
                                                 policy=BF16, size=size)
            torch.cuda.synchronize()
            launches[on] = K5.fused_attention.launches
            print(f"video: cli/bench_video --no-demux with K5 "
                  f"{'on' if on else 'off'}:", flush=True)
            bench_video.main(["--no-demux", "--frames",
                              str(VIDEO_BENCH_FRAMES), "--batch",
                              str(VIDEO_FRAMES), "--height",
                              str(VIDEO_HW[0]), "--width", str(VIDEO_HW[1]),
                              "--size", str(size), "--device", "cuda"])
    with torch.no_grad():
        crop = resize_center_crop(torch.from_numpy(frames).to(dev), size)
    host = V.score_video_frames(params, cfg, crop.cpu().numpy(), emb,
                                policy=BF16, stats="imagenet")
    sums = max(float(np.abs(p.sum(-1) - 1).max()) for p in probs.values())
    finite = all(np.isfinite(p).all() for p in probs.values())
    vs_plain, vs_host = close(probs[True], probs[False]), \
        close(probs[True], host)
    u8 = crop.round().clamp(0, 255).to(torch.uint8)
    folded = dict(params)
    folded["vision"] = C.fold_image_normalization(params["vision"])
    with torch.no_grad():
        a = l2_normalize(C.get_image_features_u8(folded, u8, cfg,
                                                 BF16)).float()
        b = l2_normalize(C.get_image_features(params, normalize_batch(u8),
                                              cfg, BF16)).float()
    vs_fold = close(a, b)
    want_k5 = cfg.vision.num_layers
    ok = finite and sums <= 1e-3 and launches == {True: want_k5, False: 0} \
        and all(m <= ENCODE_TOL["max_abs"] and c >= ENCODE_TOL["cosine"]
                for m, c in (vs_plain, vs_host, vs_fold))
    print(f"video ViT-B/16 BF16, {VIDEO_FRAMES} frames {VIDEO_HW}: rows "
          f"finite {finite}, |sum - 1| <= {sums:.2e}; K5 launches "
          f"{launches}; (max abs diff, least cosine) K5 on vs off "
          f"{vs_plain}, raw vs host resize {vs_host}, uint8 folded tower vs "
          f"normalize-then-tower {vs_fold} (limits {ENCODE_TOL}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("video: the scorer disagrees")


def data_paths_phase() -> dict:
    """The CLIP data path and BASELINE configs 4-5 on the card:
    (a) the native loader's rate (_native_loader_rate), (b) config 5
    (_config5_check), (c) full train-state resume (_resume_check), (d)
    config 4's video scorer and the uint8 folded tower (_video_check).
    Returns config 5's launches of the M kernels."""
    import shutil

    work = os.path.join(REPO, "build", "chip_smoke", "data_paths")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.time()
    _native_loader_rate(work)
    t_a = time.time()
    counts = _config5_check(work)
    t_b = time.time()
    _resume_check(work)
    t_c = time.time()
    _video_check()
    print(f"data_paths: native loader {t_a - t0:.1f}s, config 5 "
          f"{t_b - t_a:.1f}s, resume {t_c - t_b:.1f}s, video "
          f"{time.time() - t_c:.1f}s", flush=True)
    return counts


class _Words:
    """A word-level stand-in for the Qwen tokenizer (no tokenizer.json is
    in the repository): one id below the special tokens per word."""

    def encode(self, text):
        import zlib

        return [zlib.crc32(w.encode()) % 150000 for w in text.split()]


def _qwen_prompt(cfg=None) -> np.ndarray:
    """The extractor's prompt ids around 256 vision tokens (a 448x448
    image), from the word-level stand-in tokenizer."""
    from vlm_clip_tpu_torch.vlm.extractor import VLM_PROMPT
    from vlm_clip_tpu_torch.vlm.qwen_model import qwen25vl_3b
    from vlm_clip_tpu_torch.vlm.qwen_process import build_prompt_ids

    return build_prompt_ids(_Words(), VLM_PROMPT, 256, cfg or qwen25vl_3b())


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) / float(b.abs().max())


def _forwards(out) -> int:
    """Decode forwards a generation ran: one per step after the first,
    up to the step where every row had stopped."""
    steps = VLM_NEW if any(len(o) == VLM_NEW for o in out) \
        else max(len(o) for o in out) + 1
    return steps - 1


@contextlib.contextmanager
def _k8_off(off: bool = True):
    """K8 off for a comparison: the dispatcher's gate answers False, so
    the decode path takes the plain attention while K7 stays on, and the
    generators decode eagerly (a captured decode graph keeps the route
    it was captured with). The port has no such option; only these
    measurements need one."""
    from vlm_clip_tpu_torch.ops import decode_attention as K8
    from vlm_clip_tpu_torch.vlm.qwen import QwenVLGenerator

    gate, graph_for = K8.kernel_route, QwenVLGenerator._graph_for
    if off:
        K8.kernel_route = lambda q, k_old: False
        QwenVLGenerator._graph_for = lambda self, cache: None
    try:
        yield
    finally:
        K8.kernel_route = gate
        QwenVLGenerator._graph_for = graph_for


@contextlib.contextmanager
def _k5_off(off: bool = True):
    """K5 off for a comparison: ``layers.fused_route`` answers False, so
    mha takes the unfused branch where the frozen towers would take K5 by
    themselves (and where the toggle would force it). The port has no
    such option; only these comparisons need one."""
    from vlm_clip_tpu_torch.models import layers as LY

    route = LY.fused_route
    if off:
        LY.fused_route = lambda *args: False
    try:
        yield
    finally:
        LY.fused_route = route


@contextlib.contextmanager
def _int8_off(off: bool = True):
    """The int8 GEMM off for a comparison: quant_matmul routes the rows it
    would take to its plain twin, and the generators decode eagerly (a
    captured decode graph keeps the route it was captured with)."""
    from vlm_clip_tpu_torch.ops import quant as K7
    from vlm_clip_tpu_torch.vlm.qwen import QwenVLGenerator

    route, graph_for = K7.int8_route, QwenVLGenerator._graph_for
    if off:
        K7.int8_route = lambda M, device_type: (
            "plain" if route(M, device_type) == "kernel"
            else route(M, device_type))
        QwenVLGenerator._graph_for = lambda self, cache: None
    try:
        yield
    finally:
        K7.int8_route = route
        QwenVLGenerator._graph_for = graph_for


def _decode_breakdown(g, ids, visions, tcfg,
                      route="int8 route (the int8 GEMM)") -> None:
    """Where a decode step's time goes (B=8, the kernel path with K8 on
    and off): the times of one layer's four quantized linears (``route``
    names their matmul) times the layers, and a decode step's time, its
    device busy share, launches and largest kernels."""
    from vlm_clip_tpu_torch.vlm import qwen_model as QM

    lp = QM.layer(g.params["text"]["layers"], 0)
    H, inter = tcfg.hidden_size, tcfg.intermediate_size
    nq = (tcfg.num_heads + 2 * tcfg.num_kv_heads) * tcfg.head_dim
    x = torch.randn(len(visions), 1, H, device=g.device).to(torch.bfloat16)
    xi = torch.randn(len(visions), 1, inter,
                     device=g.device).to(torch.bfloat16)
    xo = x[..., :tcfg.num_heads * tcfg.head_dim]
    ms = {name: _timed(lambda: QM.linear(w, a), 20) for name, w, a in (
        (f"qkv [{H}, {nq}]", lp["attn"]["qkv"], x),
        (f"o [{xo.shape[-1]}, {H}]", lp["attn"]["o"], xo),
        (f"gateup [{H}, {2 * inter}]", lp["mlp"]["gateup"], x),
        (f"down [{inter}, {H}]", lp["mlp"]["down"], xi))}
    print(f"{route}, one layer "
          f"at M={len(visions)}: { {k: round(v, 4) for k, v in ms.items()} }"
          f" ms; x {tcfg.num_layers} layers = "
          f"{sum(ms.values()) * tcfg.num_layers:.2f} ms a step", flush=True)
    for on in (True, False):
        with _k8_off(not on):
            l0, cache, T, delta = g.prefill_batch(ids, visions)
            tok = l0.argmax(-1)

            def step_fn():
                return g._decode_step(tok, T + delta, cache, T)

            step_fn()  # a first step captures the decode graph
            step = _timed(step_fn, 2)
            per = _profiled(step_fn, 2)
            busy = sum(v[0] for v in per.values())
            top = sorted(((round(v[0], 3), round(v[1]), n[:60])
                          for n, v in per.items()), reverse=True)[:8]
            print(f"decode step profile, K8 {'on' if on else 'off'}: "
                  f"{step:.2f} ms a step by events, device busy "
                  f"{busy:.2f} ms ({100 * busy / step:.1f}%), "
                  f"{sum(v[1] for v in per.values()):.0f} kernel launches; "
                  f"largest (ms a step, launches, name): {top}", flush=True)
            del cache


def vlm_phase() -> dict:
    """cli/check_decode_attn; then Qwen2.5-VL-3B at full width under
    8h4: generate_batch_from_ids through the kernels (K8 off, on; int8
    cache at B=16) and the plain versions, logits and first tokens
    held."""
    import dataclasses

    from vlm_clip_tpu_torch.cli import check_decode_attn
    from vlm_clip_tpu_torch.ops import decode_attention as K8
    from vlm_clip_tpu_torch.ops import quant as K7
    from vlm_clip_tpu_torch.vlm import qwen_model as QM
    from vlm_clip_tpu_torch.vlm.qwen import QwenVLGenerator
    from vlm_clip_tpu_torch.vlm.qwen_convert import (
        MIXED_DECODE_BITS, fold_qwen_patch_normalization,
        quantize_qwen_params)
    from vlm_clip_tpu_torch.vlm.qwen_process import prepare_vision_inputs

    check_decode_attn.main()
    dev = torch.device("cuda")
    t0 = time.time()
    cfg = QM.qwen25vl_3b()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {"text": QM.init_text(gen, cfg.text, device=dev),
              "vision": QM.init_vision(gen, cfg.vision, device=dev)}
    params["vision"] = fold_qwen_patch_normalization(params["vision"],
                                                     cfg.vision)
    qparams = quantize_qwen_params(params, 8, head_bits=4, fuse_decode=True)
    # the mixed preset (int4 text gate/up: K7 on every layer's gateup)
    mixed = quantize_qwen_params(params, MIXED_DECODE_BITS, head_bits=4,
                                 fuse_decode=True)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, tie_word_embeddings=False))
    print(f"Qwen2.5-VL-3B under 8h4 on the card in {time.time() - t0:.1f}s "
          f"({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB)", flush=True)
    rng = np.random.default_rng(0)
    visions = [prepare_vision_inputs(
        rng.integers(0, 255, (448, 448, 3), dtype=np.uint8), cfg.vision,
        fixed_resolution=448, raw_uint8=True) for _ in range(8)]
    ids = _qwen_prompt(cfg)

    def generator(impl="auto", kv_bits=16, params=qparams):
        g = QwenVLGenerator(params, cfg, max_len=768, kv_bits=kv_bits,
                            impl=impl)
        g.u8_patches = True
        return g

    gk, gp = generator(), generator("torch")
    torch.cuda.reset_peak_memory_stats()
    # 1. prefill and first-step logits: kernels (K8 off, on; the int8
    # GEMM off), plain
    logits = {}
    for name, g, on, int8 in (("off", gk, False, True),
                              ("off, int8 off", gk, False, False),
                              ("on", gk, True, True),
                              ("plain", gp, True, True)):
        with _k8_off(not on), _int8_off(not int8):
            l0, cache, T, delta = g.prefill_batch(ids, visions)
            l1, _ = g._decode_step(l0.argmax(-1), T + delta, cache, T)
            logits[name] = (l0, l1)
            del cache
    d = {"prefill K7 vs plain": _rel(logits["off"][0],
                                     logits["plain"][0]),
         "step 1 K7 vs plain (K8 off, int8 GEMM off)": _rel(
             logits["off, int8 off"][1], logits["plain"][1]),
         "step 1 int8 GEMM on vs off (K8 off)": _rel(
             logits["off"][1], logits["off, int8 off"][1]),
         "step 1 K8 on vs off": _rel(logits["on"][1], logits["off"][1])}
    first = [logits[n][0].argmax(-1) for n in ("off", "on", "plain")]
    first += [logits[n][1].argmax(-1) for n in ("off", "off, int8 off")]
    ok = d["prefill K7 vs plain"] <= VLM_TOL["k7"] \
        and d["step 1 K7 vs plain (K8 off, int8 GEMM off)"] \
        <= VLM_TOL["k7"] \
        and d["step 1 int8 GEMM on vs off (K8 off)"] <= VLM_TOL["int8"] \
        and d["step 1 K8 on vs off"] <= VLM_TOL["k8"] \
        and all(torch.equal(first[0], f) for f in first[1:3]) \
        and torch.equal(first[3], first[4]) \
        and all(bool(torch.isfinite(v).all()) for p in logits.values()
                for v in p)
    print(f"Qwen2.5-VL-3B 8h4 B=8 T={T}: logits max|diff| / max|logit| "
          f"{d} (limits {VLM_TOL}); first tokens equal: "
          f"{all(torch.equal(first[0], f) for f in first[1:3])}, step 1 "
          f"int8 GEMM on vs off {torch.equal(first[3], first[4])} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("the VLM's kernel path disagrees with the "
                         "plain path")
    del logits

    _decode_breakdown(gk, ids, visions, cfg.text)

    # 2. timed generations: vision + prefill alone (1 token), then
    # VLM_NEW tokens; host clock to a synchronize
    runs, counts, forwards, ms_token = {}, {}, {}, {}
    for name, g, on, visions_b in (
            ("kernels, K8 off", gk, False, visions),
            ("kernels, K8 on", gk, True, visions),
            ("plain", gp, True, visions),
            ("kernels, K8 on, int8 cache, B=16", generator(kv_bits=8),
             True, visions * 2),
            ("kernels, K8 on, mixed preset", generator(params=mixed),
             True, visions)):
        with _k8_off(not on):
            g.generate_batch_from_ids(ids, visions_b, max_new_tokens=2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g.generate_batch_from_ids(ids, visions_b, max_new_tokens=1)
            torch.cuda.synchronize()
            t_pf = time.perf_counter() - t0
            K7.reset_launch_counts()
            K8.reset_launch_counts()
            t0 = time.perf_counter()
            out = g.generate_batch_from_ids(ids, visions_b,
                                            max_new_tokens=VLM_NEW)
            torch.cuda.synchronize()
            t_all = time.perf_counter() - t0
            counts[name] = {**K7.launch_counts(), **K8.launch_counts()}
            n_fwd = forwards[name] = _forwards(out)
            ms_tok = ms_token[name] = (t_all - t_pf) * 1e3 / n_fwd
            runs[name] = out
            print(f"generate {name}: vision + prefill {t_pf * 1e3:.1f} ms, "
                  f"decode {ms_tok:.2f} ms/token ({n_fwd} forwards), "
                  f"{len(visions_b) * 1e3 / ms_tok:.1f} tokens/s; launches "
                  f"{counts[name]}", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    path = counts["kernels, K8 on"]
    # mixed: K7 on the head and, at decode rows, every layer's gateup
    L = cfg.text.num_layers
    n_fwd = counts["kernels, K8 on, mixed preset"][
        "decode_attention_kernel"] // L
    wide = mixed["text"]["layers"]["mlp"]["gateup"].qweight.shape[-1] \
        >= 4 * 1024
    # one K8 launch a layer a decode forward (1,116 for 36 layers and 31
    # forwards), however its columns split across blocks
    if min(path.values()) < 1 or path["decode_attention_kernel"] \
            != L * forwards["kernels, K8 on"] or \
            counts["kernels, K8 on, mixed preset"]["quant_matmul_int4"] \
            != 1 + (1 + L * wide) * n_fwd or \
            counts["kernels, K8 on, int8 cache, B=16"][
                "decode_attention_kernel"] < 1 or \
            any(counts["plain"].values()) or \
            counts["kernels, K8 off"]["decode_attention_kernel"]:
        raise SystemExit(f"VLM launches: {counts}")
    ref = runs["plain"]
    for name, out in runs.items():
        if name == "plain":
            continue
        if "B=16" in name or "mixed" in name:
            ok = len(out) == len(ref) * (2 if "B=16" in name else 1) \
                and all(len(o) >= 1 for o in out)
            print(f"{name}: {sum(len(o) for o in out)} tokens over "
                  f"{len(out)} rows {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise SystemExit(f"the generation '{name}' failed")
            continue
        same = [a == b for o, r in zip(out, ref) for a, b in zip(o, r)]
        firsts = all(o[:1] == r[:1] for o, r in zip(out, ref))
        print(f"tokens {name} vs plain: first token of every row equal "
              f"{firsts}; {100 * np.mean(same):.1f}% of "
              f"{len(same)} tokens equal (printed, not held)", flush=True)
        if not firsts:
            raise SystemExit(f"{name}: a row's first token differs from the "
                             "plain path's")
    print(f"VLM phase peak memory {peak:.2f} GiB on {card()}", flush=True)
    # the vlm_engine phase serves this model (built once); the nf4 phase
    # compares with its decode time and tokens
    _VLM.update(params=qparams, cfg=cfg,
                ms_token=ms_token["kernels, K8 on"],
                tokens=runs["kernels, K8 on"])
    del gk, gp, qparams, mixed
    torch.cuda.empty_cache()

    return path


NF4_TOL = {"dequant": 1e-6, "rowpair": 1e-4, "materialize": 2e-2}
NF4_PREFILL_ROWS = 8 * 547  # B=8 rows of prefill: past the row-pair cutoff


def nf4_phase() -> dict:
    """Qwen2.5-VL-3B at full width under NF4 (weights seeded as the vlm
    phase's, quantized on the card one layer at a time): the quantizer on
    the card against the CPU's on two layers of the stacked gate kernel
    (qweight bit for bit, dequantized weights within NF4_TOL of the
    largest |w|), nf4_matmul's row-pair route at the untied head's shape
    (x [8, 2048], N 151,936) and its materialize route at prefill's rows
    against float64, NF4's RMS weight error below int4's; then the
    extractor's "nf4" preset (qwen.quantize_preset, tied head) and the
    preset with head_bits="nf4" generate as the vlm phase does (B=8,
    448x448, VLM_NEW tokens, K8 on), the latter timed beside 8h4. Returns
    K8's launches in that generation."""
    import dataclasses

    from vlm_clip_tpu_torch.bridge import tree_leaves
    from vlm_clip_tpu_torch.ops import decode_attention as K8
    from vlm_clip_tpu_torch.ops import nf4 as N
    from vlm_clip_tpu_torch.ops import quant as K7
    from vlm_clip_tpu_torch.vlm import qwen_model as QM
    from vlm_clip_tpu_torch.vlm.qwen import QwenVLGenerator, quantize_preset
    from vlm_clip_tpu_torch.vlm.qwen_convert import (
        fold_qwen_patch_normalization, quantize_qwen_params)
    from vlm_clip_tpu_torch.vlm.qwen_process import prepare_vision_inputs

    dev = torch.device("cuda")
    cfg = QM.qwen25vl_3b()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {"text": QM.init_text(gen, cfg.text, device=dev),
              "vision": QM.init_vision(gen, cfg.vision, device=dev)}
    params["vision"] = fold_qwen_patch_normalization(params["vision"],
                                                     cfg.vision)

    # 1. the quantizer, card against CPU; NF4's error against int4's
    gate = params["text"]["layers"]["mlp"]["gate"]["kernel"][:2]
    on_card = N.quantize_nf4_stacked(gate)
    on_cpu = N.quantize_nf4_stacked(gate.cpu())
    bits = torch.equal(on_card.qweight.cpu(), on_cpu.qweight)
    deq = [N.dequantize_nf4(q.map(lambda t, i=i: t[i])).cpu()
           for q in (on_card, on_cpu) for i in range(2)]
    d_err = max(float((deq[i] - deq[2 + i]).abs().max()) for i in range(2))
    amax = float(gate.abs().max())
    w = gate[0].float()
    rms_nf4 = float(((deq[0].to(dev) - w) ** 2).mean().sqrt())
    rms_int4 = float(((K7.dequantize_weight(K7.quantize_weight(w, 4))
                       - w) ** 2).mean().sqrt())
    ok = bits and d_err <= NF4_TOL["dequant"] * amax and rms_nf4 < rms_int4
    print(f"NF4 quantizer, gate layers 0-1 {list(gate.shape)}, card vs CPU: "
          f"qweight bit for bit {bits}, dequantized max|diff| {d_err:.3e} "
          f"(limit {NF4_TOL['dequant']} x max|w| {amax:.4f}); RMS weight "
          f"error NF4 {rms_nf4:.6e}, int4 {rms_int4:.6e} "
          f"({'ok' if ok else 'FAIL'})", flush=True)
    if not ok:
        raise SystemExit("NF4's quantizer failed on the card")
    del on_card, on_cpu, deq, gate, w

    # 2. the two presets, quantized on the card one layer at a time
    torch.cuda.synchronize()
    t0 = time.time()
    tied, tied_cfg = quantize_preset(params, cfg, "nf4")
    torch.cuda.synchronize()
    t_tied = time.time() - t0
    t0 = time.time()
    nf4 = quantize_qwen_params(params, "nf4", head_bits="nf4",
                               fuse_decode=True)
    torch.cuda.synchronize()
    t_head = time.time() - t0
    del params
    torch.cuda.empty_cache()
    untied = dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, tie_word_embeddings=False))

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    print(f"quantize seconds: 'nf4' (tied head) {t_tied:.2f}, 'nf4' + "
          f"head_bits='nf4' {t_head:.2f}; bytes: NF4 tree {nbytes(nf4)}, "
          f"8h4 tree {nbytes(_VLM['params'])}, NF4 tied-head tree "
          f"{nbytes(tied)}", flush=True)

    # 3. the matmul routes against float64
    head = nf4["text"]["lm_head"]
    x = torch.randn(8, cfg.text.hidden_size, generator=gen, device=dev)
    want = x.double() @ N.dequantize_nf4(head).double()
    r_err = float((N.nf4_matmul(x, head).double() - want).abs().max()) \
        / float(want.abs().max())
    gateup = QM.layer(nf4["text"]["layers"], 0)["mlp"]["gateup"]
    xp = torch.randn(NF4_PREFILL_ROWS, cfg.text.hidden_size, generator=gen,
                     device=dev)
    want = xp.double() @ N.dequantize_nf4(gateup).double()
    m_err = float((N.nf4_matmul(xp, gateup).double() - want).abs().max()) \
        / float(want.abs().max())
    del want
    t_head_ms = _timed(lambda: N.nf4_matmul(x, head))
    ok = r_err <= NF4_TOL["rowpair"] and m_err <= NF4_TOL["materialize"]
    print(f"nf4_matmul vs float64, max|diff| / max|y|: row-pair route at the "
          f"head's {list(x.shape)} x [{head.in_features}, "
          f"{head.out_features}] {r_err:.3e}, "
          f"materialize route at layer 0's gateup, {NF4_PREFILL_ROWS} rows, "
          f"{m_err:.3e} (limits {NF4_TOL}) {'ok' if ok else 'FAIL'}; the "
          f"head's row-pair matmul {t_head_ms:.3f} ms", flush=True)
    if not ok:
        raise SystemExit("nf4_matmul disagrees with its float64 product")

    # 4. generation, K8 on, as the vlm phase's
    rng = np.random.default_rng(0)
    visions = [prepare_vision_inputs(
        rng.integers(0, 255, (448, 448, 3), dtype=np.uint8), cfg.vision,
        fixed_resolution=448, raw_uint8=True) for _ in range(8)]
    ids = _qwen_prompt(cfg)

    def generator(p, c):
        g = QwenVLGenerator(p, c, max_len=768)
        g.u8_patches = True
        return g

    out = generator(tied, tied_cfg).generate_batch_from_ids(
        ids, visions, max_new_tokens=VLM_NEW)
    if len(out) != len(visions) or not all(out):
        raise SystemExit(f"the tied-head NF4 preset generated {out}")
    print(f"'nf4' preset (tied head): {sum(len(o) for o in out)} tokens over "
          f"{len(out)} rows", flush=True)
    del tied
    g = generator(nf4, untied)
    _decode_breakdown(g, ids, visions, untied.text,
                      "NF4 route (dequantize to fp32, row-pair products)")
    l0, cache, _, _ = g.prefill_batch(ids, visions)
    if not bool(torch.isfinite(l0).all()):
        raise SystemExit("NF4 prefill logits are not finite")
    del cache
    g.generate_batch_from_ids(ids, visions, max_new_tokens=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g.generate_batch_from_ids(ids, visions, max_new_tokens=1)
    torch.cuda.synchronize()
    t_pf = time.perf_counter() - t0
    K7.reset_launch_counts()
    K8.reset_launch_counts()
    t0 = time.perf_counter()
    out = g.generate_batch_from_ids(ids, visions, max_new_tokens=VLM_NEW)
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    counts = {**K7.launch_counts(), **K8.launch_counts()}
    n_fwd = _forwards(out)
    ms_tok = (t_all - t_pf) * 1e3 / n_fwd
    same = [a == b for o, r in zip(out, _VLM["tokens"])
            for a, b in zip(o, r)]
    print(f"generate nf4 + nf4 head, K8 on: vision + prefill "
          f"{t_pf * 1e3:.1f} ms, decode {ms_tok:.2f} ms/token ({n_fwd} "
          f"forwards; 8h4 {_VLM['ms_token']:.2f} ms/token in the vlm phase, "
          f"ratio {ms_tok / _VLM['ms_token']:.3f}), "
          f"{len(visions) * 1e3 / ms_tok:.1f} tokens/s; launches {counts}; "
          f"{100 * np.mean(same):.1f}% of {len(same)} greedy tokens agree "
          f"with 8h4's (printed, not held) on {card()}", flush=True)
    if counts["decode_attention_kernel"] != cfg.text.num_layers * n_fwd \
            or counts["quant_matmul_int4"]:
        raise SystemExit(f"NF4 generation launches: {counts}")
    del g, nf4
    torch.cuda.empty_cache()
    return {"decode_attention_kernel": counts["decode_attention_kernel"]}


def _engine_requests(cfg, n: int, seed: int = 13):
    """(prompt ids, n vision inputs of random 448x448 images, n budgets
    drawn from ENGINE_BUDGETS): the engine phase's load."""
    from vlm_clip_tpu_torch.vlm.qwen_process import prepare_vision_inputs

    rng = np.random.default_rng(seed)
    visions = [prepare_vision_inputs(
        rng.integers(0, 255, (448, 448, 3), dtype=np.uint8), cfg.vision,
        fixed_resolution=448, raw_uint8=True) for _ in range(n)]
    lo, hi = ENGINE_BUDGETS
    return _qwen_prompt(cfg), visions, rng.integers(lo, hi + 1, n).tolist()


@contextlib.contextmanager
def _recorded(module, name: str, record):
    """Replace ``module.name`` by a wrapper that hands its arguments to
    ``record`` before the call (a measurement; nothing of the port)."""
    fn = getattr(module, name)

    def spy(*args, **kw):
        record(*args, **kw)
        return fn(*args, **kw)

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, fn)


def _engine_run(eng, ids, visions, budgets):
    """(results in request order, wall seconds, install groups) of one
    engine draining these requests, queued at t0."""
    groups = []
    with _recorded(eng, "_install", lambda g, s: groups.append(len(g))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [eng.submit(ids, v, max_new_tokens=m)
                for v, m in zip(visions, budgets)]
        res = eng.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return [res[r] for r in rids], wall, groups


def _first_logits(eng, ids, visions, budgets):
    """The engine's prefill logits and its first decode step's logits
    ([n, V] each, the order of the slots = the requests') for one group
    installed into an engine of that many slots, after one chunk."""
    from vlm_clip_tpu_torch.vlm import engine as E

    seen = []
    with _recorded(E, "sample_token", lambda logits, *a: seen.append(
            logits.float().clone())):
        for v, m in zip(visions, budgets):
            eng.submit(ids, v, max_new_tokens=m)
        eng._refill()
        eng._harvest(eng._dispatch())
    return seen[0], seen[1]


def _overlapped(eng, record: list):
    """Record, at each harvest of ``eng``, whether another chunk was
    already on the device's queue (pipelined dispatch at work)."""
    return _recorded(eng, "_harvest", lambda pend: record.append(
        eng._pend is not None and eng._pend is not pend))


def vlm_engine_phase() -> dict:
    """The continuous-batching engine (vlm/engine.py) on the vlm phase's
    Qwen2.5-VL-3B (8h4, random weights, 448x448 images, the 291-token
    prompt, max_len 768): the mixed load through K7 and K8 with their
    launch counts; the first logits and tokens against the fixed-batch
    path and against the plain versions; speculative and int8-cache
    runs; a chunk under torch.cuda.set_sync_debug_mode("error");
    cli/serve_vlm over HTTP; the five benches, shortened. Returns the
    mixed run's launches."""
    import http.client as hc
    import threading as th
    from http.server import ThreadingHTTPServer

    from vlm_clip_tpu_torch.cli import (bench_context, bench_decode,
                                        bench_engine, bench_spec,
                                        bench_vision, serve_vlm)
    from vlm_clip_tpu_torch.ops import decode_attention as K8
    from vlm_clip_tpu_torch.ops import quant as K7
    from vlm_clip_tpu_torch.vlm.engine import ContinuousBatchingEngine
    from vlm_clip_tpu_torch.vlm.qwen import QwenVLGenerator

    params, cfg = _VLM["params"], _VLM["cfg"]  # the model_parallel
    # phase drives this tree too and drops it
    L = cfg.text.num_layers
    where = card()

    def generator(impl="auto", kv_bits=16):
        g = QwenVLGenerator(params, cfg, max_len=768, kv_bits=kv_bits,
                            impl=impl)
        g.u8_patches = True
        return g

    gen = generator()
    ids, visions, budgets = _engine_requests(cfg, ENGINE_REQUESTS)
    failures = []

    # 1. the mixed load at the reference's defaults; K8 once a layer a
    # decode forward, K7 once a decode forward (the int4 head at M = 32)
    # and once an install (the prefill's head at M = the group's size),
    # the int8 GEMM four times a layer a decode forward (32 rows; an
    # install's prefill rows take the materialize route)
    def engine(g=gen, **kw):
        kw.setdefault("n_slots", ENGINE_SLOTS)
        return ContinuousBatchingEngine(g, sync_steps=ENGINE_SYNC, **kw)

    _engine_run(engine(), ids, visions[:8], budgets[:8])  # warm
    K7.reset_launch_counts()
    K8.reset_launch_counts()
    eng, overlaps = engine(), []
    with _overlapped(eng, overlaps):
        out, wall, groups = _engine_run(eng, ids, visions, budgets)
    launches = {**K7.launch_counts(), **K8.launch_counts()}
    rounds, tokens = eng.stats["rounds"], sum(len(o) for o in out)
    want = {"decode_attention_kernel": L * rounds,
            "quant_matmul_int4": rounds + len(groups),
            "quant_matmul_int8": 4 * L * rounds}
    ok = launches == want and all(1 <= len(o) <= m
                                  for o, m in zip(out, budgets))
    print(f"engine mixed load ({ENGINE_REQUESTS} requests, budgets "
          f"{ENGINE_BUDGETS[0]}-{ENGINE_BUDGETS[1]}, {ENGINE_SLOTS} slots, "
          f"{ENGINE_SYNC} steps a chunk at least, pipelined): {tokens} "
          f"tokens in {wall:.2f} s = {tokens / wall:.1f} tok/s, {rounds} "
          f"decode forwards in {eng.stats['chunks']} chunks "
          f"({wall * 1e3 / rounds:.2f} ms a forward, installs included), "
          f"{sum(overlaps)} of {len(overlaps)} harvests with the next chunk "
          f"in flight, {len(groups)} installs {groups}; launches {launches} "
          f"(expected {want}) {'ok' if ok else 'FAIL'} on {where}",
          flush=True)
    if not ok:
        failures.append("engine launches")
    # pipelined against unpipelined dispatch on the same load, in turns;
    # the counted run above is the first pipelined one
    turns = {True: [(wall, tokens, rounds, eng.stats["chunks"])], False: []}
    chains = {True: out}
    for pipe in (False, True, False):
        e2, ov2 = engine(pipeline=pipe), []
        with _overlapped(e2, ov2):
            o2, w2, _ = _engine_run(e2, ids, visions, budgets)
        turns[pipe].append((w2, sum(len(o) for o in o2), e2.stats["rounds"],
                            e2.stats["chunks"]))
        chains.setdefault(pipe, o2)
        if any(ov2) != pipe:
            failures.append(f"engine pipeline={pipe} overlap {ov2}")
    del e2
    rate = {p: [round(t / w, 1) for w, t, _, _ in v] for p, v in turns.items()}
    same = sum(a == b for a, b in zip(chains[True], chains[False]))
    print(f"engine mixed load, pipelined against unpipelined dispatch in "
          f"turns (P, U, P, U): tok/s pipelined {rate[True]}, unpipelined "
          f"{rate[False]}; (seconds, tokens, forwards, chunks) pipelined "
          f"{turns[True]}, unpipelined {turns[False]}; {same} of "
          f"{len(out)} chains equal (printed) on {where}", flush=True)

    # 2. against the fixed-batch path (generate_from_ids's prefill and
    # decode step on the same 4 requests) and against the plain versions
    few_v, few_b = visions[:4], budgets[:4]
    p_e, d_e = _first_logits(engine(n_slots=4, adaptive=False), ids, few_v,
                             few_b)
    with _k8_off():
        p_p, d_p = _first_logits(engine(generator("torch"), n_slots=4,
                                        adaptive=False), ids, few_v, few_b)
    l0, cache, T, delta = gen.prefill_batch(ids, few_v)
    l1, _ = gen._decode_step(l0.argmax(-1), T + delta, cache, T)
    del cache
    rel = {"prefill vs generate": _rel(p_e, l0),
           "step 1 vs generate": _rel(d_e, l1),
           "prefill vs plain": _rel(p_e, p_p),
           "step 1 vs plain (K7, K8 off)": _rel(d_e, d_p)}
    lim = {"prefill vs generate": VLM_TOL["k7"],
           "step 1 vs generate": VLM_TOL["k8"],
           "prefill vs plain": VLM_TOL["k7"],
           "step 1 vs plain (K7, K8 off)": VLM_TOL["k8"]}
    firsts = [t.argmax(-1).tolist() for t in (p_e, l0, p_p)]
    fixed = gen.generate_batch_from_ids(ids, few_v, max_new_tokens=max(few_b))
    fixed = [f[:m] for f, m in zip(fixed, few_b)]
    same = [a == b for o, f in zip(out[:4], fixed) for a, b in zip(o, f)]
    whole = sum(o == f for o, f in zip(out[:4], fixed))
    ok = all(rel[k] <= lim[k] for k in rel) \
        and firsts[0] == firsts[1] == firsts[2] \
        and [o[:1] for o in out[:4]] == [[t] for t in firsts[0]] \
        and all(bool(torch.isfinite(t).all()) for t in (p_e, d_e, p_p, d_p))
    print(f"engine against the fixed batch and the plain versions (4 "
          f"requests): logits max|diff| / max|logit| "
          f"{ {k: round(v, 6) for k, v in rel.items()} } (limits {lim}); "
          f"first tokens equal {firsts[0] == firsts[1] == firsts[2]}; "
          f"whole chains equal to generate_batch_from_ids {whole} of 4, "
          f"{100 * np.mean(same):.1f}% of {len(same)} tokens (printed, not "
          f"held: near ties in bf16 flip later tokens) "
          f"{'ok' if ok else 'FAIL'} on {where}", flush=True)
    if not ok:
        failures.append("engine against generate / plain")

    # 3. speculative (K8 at T = spec_k + 1 = 5) and the int8 cache
    Ts = []
    K7.reset_launch_counts()
    K8.reset_launch_counts()
    with _recorded(K8, "_launch", lambda q, *a: Ts.append(q.shape[1])):
        seng = engine(spec_k=4)
        sout, swall, sgroups = _engine_run(seng, ids, visions, budgets)
    sl = {**K7.launch_counts(), **K8.launch_counts()}
    sr = seng.stats["rounds"]
    stok = sum(len(o) for o in sout)
    # the first 32 requests install in the same groups of 8 in both runs
    n1 = ENGINE_SLOTS
    ok = set(Ts) == {5} and sl["decode_attention_kernel"] == L * sr \
        and sl["quant_matmul_int4"] == len(sgroups) \
        and [o[:1] for o in sout[:n1]] == [o[:1] for o in out[:n1]]
    sdiff = sum(a != b for a, b in zip(sout, out))
    print(f"engine spec_k=4: {stok} tokens in {sr} verify rounds "
          f"({stok / sr:.2f} tokens a round over up to {ENGINE_SLOTS} "
          f"slots; plain: {tokens / rounds:.2f}), {swall:.2f} s = "
          f"{stok / swall:.1f} tok/s; K8 new rows per launch {sorted(set(Ts))}"
          f", launches {sl} (K7 only at the installs: a verify forward has "
          f"{ENGINE_SLOTS * 5} rows, the row-pair route); first tokens of the "
          f"first refill's {n1} requests equal the plain engine's; {sdiff} of"
          f" {len(out)} chains differ "
          f"(printed) {'ok' if ok else 'FAIL'} on {where}", flush=True)
    if not ok:
        failures.append("engine spec_k=4")
    K8.reset_launch_counts()
    int8 = {"cache": []}
    with _recorded(K8, "_launch", lambda q, k_old, *a: int8["cache"].append(
            k_old.dtype)):
        ieng = engine(generator(kv_bits=8), n_slots=16)
        iout, iwall, _ = _engine_run(ieng, ids, visions[:16], budgets[:16])
    ok = set(int8["cache"]) == {torch.int8} \
        and K8.launch_counts()["decode_attention_kernel"] \
        == L * ieng.stats["rounds"] and all(len(o) >= 1 for o in iout)
    print(f"engine int8 cache, 16 slots: {sum(len(o) for o in iout)} tokens "
          f"in {iwall:.2f} s, K8 launches {K8.launch_counts()} on an int8 "
          f"cache ({L} x {ieng.stats['rounds']} forwards); first tokens equal"
          f" the bf16 cache's in {sum(a[:1] == b[:1] for a, b in zip(iout, out))}"
          f" of 16 rows (printed) {'ok' if ok else 'FAIL'} on {where}",
          flush=True)
    if not ok:
        failures.append("engine int8 cache")

    # 4. one chunk of 32 rows with a cancel in it, no host sync allowed
    ceng = engine(pipeline=False, adaptive=False)
    for v, m in zip(visions[:ENGINE_SLOTS], [64] * ENGINE_SLOTS):
        ceng.submit(ids, v, max_new_tokens=m)
    ceng._refill()
    ceng._harvest(ceng._dispatch())
    ceng.cancel(ceng._slot_req[3])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        pend = ceng._dispatch()
        t_host = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    ceng._harvest(pend)
    ok = bool(ceng.done[3]) and int(ceng.remaining[3]) == 0
    print(f"engine chunk of {ENGINE_SYNC} steps at {ENGINE_SLOTS} rows under "
          f"sync_debug_mode('error'): no host sync; launched in "
          f"{t_host * 1e3:.1f} ms, done in {t_all * 1e3:.1f} ms = "
          f"{t_all * 1e3 / ENGINE_SYNC:.2f} ms a step (beside the vlm "
          f"phase's B=8 generate's ms/token above); the cancelled row "
          f"stopped by the mask {'ok' if ok else 'FAIL'} on {where}",
          flush=True)
    if not ok:
        failures.append("engine cancel mask")
    # where a 32-row step's time goes: one more chunk under the profiler
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pend = ceng._dispatch()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / ENGINE_SYNC
    ceng._harvest(pend)
    kern = [(getattr(e, "self_device_time_total", 0) / 1e3 / ENGINE_SYNC,
             e.count / ENGINE_SYNC, e.key) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    busy = sum(k[0] for k in kern)
    top = [(round(t, 3), round(c, 1), n[:50])
           for t, c, n in sorted(kern, reverse=True)[:6]]
    print(f"engine step profile at {ENGINE_SLOTS} rows: host {wall:.2f} ms "
          f"a step (profiler on), device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%), {sum(k[1] for k in kern):.0f} "
          f"kernel launches a step; largest (ms a step, launches, name): "
          f"{top} on {where}", flush=True)
    del ceng

    # 5. cli/serve_vlm over HTTP on this model (8 slots)
    from vlm_clip_tpu_torch.vlm.qwen_process import prepare_vision_inputs

    def prep(img, prompt_text):
        return ids, prepare_vision_inputs(
            np.asarray(img.convert("RGB")), cfg.vision,
            fixed_resolution=448, raw_uint8=True)

    worker = serve_vlm.EngineWorker(engine(n_slots=8, refill_chunks=(8, 1)))
    worker.start()
    srv = ThreadingHTTPServer(("127.0.0.1", 0), serve_vlm.make_vlm_handler(
        worker, prep, None, 16, "chip_smoke"))
    th.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    try:
        conn = hc.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        conn.close()
        got, errs = [None] * 3, []

        def hit(i):
            try:
                got[i] = _post(port, "/generate?max_new=16",
                               _jpeg(40 + i, (448, 448)))
            except Exception as e:  # noqa: BLE001 — reported below
                errs.append(str(e))

        threads = [th.Thread(target=hit, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        conn = hc.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/generate?max_new=40&stream=1",
                     body=_jpeg(43, (448, 448)))
        r = conn.getresponse()
        events = [json.loads(ln[6:]) for ln in r.read().decode().splitlines()
                  if ln.startswith("data: ")]
        conn.close()
        deltas = [t for e in events[:-1] for t in e["tokens"]]
        conn = hc.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/generate?max_new=400&stream=1",
                     body=_jpeg(44, (448, 448)))
        r = conn.getresponse()
        r.read(16)
        r.close()
        conn.close()
        deadline = time.time() + 60
        while worker.total_cancelled < 1 and time.time() < deadline:
            time.sleep(0.05)
        conn = hc.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/generate", body=b"not an image")
        bad = conn.getresponse().status
        conn.close()
    finally:
        srv.shutdown()
        worker.stop()
    ms = [g[1] for g in got if g is not None]
    ok = health.get("status") == "ok" and not errs \
        and all(g is not None and 1 <= len(g[0]["tokens"]) <= 16
                for g in got) \
        and events and events[-1].get("done") is True \
        and len(events) >= 3 and deltas == events[-1]["tokens"] \
        and worker.total_cancelled == 1 and bad == 400
    print(f"serve_vlm: /healthz {health}; 3 concurrent /generate in "
          f"{[round(m, 1) for m in ms]} ms, errors {errs}; streamed 40 "
          f"tokens in {len(events) - 1} deltas; a client gone mid-stream "
          f"cancelled ({worker.total_cancelled}); a bad image -> {bad} "
          f"{'ok' if ok else 'FAIL'} on {where}", flush=True)
    if not ok:
        failures.append("serve_vlm")
    del worker, eng, seng, ieng

    # 6. the benches, shortened
    be = bench_engine.main(["--workload", "mixed", "--slots", "32",
                            "--requests", "32", "--budget-lo", "8",
                            "--budget-hi", "64", "--refill-chunks", "8,1",
                            "--arrivals", "6"], gen=gen)
    arr = be["arrivals"][0]
    print(f"bench_engine (mixed, 32 requests, 32 slots): engine "
          f"{be['engine_tok_s']:.1f} tok/s, static {be['static_tok_s']:.1f} "
          f"tok/s; Poisson {arr['rate']:g} req/s: engine "
          f"{arr['engine_tok_s']:.1f} tok/s, TTFT p50 "
          f"{arr['engine_ttft_p50']:.3f} s p95 {arr['engine_ttft_p95']:.3f} s;"
          f" static {arr['static_tok_s']:.1f} tok/s, TTFT p50 "
          f"{arr['static_ttft_p50']:.3f} s p95 {arr['static_ttft_p95']:.3f} s"
          f" on {where}", flush=True)
    bs = bench_spec.main(["--device", "cuda", "--slots", "8", "--requests",
                          "8", "--budget", "32"], gen=gen)
    print(f"bench_spec round cost at 8 slots: plain {bs['round_ms'][8][0]:.2f}"
          f" ms a step, spec_k=4 {bs['round_ms'][8][1]:.2f} ms a round on "
          f"{where}", flush=True)
    # the 3B weights go before the next two benches build their own
    del gen, params, engine, generator
    gc.collect()
    torch.cuda.empty_cache()
    bc = bench_context.main(["--batch", "8", "--new", "32", "--u8",
                             "--max-len", "768", "--reps", "2"])
    bv = bench_vision.main(["--batch", "1", "--dtype", "bf16", "--quant",
                            "int8", "--reps", "5"])
    # max_len 768 (the extractor's): at the CLI's default 256 the per-layer
    # cache takes the dense route and K8 is never reached
    bd = bench_decode.main(["--bits", "8", "--head-bits", "4", "--fused",
                            "--batch", "8", "--new", "8", "--max-len", "768"])
    print(f"bench_context: {bc['line']}; bench_vision: {bv['line']}; "
          f"bench_decode: {bd['line']} on {where}", flush=True)
    if not (bv["finite"] and bv["shape"] == (1, 256, cfg.vision.out_hidden_size)
            and all(len(t) >= 1 for t in bc["tokens"])
            and bd["tokens"].shape == (8, 8)
            and np.isfinite(bd["ms_per_token"])):
        failures.append("benches")
    if failures:
        raise SystemExit(f"vlm_engine phase failed: {failures}")
    return launches


# The model_parallel phase: the world-1 drives of the engine's mesh,
# PipelineGenerator and the sharded video scorer (engine: 32 slots, 16
# requests with budgets drawn from 8-32; the pipeline: 8 rows of 64
# random prompt ids, 32 new tokens; 64 frames), then K7, K8 and K5 at
# each rank's shard shapes for these model sizes.
MP_MODELS = (2, 4)
MP_REQUESTS, MP_BUDGETS, MP_ROWS, MP_FRAMES = 16, (8, 32), 8, 64
# A shard's kernel against its plain version: K7_TOL, check_decode_attn's
# limits, TOL[bf16] (the vlm and t_kernels phases' tolerances). The
# ranks' results recombined against the unsharded layer on the card: the
# head shards concatenated against the whole head's K7 call (K7_TOL: the
# same nibbles and fp32 sums, the same depth splits at these widths);
# the heads' K8 / K5 outputs concatenated against one call over every
# head (check_decode_attn's limits / TOL[bf16]: another column split or
# tile order may round p apart); the row-parallel o / out products of
# those outputs, fp32 partial products summed over the ranks, against
# the unsharded fp32 product within 1e-4 x max |want| (summation order).
MP_SUM_TOL = 1e-4
# The tensor-parallel layers across processes (_mp_layers): four ranks on
# the one card, model 4 and data 2 x model 2. A sharded layer in bf16
# against the unsharded layer in bf16, elementwise within TOL[bf16]:
# the sharded row-parallel linears sum fp32 partials and round once, the
# unsharded ones round their fp32 sums once, so a bf16 rounding flip in
# a linear's output, carried through the layer's norm and MLP, parts
# them by a few bf16 ulps.
MP_LAYER_RANKS, MP_LAYER_TIMEOUT = 4, 300
MP_LAYER_TOL = TOL[torch.bfloat16]
MP_LAYER_RESULT = "tp layer result: "


def _mp_world1(params, cfg, where) -> dict:
    """NCCL at world 1: the engine with a (data 1, model 1) mesh against
    mesh=None, PipelineGenerator at one stage against QwenVLGenerator on
    the same prompt ids, score_video_frames_sharded at seq 1 against
    score_video_frames (ViT-B/16, K5 on); each must agree, and K7, K8 and
    K5 must launch on these drives as their counts say. Returns the
    drives' launches."""
    from torch.distributed.device_mesh import init_device_mesh

    from vlm_clip_tpu_torch.core.config import clip_preset
    from vlm_clip_tpu_torch.core.dtypes import BF16
    from vlm_clip_tpu_torch.data import video as V
    from vlm_clip_tpu_torch.models.clip import init_clip
    from vlm_clip_tpu_torch.ops import attention as K5
    from vlm_clip_tpu_torch.ops import decode_attention as K8
    from vlm_clip_tpu_torch.ops import quant as K7
    from vlm_clip_tpu_torch.parallel import distributed as D
    from vlm_clip_tpu_torch.parallel.mesh import (MeshConfig, create_mesh,
                                                  create_pipe_mesh)
    from vlm_clip_tpu_torch.parallel.pipeline import PipelineGenerator
    from vlm_clip_tpu_torch.vlm.engine import ContinuousBatchingEngine
    from vlm_clip_tpu_torch.vlm.qwen import QwenVLGenerator

    L = cfg.text.num_layers
    dev = torch.device("cuda")
    failures, launches = [], {}

    def reset():
        for k in (K5, K7, K8):
            k.reset_launch_counts()

    def counts():
        return {**K5.launch_counts(), **K7.launch_counts(),
                **K8.launch_counts()}

    def gen():
        g = QwenVLGenerator(params, cfg, max_len=768)
        g.u8_patches = True
        return g

    ids, visions, budgets = _engine_requests(cfg, MP_REQUESTS, seed=17)
    budgets = np.random.default_rng(17).integers(
        MP_BUDGETS[0], MP_BUDGETS[1] + 1, MP_REQUESTS).tolist()
    D.maybe_initialize(D.DistributedConfig(
        coordinator_address=f"localhost:{_free_port()}", num_processes=1,
        process_id=0, local_rank=0, local_world_size=1), device="cuda")
    try:
        # the engine, (data 1, model 1) mesh against no mesh
        plain, _, _ = _engine_run(ContinuousBatchingEngine(
            gen(), n_slots=ENGINE_SLOTS, sync_steps=ENGINE_SYNC), ids,
            visions, budgets)
        reset()
        eng = ContinuousBatchingEngine(
            gen(), n_slots=ENGINE_SLOTS, sync_steps=ENGINE_SYNC,
            mesh=create_mesh(MeshConfig(data=1, model=1), "cuda"))
        out, wall, groups = _engine_run(eng, ids, visions, budgets)
        got = counts()
        rounds = eng.stats["rounds"]
        want = {"decode_attention_kernel": L * rounds,
                "quant_matmul_int4": rounds + len(groups),
                "quant_matmul_int8": 4 * L * rounds}
        ok = out == plain and all(got[k] == v for k, v in want.items())
        launches["engine"] = got
        print(f"model_parallel engine, (data 1, model 1) mesh under NCCL at "
              f"world 1 vs mesh=None ({MP_REQUESTS} requests, budgets "
              f"{MP_BUDGETS[0]}-{MP_BUDGETS[1]}, {ENGINE_SLOTS} slots): "
              f"tokens equal {out == plain}, {sum(map(len, out))} tokens in "
              f"{wall:.2f} s, launches {got} (expected {want}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append("engine mesh")
        del eng

        # PipelineGenerator at one stage against QwenVLGenerator
        g = gen()
        rng = np.random.default_rng(19)
        T = 64
        pids = rng.integers(1, min(150000, cfg.text.vocab_size),
                            (MP_ROWS, T)).astype(np.int64)
        with torch.no_grad():
            emb = params["text"]["embed_tokens"][torch.from_numpy(pids).to(
                dev)].to(g.dtype)
            pos3 = torch.arange(T, device=dev).expand(3, MP_ROWS, T)
            logits, cache = g._prefill(emb, pos3, g._new_cache(MP_ROWS),
                                       T - 1)
            want_tok = g._run_decode_loop(logits, cache, T, 0, VLM_NEW, None,
                                          0, pids)
        del cache
        reset()
        pgen = PipelineGenerator.from_params(
            params["text"], cfg.text, create_pipe_mesh(1, device="cuda"),
            cfg.eos_token_id, max_len=768)
        t0 = time.perf_counter()
        got_tok = pgen.generate_text(pids[None], max_new_tokens=VLM_NEW)
        wall = time.perf_counter() - t0
        got = counts()
        want = {"decode_attention_kernel": L * VLM_NEW,
                "quant_matmul_int4": 1 + VLM_NEW,
                "quant_matmul_int8": 4 * L * VLM_NEW}
        ok = got_tok == want_tok and all(got[k] == v
                                         for k, v in want.items())
        launches["pipeline"] = got
        print(f"model_parallel PipelineGenerator, 1 stage under NCCL vs "
              f"QwenVLGenerator ({MP_ROWS} rows of {T} prompt ids, "
              f"{VLM_NEW} new tokens, greedy): tokens equal "
              f"{got_tok == want_tok} ({sum(map(len, got_tok))} tokens, "
              f"{wall:.2f} s), launches {got} (expected {want}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append("pipeline")
        del pgen, g

        # the sharded video scorer at seq 1, ViT-B/16 with K5 on
        ccfg = clip_preset("vit-base-patch16")
        cp = init_clip(torch.Generator(device=dev).manual_seed(7), ccfg,
                       device=dev)
        vr = np.random.default_rng(23)
        frames = vr.integers(0, 256, (MP_FRAMES, 224, 224, 3),
                             dtype=np.uint8)
        emb = vr.normal(size=(7, ccfg.projection_dim)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
        mesh = init_device_mesh("cuda", (1, 1, 1),
                                mesh_dim_names=("data", "model", "seq"))
        was = K5.fused_attention_enabled()
        K5.set_fused_attention(True)
        try:
            want_s = V.score_video_frames(cp, ccfg, frames, emb,
                                          policy=BF16)
            reset()
            got_s = V.score_video_frames_sharded(cp, ccfg, frames, emb,
                                                 mesh, policy=BF16)
        finally:
            K5.set_fused_attention(was)
        got = counts()
        err = float(np.abs(got_s - want_s).max())
        layers = ccfg.vision.num_layers
        ok = got_s.shape == (MP_FRAMES, 7) and np.isfinite(got_s).all() \
            and err <= 1e-5 and got["fused_attention"] == layers
        launches["video"] = got
        print(f"model_parallel score_video_frames_sharded at seq 1 vs "
              f"score_video_frames (ViT-B/16, {MP_FRAMES} frames, BF16, K5 "
              f"on): max |diff| {err:.3e} (limit 1e-5), launches {got} "
              f"(expected K5 {layers}) {'ok' if ok else 'FAIL'} on {where}",
              flush=True)
        if not ok:
            failures.append("video")
    finally:
        torch.distributed.destroy_process_group()
    if failures:
        raise SystemExit(f"model_parallel world-1 drives failed: {failures}")
    total = {}
    for c in launches.values():
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


def _mp_row_sum(parts, full, what: str, failures) -> None:
    """The ranks' fp32 partial products summed, against the unsharded
    fp32 product."""
    got = sum(parts)
    err = float((got - full).abs().max())
    lim = MP_SUM_TOL * float(full.abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= lim
    print(f"model_parallel {what}: ranks' partial products summed vs the "
          f"unsharded product: max |diff| {err:.3e} (limit {lim:.3e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        failures.append(what)


def _mp_shards(params, cfg) -> dict:
    """K7, K8 and K5 at each rank's shard shapes for model 2 and 4, cut by
    parallel.sharding.cut_params (the pure cut, one rank at a time in this
    process): each launch against its plain version, the ranks' results
    recombined against the unsharded layer (the shapes' times are rows of
    the timing table). Returns the launches of the checks."""
    from vlm_clip_tpu_torch.cli import check_decode_attn
    from vlm_clip_tpu_torch.core.config import clip_preset
    from vlm_clip_tpu_torch.models import layers as LY
    from vlm_clip_tpu_torch.ops import attention as K5
    from vlm_clip_tpu_torch.ops import decode_attention as K8
    from vlm_clip_tpu_torch.ops import quant as K7
    from vlm_clip_tpu_torch.parallel.sharding import (cut_params,
                                                      clip_param_rules,
                                                      qwen_param_rules)
    from vlm_clip_tpu_torch.vlm.qwen_model import local_heads

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(29)
    failures = []
    for k in (K5, K7, K8):
        k.reset_launch_counts()
    tcfg = cfg.text
    hd = tcfg.head_dim

    def cut(tree, rules, m, r, head_dim):
        return cut_params(tree, rules, {"model": m}, {"model": r},
                          {"": head_dim})

    # K7 on the 8h4 head's vocabulary shards, x [8, 2048] bf16
    head = params["text"]["lm_head"]
    x = (torch.randn(8, tcfg.hidden_size, generator=gen, device=dev)
         ).to(torch.bfloat16)
    with torch.no_grad():
        whole = K7.quant_matmul_int4(x, head)
    for m in MP_MODELS:
        outs = []
        for r in range(m):
            sh = cut({"text": {"lm_head": head}}, qwen_param_rules(), m, r,
                     hd)["text"]["lm_head"]
            q = sh.inner
            with torch.no_grad():
                got = K7.quant_matmul_int4(x, q)
                want = K7.quant_matmul_int4_torch(x, q)
            err = (got - want).abs()
            ratio = float((err / (K7_TOL[0] + K7_TOL[1] * want.abs())).max())
            ok = bool(torch.isfinite(got).all()) and ratio <= 1.0
            outs.append(got)
            shape = (f"model {m} rank {r}: x[8, {tcfg.hidden_size}] bf16 "
                     f"against [{tcfg.hidden_size}, {q.logical_out}] "
                     f"(packed {list(q.qweight.shape)})")
            print(f"model_parallel K7 {shape}: max_abs_err "
                  f"{float(err.max()):.3e} err/tol {ratio:.3f} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                failures.append(f"K7 {shape}")
        cat = torch.cat(outs, dim=1)
        err = (cat - whole).abs()
        ratio = float((err / (K7_TOL[0] + K7_TOL[1] * whole.abs())).max())
        ok = cat.shape == whole.shape and ratio <= 1.0
        print(f"model_parallel K7 model {m}: the {m} shards' logits "
              f"concatenated vs the whole head's K7 call: max |diff| "
              f"{float(err.max()):.3e}, err/tol {ratio:.3f}, bit for bit "
              f"{torch.equal(cat, whole)} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            failures.append(f"K7 model {m} recombined")

    # K8 at the fp/unfused tree's local heads: one layer's attention at
    # the 3B width, B=8, S=768, every row at depth 307
    H = tcfg.hidden_size
    attn = {n: {"kernel": (torch.randn(1, i, o, generator=gen, device=dev)
                           * i ** -0.5).to(torch.bfloat16)}
            for n, i, o in (("q", H, tcfg.num_heads * hd),
                            ("k", H, tcfg.num_kv_heads * hd),
                            ("v", H, tcfg.num_kv_heads * hd),
                            ("o", tcfg.num_heads * hd, H))}
    B, S, depth = 8, 768, len(_qwen_prompt()) + VLM_NEW // 2
    case = list(check_decode_attn.rand_case(
        gen, B, 1, tcfg.num_heads, tcfg.num_kv_heads, hd, S, torch.bfloat16,
        False, dev))
    case[5] = torch.full((B,), depth, dtype=torch.int32, device=dev)
    with torch.no_grad():
        full = K8.decode_attention_kernel(*case)
        wo = attn["o"]["kernel"][0].float()
        full_o = full[:, 0].float() @ wo
    for m in MP_MODELS:
        outs, parts = [], []
        for r in range(m):
            sh = cut({"layers": {"attn": attn}}, qwen_param_rules(), m, r,
                     hd)["layers"]["attn"]
            h, kv, pick = local_heads(sh, tcfg)
            q0 = sh["q"].start // hd
            if pick is None:  # k/v shards: this rank's kv heads
                k0 = sh["k"].start // hd
                pick = slice(k0, k0 + kv)
            rc = [case[0][:, :, q0:q0 + h].contiguous()] + [
                t[:, :, pick].contiguous() for t in case[1:5]] + [case[5],
                                                                  None, None]
            with torch.no_grad():
                got = K8.decode_attention_kernel(*rc)
                want = K8.decode_attention_reference(*rc)
            err, ratio = check_decode_attn.compare(got, want, rc)
            ok = bool(torch.isfinite(got.float()).all()) and ratio <= 1.0
            outs.append(got)
            o = sh["o"]
            parts.append(got[:, 0].float() @ o.inner["kernel"][0].float())
            shape = (f"model {m} rank {r}: q [{B}, 1, {h}, {hd}] over "
                     f"{kv} kv head(s) {pick}, S={S}, depth {depth}, bf16")
            print(f"model_parallel K8 {shape}: max_abs_err {err:.3e} "
                  f"err/limit {ratio:.3f} {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                failures.append(f"K8 {shape}")
        cat = torch.cat(outs, dim=2)
        err, ratio = check_decode_attn.compare(cat, full, case)
        ok = ratio <= 1.0
        print(f"model_parallel K8 model {m}: the ranks' heads concatenated "
              f"vs one call over every head: max |diff| {err:.3e}, "
              f"err/limit {ratio:.3f} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"K8 model {m} recombined")
        _mp_row_sum(parts, cat[:, 0].float() @ wo, f"o rows, model {m}",
                    failures)

    # K5 at ViT-B/16's local heads, 32 images, K5 on
    vcfg = clip_preset("vit-base-patch16").vision
    W, nh = vcfg.hidden_size, vcfg.num_heads
    vhd = W // nh
    layer = LY.stack_trees([LY.init_encoder_layer(gen, W, vcfg.intermediate_size,
                                                  dev)])
    vattn = {n: {k: t.to(torch.bfloat16) for k, t in p.items()}
             for n, p in layer["attn"].items()}
    xs = torch.randn(32, 197, W, generator=gen, device=dev).to(torch.bfloat16)
    sc = vhd ** -0.5

    def heads(t):
        return t.reshape(32, 197, -1, vhd).transpose(1, 2).contiguous()

    with torch.no_grad():
        full = K5.fused_attention(*(heads(LY._linear(
            LY.layer_slice(vattn, 0)[n], xs)) for n in "qkv"), sc)
        w_out = vattn["out"]["kernel"][0].float()
    atol, rtol = TOL[torch.bfloat16]
    for m in MP_MODELS:
        outs, parts = [], []
        for r in range(m):
            sh = LY.layer_slice(cut({"layers": {"attn": vattn}},
                                    clip_param_rules(), m, r,
                                    vhd)["layers"]["attn"], 0)
            q, k, v = (heads(LY._linear(sh[n].inner, xs)) for n in "qkv")
            with torch.no_grad():
                got = K5.fused_attention(q, k, v, sc)
                want = K5.fused_attention_torch(q, k, v, sc)
            err = (got.float() - want.float()).abs()
            ok = bool(torch.isfinite(got.float()).all()) and bool(
                (err <= atol + rtol * want.float().abs()).all())
            outs.append(got)
            parts.append(got.transpose(1, 2).reshape(32, 197, -1).float()
                         @ sh["out"].inner["kernel"].float())
            shape = f"model {m} rank {r}: {list(q.shape)} bf16"
            print(f"model_parallel K5 {shape}: max_abs_err "
                  f"{float(err.max()):.3e} {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                failures.append(f"K5 {shape}")
        cat = torch.cat(outs, dim=1)
        err = (cat.float() - full.float()).abs()
        ok = bool((err <= atol + rtol * full.float().abs()).all())
        print(f"model_parallel K5 model {m}: the ranks' heads concatenated "
              f"vs one call over every head: max |diff| "
              f"{float(err.max()):.3e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            failures.append(f"K5 model {m} recombined")
        _mp_row_sum(parts, cat.transpose(1, 2).reshape(32, 197, W).float()
                    @ w_out, f"out rows, model {m}", failures)
    checks = {**K5.launch_counts(), **K7.launch_counts(),
              **K8.launch_counts()}
    print(f"model_parallel shard checks' launches {checks}", flush=True)
    if failures:
        raise SystemExit(f"model_parallel shard checks failed: {failures}")
    return checks


def tp_layer_rank() -> None:
    """One of the MP_LAYER_RANKS processes of :func:`_mp_layers`, all on
    the one card (``python3 chip_smoke.py --tp-layer-rank`` under the
    launcher's variables). NCCL refuses ranks that share a device, so
    the process group is gloo, whose all-reduce takes CUDA tensors
    through the host. Each rank makes the same seeded layers, cuts its
    shard for model 4 (its rank) and model 2 (its rank in the pair
    [0, 1] or [2, 3], a data 2 x model 2 layout), runs it in bf16
    through the model code's layer functions, whose row-parallel
    linears all-reduce over that group, and holds the result against
    the unsharded layer; the last line of its output is its result."""
    import dataclasses

    import torch.distributed as dist

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    from vlm_clip_tpu_torch.bridge import tree_map
    from vlm_clip_tpu_torch.core.config import clip_preset
    from vlm_clip_tpu_torch.models import layers as LY
    from vlm_clip_tpu_torch.ops import attention as K5
    from vlm_clip_tpu_torch.ops import decode_attention as K8
    from vlm_clip_tpu_torch.parallel.sharding import (clip_param_rules,
                                                      cut_params,
                                                      qwen_param_rules)
    from vlm_clip_tpu_torch.vlm import qwen_model as QM
    from vlm_clip_tpu_torch.vlm.qwen_convert import quantize_qwen_params

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        "gloo", init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
        f"{os.environ['MASTER_PORT']}", rank=rank, world_size=world)
    groups = {4: dist.new_group(list(range(4)))}
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    groups[2] = pairs[rank // 2]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    atol, rtol = MP_LAYER_TOL
    checks = []

    def hold(what, m, got, want, ref32, launches, expect):
        err = (got.float() - want.float()).abs()
        ratio = float((err / (atol + rtol * want.float().abs())).max())
        ok = bool(torch.isfinite(got.float()).all()) and ratio <= 1.0 \
            and all(launches.get(k) == v for k, v in expect.items())
        line = (f"{what}, model {m} rank {rank % m} of process {rank}: "
                f"max |diff| {float(err.max()):.3e} to the unsharded bf16 "
                f"layer, err/tol {ratio:.3f}")
        if ref32 is not None:
            line += (f"; to the fp32 layer: sharded "
                     f"{float((got.float() - ref32).abs().max()):.3e}, "
                     f"unsharded "
                     f"{float((want.float() - ref32).abs().max()):.3e}")
        line += (f"; launches {launches} (expected {expect}) "
                 f"{'ok' if ok else 'FAIL'}")
        print(f"tp layer {line}", flush=True)
        checks.append({"what": what, "model": m, "ok": ok,
                       "ratio": ratio, "launches": launches})

    # Qwen2.5-VL-3B, one layer: one decode step, B=8, S=768, depth 307
    tcfg = QM.qwen25vl_3b().text
    hd = tcfg.head_dim
    fp = QM.init_text(gen, dataclasses.replace(tcfg, num_layers=1,
                                               vocab_size=16),
                      dtype=torch.bfloat16, device=dev)["layers"]
    trees = {"fp/unfused": fp,
             "8h4": quantize_qwen_params({"text": {"layers": fp}}, 8,
                                         fuse_decode=True)["text"]["layers"]}
    B, S, depth = 8, 768, 307
    x = torch.randn(B, 1, tcfg.hidden_size, generator=gen,
                    device=dev).to(torch.bfloat16)
    ck, cv = (torch.randn(B, S, tcfg.num_kv_heads, hd, generator=gen,
                          device=dev).to(torch.bfloat16) for _ in range(2))
    idx = torch.full((B,), depth, dtype=torch.int32, device=dev)
    cos, sin = QM.mrope_cos_sin(idx.long()[None, :, None].expand(3, B, 1),
                                hd, tcfg.rope_theta, tcfg.mrope_section)

    def decode(p, dtype=torch.bfloat16):
        attn = p["attn"]
        _, _, pick = QM.local_heads(attn, tcfg)
        k = attn.get("k")
        if pick is None and getattr(k, "kind", None) == "column":
            pick = slice(k.start // hd, k.stop // hd)
        kv = [(c if pick is None else c[:, :, pick]).to(dtype).clone()
              for c in (ck, cv)]
        with torch.no_grad():
            return QM.text_decoder_layer(
                p, x.to(dtype), cos, sin, None, tcfg,
                cache_kv=(kv[0], kv[1], None, None), cache_index=idx)[0]

    for layout, tree in trees.items():
        want = decode(QM.layer(tree, 0))
        ref32 = (decode(QM.layer(tree_map(lambda t: t.float(), tree), 0),
                        torch.float32) if layout == "fp/unfused" else None)
        for m in MP_MODELS:
            sh = cut_params({"layers": tree}, qwen_param_rules(),
                            {"model": m}, {"model": rank % m}, {"": hd},
                            {"model": groups[m]})["layers"]
            K8.reset_launch_counts()
            got = decode(QM.layer(sh, 0))
            hold(f"Qwen2.5-VL-3B {layout} decoder layer, decode step",
                 m, got, want, ref32, K8.launch_counts(),
                 {"decode_attention_kernel": 1})

    # CLIP ViT-B/16, one encoder layer on 32 images, K5 on
    vcfg = clip_preset("vit-base-patch16").vision
    W, nh = vcfg.hidden_size, vcfg.num_heads
    clayer = tree_map(lambda t: t.to(torch.bfloat16), LY.stack_trees([
        LY.init_encoder_layer(gen, W, vcfg.intermediate_size, dev)]))
    xs = torch.randn(32, 197, W, generator=gen, device=dev).to(
        torch.bfloat16)
    K5.set_fused_attention(True)

    def encode(p, dtype=torch.bfloat16):
        with torch.no_grad():
            return LY.encoder_layer(LY.layer_slice(p, 0), xs.to(dtype), nh,
                                    vcfg.layer_norm_eps, vcfg.hidden_act)

    want = encode(clayer)
    ref32 = encode(tree_map(lambda t: t.float(), clayer), torch.float32)
    for m in MP_MODELS:
        sh = cut_params({"layers": clayer}, clip_param_rules(), {"model": m},
                        {"model": rank % m}, {"": W // nh},
                        {"model": groups[m]})["layers"]
        K5.reset_launch_counts()
        got = encode(sh)
        hold("CLIP ViT-B/16 encoder layer, [32, 197, 768]", m, got, want,
             ref32, K5.launch_counts(), {"fused_attention": 1})
    dist.destroy_process_group()
    print(MP_LAYER_RESULT + json.dumps({"rank": rank, "checks": checks}),
          flush=True)


def _mp_layers(where) -> dict:
    """The tensor-parallel layers run by MP_LAYER_RANKS processes on the
    card (:func:`tp_layer_rank`): every check of every rank must pass.
    Returns the launches the ranks' sharded layers made."""
    import tempfile

    port = _free_port()
    base = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    procs, files, failures = [], [], []
    t0 = time.time()
    try:
        for r in range(MP_LAYER_RANKS):
            files.append((tempfile.TemporaryFile("w+"),
                          tempfile.TemporaryFile("w+")))
            env = dict(base, WORLD_SIZE=str(MP_LAYER_RANKS), RANK=str(r),
                       LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(MP_LAYER_RANKS),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--tp-layer-rank"], cwd=REPO, env=env,
                stdout=files[-1][0], stderr=files[-1][1], text=True))
        deadline = time.time() + MP_LAYER_TIMEOUT
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        failures.append(f"a rank ran past {MP_LAYER_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    launches = {}
    for r, (p, (out, err)) in enumerate(zip(procs, files)):
        out.seek(0)
        err.seek(0)
        lines = out.read().splitlines()
        for ln in lines:
            if ln.startswith("tp layer") and (r == 0 or "FAIL" in ln):
                print(f"model_parallel {ln}", flush=True)
        res = (json.loads(lines[-1][len(MP_LAYER_RESULT):])
               if lines and lines[-1].startswith(MP_LAYER_RESULT) else None)
        if p.returncode != 0 or res is None:
            failures.append(f"process {r} exited {p.returncode}")
            print(f"model_parallel tp layer process {r} exited "
                  f"{p.returncode}; its stderr ends:\n"
                  f"{err.read()[-3000:]}", file=sys.stderr, flush=True)
            continue
        for c in res["checks"]:
            if not c["ok"]:
                failures.append(f"process {r}: {c['what']} model "
                                f"{c['model']}")
            for k, v in c["launches"].items():
                launches[k] = launches.get(k, 0) + v
    print(f"model_parallel tp layers: {MP_LAYER_RANKS} processes (gloo) on "
          f"{where}, {time.time() - t0:.1f} s, launches {launches}, "
          f"{'FAIL' if failures else 'ok'}", flush=True)
    if failures:
        raise SystemExit(f"model_parallel tp layers failed: {failures}")
    return launches


def model_parallel_phase() -> dict:
    """Model parallelism on the card (one H100, so NCCL at world 1; two
    and four ranks run on the CPU in the tests): the world-1 drives
    (:func:`_mp_world1`) on the vlm phase's Qwen2.5-VL-3B 8h4 tree, the
    tensor-parallel layers in bf16 across four processes
    (:func:`_mp_layers`), then the shard checks (:func:`_mp_shards`).
    Returns the drives' launches (``launches_mp``)."""
    params, cfg = _VLM.pop("params"), _VLM.pop("cfg")
    where = card()
    launches = _mp_world1(params, cfg, where)
    print(f"model_parallel drives' launches {launches}", flush=True)
    if min(launches.get(k, 0) for k in (
            "quant_matmul_int4", "decode_attention_kernel",
            "fused_attention")) < 1:
        raise SystemExit(f"a kernel of the model-parallel path never "
                         f"launched: {launches}")
    _mp_layers(where)
    _mp_shards(params, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def main() -> None:
    if sys.argv[1:] == ["--tp-layer-rank"]:
        tp_layer_rank()
        return
    if sys.argv[1:] == ["--int8"]:  # the int8 GEMM's rows alone
        setup()
        results, failures = {}, []
        _int8_times(results, failures)
        print(json.dumps(results), flush=True)
        if failures:
            raise SystemExit(f"int8 GEMM: {failures}")
        return
    if len(sys.argv) == 3 and sys.argv[1] == "--times":
        root = os.path.abspath(sys.argv[2])
        setup(root)
        kernel_times(root)
        return
    kind = setup()
    phases = []

    def run(name, fn):
        t0 = time.time()
        out = fn()
        phases.append(f"{name} {time.time() - t0:.1f}s")
        print(f"phase {name}: {time.time() - t0:.1f}s", flush=True)
        return out

    results = run("times", kernel_times)
    train_counts = run("train", train_phase)
    dp_counts = run("data_parallel", data_parallel_phase)
    t_counts = run("pipeline_t", pipeline_t_phase)
    v_counts = run("pipeline_v", pipeline_v_phase)
    serve_counts = run("serve", serve_phase)
    emotic_counts = run("real_weights_emotic", real_weights_emotic_phase)
    c5_counts = run("data_paths", data_paths_phase)
    vlm_counts = run("vlm", vlm_phase)
    nf4_counts = run("nf4", nf4_phase)
    engine_counts = run("vlm_engine", vlm_engine_phase)
    mp_counts = run("model_parallel", model_parallel_phase)
    print("phases:", ", ".join(phases), flush=True)
    launches = {**train_counts, **t_counts, **vlm_counts}
    others = {"launches_serve": serve_counts, "launches_v": v_counts,
              "launches_emotic": emotic_counts, "launches_c5": c5_counts,
              "launches_engine": engine_counts, "launches_dp": dp_counts,
              "launches_nf4": nf4_counts, "launches_mp": mp_counts}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                 "shapes": r["shapes"]}
        entry.update({key: counts[name] for key, counts in others.items()
                      if name in counts})
        if name in KERNEL_HMMA:
            entry["hmma"] = {k: HMMA[k] for k in KERNEL_HMMA[name]}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
