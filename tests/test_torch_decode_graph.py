"""The Qwen generator's decode step as one CUDA graph (``vlm/qwen.py``'s
``_DecodeGraph``) against its eager step.

On the CPU (tier-1): the step the graph captures, driven eagerly with its
device buffers (tokens, a [3, 1, 1] rope position and a [B] depth, the
per-row route), gives the eager step's logits and cache bit for bit on a
split-route cache; and a CPU generator never graphs. On the card (marker
``cuda``; they skip without one): a small 8h4 model decodes the same
tokens through the graph as eagerly, over two batches with one capture,
and the launch counters match (the int8 GEMM: 144 launches a forward
at 36 layers). This file imports neither jax nor
vlm_clip_tpu, so on a machine without jax it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_decode_graph.py -s
"""

import dataclasses

import pytest
import torch

from vlm_clip_tpu_torch.utils import profiling as P
from vlm_clip_tpu_torch.vlm import qwen_model as QM
from vlm_clip_tpu_torch.vlm.qwen import (QwenVLGenerator, _DecodeGraph,
                                         quantize_preset)
from vlm_clip_tpu_torch.vlm.sampling import GREEDY

# the tiny text tower of tests/test_qwen.py
TINY = QM.QwenTextConfig(hidden_size=64, intermediate_size=128, num_layers=2,
                         num_heads=4, num_kv_heads=2, head_dim=16,
                         vocab_size=256, mrope_section=(2, 3, 3))
EOS = 10 ** 6  # outside every vocabulary here: rows never stop early


def _generator(text_cfg, dev, max_len, kv_bits=16, seed=0):
    """An 8h4 generator over seeded text weights (no vision tower)."""
    cfg = QM.QwenVLConfig(text=text_cfg, eos_token_id=EOS)
    text = QM.init_text(torch.Generator(device=dev).manual_seed(seed),
                        text_cfg, device=dev)
    params, cfg = quantize_preset({"text": text, "vision": {}}, cfg, "8h4")
    return QwenVLGenerator(params, cfg, max_len=max_len, kv_bits=kv_bits)


def _prefilled(gen, cache, T, seed):
    """The cache after a prefill of T random embeds, and its logits."""
    g = torch.Generator(device=gen.device).manual_seed(seed)
    B, H = cache.k.shape[1], gen.cfg.text.hidden_size
    emb = (torch.randn(B, T, H, generator=g, device=gen.device) * 0.02
           ).to(gen.dtype)
    pos3 = torch.arange(T, device=gen.device)[None, None].expand(3, B, T)
    return gen._prefill(emb, pos3, cache, T - 1)


def _caches_equal(a, b):
    return all(torch.equal(getattr(a, n), getattr(b, n))
               for n in ("k", "v", "k_scale", "v_scale")
               if getattr(a, n) is not None)


# -- CPU ---------------------------------------------------------------------

@pytest.mark.parametrize("kv_bits", [16, 8])
def test_graph_step_matches_the_eager_step_bit_for_bit(monkeypatch, kv_bits):
    """Three ways over several steps give equal logits and cache rows: the
    step the graph holds (device buffers, per-row depth), the eager step
    at its int depth, and text_forward at a plain [B] depth tensor."""
    # the 3B cell's cache is past the threshold: the split route
    monkeypatch.setattr(QM, "_DENSE_CACHE_ROUTE_MAX_BYTES", 0)
    B, T, steps = 3, 7, 5
    gen = _generator(TINY, torch.device("cpu"), 32, kv_bits)
    (l0, graph_c), (_, eager_c), (_, vec_c) = (
        _prefilled(gen, gen._new_cache(B), T, seed=1) for _ in range(3))
    assert QM.split_route(graph_c.k[0])
    graph = _DecodeGraph(gen.params["text"], gen.cfg.text, gen.dtype,
                         gen.impl, graph_c)
    tok = l0.argmax(-1)
    for s in range(steps):
        graph.tokens.copy_(tok)
        graph.pos.fill_(T + s)
        graph.depth.fill_(T + s)
        got = graph.forward()
        want, eager_c = gen._decode_step(tok, T + s, eager_c, T + s)
        emb = gen.params["text"]["embed_tokens"][tok][:, None]
        vec, _ = QM.text_forward(
            gen.params["text"], emb.to(gen.dtype),
            torch.full((3, 1, 1), T + s), gen.cfg.text, None, vec_c,
            torch.full((B,), T + s, dtype=torch.long))
        assert eager_c.length == T + s + 1
        assert torch.equal(got, want) and torch.equal(vec[:, -1], want)
        assert _caches_equal(graph_c, eager_c)
        assert _caches_equal(vec_c, eager_c)
        tok = want.argmax(-1)


def test_cpu_generator_decodes_eagerly():
    """On the CPU nothing is captured: the batch cache is a plain one and
    the graph counters stay at 0 while the forwards are counted."""
    B, T = 2, 6
    gen = _generator(TINY, torch.device("cpu"), 32)
    cache = gen._batch_cache(B)
    assert gen._decode_graph is None and gen._graph_for(cache) is None
    l0, cache = _prefilled(gen, cache, T, seed=2)
    P.take()
    with P.tracing():
        buf, n_out, _ = gen._decode_loop(
            l0, T, cache, T, torch.zeros(B, 1, dtype=torch.bool), None, 6,
            GREEDY)
    counts = P.take()["counts"]
    assert counts["qwen.decode_forwards"] == 5
    assert "qwen.decode_graph_captures" not in counts
    assert "qwen.decode_graph_replays" not in counts
    assert buf.shape == (B, 6) and int(n_out.max()) <= 6


def test_split_route_and_row_positions():
    """The graph's gate reads the route an int depth takes; the per-row
    write index clamps past the cache's last row."""
    # a layer's k: 2 rows x S x 2 kv heads x 16 x 2 bytes = 128 S bytes
    edge = QM._DENSE_CACHE_ROUTE_MAX_BYTES // 128
    at = QM.init_kv_cache(TINY, 2, edge, device="cpu")
    assert not QM.split_route(at.k[0])
    past = QM.init_kv_cache(TINY, 2, edge + 1, device="cpu")
    assert QM.split_route(past.k[0])
    bidx, idx = QM.row_positions(torch.tensor([3, 14], dtype=torch.int32),
                                 2, 16)
    assert bidx.tolist() == [[0], [1]]
    assert idx.tolist() == [[3, 4], [14, 15]] and idx.dtype == torch.long
    _, idx = QM.row_positions(torch.tensor([15]), 3, 16)
    assert idx.tolist() == [[15, 15, 15]]


# -- on the card -------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph captures CUDA kernels")
    return torch.device("cuda")


def _decode(gen, B, T, steps, seeds):
    """Greedy decode loops over one prefill a seed: (tokens, the logits of
    every step, the counters and launches the run added)."""
    logits = []
    real = gen._decode_step

    def step(*a, **k):
        out = real(*a, **k)
        logits.append(out[0].clone())
        return out

    gen._decode_step = step
    toks = []
    P.take()
    with P.tracing():
        for seed in seeds:
            l0, cache = _prefilled(gen, gen._batch_cache(B), T, seed)
            presence = torch.zeros(B, 1, dtype=torch.bool, device=gen.device)
            buf, _, _ = gen._decode_loop(l0, T, cache, T, presence, None,
                                         steps, GREEDY)
            toks.append(buf.cpu())
    torch.cuda.synchronize()
    return toks, logits, P.take()["counts"]


@pytest.mark.cuda
def test_graph_decodes_as_the_eager_step_on_the_card(dev):
    """B = 4, 40 greedy steps over two batches: one capture, a replay a
    forward after the first, the eager tokens, and K7's and K8's launches
    as the eager run counts them."""
    # head_dim 128 and a cache past the dense threshold: K8 and K7 launch
    text_cfg = dataclasses.replace(
        TINY, hidden_size=512, intermediate_size=1024, num_layers=4,
        num_heads=4, num_kv_heads=2, head_dim=128, vocab_size=8192,
        mrope_section=(16, 24, 24))
    B, T, steps, seeds = 4, 300, 40, (3, 4)
    graphed = _generator(text_cfg, dev, 1536)
    eager = _generator(text_cfg, dev, 1536)
    eager._graph_for = lambda cache: None
    g_toks, g_logits, g_counts = _decode(graphed, B, T, steps, seeds)
    e_toks, e_logits, e_counts = _decode(eager, B, T, steps, seeds)
    assert graphed._decode_graph is not None
    assert graphed._decode_graph.graph is not None
    assert eager._decode_graph.graph is None
    diff = max(float((g - e).abs().max()) for g, e in zip(g_logits,
                                                          e_logits))
    print(f"largest logit difference, graph vs eager: {diff}")
    for g, e in zip(g_toks, e_toks):
        assert torch.equal(g, e)
    forwards = 2 * (steps - 1)
    assert g_counts["qwen.decode_forwards"] == forwards
    assert g_counts["qwen.decode_graph_captures"] == 1
    # the first batch's first forward runs eagerly, before the capture
    assert g_counts["qwen.decode_graph_replays"] == forwards - 1
    assert "qwen.decode_graph_replays" not in e_counts
    for k in ("launches.quant_matmul_int4",
              "launches.decode_attention_kernel"):
        assert g_counts[k] == e_counts[k] > 0, k
    assert e_counts["launches.decode_attention_kernel"] == \
        forwards * text_cfg.num_layers


@pytest.mark.cuda
def test_graph_replays_credit_the_int8_gemm(dev):
    """36 layers of small width: each decode forward launches the int8
    GEMM 144 times (qkv, o, gateup, down a layer), eagerly and as a graph
    replay (which credits the launches its capture recorded); the graph's
    logits equal the eager step's bit for bit."""
    text_cfg = dataclasses.replace(
        TINY, hidden_size=512, intermediate_size=1024, num_layers=36,
        num_heads=4, num_kv_heads=2, head_dim=128, vocab_size=8192,
        mrope_section=(16, 24, 24))
    B, T, steps, seeds = 4, 300, 6, (5,)
    graphed = _generator(text_cfg, dev, 1536)
    eager = _generator(text_cfg, dev, 1536)
    eager._graph_for = lambda cache: None
    g_toks, g_logits, g_counts = _decode(graphed, B, T, steps, seeds)
    e_toks, e_logits, e_counts = _decode(eager, B, T, steps, seeds)
    forwards = steps - 1
    assert g_counts["qwen.decode_graph_replays"] == forwards - 1
    assert e_counts["launches.quant_matmul_int8"] == 144 * forwards
    assert g_counts["launches.quant_matmul_int8"] == 144 * forwards
    assert len(g_logits) == len(e_logits) == forwards
    for g, e in zip(g_logits, e_logits):
        assert torch.equal(g, e)
    for g, e in zip(g_toks, e_toks):
        assert torch.equal(g, e)
