"""Benchmark Qwen-3B-shape quantized decode on the card.

Port of ``vlm_clip_tpu/cli/bench_decode.py``: times
``QwenVLGenerator``'s decode loop on a random-weight model with the exact
Qwen2.5-VL-3B text dims, its weights synthesized on the device in
quantized form (packed uint8 / int8 plus scales) from a seeded
``torch.Generator``, so the fp32 model never exists.

    python -m vlm_clip_tpu_torch.cli.bench_decode --bits 8 --head-bits 4 \\
        --fused --batch 8 --new 64 [--kv-bits 8] [--device cpu]

Prints the per-token latency and the aggregate tokens/s. K8 (decode
attention) runs once the per-layer cache takes the split route (over
2 MB: ``--max-len 768`` at B=8 with a bf16 cache); K7 (the int4 GEMV)
whenever an int4 weight meets a decode-shaped GEMV.
"""

from __future__ import annotations

import argparse
import time

import torch


def synth_quantized_text_params(cfg, bits, head_bits: int = 0,
                                seed: int = 0, fused: bool = False,
                                device="cuda"):
    """Random 3B-shape text params with quantized linears, in the layout
    of ``quantize_qwen_params``: stacked [L, ...] QuantizedLinear layers,
    a bf16 embedding, fp32 norms; ``head_bits`` adds a quantized untied
    head. Made on ``device``: the card unless the caller asks for the
    CPU."""
    from vlm_clip_tpu_torch.ops.quant import (_I4_TK, _I4_TN,
                                              QuantizedLinear,
                                              quantize_weight)

    gen = torch.Generator(device=device).manual_seed(seed)
    L, H = cfg.num_layers, cfg.hidden_size
    heads, kv, hd, inter = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                            cfg.intermediate_size)

    if bits == "mixed":
        from vlm_clip_tpu_torch.vlm.qwen_convert import MIXED_DECODE_BITS

        def role_bits(role):
            return MIXED_DECODE_BITS.get(f"text/layers/{role}",
                                         MIXED_DECODE_BITS["default"])
    else:
        def role_bits(role):
            return bits

    def zeros(n, bias):
        return (torch.zeros(L, n, device=device) if bias else None)

    def qlin(k, n, bias, b):
        if b == 8:
            qw = torch.randint(-127, 128, (L, k, n), generator=gen,
                               dtype=torch.int8, device=device)
            return QuantizedLinear(qw, torch.full((L, n), 0.01,
                                                  device=device), 8,
                                   zeros(n, bias))
        k2p = k // 2 + (-(k // 2)) % (_I4_TK // 2)
        np_ = n + (-n) % _I4_TN
        qw = torch.randint(0, 256, (L, k2p, np_), generator=gen,
                           dtype=torch.uint8, device=device)
        return QuantizedLinear(qw, torch.full((L, np_), 0.01,
                                              device=device), 4,
                               zeros(n, bias), in_features=k, out_features=n)

    if fused:
        attn = {"qkv": qlin(H, (heads + 2 * kv) * hd, True,
                            role_bits("attn/qkv")),
                "o": qlin(heads * hd, H, False, role_bits("attn/o"))}
        mlp = {"gateup": qlin(H, 2 * inter, False, role_bits("mlp/gateup")),
               "down": qlin(inter, H, False, role_bits("mlp/down"))}
    else:
        attn = {"q": qlin(H, heads * hd, True, role_bits("attn/q")),
                "k": qlin(H, kv * hd, True, role_bits("attn/k")),
                "v": qlin(H, kv * hd, True, role_bits("attn/v")),
                "o": qlin(heads * hd, H, False, role_bits("attn/o"))}
        mlp = {"gate": qlin(H, inter, False, role_bits("mlp/gate")),
               "up": qlin(H, inter, False, role_bits("mlp/up")),
               "down": qlin(inter, H, False, role_bits("mlp/down"))}
    params = {
        "embed_tokens": (torch.randn(cfg.vocab_size, H, generator=gen,
                                     device=device) * 0.02
                         ).to(torch.bfloat16),
        "final_norm": {"scale": torch.ones(H, device=device)},
        "layers": {"attn": attn, "mlp": mlp,
                   "ln1": {"scale": torch.ones(L, H, device=device)},
                   "ln2": {"scale": torch.ones(L, H, device=device)}},
    }
    if head_bits:
        w = torch.randn(H, cfg.vocab_size, generator=gen,
                        device=device) * 0.02
        params["lm_head"] = quantize_weight(w, head_bits)
    return params


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--bits", default="4", choices=("4", "8", "mixed"))
    p.add_argument("--head-bits", type=int, default=0, choices=(0, 4, 8),
                   help="quantize an untied lm head (0 = tied bf16 head)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--new", type=int, default=64, help="tokens to decode")
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--fused", action="store_true",
                   help="fused qkv/gateup decode GEMVs (the extractor's "
                        "layout)")
    p.add_argument("--kv-bits", type=int, default=16, choices=(8, 16),
                   help="8 = int8 KV cache (per-row scales)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    import dataclasses

    from vlm_clip_tpu_torch.cli.common import resolve_device
    from vlm_clip_tpu_torch.vlm.qwen import QwenVLGenerator
    from vlm_clip_tpu_torch.vlm.qwen_model import (QwenTextConfig,
                                                   QwenVLConfig,
                                                   init_kv_cache)
    from vlm_clip_tpu_torch.vlm.sampling import GREEDY

    dev = resolve_device(args.device)
    bits = args.bits if args.bits == "mixed" else int(args.bits)
    head_bits = args.head_bits or (4 if bits == "mixed" else 0)
    tcfg = QwenTextConfig()  # 3B dims
    if head_bits:
        tcfg = dataclasses.replace(tcfg, tie_word_embeddings=False)
    cfg = QwenVLConfig(text=tcfg)
    print(f"synthesizing 3B-shape params (bits={bits}, "
          f"head_bits={head_bits}) ...", flush=True)
    text = synth_quantized_text_params(tcfg, bits, head_bits,
                                       fused=args.fused, device=dev)
    gen = QwenVLGenerator({"text": text, "vision": {}}, cfg,
                          max_len=args.max_len)

    B, T = args.batch, args.prompt_len
    cache = init_kv_cache(tcfg, B, args.max_len, torch.bfloat16,
                          quantized=args.kv_bits == 8, device=dev)
    cache.length = T  # as if a prefill of T tokens had run
    logits0 = torch.randn(B, tcfg.vocab_size, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(1))
    presence = torch.zeros(B, 1, dtype=torch.bool, device=dev)

    def run(cache):
        buf, n_out, cache = gen._decode_loop(
            logits0, T, cache, T, presence,
            torch.Generator(device=dev).manual_seed(0), args.new, GREEDY)
        return buf.cpu().numpy(), cache

    print("first decode loop ...", flush=True)
    t0 = time.perf_counter()
    buf, cache = run(cache)
    print(f"first call: {time.perf_counter() - t0:.1f}s", flush=True)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        buf, cache = run(cache)
        times.append(time.perf_counter() - t0)
    dt = min(times)
    per_tok = dt / args.new
    line = (f"bits={bits} head_bits={head_bits} B={B} fused={args.fused} "
            f"kv_bits={args.kv_bits}: {dt * 1e3:.1f} ms for {args.new} "
            f"tokens -> {per_tok * 1e3:.2f} ms/token, "
            f"{B / per_tok:.1f} tok/s aggregate")
    print(line, flush=True)
    return {"line": line, "ms_per_token": per_tok * 1e3,
            "tok_per_s": B / per_tok, "tokens": buf}


if __name__ == "__main__":
    main()
