"""Speculative decoding: acceptance on realistic text, and round cost.

Port of ``vlm_clip_tpu/cli/bench_spec.py``. Random weights accept almost
no drafts (their greedy chains do not repeat phrases), so engine-only
runs measure the overhead and nothing of the gain. Two halves:

1. Oracle acceptance (hermetic, model-independent): walk the n-gram
   draft (``vlm/speculative.ngram_draft``) along reference-style context
   descriptions, the reference's serving workload ("describe the emotion
   and facial expression ...", model_v.py:86,108-118), scoring each
   round's draft against the text's true continuation: the acceptance a
   greedy model that emits this text would realize.
2. Round cost (``--device cuda``, where the reference has ``--tpu``):
   plain ms a step against speculative ms a round at the serving shapes
   (3B-shape random 8h4 weights made on the device), from the engine's
   rounds counter.

Then tok/s = slots * (1 + acceptance) / round_ms against slots / step_ms,
every input measured.

    python -m vlm_clip_tpu_torch.cli.bench_spec            # hermetic half
    python -m vlm_clip_tpu_torch.cli.bench_spec --device cuda
"""

from __future__ import annotations

import argparse
import time

# Reference-style VLM context descriptions (the workload of
# model_v.py:108-118's generate calls), the reference bench's corpus:
# multi-sentence facial-expression paragraphs whose phrase reuse is what
# prompt-lookup speculation exploits.
CORPUS = [
    "The person in the image appears to be experiencing a moment of "
    "genuine happiness. Their eyes are slightly narrowed with visible "
    "crinkling at the outer corners, and their eyebrows are relaxed "
    "and resting in a natural position. The mouth is curved into a "
    "broad smile with the corners of the mouth pulled upward, showing "
    "the upper teeth. The overall expression suggests warmth and "
    "genuine enjoyment of the moment.",
    "The person in the image appears to be experiencing sadness. "
    "Their eyes are slightly downcast with the upper eyelids drooping, "
    "and their eyebrows are drawn together and angled upward at the "
    "inner corners. The mouth is turned downward at the corners of "
    "the mouth, with the lower lip pushed slightly forward. The "
    "overall expression suggests a sense of loss or disappointment.",
    "The person in the image appears to be experiencing surprise. "
    "Their eyes are wide open with the whites visible above and below "
    "the iris, and their eyebrows are raised high on the forehead, "
    "creating horizontal wrinkles. The mouth is open in a relaxed "
    "oval shape with the jaw dropped. The overall expression suggests "
    "the person has just encountered something unexpected.",
    "The person in the image appears to be experiencing anger. Their "
    "eyes are narrowed and intense with a fixed glare, and their "
    "eyebrows are drawn together and pulled downward, creating "
    "vertical wrinkles between the eyebrows. The mouth is pressed "
    "into a tight line with the lips compressed. The overall "
    "expression suggests frustration and a readiness to confront.",
    "The person in the image appears to be experiencing fear. Their "
    "eyes are wide open with the upper eyelids raised and tension in "
    "the lower eyelids, and their eyebrows are raised and drawn "
    "together. The mouth is slightly open with the lips stretched "
    "horizontally toward the ears. The overall expression suggests "
    "alarm and a heightened state of alertness.",
    "The person in the image appears to be experiencing disgust. "
    "Their eyes are slightly narrowed, and their eyebrows are lowered. "
    "The nose is wrinkled with the upper lip raised, and the mouth is "
    "slightly open with the upper teeth showing. The overall "
    "expression suggests a strong aversion to something in the "
    "environment.",
    "The person in the image appears to have a neutral expression. "
    "Their eyes are open and relaxed with a steady gaze, and their "
    "eyebrows are resting in a natural position without tension. The "
    "mouth is closed with the lips resting together naturally, "
    "neither smiling nor frowning. The overall expression suggests "
    "calmness and composure, with no strong emotion visible.",
    "The person in the image shows a complex mixture of emotions. "
    "Their eyes are slightly narrowed, suggesting concentration, "
    "while their eyebrows are raised at the inner corners, suggesting "
    "concern. The mouth shows a slight asymmetry, with one corner of "
    "the mouth pulled upward in a half smile. The overall expression "
    "suggests the person is experiencing both amusement and "
    "uncertainty at the same time.",
]



def word_tokens(text: str):
    """One id per whitespace-delimited word (punctuation attached). A BPE
    tokenizer splits words into more tokens and raises n-gram repetition,
    so acceptance on word tokens is a lower bound for it."""
    vocab = {}
    out = []
    for w in text.lower().split():
        out.append(vocab.setdefault(w, len(vocab) + 2))
    return out, vocab


def oracle_acceptance(tokens, k: int, n: int = 2, warmup: int = 0,
                      prompt=()):
    """Walk speculative rounds along a known token stream: each round
    emits the carried token, drafts k continuations from the window and
    accepts the longest prefix that agrees with the stream (the model's
    choices, for a model that emits exactly this stream). ``prompt``
    seeds the window first, as the engine seeds ``hist`` at install.
    Returns (rounds, accepted). Runs on the CPU."""
    import numpy as np
    import torch

    from vlm_clip_tpu_torch.vlm.speculative import ngram_draft

    P = len(prompt)
    H = P + len(tokens) + 1
    hist = np.zeros((1, H), np.int64)
    hist[0, :P] = prompt
    g = P          # valid tokens in the window (prompt + emitted)
    i = 0          # position in the output stream
    rounds = accepted = 0
    while i < len(tokens):
        hist[0, g] = tokens[i]
        g += 1
        i += 1
        if i >= len(tokens):
            break
        draft = ngram_draft(torch.from_numpy(hist),
                            torch.tensor([g]), k, n=n)[0].tolist()
        true = tokens[i:i + k]
        a = 0
        while a < len(true) and draft[a] == true[a]:
            a += 1
        if i > warmup:
            rounds += 1
            accepted += a
        for j in range(a):
            hist[0, g + j] = tokens[i + j]
        g += a
        i += a
    return rounds, accepted


def hermetic_half() -> dict:
    """The oracle acceptances the reference prints, printed the same
    way: {"k": {K: accepted/round}, "long": ..., "seeded": {...}}."""
    from vlm_clip_tpu_torch.vlm.extractor import VLM_PROMPT

    print("oracle acceptance of the n-gram draft on reference-style "
          "context descriptions (word tokens, lower bound):")
    acc_by_k = {}
    for k in (2, 4, 8):
        rounds = accepted = emitted = 0
        for text in CORPUS:
            toks, _ = word_tokens(text)
            r, a = oracle_acceptance(toks, k)
            rounds += r
            accepted += a
            emitted += r + a
        acc_by_k[k] = accepted / rounds
        print(f"  K={k}: {accepted / rounds:.2f} accepted/round -> "
              f"{emitted / rounds:.2f} tokens/forward "
              f"({rounds} rounds over {len(CORPUS)} descriptions)",
              flush=True)
    # phrase reuse across paragraphs: the corpus as one long stream (the
    # engine's window is per slot, so this is for long outputs)
    all_toks = []
    for text in CORPUS:
        all_toks.extend(word_tokens(text)[0])
    r, a = oracle_acceptance(all_toks, 4)
    acc_long = a / r
    print(f"  K=4 over one concatenated long stream: {acc_long:.2f} "
          f"accepted/round (phrase reuse across paragraphs)", flush=True)
    # the prompt-seeded window, three workload models: the instruction
    # alone; a description of another image in the prompt (paraphrase);
    # the same description in the prompt (re-describe)
    print("prompt-seeded acceptance (engine seeds hist with the "
          "prompt at install), K=4:")
    acc_seeded = {}
    for name, make in (
        ("instruction", lambda t: (VLM_PROMPT, t)),
        ("paraphrase", lambda t: (VLM_PROMPT + " " + CORPUS[
            (CORPUS.index(t) + 1) % len(CORPUS)], t)),
        ("re-describe", lambda t: (VLM_PROMPT + " " + t, t)),
    ):
        rounds = accepted = 0
        for text in CORPUS:
            ptxt, otxt = make(text)
            toks, _ = word_tokens(ptxt + " \x00 " + otxt)
            plen = len(ptxt.split()) + 1   # +1: the \x00 separator
            r, a = oracle_acceptance(toks[plen:], 4, prompt=toks[:plen])
            rounds += r
            accepted += a
        acc_seeded[name] = accepted / rounds
        print(f"  {name:12s}: {accepted / rounds:.2f} accepted/round "
              f"({rounds} rounds)", flush=True)
    return {"k": acc_by_k, "long": acc_long, "seeded": acc_seeded}


def main(argv=None, gen=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None,
                   help="also measure the engine's round costs on this "
                        "device (cuda; cpu for a tiny check)")
    p.add_argument("--slots", default="8,64")
    p.add_argument("--budget", type=int, default=120)
    p.add_argument("--requests", type=int, default=128)
    p.add_argument("--spec-k", type=int, default=4)
    args = p.parse_args(argv)

    out = hermetic_half()
    if args.device is None:
        return out

    # ---- the engine's round costs at the serving shapes ----------------
    from vlm_clip_tpu_torch.cli.bench_engine import (synth_generator,
                                                     synth_requests)
    from vlm_clip_tpu_torch.cli.common import resolve_device
    from vlm_clip_tpu_torch.vlm.engine import ContinuousBatchingEngine

    if gen is None:
        print("synthesizing 3B-shape params (8h4) ...", flush=True)
        gen = synth_generator(768, 16, resolve_device(args.device))
    ids, vins, _ = synth_requests(gen.cfg, 1, 448)
    K = args.spec_k

    def run(slots, spec_k):
        for timed in (False, True):  # the first run is untimed
            eng = ContinuousBatchingEngine(gen, n_slots=slots,
                                           sync_steps=16, spec_k=spec_k,
                                           refill_chunks=(32, 8, 1),
                                           profile=True)
            for _ in range(args.requests):
                eng.submit(ids, vins[0], max_new_tokens=args.budget)
            t0 = time.perf_counter()
            res = eng.flush()
            dt = time.perf_counter() - t0
        toks = sum(len(v) for v in res.values())
        rounds = eng.stats["rounds"]
        ms_round = eng.stats["steps_s"] / rounds * 1e3
        # tokens a slot-round: plain emits <= 1 (slot use), speculative
        # 1 + the accepted drafts
        rate = toks / (rounds * slots)
        note = (f"measured accepted/round = {rate - 1:+.2f} (random "
                f"weights)" if spec_k else f"slot utilization {rate:.2f}")
        print(f"  slots={slots} spec_k={spec_k}: {ms_round:.2f} ms/round "
              f"(decode only), {toks} tokens in {dt:.1f}s end-to-end, "
              + note, flush=True)
        return ms_round

    print(f"engine round costs (3B 8h4, budget {args.budget}, "
          f"{args.requests} requests):", flush=True)
    table = {}
    for slots in (int(s) for s in args.slots.split(",")):
        table[slots] = (run(slots, 0), run(slots, K))
    acc, acc_long = out["k"].get(K, out["k"][4]), out["long"]
    print(f"\nthroughput (decode only; acceptance from the oracle above, "
          f"costs from this device):")
    print(f"| slots | plain tok/s | spec{K} @acc={acc:.2f} (single "
          f"description) | spec{K} @acc={acc_long:.2f} (long stream) |")
    for slots, (v, s) in table.items():
        tv = slots / v * 1e3
        t0_ = slots * (1 + acc) / s * 1e3
        t1_ = slots * (1 + acc_long) / s * 1e3
        print(f"| {slots} | {tv:.0f} | {t0_:.0f} ({t0_ / tv:.2f}x) | "
              f"{t1_:.0f} ({t1_ / tv:.2f}x) |")
    out["round_ms"] = table
    return out


if __name__ == "__main__":
    main()
